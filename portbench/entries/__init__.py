"""The program's entry points the windows drive, one module each, found by
the ``entry`` a traffic file names. Each has ``setup(ctx)``, ``window(ctx,
seconds, keep)``, ``slice(ctx, n)`` (the run of one profiled request) and
``reference_inputs(ctx, desc)``."""
