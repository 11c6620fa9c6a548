"""The harness's own modules: statistics, the profiler's reduction, the
operation counts, the model's layer plan and weights, and the comparison
that decides ``correct``. ``program`` and ``spans`` reach the measured
program (``drsa_audio_tpu_torch``) by name, inside their functions."""
