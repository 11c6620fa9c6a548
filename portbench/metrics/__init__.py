"""One reader a metric, ``read(run) -> float | None``, named as the metric.
``run`` holds the window (records of (start, end, clips) on the host clock,
t0, t1), ``setup_s``, the stage spans of a traced window (``stages``, one
dict of ms a request, or None), the profiled slice (``profile``, or None),
the request's operations and bytes by layer (``work``) and the cell's
configuration and traffic. A reader that finds nothing to read returns
None, and the metric is left out of the line."""
