"""Per-request numbers from the program's own request log
(``drsa_audio_tpu_torch.utils.profiling``: spans and counters the service
records for every request), over the benchmark's window.

A program without the log (no ``profiling.requests``), or a window with no
request in it that has the value, gives None, and the metric is left out of
the line."""

from __future__ import annotations

import importlib

from pb.stats import median

PROFILING = "drsa_audio_tpu_torch.utils.profiling"


def window_median(run, value) -> float | None:
    """The median of ``value(request)`` over the requests whose
    ``service.request`` span lies inside the window [t0, t1], leaving out
    those for which it is None (a device span on the CPU)."""
    try:
        profiling = importlib.import_module(PROFILING)
    except ImportError:
        return None
    requests = getattr(profiling, "requests", None)
    if requests is None:
        return None
    vals = [v for v in map(value, requests(run.window["t0"], run.window["t1"])) if v is not None]
    return median(vals) if vals else None
