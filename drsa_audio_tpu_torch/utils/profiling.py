"""Tracing and per-phase timing (the port of
drsa_audio_tpu.utils.profiling).

``PhaseTimer`` accumulates wall-clock blocks with a summary table;
``trace`` wraps ``torch.profiler.profile`` so any pipeline can write a
TensorBoard-viewable trace, and ``annotate`` names a region inside it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall-clock per named phase."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'phase':24s} {'calls':>6s} {'total_s':>10s} {'mean_ms':>10s}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {n:6d} {total:10.3f} {total / n * 1e3:10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiler trace of the block, written to ``log_dir`` for TensorBoard
    (``tensorboard_trace_handler``): host activity always, the CUDA
    device's where there is one. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield
