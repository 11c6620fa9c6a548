"""A slice of requests under torch.profiler, reduced by ``pb.trace``."""

from __future__ import annotations

import time

from pb import trace


def profiled(run, n: int) -> dict:
    """``run(i)`` for i < n under the profiler (device and host activity);
    the device is synchronised before and after, and the slice's wall time
    is the host clock around it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            with record_function("request"):
                run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = []
    for e in prof.events():
        kind = trace.DEVICE if e.device_type == DeviceType.CUDA else trace.HOST
        events.append((kind, e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    return trace.reduce(events, wall)
