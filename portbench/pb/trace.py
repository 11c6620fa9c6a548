"""Reduction of a profiled slice to the device's busy time, its idle share
and the breakdown: the device intervals' union (overlapping kernels and
copies counted once), the top device operations by time, and the longest
idle gaps named by the innermost host range that spans them."""

from __future__ import annotations

import collections

DEVICE = "device"
HOST = "host"


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches of [lo, hi] not covered by any interval, as
    (start, end) pairs."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def reduce(events, wall_s: float, top: int = 10) -> dict:
    """``events`` are (kind, name, start_s, end_s) with kind DEVICE or HOST,
    on one clock; ``wall_s`` is the slice's host-clock length. A device
    event that carries a host range's name is the range's shadow on the
    device timeline (a user annotation), not an operation, and is left
    out. Returns busy_s, idle share, and the breakdown lists."""
    ranges = {name for k, name, _, _ in events if k == HOST}
    events = [ev for ev in events if ev[0] == HOST or ev[1] not in ranges]
    dev = [(s, e) for k, _, s, e in events if k == DEVICE]
    if not dev:
        raise ValueError("the profiler recorded no device operation")
    busy = union_length(dev)
    by_name = collections.Counter()
    for k, name, s, e in events:
        if k == DEVICE:
            by_name[name] += e - s
    host = [(s, e, name) for k, name, s, e in events if k == HOST]
    lo = min(s for _, _, s, _ in events)
    hi = max(e for _, _, _, e in events)
    named = collections.Counter()
    for s, e in gaps(dev, lo, hi):
        mid = 0.5 * (s + e)
        around = [h for h in host if h[0] <= mid <= h[1]]
        name = min(around, key=lambda h: h[1] - h[0])[2] if around else "no host range"
        named[name] += e - s
    return {"busy_s": busy, "window_s": wall_s,
            "idle_pct": 100.0 * (1.0 - busy / wall_s),
            "device_ops": [[n, t] for n, t in by_name.most_common(top)],
            "idle_gaps": [[n, t] for n, t in named.most_common(top)]}
