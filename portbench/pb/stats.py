"""Percentiles, rates and spreads of a window's request records."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default, written out). Raises on an empty list."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Sequence[float]) -> float:
    return percentile(values, 50.0)


def window_rate(records, t0: float, t1: float) -> float:
    """Clips completed in the window over the window's seconds: all the
    work and all the time, never a median of pieces. ``records`` are
    (start, end, clips) tuples, host clock."""
    if t1 <= t0:
        raise ValueError("empty window")
    return sum(r[2] for r in records) / (t1 - t0)


def latencies_ms(records) -> list[float]:
    return [(end - start) * 1e3 for start, end, _ in records]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile over the median,
    as ``statistics.quantiles(values, n=4)`` gives the quartiles."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
