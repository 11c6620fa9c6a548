"""Clips whose results reached the caller in the window, over the window's
seconds (from its start to the last result)."""

from pb.stats import window_rate


def read(run):
    w = run.window
    return window_rate(w["records"], w["t0"], w["t1"]) if w["records"] else None
