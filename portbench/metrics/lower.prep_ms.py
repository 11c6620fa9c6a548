"""The median over the window's requests of the summed ``lower.prep``
spans: the host's time rebuilding the chain's weight layouts, ms
(pb.request_log)."""

from pb.request_log import window_median


def read(run):
    return window_median(run, lambda r: r.ms("lower.prep"))
