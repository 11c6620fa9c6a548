"""The median over the window's requests of the device ms of the program's
span ``service.device_sort``: the subspace sort of the maps on the device
(pb.request_log)."""

from pb.request_log import window_median


def read(run):
    return window_median(run, lambda r: r.device_ms("service.device_sort"))
