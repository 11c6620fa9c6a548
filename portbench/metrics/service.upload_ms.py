"""The median over the window's requests of the program's span
``service.upload``: the host's time to copy the request's waveforms to the
device, ms (pb.request_log)."""

from pb.request_log import window_median


def read(run):
    return window_median(run, lambda r: r.ms("service.upload"))
