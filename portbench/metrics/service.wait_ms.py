"""The median over the window's requests of ``service.finalize`` less
``service.readback``: the host blocked on the device before the readback,
ms (pb.request_log)."""

from pb.request_log import window_median


def read(run):
    return window_median(run, lambda r: r.ms("service.finalize") - r.ms("service.readback"))
