"""The median over the window's requests of ``service.dispatch`` less
``service.upload``: the host's time to enqueue the request's device work,
ms (pb.request_log)."""

from pb.request_log import window_median


def read(run):
    return window_median(run, lambda r: r.ms("service.dispatch") - r.ms("service.upload"))
