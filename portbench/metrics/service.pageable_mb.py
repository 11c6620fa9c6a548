"""The median over the window's requests of the bytes the service moved
between pageable host memory and the device, both ways (the program's
counters ``h2d_bytes`` and ``d2h_bytes``, pageable), MB of 10^6 bytes
(pb.request_log)."""

from pb.request_log import window_median


def read(run):
    return window_median(run, lambda r: (r.counters["h2d_bytes.pageable"]
                                         + r.counters["d2h_bytes.pageable"]) / 1e6)
