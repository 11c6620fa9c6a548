"""The median over the traced window's requests of a request's device ms in
the program's span ``chain.wide``: the chain_block calls with a conv over
128 channels (VGGish's 256 and 512), summed a request (pb.request_log). A
request whose counter ``chain.wide_launches`` is 0 or absent (the plain
tiled walk, or a program without the span) gives nothing, so the metric is
left out rather than read from another path."""

from pb.request_log import window_median


def wide_ms(request):
    """A request's summed ``chain.wide`` device ms, or None where no wide
    kernel launched."""
    if not request.counters.get("chain.wide_launches", 0):
        return None
    return request.device_ms("chain.wide")


def read(run):
    return window_median(run, wide_ms)
