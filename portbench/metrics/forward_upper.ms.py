"""The median over the traced window's requests of the service's
``forward_upper`` stage, ms (pb.spans.StageSpans)."""

from pb.stats import median


def read(run):
    vals = [s["forward_upper"] for s in (run.stages or []) if "forward_upper" in s]
    return median(vals) if vals else None
