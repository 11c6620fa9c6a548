"""The median over the traced window's requests of the service's
``readback`` stage, ms (pb.spans.StageSpans)."""

from pb.stats import median


def read(run):
    vals = [s["readback"] for s in (run.stages or []) if "readback" in s]
    return median(vals) if vals else None
