"""The median over the traced window's requests of the service's
``lower`` stage, ms (pb.spans.StageSpans)."""

from pb.stats import median


def read(run):
    vals = [s["lower"] for s in (run.stages or []) if "lower" in s]
    return median(vals) if vals else None
