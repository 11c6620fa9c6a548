"""The median over the traced window's requests of the service's
``frontend`` stage, ms (pb.spans.StageSpans)."""

from pb.stats import median


def read(run):
    vals = [s["frontend"] for s in (run.stages or []) if "frontend" in s]
    return median(vals) if vals else None
