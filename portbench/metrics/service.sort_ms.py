"""The median over the traced window's requests of the service's
``sort`` stage, ms (pb.spans.StageSpans)."""

from pb.stats import median


def read(run):
    vals = [s["sort"] for s in (run.stages or []) if "sort" in s]
    return median(vals) if vals else None
