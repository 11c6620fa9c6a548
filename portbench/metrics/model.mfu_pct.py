"""The algorithm's operations of every request completed in the traced
window (front-end, forward, upper and lower LRP, counted from the shapes by
pb.work) over the window's seconds at 495 TFLOP/s, %."""

from pb.work import PEAK_TF32_OPS


def read(run):
    w = run.window
    if not w["records"] or run.stages is None and run.profile is None:
        return None
    ops_per_clip = run.work["total"][0] / run.clips_per_request
    clips = sum(r[2] for r in w["records"])
    return 100.0 * ops_per_clip * clips / ((w["t1"] - w["t0"]) * PEAK_TF32_OPS)
