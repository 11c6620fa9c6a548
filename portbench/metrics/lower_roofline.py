"""The lower segment's least time over its median time in the traced window,
%: the least time is the larger of the algorithm's operations at 495
TFLOP/s (dense TF32, the fastest rate of any float32-accurate product) and
its bytes at 3.35 TB/s, counted from the shapes (pb.work, per layer, not
per CUDA kernel)."""

from pb.stats import median
from pb.work import least_seconds


def read(run):
    vals = [s["lower"] for s in (run.stages or []) if "lower" in s]
    if not vals:
        return None
    return 100.0 * least_seconds(*run.work["lower"]) / (median(vals) * 1e-3)
