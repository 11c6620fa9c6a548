"""A request's operations and bytes by layer, from the configuration's
shapes: the front-end, the forward pass, the upper LRP segment (down to the
subspace filter, one clone) and the lower segment (the projection's
epsilon and the convolutions' rules, K clones). The counts come from the
modules of ``work/``, one a layer kind, found by name."""

from __future__ import annotations

import functools

import numpy as np

import run
from pb.model import layer_plan


@functools.cache
def kind(name: str):
    """``work/<name>.py``'s ``work`` function."""
    return run.load("work", name).work


def _add(acc, key, ow):
    o, w = acc.get(key, (0.0, 0.0))
    acc[key] = (o + ow[0], w + ow[1])


def request_work(cfg: dict, b: int) -> dict:
    """{"frontend", "forward", "upper", "lower", "total"}: (operations,
    bytes) of one request of ``b`` clips."""
    from reference.frontend import htk_filterbank
    K, d = cfg["num_concepts"], cfg["subspace_dim"]
    rules = {n: (r, kw) for n, r, kw in cfg["rules"]}
    plan = layer_plan(cfg)
    at = next(i for i, ly in enumerate(plan) if ly["name"] == f"features.{cfg['drsa_layer']}")
    acc: dict = {}
    samples = cfg["slice_length"] * cfg["sample_rate"]
    frames = samples // cfg["hop_length"] + 1
    nnz = int(np.count_nonzero(htk_filterbank(cfg["n_fft"] // 2 + 1, cfg["n_mels"],
                                              cfg["sample_rate"])))
    _add(acc, "frontend", kind("frontend")(b, samples, frames, cfg["n_fft"], cfg["n_mels"], nnz))
    n = plan[at]["hw"][0] * plan[at]["hw"][1]
    # the projection and its inverse in the forward pass
    _add(acc, "forward", kind("epsilon")(b, 0, n, d, d, forward=True))
    _add(acc, "forward", kind("epsilon")(b, 0, n, d, d, forward=True))
    nonneg = False
    for i, ly in enumerate(plan):
        lower = i <= at
        if ly["kind"] == "conv":
            H, W = ly["hw"]
            args = (H, W, ly["in_ch"], ly["out_ch"], *ly["kernel"])
            _add(acc, "forward", kind("conv")(b, *args))
            rule = rules.get(ly["name"], (None, {}))[0]
            if rule is not None:
                seg, clones = ("lower", K) if lower else ("upper", 1)
                if rule == "gamma":
                    _add(acc, seg, kind("gamma")(b, clones, *args, nonneg=nonneg))
                else:
                    _add(acc, seg, kind(rule)(b, clones, *args))
        elif ly["kind"] == "linear":
            _add(acc, "forward", kind("linear")(b, ly["in_f"], ly["out_f"]))
            if ly["name"] in rules:
                _add(acc, "upper", kind("epsilon")(b, 1, 1, ly["in_f"], ly["out_f"]))
        if ly["kind"] == "relu":
            nonneg = True
        elif ly["kind"] not in ("maxpool", "batchnorm", "batchnorm1d"):
            nonneg = False
        if i == at:
            # the inverse projection's rule (upper, one clone) and the
            # projection's at K clones (lower); past it the input has both signs
            _add(acc, "upper", kind("epsilon")(b, 1, n, d, d))
            _add(acc, "lower", kind("epsilon")(b, K, n, d, d, forward=True))
            nonneg = False
    H, W = plan[0]["hw"]
    o, w = acc["lower"]
    acc["lower"] = (o, w + 4.0 * b * (n * d + H * W))   # R at the filter in, the standard map out
    acc["total"] = (sum(v[0] for k, v in acc.items()), sum(v[1] for k, v in acc.items()))
    return acc


PEAK_TF32_OPS = 495e12     # H100 SXM, dense TF32 on the tensor cores (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM, HBM3 (NVIDIA data sheet)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card can take for the work: the larger of the
    operations at the dense TF32 rate (the fastest any float32-accurate
    scheme forms products) and the bytes at the memory rate."""
    return max(ops / PEAK_TF32_OPS, nbytes / PEAK_HBM_BYTES)
