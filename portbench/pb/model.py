"""A configuration's layer plan, and its weights, BatchNorm statistics and
class projections drawn from the seed on the device.

The plan is plain data (one dict a layer, named ``features.N`` /
``classifier.N`` as the reference's modules are) worked out from the
configuration's numbers alone. The benchmark hands the same weights to the
program and to the plain reference; each side builds its model from them
itself (the program through its own layer specs and ``fold_batchnorm``,
the reference through its own fold)."""

from __future__ import annotations

import math

import torch


def layer_plan(cfg: dict) -> list[dict]:
    """[conv -> (bn) -> relu] * block_depth -> maxpool per block, flatten,
    [linear -> (bn1d) -> relu -> (dropout)] * dense_depth -> linear."""
    plan, idx, in_ch = [], 0, 1
    h, w = cfg["n_mels"], cfg["mel_width"]
    kh, kw = cfg["conv_kernel"]
    for filters, pool in zip(cfg["n_filters"], cfg["pool_kernels"]):
        for d in range(cfg["block_depth"]):
            plan.append({"kind": "conv", "name": f"features.{idx}",
                         "in_ch": in_ch if d == 0 else filters, "out_ch": filters,
                         "kernel": [kh, kw], "hw": [h, w]})
            idx += 1
            if cfg["conv_bn"]:
                plan.append({"kind": "batchnorm", "name": f"features.{idx}", "ch": filters})
                idx += 1
            plan.append({"kind": "relu", "name": f"features.{idx}", "hw": [h, w], "ch": filters})
            idx += 1
        plan.append({"kind": "maxpool", "name": f"features.{idx}", "kernel": list(pool),
                     "hw": [h, w], "ch": filters})
        idx += 1
        h, w = h // pool[0], w // pool[1]
        in_ch = filters
    n_in = h * w * in_ch
    plan.append({"kind": "flatten", "name": "flatten", "features": n_in})
    idx = 0
    for _ in range(cfg["dense_depth"]):
        plan.append({"kind": "linear", "name": f"classifier.{idx}", "in_f": n_in,
                     "out_f": cfg["n_dense"]})
        idx += 1
        if cfg["dense_bn"]:
            plan.append({"kind": "batchnorm1d", "name": f"classifier.{idx}", "ch": cfg["n_dense"]})
            idx += 1
        plan.append({"kind": "relu", "name": f"classifier.{idx}"})
        idx += 1
        if cfg["dropout"]:
            plan.append({"kind": "dropout", "name": f"classifier.{idx}", "rate": cfg["dropout"]})
            idx += 1
        n_in = cfg["n_dense"]
    plan.append({"kind": "linear", "name": f"classifier.{idx}", "in_f": n_in,
                 "out_f": cfg["n_classes"]})
    return plan


def _shapes(layer):
    if layer["kind"] == "conv":
        kh, kw = layer["kernel"]
        return (layer["out_ch"], layer["in_ch"], kh, kw), layer["in_ch"] * kh * kw
    return (layer["out_f"], layer["in_f"]), layer["in_f"]


def draw(cfg: dict, seed: int, device) -> tuple[dict, torch.Tensor]:
    """({name: {"weight", "bias"[, "running_mean", "running_var"]}}, the
    class projections U [n_classes, d, d]), all float32 on ``device``, from
    one generator seeded with ``seed``, in a few large calls: weights
    He-normal (std sqrt(2 / fan_in)), biases uniform in +-1/sqrt(fan_in),
    BatchNorm scale U(0.5, 1.5), bias N(0, 0.1), mean N(0, 0.1), var
    U(0.5, 2), and U the Q of a Gaussian matrix's QR with R's diagonal
    made positive."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    plan = layer_plan(cfg)
    lin = [ly for ly in plan if ly["kind"] in ("conv", "linear")]
    bns = [ly for ly in plan if ly["kind"] in ("batchnorm", "batchnorm1d")]
    shapes = [_shapes(ly) for ly in lin]
    n_w = sum(math.prod(s) for s, _ in shapes)
    n_b = sum(s[0] for s, _ in shapes)
    n_bn = sum(ly["ch"] for ly in bns)
    f32 = dict(device=device, dtype=torch.float32)
    wn = torch.randn(n_w, generator=g, **f32)
    bu = torch.rand(n_b, generator=g, **f32) * 2.0 - 1.0
    bn_u = torch.rand(2, n_bn, generator=g, **f32)
    bn_n = torch.randn(2, n_bn, generator=g, **f32)
    d = cfg["subspace_dim"]
    gauss = torch.randn(cfg["n_classes"], d, d, generator=g, **f32)
    params, ow, ob = {}, 0, 0
    for ly, (shape, fan_in) in zip(lin, shapes):
        n = math.prod(shape)
        params[ly["name"]] = {
            "weight": (wn[ow:ow + n] * math.sqrt(2.0 / fan_in)).reshape(shape),
            "bias": bu[ob:ob + shape[0]] / math.sqrt(fan_in)}
        ow, ob = ow + n, ob + shape[0]
    o = 0
    for ly in bns:
        c = ly["ch"]
        params[ly["name"]] = {"weight": 0.5 + bn_u[0, o:o + c], "bias": 0.1 * bn_n[0, o:o + c],
                              "running_mean": 0.1 * bn_n[1, o:o + c],
                              "running_var": 0.5 + 1.5 * bn_u[1, o:o + c]}
        o += c
    q, r = torch.linalg.qr(gauss)
    U = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    return params, U.contiguous()
