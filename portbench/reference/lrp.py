"""The model and its explanation, written out plainly in NCHW: BatchNorm
folded into the layer before it, the class projection U spliced in after
``features.<drsa_layer>`` (projection, subspace filter, inverse
projection), and LRP by the configuration's rules (zennit 0.5.1's algebra):

  epsilon   R_in = x * W^T (R / stab(z))
  gamma     four clamp combinations gated by the sign of the true output
  wsquare   z = f(1; w^2, b^2), R_in = W^2^T (R / stab(z))
  relu      R * (1 where a > 0, 0.5 at 0, 0 below)
  maxpool   the whole R of a window to its first maximum (row-major)

stab(z) = z + eps * (1 if z >= 0 else -1). The standard heatmap is its own
backward pass with nothing masked at the subspace filter; concept k's map
keeps only block k there. Every pass is computed anew: the upper segment's
relevance once a block of clips (the mask lies below it), then the K + 1
masked copies through the lower segment together."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pb.model import layer_plan


def stab(z: torch.Tensor, eps: float) -> torch.Tensor:
    return z + torch.where(z >= 0, eps, -eps)


def fold(cfg: dict, params: dict) -> list[dict]:
    """The layer plan with each BatchNorm merged into the conv or linear
    layer before it, the weights attached."""
    eps = cfg.get("bn_eps", 1e-5)
    out = []
    for ly in layer_plan(cfg):
        if ly["kind"] in ("batchnorm", "batchnorm1d"):
            bn, prev = params[ly["name"]], out[-1]
            f = bn["weight"] / torch.sqrt(bn["running_var"] + eps)
            prev["w"] = prev["w"] * f.reshape(-1, *([1] * (prev["w"].ndim - 1)))
            prev["b"] = (prev["b"] - bn["running_mean"]) * f + bn["bias"]
            continue
        ly = dict(ly)
        if ly["kind"] in ("conv", "linear"):
            ly["w"], ly["b"] = params[ly["name"]]["weight"], params[ly["name"]]["bias"]
        out.append(ly)
    return out


def with_projection(layers: list[dict], cfg: dict) -> list[dict]:
    at = f"features.{cfg['drsa_layer']}"
    out = []
    for ly in layers:
        out.append(ly)
        if ly["name"] == at:
            out += [{"kind": "projection", "name": "projection"},
                    {"kind": "filter", "name": "filter"},
                    {"kind": "invprojection", "name": "invprojection"}]
    return out


def _pad(w):
    return (w.shape[2] // 2, w.shape[3] // 2)


def conv(x, w, b):
    return F.conv2d(x, w, b, padding=_pad(w))


def conv_t(s, w):
    return F.conv_transpose2d(s, w, padding=_pad(w))


def route(a: torch.Tensor, kernel) -> torch.Tensor:
    """One-hot of each window's first maximum, the shape of ``a``."""
    kh, kw = kernel
    b, c, H, W = a.shape
    win = a.reshape(b, c, H // kh, kh, W // kw, kw).permute(0, 1, 2, 4, 3, 5).reshape(
        b, c, H // kh, W // kw, kh * kw)
    pos = torch.arange(kh * kw, device=a.device)
    first = torch.where(win == win.amax(-1, keepdim=True), pos, kh * kw).amin(-1)
    onehot = F.one_hot(first, kh * kw).to(a.dtype)
    return onehot.reshape(b, c, H // kh, W // kw, kh, kw).permute(0, 1, 2, 4, 3, 5).reshape(
        b, c, H, W)


def project(x, U, K):
    b, d, h, w = x.shape
    return (x.reshape(b, d, h * w).transpose(1, 2) @ U).reshape(b, h * w, K, d // K)


def project_t(s, U, hw):
    b, n = s.shape[:2]
    return (s.reshape(b, n, -1) @ U.T).transpose(1, 2).reshape(b, -1, *hw)


def forward_layer(ly, x, U, K, hw):
    k = ly["kind"]
    if k == "conv":
        return conv(x, ly["w"], ly["b"])
    if k == "linear":
        return x @ ly["w"].T + ly["b"]
    if k == "relu":
        return torch.clamp(x, min=0.0)
    if k == "maxpool":
        return F.max_pool2d(x, tuple(ly["kernel"]))
    if k == "flatten":
        return x.reshape(x.shape[0], -1)
    if k in ("dropout", "filter"):
        return x
    if k == "projection":
        return project(x, U, K)
    if k == "invprojection":
        return project_t(x, U, hw)
    raise ValueError(k)


def backward_layer(ly, x, R, rule, U, K, hw):
    """Relevance at the input of layer ``ly`` from the relevance ``R`` at its
    output; ``x`` is its input."""
    k = ly["kind"]
    if k == "relu":
        return R * torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))
    if k == "maxpool":
        kh, kw = ly["kernel"]
        return R.repeat_interleave(kh, dim=2).repeat_interleave(kw, dim=3) * route(x, (kh, kw))
    if k == "flatten":
        return R.reshape(x.shape)
    if k in ("dropout", "filter"):
        return R
    name, kw_ = rule
    if k == "linear":
        z = x @ ly["w"].T + ly["b"]
        return x * ((R / stab(z, kw_["epsilon"])) @ ly["w"])
    if k == "projection":
        return x * project_t(R / stab(project(x, U, K), kw_["epsilon"]), U, hw)
    if k == "invprojection":
        return x * project(R / stab(project_t(x, U, hw), kw_["epsilon"]), U, K)
    w, b = ly["w"], ly["b"]
    if name == "wsquare":
        z = conv(torch.ones_like(x), w * w, b * b)
        return conv_t(R / stab(z, kw_["stabilizer"]), w * w)
    if name == "gamma":
        g, eps = kw_["gamma"], kw_["stabilizer"]
        wp, wn = w + g * w.clamp(min=0), w + g * w.clamp(max=0)
        bp, bn = b + g * b.clamp(min=0), b + g * b.clamp(max=0)
        xp, xn = x.clamp(min=0), x.clamp(max=0)
        z = conv(x, w, b)
        s_pos = R * (z > 0).to(R.dtype) / stab(conv(xp, wp, bp) + conv(xn, wn, bn), eps)
        s_neg = R * (z < 0).to(R.dtype) / stab(conv(xp, wn, None) + conv(xn, wp, None), eps)
        return (xp * conv_t(s_pos, wp) + xn * conv_t(s_pos, wn)
                + xp * conv_t(s_neg, wn) + xn * conv_t(s_neg, wp))
    raise ValueError(f"no reference for rule {name} on {k}")


class Model:
    """The folded model with the projection spliced in, for one class's U."""

    def __init__(self, cfg: dict, params: dict):
        self.cfg = cfg
        self.layers = with_projection(fold(cfg, params), cfg)
        self.rules = {n: (r, kw) for n, r, kw in cfg["rules"]}
        self.rules["projection"] = self.rules["invprojection"] = (
            "epsilon", {"epsilon": cfg["projection_epsilon"]})
        self.K = cfg["num_concepts"]
        self.split = next(i for i, ly in enumerate(self.layers) if ly["kind"] == "filter")
        at = next(ly for ly in self.layers if ly["name"] == f"features.{cfg['drsa_layer']}")
        self.hw = tuple(at["hw"])

    def _forward(self, x, U):
        acts = []
        for ly in self.layers:
            acts.append(x)
            x = forward_layer(ly, x, U, self.K, self.hw)
        return x, acts

    def _backward(self, lo, hi, acts, R, U):
        for i in range(hi - 1, lo - 1, -1):
            ly = self.layers[i]
            R = backward_layer(ly, acts[i], R, self.rules.get(ly["name"]), U, self.K, self.hw)
        return R

    def explain(self, mels: torch.Tensor, U: torch.Tensor, class_idx: int):
        """mels [b, 1, n_mels, width] -> (heatmaps [b, K + 1, n_mels, width],
        index 0 the standard map, 1 .. K concept k's; logits [b, classes])."""
        K, s = self.K, self.split
        logits, acts = self._forward(mels, U)
        R = torch.zeros_like(logits)
        R[:, class_idx] = logits[:, class_idx]
        R_f = self._backward(s + 1, len(self.layers), acts, R, U)          # [b, n, K, d_k]
        masks = torch.cat([torch.ones(1, K, device=R_f.device),
                           torch.eye(K, device=R_f.device)])              # [K + 1, K]
        Rm = (R_f[None] * masks[:, None, None, :, None]).reshape(-1, *R_f.shape[1:])
        big = [a.repeat(K + 1, *([1] * (a.ndim - 1))) for a in acts[:s]]
        heat = self._backward(0, s, big, Rm, U)[:, 0]                     # [(K+1) b, H, W]
        b = mels.shape[0]
        return heat.reshape(K + 1, b, *heat.shape[1:]).transpose(0, 1), logits


def block_size(cfg: dict, budget_bytes: float = 6e9) -> int:
    """Clips a block, so that the lower pass's largest activations at K + 1
    copies, about twelve live at once, stay under ``budget_bytes``."""
    biggest = max(ly["hw"][0] * ly["hw"][1] * max(ly["in_ch"], ly["out_ch"])
                  for ly in layer_plan(cfg) if ly["kind"] == "conv")
    per_clip = 4.0 * biggest * (cfg["num_concepts"] + 1) * 12
    return max(1, int(budget_bytes // per_clip))
