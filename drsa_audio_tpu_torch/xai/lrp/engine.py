"""LRP engine pieces (the port of drsa_audio_tpu.xai.lrp.engine).

``LayerOp`` is the port's apply factory: the forward of a linear layer with
its parameters transformed by ``w_mod``/``b_mod``, the transpose of its
bias-free part (what jax.vjp gives for a linear layer), and its bias term.
Rules in xai.lrp.rules are written against it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from drsa_audio_tpu_torch.models.projection import (
    apply_inv_projection, apply_projection, inv_projection_vjp, projection_vjp)
from drsa_audio_tpu_torch.models.vgg import (
    LayerSpec, conv2d_same, conv2d_same_nhwc, linear_apply)


@dataclasses.dataclass(frozen=True)
class Composite:
    """Layer name -> (rule name, kwargs); a zennit NameMapComposite."""
    name_map: tuple

    def rule_for(self, name: str):
        for pattern, rule in self.name_map:
            if pattern == name:
                return rule
        return None

    @classmethod
    def from_list(cls, name_map) -> "Composite":
        return cls(tuple((n, (r, dict(kw))) for n, (r, kw) in name_map))


def _identity(p):
    return p


class LayerOp:
    """Apply factory of one linear layer (conv, linear, projection,
    invprojection). ``nhwc`` selects channels-last convs (the conv section
    of the lower segment)."""

    def __init__(self, spec: LayerSpec, params: dict, nhwc: bool = False):
        self.kind = spec.kind
        self.nhwc = nhwc
        if spec.kind in ("conv", "linear"):
            p = params[spec.name]
            self.w, self.b = p["weight"], p.get("bias")
        elif spec.kind in ("projection", "invprojection"):
            self.w, self.b = spec.config["U"], None
            self.k = spec.config["num_concepts"]
            self.map_hw = spec.config.get("map_hw")
        else:
            raise ValueError(f"no apply factory for layer kind {spec.kind}")

    def forward(self, x, w_mod=_identity, b_mod=_identity):
        w = w_mod(self.w)
        b = b_mod(self.b) if (b_mod is not None and self.b is not None) else None
        return self._apply(x, w, b)

    def _apply(self, x, w, b):
        if self.kind == "conv":
            return (conv2d_same_nhwc if self.nhwc else conv2d_same)(x, w, b)
        if self.kind == "linear":
            return linear_apply(x, w, b)
        if self.kind == "projection":
            return apply_projection(x, w, self.k)
        return apply_inv_projection(x, w, self.k, self.map_hw)

    def vjp(self, g, x, w_mod=_identity):
        """Transpose of x -> forward(x, w_mod, no bias), applied to g; ``x``
        gives the input's shape past the batch axis (g sets the batch)."""
        return self._transpose(g, x, w_mod(self.w))

    def _transpose(self, g, x, w):
        if self.kind == "conv":
            if self.nhwc:
                g = g.permute(0, 3, 1, 2)
            pad = (w.shape[2] // 2, w.shape[3] // 2)
            c = F.conv_transpose2d(g, w, padding=pad)
            return c.permute(0, 2, 3, 1) if self.nhwc else c
        if self.kind == "linear":
            return g @ w
        if self.kind == "projection":
            return projection_vjp(g, w, tuple(x.shape[2:]))
        return inv_projection_vjp(g, w, self.k)

    def _out_axis(self) -> int:
        return 1 if (self.kind == "conv" and not self.nhwc) else -1

    def forward_stacked(self, x, w_mods, b_mods):
        """forward(x, w_mods[i], b_mods[i]) for every i (b_mods[i] None: no
        bias). A conv or linear layer runs them as ONE conv or matmul with
        the weight variants stacked on the output axis, as the JAX
        package's ``grouped``."""
        if self.kind not in ("conv", "linear"):
            return tuple(self.forward(x, wm, bm) for wm, bm in zip(w_mods, b_mods))
        w = torch.cat([m(self.w) for m in w_mods])
        b = torch.cat([m(self.b) if m is not None else torch.zeros_like(self.b)
                       for m in b_mods])
        return self._apply(x, w, b).chunk(len(w_mods), dim=self._out_axis())

    def vjp_stacked(self, gs, x, w_mods):
        """sum_i vjp(gs[i], x, w_mods[i]); for a conv or linear layer ONE
        transpose over the cotangents stacked on the output axis."""
        if self.kind not in ("conv", "linear"):
            return sum(self.vjp(g, x, m) for g, m in zip(gs, w_mods))
        return self._transpose(torch.cat(gs, dim=self._out_axis()), x,
                               torch.cat([m(self.w) for m in w_mods]))

    def bias_of(self, b_mod):
        """f(0) of the modified layer, broadcastable against its output."""
        b = b_mod(self.b)
        if self.kind == "conv" and not self.nhwc:
            return b[None, :, None, None]
        return b


_RULE_LAYERS = ("conv", "linear", "projection", "invprojection", "subspacefilter")


def _specialize_rule(rule_name: str, specs, i: int) -> str:
    """The cheaper non-negative-input gamma where the layer input is
    provably >= 0: preceded by a ReLU, possibly through MaxPools."""
    if rule_name != "gamma":
        return rule_name
    j = i - 1
    while j >= 0 and specs[j].kind == "maxpool":
        j -= 1
    if j >= 0 and specs[j].kind == "relu":
        return "gamma_nonneg"
    return rule_name


def output_mask_class(class_idx: int, one_hot: bool = False):
    """Attribute one class: R_out = logit (or 1.0 if one_hot) at class_idx."""
    def fn(logits):
        mask = torch.zeros_like(logits)
        mask[..., class_idx] = 1.0
        return mask if one_hot else logits * mask
    return fn


def output_mask_all_classes(num_classes: int, one_hot: bool = False):
    """Balanced consecutive-class batch: sample i attributes class
    i // (batch / num_classes)."""
    def fn(logits):
        per = logits.shape[0] // num_classes
        eye = torch.eye(num_classes, dtype=logits.dtype, device=logits.device)
        mask = eye.repeat_interleave(per, dim=0)
        return mask if one_hot else logits * mask
    return fn
