"""LRP engine (the port of drsa_audio_tpu.xai.lrp.engine).

``lrp`` is the function interpreter: the forward records every layer's
input, the backward walks the layer list in reverse and applies each mapped
layer's rule; a layer without a rule takes the vjp of its forward at the
recorded input (``_unmapped_backward``). ``capture`` returns the (output
activation, output relevance) pair of named layers, the DRSA extraction's
hook.

``LayerOp`` is the port's apply factory: the forward of a linear layer with
its parameters transformed by ``w_mod``/``b_mod``, the transpose of its
bias-free part (what jax.vjp gives for a linear layer), and its bias term.
Rules in xai.lrp.rules are written against it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from drsa_audio_tpu_torch.models.projection import (
    apply_inv_projection, apply_projection, inv_projection_vjp, projection_vjp)
from drsa_audio_tpu_torch.models.vgg import (
    LayerSpec, apply_layer, apply_layer_nhwc, conv2d_same, conv2d_same_nhwc, linear_apply)
from drsa_audio_tpu_torch.xai.lrp import chain
from drsa_audio_tpu_torch.xai.lrp.rules import RULES


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


def layer_map_composite(specs: Sequence[LayerSpec], conv_rule, dense_rule,
                        first_layer_rule=None) -> Composite:
    """SpecialFirstLayerMapComposite equivalent (reference pf.py:230-238):
    ``conv_rule`` on every conv, ``dense_rule`` on every linear, and
    ``first_layer_rule``, if given, on the first conv."""
    name_map = []
    first_conv = True
    for spec in specs:
        if spec.kind == "conv":
            use_first = first_conv and first_layer_rule is not None
            name_map.append((spec.name, first_layer_rule if use_first else conv_rule))
            first_conv = False
        elif spec.kind == "linear":
            name_map.append((spec.name, dense_rule))
    return Composite.from_list(name_map)


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


def _vjp_of_forward(spec, params, a_in, R, nhwc: bool):
    """The vjp of the layer's forward (apply_layer, or apply_layer_nhwc on
    the NHWC walk) at a_in, applied to R, as the JAX package takes it for
    every layer without a rule. Autograd runs outside inference mode, on
    copies of the inputs, so that a caller in inference mode may call it."""
    apply = apply_layer_nhwc if nhwc else apply_layer
    with torch.inference_mode(False):
        _, vjp = torch.func.vjp(lambda t: apply(spec, params, t), a_in.clone())
        (out,) = vjp(R.clone())
    return out


def _unmapped_backward(spec, params, a_in, R, nhwc: bool):
    """Relevance through a layer without a rule: the vjp of its forward.
    relu and maxpool are written out, so that they keep JAX's tie semantics
    (gate 0.5 at 0, where torch's relu backward gives 0; the first argmax of
    a window); conv, linear, flatten and the identities are written out
    because they are exact and cheap. Every other kind (projection,
    invprojection, batchnorm, batchnorm1d) takes _vjp_of_forward."""
    if spec.kind in ("conv", "linear"):
        return LayerOp(spec, params, nhwc).vjp(R, a_in)
    if spec.kind == "relu":
        return R * chain.relu_gate(a_in)
    if spec.kind == "maxpool":
        k = spec.config["kernel"]
        return chain.pool_backward(R, chain.route_mask(a_in, k, nhwc), k, nhwc)
    if spec.kind == "flatten":
        return R.reshape(a_in.shape)
    if spec.kind in ("dropout", "subspacefilter"):
        return R
    return _vjp_of_forward(spec, params, a_in, R, nhwc)


def lrp(specs: Sequence[LayerSpec], params: dict, x: torch.Tensor,
        composite: Composite, output_relevance: Callable[[torch.Tensor], torch.Tensor],
        capture: Sequence[str] = (), stop_after_capture: bool = False):
    """LRP over the whole layer list, NCHW: a forward recording every
    layer's input, then the rule (or, unmapped, the vjp) of each layer in
    reverse. Runs on the device of ``x`` and ``params``.

    ``output_relevance`` maps the logits to the initial relevance.
    ``capture`` names layers whose (output activation, output relevance)
    are returned; with ``stop_after_capture`` the walk ends once every one
    of them is recorded, and the relevance returned is then the one at the
    lowest captured layer's output, not at the input.

    Returns (input relevance, logits, {name: (activation, relevance)})."""
    acts = []
    h = x
    for spec in specs:
        acts.append(h)
        h = apply_layer(spec, params, h)
    logits = h
    R = output_relevance(logits)
    captured: dict[str, tuple] = {}
    capture = set(capture)
    for i in range(len(specs) - 1, -1, -1):
        spec = specs[i]
        a_in = acts[i]
        if spec.name in capture:
            # the relevance at this layer's output is the R arriving now
            captured[spec.name] = (acts[i + 1] if i + 1 < len(acts) else logits, R)
            if stop_after_capture and len(captured) == len(capture):
                return R, logits, captured
        rule = composite.rule_for(spec.name)
        if rule is not None and spec.kind in _RULE_LAYERS:
            rule_name, kwargs = rule
            if spec.kind == "subspacefilter":
                R = RULES["subspace_mask"](None, a_in, R, **kwargs)
            else:
                R = RULES[_specialize_rule(rule_name, specs, i)](
                    LayerOp(spec, params), a_in, R, **kwargs)
        else:
            R = _unmapped_backward(spec, params, a_in, R, nhwc=False)
    return R, logits, captured


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


def compute_relevances(specs, params, x: torch.Tensor, composite: Composite,
                       class_idx: int | None = None, num_classes: int | None = None,
                       one_hot_encoded: bool = False) -> torch.Tensor:
    """Input relevance maps, the shape of ``x`` (reference
    attribute.compute_relevances, attribute.py:70-108): one class for the
    batch, or with ``num_classes`` a balanced consecutive-class batch."""
    if class_idx is not None:
        out_fn = output_mask_class(class_idx, one_hot_encoded)
    elif num_classes is not None:
        out_fn = output_mask_all_classes(num_classes, one_hot_encoded)
    else:
        raise ValueError("provide class_idx or num_classes")
    R, _, _ = lrp(specs, params, x, composite, out_fn)
    return R
