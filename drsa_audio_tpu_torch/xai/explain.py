"""Standard + per-subspace heatmaps (the port of drsa_audio_tpu.xai.explain).

The fast path of the JAX package: the forward and ONE upper LRP backward run
on the unrepeated batch down to the subspace filter; the K concept maskings
of the filter relevance then go through the lower segment as K clones
(LRP backward is linear in R for fixed activations), and the standard
heatmap is their sum.

By default the conv section of the lower segment is recorded channels-last
(NHWC), the layout the chain kernels read, and the lower segment runs
through the chain (xai.lrp.chain: CUDA kernels on the GPU, their plain
versions on the CPU); ``fused=False`` takes the plain tiled rule walk, and
``clone_chunk`` runs that walk a few clones at a time. With
``shared_denominators=True`` the segment is recorded NCHW and walked once
with every rule's denominators computed at batch b for all K clones
(rules.SHARED_RULES; the gamma rule of a 3x3 conv as the CUDA kernel of
xai.lrp.fused_gamma on the GPU): about K times lighter on device memory
than the tiled walk, which tiles every activation K times.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from drsa_audio_tpu_torch.models.vgg import LayerSpec, apply_layer, apply_layer_nhwc
from drsa_audio_tpu_torch.xai.lrp import chain
from drsa_audio_tpu_torch.xai.lrp.engine import (
    _RULE_LAYERS, Composite, LayerOp, _specialize_rule, output_mask_all_classes,
    output_mask_class)
from drsa_audio_tpu_torch.xai.lrp.rules import (
    RULES, SHARED_RULES, _expand_batch, _mul_small)


def class_composite(name_map, num_concepts: int) -> Composite:
    """Epsilon on the virtual projection layers, the subspace mask on the
    filter (reference explainer.py:179-203)."""
    entries = list(name_map)
    entries.append(("features.invprojection", ("epsilon", {"epsilon": 1e-6})))
    entries.append(("features.subspacefilter",
                    ("subspace_mask", {"num_concepts": num_concepts})))
    entries.append(("features.projection", ("epsilon", {"epsilon": 1e-6})))
    return Composite.from_list(entries)


def _split_at_filter(specs: Sequence[LayerSpec]):
    idx = next(i for i, s in enumerate(specs) if s.kind == "subspacefilter")
    return list(specs[:idx]), list(specs[idx + 1:])


def _conv_section(lower):
    if lower[-1].kind != "projection":
        raise ValueError(f"lower segment must end at the projection, got {lower[-1].kind}")
    return lower[:-1], lower[-1]


def maxpool_route_mask(a: torch.Tensor, kernel: tuple) -> torch.Tensor:
    """First-argmax routing mask of a stride == kernel max-pool, NCHW."""
    return chain.route_mask(a, kernel, nhwc=False)


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


def _lrp_segment_backward(specs, params, acts, R, composite, nhwc: bool = False):
    """Backward over a recorded segment (acts[i] is the input of specs[i]).
    ``nhwc``: the conv section of the lower segment, channels-last."""
    for i in range(len(specs) - 1, -1, -1):
        spec = specs[i]
        rule = composite.rule_for(spec.name)
        if (rule is not None and spec.kind in _RULE_LAYERS
                and spec.kind != "subspacefilter"):
            rule_name, kwargs = rule
            R = RULES[_specialize_rule(rule_name, specs, i)](
                LayerOp(spec, params, nhwc), acts[i], R, **kwargs)
        else:
            R = _unmapped_backward(spec, params, acts[i], R, nhwc)
    return R


def explain_forward_upper(specs_proj: Sequence[LayerSpec], params: dict,
                          x: torch.Tensor, composite: Composite,
                          class_idx: int | None = None,
                          num_classes: int | None = None,
                          one_hot_encoded: bool = False, output_mask=None,
                          nhwc: bool = True):
    """Forward (recording the lower segment's activations) and ONE upper
    backward down to the subspace filter.

    With ``nhwc`` (the default here; the JAX package's default is False) the
    conv section is recorded NHWC and the projection input stays NCHW. A
    relu that feeds a pool is then recorded as its pre-activation, and the
    pool input as relu(pre); the model pools the pre-activation and relus
    the coarse result (max commutes with a monotone function). With
    ``nhwc=False`` every lower layer's input is recorded NCHW, layer by
    layer, as the shared-denominator walk reads them. Returns
    (R_filter [b, n, K, d_k], acts_lower, logits)."""
    lower, upper = _split_at_filter(specs_proj)
    acts_lower = []
    h = x
    if nhwc:
        conv_sec, proj_spec = _conv_section(lower)
        h = x.permute(0, 2, 3, 1).contiguous()
        i = 0
        while i < len(conv_sec):
            spec = conv_sec[i]
            nxt = conv_sec[i + 1] if i + 1 < len(conv_sec) else None
            if spec.kind == "relu" and nxt is not None and nxt.kind == "maxpool":
                acts_lower.append(h)
                acts_lower.append(torch.clamp(h, min=0.0))
                h = torch.clamp(apply_layer_nhwc(nxt, params, h), min=0.0).contiguous()
                i += 2
            else:
                acts_lower.append(h)
                h = apply_layer_nhwc(spec, params, h).contiguous()
                i += 1
        h = h.permute(0, 3, 1, 2)
        acts_lower.append(h)
        h = apply_layer(proj_spec, params, h)
    else:
        for spec in lower:
            acts_lower.append(h)
            h = apply_layer(spec, params, h)
    acts_upper = []
    for spec in upper:
        acts_upper.append(h)
        h = apply_layer(spec, params, h)
    logits = h
    if output_mask is not None:
        out_fn = output_mask
    elif class_idx is not None:
        out_fn = output_mask_class(class_idx, one_hot_encoded)
    else:
        out_fn = output_mask_all_classes(num_classes, one_hot_encoded)
    R_filter = _lrp_segment_backward(upper, params, acts_upper, out_fn(logits),
                                     composite)
    return R_filter, tuple(acts_lower), logits


def _lower_backward_tiled(lower, params, acts, R, composite, nhwc: bool):
    """One tiled backward over the lower segment, acts already tiled to R's
    batch. With ``nhwc`` the conv-section acts are NHWC and the projection
    rule runs NCHW first."""
    if not nhwc:
        return _lrp_segment_backward(lower, params, acts, R, composite)
    conv_sec, proj_spec = _conv_section(lower)
    R = _lrp_segment_backward([proj_spec], params, acts[-1:], R, composite)
    R = _lrp_segment_backward(conv_sec, params, acts[:-1], R.permute(0, 2, 3, 1),
                              composite, nhwc=True)
    return R.permute(0, 3, 1, 2)


def _lrp_segment_backward_shared(specs, params, acts, R, K: int, composite):
    """Backward over a recorded NCHW segment whose activations (batch b) are
    shared by K relevance clones folded clone-major into R [K*b, ...]: the
    rule denominators (rules.SHARED_RULES), the relu gate 1/0.5/0 and the
    first-argmax pool route are computed once at batch b and broadcast onto
    the clones."""
    for i in range(len(specs) - 1, -1, -1):
        spec = specs[i]
        a_in = acts[i]
        rule = composite.rule_for(spec.name)
        if (rule is not None and spec.kind in _RULE_LAYERS
                and spec.kind != "subspacefilter"):
            rule_name, kwargs = rule
            rule_name = _specialize_rule(rule_name, specs, i)
            layer = LayerOp(spec, params)
            if rule_name in SHARED_RULES:
                R = SHARED_RULES[rule_name](layer, a_in, R, K, **kwargs)
            else:
                R = RULES[rule_name](layer, _expand_batch(a_in, K), R, **kwargs)
        elif spec.kind == "relu":
            R = _mul_small(R, chain.relu_gate(a_in), K)
        elif spec.kind == "maxpool":
            kh, kw = spec.config["kernel"]
            R_up = R.repeat_interleave(kh, dim=-2).repeat_interleave(kw, dim=-1)
            R = _mul_small(R_up, maxpool_route_mask(a_in, (kh, kw)), K)
        elif spec.kind == "flatten":
            R = R.reshape(R.shape[0], *a_in.shape[1:])
        else:
            R = _unmapped_backward(spec, params, _expand_batch(a_in, K), R, False)
    return R


def explain_lower(specs_proj: Sequence[LayerSpec], params: dict, acts_lower,
                  R_filter: torch.Tensor, composite: Composite,
                  num_concepts: int, shared_denominators: bool = False,
                  clone_chunk: int | None = None, nhwc: bool = True,
                  fused: bool | None = None):
    """K concept maskings of the filter relevance through the lower segment;
    the standard heatmap is their sum. Returns heatmaps [b, K+1, h, w]
    (index 0 = standard).

    ``nhwc`` must match the explain_forward_upper call that recorded
    ``acts_lower``. The paths, in the JAX package's order of precedence:
    the chain (``fused``; default when ``nhwc`` and not shared and
    plan_chain accepts the conv section), then ``clone_chunk`` (the tiled
    walk over chunks of that many clones), then ``shared_denominators``
    (one walk at batch b for all clones; needs NCHW acts), then the plain
    tiled walk on the K-fold batch."""
    if nhwc and shared_denominators:
        raise ValueError("shared_denominators expects NCHW activations")
    if fused and not nhwc:
        raise ValueError("fused=True requires nhwc=True (activations must be "
                         "recorded NHWC by explain_forward_upper)")
    lower, _ = _split_at_filter(specs_proj)
    K = num_concepts
    b = R_filter.shape[0]
    eye = torch.eye(K, dtype=R_filter.dtype, device=R_filter.device)
    # clone k keeps concept k; clones fold clone-major into the batch [K*b]
    R_masked = (R_filter[None] * eye[:, None, None, :, None]).reshape(
        K * b, *R_filter.shape[1:])
    plan = None
    if fused or (fused is None and nhwc and not shared_denominators):
        conv_sec, proj_spec = _conv_section(lower)
        plan = chain.plan_chain(conv_sec, params, composite,
                                fine_hw=acts_lower[0].shape[1:3])
        if plan is None and fused:
            raise ValueError("fused=True requested but the conv section is "
                             "outside the chain's topology (see plan_chain)")
    if plan is not None:
        R = _lrp_segment_backward([proj_spec], params, [_expand_batch(acts_lower[-1], K)],
                                  R_masked, composite)
        R_nhwc = R.reshape(K, b, *R.shape[1:]).permute(1, 0, 3, 4, 2).contiguous()
        heat = chain.fused_lower_conv_backward(plan, params, list(acts_lower[:-1]),
                                               R_nhwc, K)            # [b, K, H, W]
        return torch.cat([heat.sum(dim=1, keepdim=True), heat], dim=1)
    if clone_chunk is not None and clone_chunk < K:
        R_m = R_masked.reshape(K, b, *R_filter.shape[1:])
        parts = []
        for k0 in range(0, K, clone_chunk):
            kc = min(clone_chunk, K - k0)
            parts.append(_lower_backward_tiled(
                lower, params, [_expand_batch(a, kc) for a in acts_lower],
                R_m[k0:k0 + kc].reshape(kc * b, *R_filter.shape[1:]), composite, nhwc))
        R_sub = torch.cat(parts)
    elif shared_denominators:
        R_sub = _lrp_segment_backward_shared(lower, params, acts_lower, R_masked, K,
                                             composite)
    else:
        R_sub = _lower_backward_tiled(lower, params,
                                      [_expand_batch(a, K) for a in acts_lower],
                                      R_masked, composite, nhwc)
    heat = R_sub[:, 0].reshape(K, b, *R_sub.shape[2:]).transpose(0, 1)
    return torch.cat([heat.sum(dim=1, keepdim=True), heat], dim=1)


def subspace_heatmaps(specs_proj: Sequence[LayerSpec], params: dict,
                      x: torch.Tensor, composite: Composite, num_concepts: int,
                      class_idx: int | None = None, num_classes: int | None = None,
                      one_hot_encoded: bool = False, output_mask=None,
                      shared_denominators: bool = False,
                      clone_chunk: int | None = None, nhwc: bool | None = None,
                      fused: bool | None = None):
    """Fast path: heatmaps [b, K+1, h, w] (index 0 = standard) and logits.
    ``specs_proj`` already holds the projection triple (insert_projection).
    ``nhwc`` defaults to ``not shared_denominators``; see explain_lower for
    the paths."""
    if nhwc is None:
        nhwc = not shared_denominators
    R_filter, acts_lower, logits = explain_forward_upper(
        specs_proj, params, x, composite, class_idx=class_idx,
        num_classes=num_classes, one_hot_encoded=one_hot_encoded,
        output_mask=output_mask, nhwc=nhwc)
    heat = explain_lower(specs_proj, params, acts_lower, R_filter, composite,
                         num_concepts, shared_denominators=shared_denominators,
                         clone_chunk=clone_chunk, nhwc=nhwc, fused=fused)
    return heat, logits


def sort_subspaces(subspace_heatmaps: np.ndarray):
    """Sort each instance's subspace heatmaps by descending total relevance
    (reference explainer.py:151-176). Returns (heatmaps, relevances, order)."""
    rel = subspace_heatmaps.sum(axis=(-2, -1))
    order = np.argsort(rel, axis=-1)[..., ::-1]
    b = subspace_heatmaps.shape[0]
    return (subspace_heatmaps[np.arange(b)[:, None], order],
            rel[np.arange(b)[:, None], order], order)
