"""Standard + per-subspace heatmaps (the port of drsa_audio_tpu.xai.explain).

The fast path of the JAX package: the forward and ONE upper LRP backward run
on the unrepeated batch down to the subspace filter; the K concept maskings
of the filter relevance then go through the lower segment as K clones
(LRP backward is linear in R for fixed activations), and the standard
heatmap is their sum. ``subspace_heatmaps_repeated`` is the reference's
scheme (each clip repeated K+1 times, one whole LRP pass), kept to check the
fast path. ``HeatmapGenerator`` is the reference-facing class around the
fast path.

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

import dataclasses
from typing import Sequence

import numpy as np
import torch

from drsa_audio_tpu_torch.models.projection import insert_projection
from drsa_audio_tpu_torch.models.vgg import LayerSpec, apply_layer, apply_layer_nhwc
from drsa_audio_tpu_torch.utils.constants import (
    AUDIO_PARAMS, CLASS_IDX_MAPPER, CLASS_IDX_MAPPER_TOY)
from drsa_audio_tpu_torch.utils import profiling
from drsa_audio_tpu_torch.utils.device import params_on, resolve_device
from drsa_audio_tpu_torch.xai.lrp import chain
from drsa_audio_tpu_torch.xai.lrp.engine import (
    _RULE_LAYERS, Composite, LayerOp, _specialize_rule, _unmapped_backward, lrp,
    output_mask_all_classes, output_mask_class)
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
    with profiling.span("forward_upper", device=True):
        R_filter, acts_lower, logits = explain_forward_upper(
            specs_proj, params, x, composite, class_idx=class_idx,
            num_classes=num_classes, one_hot_encoded=one_hot_encoded,
            output_mask=output_mask, nhwc=nhwc)
    with profiling.span("lower", device=True):
        heat = explain_lower(specs_proj, params, acts_lower, R_filter, composite,
                             num_concepts, shared_denominators=shared_denominators,
                             clone_chunk=clone_chunk, nhwc=nhwc, fused=fused)
    return heat, logits


def subspace_heatmaps_repeated(specs_proj: Sequence[LayerSpec], params: dict,
                               x: torch.Tensor, composite: Composite, num_concepts: int,
                               class_idx: int | None = None,
                               num_classes: int | None = None,
                               one_hot_encoded: bool = False):
    """The reference's scheme: each clip repeated K+1 times, one LRP pass
    with the subspace mask at the filter (clone 0 keeps everything, clone k
    concept k). Returns heatmaps [b, K+1, h, w] and the logits of the
    repeated batch."""
    k1 = num_concepts + 1
    if class_idx is not None:
        out_fn = output_mask_class(class_idx, one_hot_encoded)
    else:
        out_fn = output_mask_all_classes(num_classes, one_hot_encoded)
    R, logits, _ = lrp(specs_proj, params, x.repeat_interleave(k1, dim=0), composite,
                       out_fn)
    return R.reshape(-1, k1, *x.shape[1:])[:, :, 0], logits


def _front_index(order: torch.Tensor) -> torch.Tensor:
    """Slots [b, K+1] of the maps: the standard map, then ``order``."""
    return torch.cat([torch.zeros_like(order[:, :1]), order + 1], dim=1)


def sort_concepts(heat: torch.Tensor):
    """Sort each instance's concept maps by descending total relevance
    (reference explainer.py:151-176) where the maps live, with no host
    sync: ``heat`` [b, K+1, h, w] is the standard map, then the K concept
    maps. Returns the maps in one new tensor, the standard map still first
    and the concepts by descending relevance, their float32 relevances
    [b, K+1], and the int64 ``order`` [b, K] of the concepts: the
    reference's ``np.argsort(rel)[..., ::-1]`` wherever the relevances
    differ, with exact ties larger index first (a stable ascending sort,
    flipped)."""
    rel = heat.sum(dim=(-2, -1))
    order = torch.sort(rel[:, 1:], dim=-1, stable=True).indices.flip(-1)
    idx = _front_index(order)
    return torch.take_along_dim(heat, idx[:, :, None, None], dim=1), rel.gather(1, idx), order


def unsort_concepts(heat: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``sort_concepts`` undone: the maps [b, K+1, h, w] with the concepts
    back in their own order."""
    idx = _front_index(order)
    return heat.clone().scatter_(1, idx[:, :, None, None].expand_as(heat), heat)


@dataclasses.dataclass
class HeatmapGenerator:
    """The reference HeatmapGenerator (explainer.py:15-176) on the fast
    path. After ``generate_subspace_heatmaps`` the ``info`` dict holds input,
    standard_heatmaps, standard_relevance, subspace_heatmaps,
    subspace_relevances and mask, as numpy arrays.

    ``case`` defaults from the class name (a name ending in 1 or 2 is the
    toy's); it sets the class mapper and the mel size the inverse
    projection restores. ``device`` defaults to CUDA and raises where there
    is none; the parameters and U are moved there once."""
    specs: Sequence[LayerSpec]
    params: dict
    U: object
    name_map: list
    sample_class: str
    num_concepts: int = 4
    layer_idx: int = 10
    case: str | None = None
    device: object = None

    def __post_init__(self):
        case = self.case
        if case is None:
            case = "toy" if self.sample_class.endswith(("1", "2")) else "gtzan"
        mapper = CLASS_IDX_MAPPER_TOY if case == "toy" else CLASS_IDX_MAPPER
        self.class_idx = mapper[self.sample_class]
        self.num_classes = len(mapper)
        self.device = resolve_device(self.device, "HeatmapGenerator")
        self.params = params_on(self.params, self.device)
        ap = AUDIO_PARAMS[case]
        self._input_size = (ap["n_mels"], ap["mel_width"])
        U = torch.as_tensor(self.U, dtype=torch.float32, device=self.device)
        self.specs_proj = insert_projection(self.specs, self.layer_idx, U,
                                            self.num_concepts, input_size=self._input_size)
        self.composite = class_composite(self.name_map, self.num_concepts)
        self.info: dict = {}

    def _heatmaps(self, x: torch.Tensor, one_hot_encoded, flip_all_classes,
                  shared_denominators, clone_chunk, sort) -> tuple:
        """The maps [b, K+1, h, w] of one attribution chunk, read back as
        numpy; with ``sort``, sorted on the device first (sort_concepts),
        with their relevances and the concepts' order."""
        with torch.inference_mode():
            if flip_all_classes:
                kw = {"num_classes": self.num_classes, "one_hot_encoded": one_hot_encoded}
            else:
                onehot = torch.zeros(self.num_classes, device=self.device)
                onehot[self.class_idx] = 1.0
                kw = {"output_mask": (lambda lg: onehot.expand_as(lg)) if one_hot_encoded
                      else (lambda lg: lg * onehot)}
            heat, _ = subspace_heatmaps(self.specs_proj, self.params, x, self.composite,
                                        self.num_concepts, shared_denominators=shared_denominators,
                                        clone_chunk=clone_chunk, **kw)
            out = sort_concepts(heat) if sort else (heat,)
            return tuple(t.cpu().numpy() for t in out)

    def generate_subspace_heatmaps(self, input_batch, one_hot_encoded: bool = False,
                                   concept_flipping: bool = False,
                                   flip_all_classes: bool = False,
                                   attr_batch_size: int | None = None,
                                   shared_denominators: bool = False,
                                   clone_chunk: int | None = None):
        """Sorted subspace heatmaps [b, K, h, w]; with ``concept_flipping``
        the raw (unsorted) ones, and ``info`` is left as it was.
        ``flip_all_classes`` attributes a balanced consecutive-class batch.
        ``attr_batch_size`` runs the attribution that many clips at a time
        (bounds device memory); it cannot be combined with
        ``flip_all_classes``, whose output mask depends on a clip's position
        in the whole batch."""
        x = torch.as_tensor(input_batch, dtype=torch.float32, device=self.device)
        self.info["input"] = x.cpu().numpy()
        args = (one_hot_encoded, flip_all_classes, shared_denominators, clone_chunk,
                not concept_flipping)
        if attr_batch_size and x.shape[0] > attr_batch_size:
            if flip_all_classes:
                raise ValueError("attr_batch_size cannot be combined with "
                                 "flip_all_classes (batch-position-dependent mask)")
            chunks = [self._heatmaps(x[i:i + attr_batch_size], *args)
                      for i in range(0, x.shape[0], attr_batch_size)]
            out = [np.concatenate(parts) for parts in zip(*chunks)]
        else:
            out = self._heatmaps(x, *args)
        if concept_flipping:
            return out[0][:, 1:]
        heat, rel, order = out                           # [b, K+1, h, w], [b, K+1], [b, K]
        self.info["standard_heatmaps"] = heat[:, 0:1]
        self.info["standard_relevance"] = rel[:, 0]
        self.info["subspace_heatmaps"] = heat[:, 1:]
        self.info["subspace_relevances"] = rel[:, 1:]
        self.info["mask"] = order
        return heat[:, 1:]


def compute_subspace_relevances(act_vecs, ctx_vecs, U, n_concepts: int = 4,
                                device=None) -> torch.Tensor:
    """Per-concept relevance sum((aU) * (cU)) over positions and each
    concept's block, without heatmaps (reference explainer.py:206-242).
    act_vecs, ctx_vecs: [batch, N, d] (or [N, d]). Returns [batch, K] on
    ``device``, which defaults to CUDA and raises where there is none."""
    device = resolve_device(device, "compute_subspace_relevances")
    a, c, U = (torch.as_tensor(v, dtype=torch.float32, device=device)
               for v in (act_vecs, ctx_vecs, U))
    if a.ndim == 2:
        a = a[None]
    if c.ndim == 2:
        c = c[None]
    x = (a @ U) * (c @ U)
    return x.reshape(*x.shape[:2], n_concepts, -1).sum(dim=(-1, 1))
