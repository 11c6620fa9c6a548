"""Layers without an LRP rule take the vjp of their forward, as in the JAX
package (drsa_audio_tpu/xai/explain.py _lrp_segment_backward and the
projection before its NHWC walk): the port's subspace_heatmaps against the
JAX package's where a composite leaves a virtual projection layer unmapped,
and on a toy model whose BatchNorm layers are not folded. The default
service composite maps every virtual layer and every caller folds
BatchNorm, so the default paths never reach the vjp fallback.

Tolerance for LRP outputs: rtol 1e-4, atol 1e-5 * max|ref|
(assert_close_lrp). U is a signed permutation (see test_torch_serving.py),
and each input holds no max-pool window within POOL_MARGIN of a tie in the
JAX forward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.xai import explain as jexp
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection as t_insert
from drsa_audio_tpu_torch.utils.convert import from_jax_params
from drsa_audio_tpu_torch.xai import explain as texp
from test_torch_util import (
    POOL_MARGIN, assert_close_lrp, both_models, random_bn, signed_permutation, t,
    tie_margins, to_np)

B, K, LAYER = 2, 4, 10
# the toy model with BatchNorm after every conv and linear layer but the
# last: conv n of the features sits at 4n, the classifier's linears at 0, 3, 6
BN_NAME_MAP = [("features.0", ("flat", {"stabilizer": 1e-7})),
               *((f"features.{4 * i}", ("gamma", {"gamma": 0.8, "stabilizer": 1e-7}))
                 for i in range(1, 5)),
               *((f"classifier.{i}", ("epsilon", {"epsilon": 1e-7})) for i in (0, 3, 6))]
# the walks of subspace_heatmaps: the default chain, and the three that
# record the lower segment NCHW or NHWC without the chain
WALKS = {"default": {}, "nchw": {"nhwc": False}, "nhwc": {"nhwc": True, "fused": False},
         "shared": {"shared_denominators": True}}


def _composites(name_map, drop=()):
    """class_composite of both packages, less the entries named in ``drop``."""
    out = []
    for mod in (jexp, texp):
        entries = [e for e in mod.class_composite(name_map, K).name_map if e[0] not in drop]
        out.append(type(mod.class_composite(name_map, K)).from_list(entries))
    return out


def _toy_case(bn: bool):
    """(JAX specs with the projection, JAX params, port specs, port params,
    name map, input) for the toy model, with unfolded BatchNorm if ``bn``."""
    if bn:
        cfg = dataclasses.replace(jvgg.toy_config(), conv_bn=True, dense_bn=True)
        jspecs = jvgg.build_layer_specs(cfg)
        jparams = random_bn(jvgg.init_params(jspecs, jax.random.PRNGKey(0)), 0)
        tspecs = tvgg.build_layer_specs(
            dataclasses.replace(tvgg.toy_config(), conv_bn=True, dense_bn=True))
        tparams = from_jax_params(to_np(jparams), device="cpu")
        nm, d, hw = BN_NAME_MAP, 16, (64, 64)
    else:
        jspecs, jparams, tspecs, tparams, nm, _, d, hw, _ = both_models("toy")
    U = signed_permutation(3, d)
    jsp = j_insert(jspecs, LAYER, jnp.asarray(U), K, input_size=hw)
    tsp = t_insert(tspecs, LAYER, t(U), K, input_size=hw)
    x = np.random.default_rng(1).standard_normal((B, 1) + hw).astype(np.float32)
    margins = tie_margins(jsp, jparams, x)
    assert margins[0] >= POOL_MARGIN["toy"], margins
    return jsp, jparams, tsp, tparams, nm, x


def _heatmaps(case, comps, walk):
    jsp, jparams, tsp, tparams, _, x = case
    jcomp, tcomp = comps
    want, want_logits = jexp.subspace_heatmaps(jsp, jparams, jnp.asarray(x), jcomp, K,
                                               class_idx=0, **WALKS[walk])
    got, logits = texp.subspace_heatmaps(tsp, tparams, t(x), tcomp, K, class_idx=0,
                                         **WALKS[walk])
    return (got.numpy(), logits.numpy()), (np.asarray(want), np.asarray(want_logits))


def _fallback_calls(monkeypatch):
    """Count the calls of the port's vjp fallback."""
    calls = []
    vjp = texp._vjp_of_forward

    def counted(spec, *args):
        calls.append(spec.kind)
        return vjp(spec, *args)
    monkeypatch.setattr(texp, "_vjp_of_forward", counted)
    return calls


@pytest.mark.parametrize("model,drop,walk,kinds", [
    # the composite without its features.invprojection entry: the upper
    # walk takes the vjp of the inverse projection
    ("toy", ("features.invprojection",), "nchw", {"invprojection"}),
    ("toy", ("features.invprojection",), "nhwc", {"invprojection"}),
    ("toy", ("features.invprojection",), "shared", {"invprojection"}),
    # without both projection entries: the lower walk takes the vjp of the
    # projection too, on the NCHW walk, before the NHWC walk, and at K*b on
    # the shared walk
    ("toy", ("features.invprojection", "features.projection"), "nchw",
     {"invprojection", "projection"}),
    ("toy", ("features.invprojection", "features.projection"), "nhwc",
     {"invprojection", "projection"}),
    ("toy", ("features.invprojection", "features.projection"), "shared",
     {"invprojection", "projection"}),
    # BatchNorm not folded: the vjp of every batchnorm and batchnorm1d layer
    ("toy_bn", (), "nchw", {"batchnorm", "batchnorm1d"}),
    ("toy_bn", (), "shared", {"batchnorm", "batchnorm1d"}),
])
def test_unmapped_layers_match_jax(monkeypatch, model, drop, walk, kinds):
    case = _toy_case(model == "toy_bn")
    calls = _fallback_calls(monkeypatch)
    (heat, logits), (want, want_logits) = _heatmaps(case, _composites(case[4], drop), walk)
    assert set(calls) == kinds
    assert heat.shape == want.shape == (B, K + 1, 64, 64)
    assert np.isfinite(heat).all() and np.abs(want).max() > 0
    assert_close_lrp(heat, want)
    assert_close_lrp(logits, want_logits)


def test_unfolded_batchnorm_on_nhwc_walk_raises_as_jax():
    """Neither package's NHWC recording applies a BatchNorm layer."""
    case = _toy_case(True)
    with pytest.raises(ValueError, match="apply_layer_nhwc: unsupported kind batchnorm"):
        _heatmaps(case, _composites(case[4]), "nhwc")


@pytest.mark.parametrize("walk", list(WALKS))
def test_default_composite_never_takes_the_vjp(monkeypatch, walk):
    """With the service's composite (every virtual layer mapped) and no
    BatchNorm, no walk reaches the vjp fallback, so no heatmap of the default
    paths moved; they still match the JAX package."""
    case = _toy_case(False)
    calls = _fallback_calls(monkeypatch)
    (heat, logits), (want, want_logits) = _heatmaps(case, _composites(case[4]), walk)
    assert calls == []
    assert_close_lrp(heat, want)
    assert_close_lrp(logits, want_logits)


def test_vjp_fallback_runs_in_inference_mode():
    """The service explains under torch.inference_mode: the fallback still
    takes the vjp there, and gives what it gives outside."""
    import torch
    _, _, tsp, tparams, _, _ = _toy_case(False)
    inv = next(s for s in tsp if s.kind == "invprojection")     # 16 channels at 8x8
    rng = np.random.default_rng(0)
    a = t(rng.standard_normal((B, 64, K, 4)))
    R = t(rng.standard_normal((B, 16, 8, 8)))
    want = texp._unmapped_backward(inv, tparams, a, R, False)
    with torch.inference_mode():
        got = texp._unmapped_backward(inv, tparams, a.clone(), R.clone(), False)
    assert torch.equal(got, want)
