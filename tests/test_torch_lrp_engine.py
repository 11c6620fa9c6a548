"""The port's LRP interpreter (drsa_audio_tpu_torch.xai.lrp.engine: lrp with
capture, compute_relevances, layer_map_composite) against the JAX package's,
mirroring tests/test_lrp_engine.py: the toy model, a narrow 3s model and the
6s structure with BatchNorm folded, weights bridged from the JAX ones.

Tolerance for LRP outputs: rtol 1e-4, atol 1e-5 * max|ref|
(assert_close_lrp). Each input holds no max-pool window within
POOL_MARGIN of a tie in the JAX forward (tie_margins)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.utils import constants as jconst
from drsa_audio_tpu.xai.lrp import engine as jeng
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.utils.convert import from_jax_params
from drsa_audio_tpu_torch.xai.lrp import engine as teng
from test_torch_util import (
    POOL_MARGIN, assert_close_lrp, both_models, random_bn, t, tie_margins, to_np)


def _narrow(name: str, **widths):
    """(JAX specs, JAX params, port specs, port params) of a model with the
    structure (layer names) of ``name``'s config at narrow widths; a model
    with BatchNorm gets random statistics and is folded in both packages."""
    cfg_fn = {"gtzan3s": "gtzan_3s_config", "gtzan6s": "gtzan_6s_config"}[name]
    jcfg = dataclasses.replace(getattr(jvgg, cfg_fn)(), **widths)
    jspecs = jvgg.build_layer_specs(jcfg)
    jparams = jvgg.init_params(jspecs, jax.random.PRNGKey(0))
    tspecs = tvgg.build_layer_specs(dataclasses.replace(getattr(tvgg, cfg_fn)(), **widths))
    if jcfg.conv_bn:
        jparams = random_bn(jparams, 0)
        tspecs, _ = tvgg.fold_batchnorm(tspecs, from_jax_params(to_np(jparams), device="cpu"))
        jspecs, jparams = jvgg.fold_batchnorm(jspecs, jparams)
    return jspecs, jparams, tspecs, from_jax_params(to_np(jparams), device="cpu")


NARROW_3S = {"n_filters": (4, 4, 8, 8, 16), "n_dense": 16}
NARROW_6S = {"n_filters": (4, 4, 6, 8, 8), "n_dense": 10, "input_size": (64, 128)}


def _model(name):
    """(JAX specs, JAX params, port specs, port params, name map, input hw,
    pool margin)."""
    if name == "toy":
        jspecs, jparams, tspecs, tparams, nm, _, _, hw, _ = both_models("toy")
        return jspecs, jparams, tspecs, tparams, nm, hw, POOL_MARGIN["toy"]
    if name == "gtzan3s":
        return (*_narrow("gtzan3s", **NARROW_3S), jconst.LRP_NAME_MAP_GTZAN, (128, 128),
                POOL_MARGIN["gtzan3s"])
    return (*_narrow("gtzan6s", **NARROW_6S), jconst.LRP_NAME_MAP_GTZAN_6S, (64, 128),
            POOL_MARGIN["gtzan6s"])


def _input(jspecs, jparams, hw, margin, b, seed):
    x = np.random.default_rng(seed).standard_normal((b, 1) + hw).astype(np.float32)
    margins = tie_margins(jspecs, jparams, x)
    assert margins[0] >= margin, margins
    return x


# (model, batch, input seed, class)
CASES = [("toy", 4, 0, 1), ("gtzan3s", 2, 0, 3)]


@pytest.mark.parametrize("name,b,seed,cls", CASES)
def test_lrp_input_relevance_matches_jax(name, b, seed, cls):
    jspecs, jparams, tspecs, tparams, nm, hw, margin = _model(name)
    x = _input(jspecs, jparams, hw, margin, b, seed)
    want, want_logits, _ = jeng.lrp(jspecs, jparams, jnp.asarray(x), jeng.Composite.from_list(nm),
                                    jeng.output_mask_class(cls))
    got, logits, captured = teng.lrp(tspecs, tparams, t(x), teng.Composite.from_list(nm),
                                     teng.output_mask_class(cls))
    assert captured == {}
    assert got.shape == x.shape and np.abs(np.asarray(want)).max() > 0
    assert_close_lrp(got, want)
    assert_close_lrp(logits, want_logits)


@pytest.mark.parametrize("name,b,seed,cls", CASES)
@pytest.mark.parametrize("stop", [False, True])
def test_capture_matches_jax(name, b, seed, cls, stop):
    """(activation, relevance) at the output of features.10 (a relu of block
    4), with and without the early return; with it, the relevance returned
    is the captured one."""
    jspecs, jparams, tspecs, tparams, nm, hw, margin = _model(name)
    x = _input(jspecs, jparams, hw, margin, b, seed)
    cap = ("features.10",)
    want_R, _, want = jeng.lrp(jspecs, jparams, jnp.asarray(x), jeng.Composite.from_list(nm),
                               jeng.output_mask_class(cls), capture=cap, stop_after_capture=stop)
    got_R, _, got = teng.lrp(tspecs, tparams, t(x), teng.Composite.from_list(nm),
                             teng.output_mask_class(cls), capture=cap, stop_after_capture=stop)
    act, rel = got["features.10"]
    assert act.shape == rel.shape and act.shape[1] == tspecs[9].config["out_ch"]
    assert (act >= 0).all()
    assert_close_lrp(act, want["features.10"][0])
    assert_close_lrp(rel, want["features.10"][1])
    assert_close_lrp(got_R, want_R)
    if stop:
        assert torch.equal(got_R, rel)
    else:
        assert got_R.shape == x.shape


def test_compute_relevances_balanced_batch():
    """A balanced consecutive-class batch attributes each clip's own class:
    against the JAX package, and against one class at a time."""
    jspecs, jparams, tspecs, tparams, nm, hw, margin = _model("toy")
    x = _input(jspecs, jparams, hw, margin, 4, 0)
    jcomp, tcomp = jeng.Composite.from_list(nm), teng.Composite.from_list(nm)
    got = teng.compute_relevances(tspecs, tparams, t(x), tcomp, num_classes=2)
    assert_close_lrp(got, jeng.compute_relevances(jspecs, jparams, jnp.asarray(x), jcomp,
                                                  num_classes=2))
    for cls, sl in ((0, slice(0, 2)), (1, slice(2, 4))):
        one = teng.compute_relevances(tspecs, tparams, t(x[sl]), tcomp, class_idx=cls)
        assert_close_lrp(got[sl], one)
    got1 = teng.compute_relevances(tspecs, tparams, t(x), tcomp, class_idx=1,
                                   one_hot_encoded=True)
    assert_close_lrp(got1, jeng.compute_relevances(jspecs, jparams, jnp.asarray(x), jcomp,
                                                   class_idx=1, one_hot_encoded=True))
    with pytest.raises(ValueError, match="class_idx or num_classes"):
        teng.compute_relevances(tspecs, tparams, t(x), tcomp)


@pytest.mark.parametrize("cfg", ["toy_config", "gtzan_3s_config", "gtzan_6s_config"])
@pytest.mark.parametrize("first", [True, False])
def test_layer_map_composite_names(cfg, first):
    rules = {"conv_rule": ("gamma", {"gamma": 0.4, "stabilizer": 1e-7}),
             "dense_rule": ("epsilon", {"epsilon": 1e-7}),
             "first_layer_rule": ("wsquare", {"stabilizer": 1e-7}) if first else None}
    want = jeng.layer_map_composite(jvgg.build_layer_specs(getattr(jvgg, cfg)()), **rules)
    got = teng.layer_map_composite(tvgg.build_layer_specs(getattr(tvgg, cfg)()), **rules)
    assert got.name_map == want.name_map
    assert got.rule_for("features.0")[0] == ("wsquare" if first else "gamma")
    assert got.rule_for("classifier.0")[0] == "epsilon"


def test_6s_structure_with_bn_folded_matches_jax():
    """The 6s layer list at narrow widths, BatchNorm folded with random
    statistics: the input relevance and the captures at the DRSA layers
    19, 26 and 33 (relu outputs)."""
    jspecs, jparams, tspecs, tparams, nm, hw, margin = _model("gtzan6s")
    assert not any(s.kind.startswith("batchnorm") for s in tspecs)
    x = _input(jspecs, jparams, hw, margin, 2, 0)
    cap = tuple(f"features.{i}" for i in jconst.DRSA_LAYERS_GTZAN_6S)
    want_R, want_logits, want = jeng.lrp(jspecs, jparams, jnp.asarray(x),
                                         jeng.Composite.from_list(nm),
                                         jeng.output_mask_class(3), capture=cap)
    got_R, logits, got = teng.lrp(tspecs, tparams, t(x), teng.Composite.from_list(nm),
                                  teng.output_mask_class(3), capture=cap)
    assert got_R.shape == x.shape and torch.isfinite(got_R).all()
    assert_close_lrp(got_R, want_R)
    assert_close_lrp(logits, want_logits)
    for name in cap:
        assert (got[name][0] >= 0).all()
        assert_close_lrp(got[name][0], want[name][0])
        assert_close_lrp(got[name][1], want[name][1])


def test_unmapped_relu_gate_is_half_at_zero():
    """A relu without a rule passes half the relevance at an exact zero, as
    the vjp of jnp.maximum(x, 0) does (torch.relu's backward would pass
    none)."""
    specs = [tvgg.LayerSpec("relu", "r")]
    x = torch.tensor([[-1.0, 0.0, 2.0]])
    R, _, _ = teng.lrp(specs, {}, x, teng.Composite.from_list([]), lambda lg: torch.ones_like(lg))
    assert R.tolist() == [[0.0, 0.5, 1.0]]
