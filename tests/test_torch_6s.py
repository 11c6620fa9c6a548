"""The GTZAN-6s path of the port against the JAX package: BatchNorm apply and
fold, the 6s forward, the deep first block (plain version of
first_block_deep, as the CPU runs it) against the JAX rule walk, the whole
chain against the JAX fused Pallas chain (interpret mode), and the explain
service. Tolerance for LRP outputs: rtol 1e-4, atol 1e-5 * max|ref|
(assert_close_lrp); U is a signed permutation (see test_torch_serving.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.models.vgg import LayerSpec as JSpec
from drsa_audio_tpu.serving import ExplainerService as JService
from drsa_audio_tpu.utils import constants as jconst
from drsa_audio_tpu.xai import explain as jexp
from drsa_audio_tpu.xai.lrp.engine import Composite as JComposite
from drsa_audio_tpu.xai.lrp.pallas_chain import fused_lower_conv_backward as j_fused
from drsa_audio_tpu.xai.lrp.pallas_chain import plan_chain as j_plan
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection as t_insert
from drsa_audio_tpu_torch.serving import ExplainerService
from drsa_audio_tpu_torch.utils import constants as tconst
from drsa_audio_tpu_torch.utils.convert import from_jax_params, to_state_dict
from drsa_audio_tpu_torch.xai import explain as texp
from drsa_audio_tpu_torch.xai.lrp import chain as tchain
from drsa_audio_tpu_torch.xai.lrp import taps
from test_torch_util import (
    POOL_MARGIN, assert_close_lrp, both_models, random_bn, service_margins,
    signed_permutation, t, to_np)

K = 3
HW6 = (128, 256)


def _unfolded_6s(seed=0):
    """6s JAX specs and params with random BN statistics, and the port's
    unfolded specs with the params bridged."""
    jspecs = jvgg.build_layer_specs(jvgg.gtzan_6s_config())
    jparams = random_bn(jvgg.init_params(jspecs, jax.random.PRNGKey(seed)), seed)
    tspecs = tvgg.build_layer_specs(tvgg.gtzan_6s_config())
    return jspecs, jparams, tspecs, from_jax_params(to_np(jparams), device="cpu")


# ------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("kind,shape", [("batchnorm", (2, 6, 4, 5)), ("batchnorm1d", (3, 6))])
def test_batchnorm_apply_matches_jax(kind, shape, rng):
    p = {"scale": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(0, 0.1, 6),
         "mean": rng.normal(0, 0.1, 6), "var": rng.uniform(0.5, 2.0, 6)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jvgg.apply_layer(JSpec(kind, "bn", {"ch": 6}),
                                       {"bn": {k: jnp.asarray(v) for k, v in p.items()}},
                                       jnp.asarray(x)))
    got = tvgg.apply_layer(tvgg.LayerSpec(kind, "bn", {"ch": 6}),
                           from_jax_params({"bn": p}, device="cpu"), t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_fold_batchnorm_matches_jax():
    """Parameter for parameter on the 6s model with random BN statistics;
    the same layer list (BN layers dropped, names kept)."""
    jspecs, jparams, tspecs, tparams = _unfolded_6s()
    jspecs_f, jparams_f = jvgg.fold_batchnorm(jspecs, jparams)
    tspecs_f, tparams_f = tvgg.fold_batchnorm(tspecs, tparams)
    assert [(s.kind, s.name) for s in tspecs_f] == [(s.kind, s.name) for s in jspecs_f]
    assert set(tparams_f) == set(jparams_f)
    for name, p in jparams_f.items():
        for jk, tk in (("w", "weight"), ("b", "bias")):
            np.testing.assert_allclose(tparams_f[name][tk].numpy(), np.asarray(p[jk]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("folded", [False, True])
def test_6s_logits_match_jax(folded, rng):
    jspecs, jparams, tspecs, tparams = _unfolded_6s()
    if folded:
        jspecs, jparams = jvgg.fold_batchnorm(jspecs, jparams)
        tspecs, tparams = tvgg.fold_batchnorm(tspecs, tparams)
    x = rng.standard_normal((1, 1) + HW6).astype(np.float32)
    want = np.asarray(jvgg.forward(jspecs, jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = tvgg.forward(tspecs, tparams, t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_6s_bridge_loads_into_module(rng):
    """BN scale/bias/mean/var reach nn.BatchNorm's weight/bias/running_*
    keys; the module's logits match the JAX forward."""
    jspecs, jparams, _, tparams = _unfolded_6s()
    model = tvgg.VGG(tvgg.gtzan_6s_config())
    sd = to_state_dict(tparams)
    model.load_state_dict(sd)
    assert set(model.state_dict()) == set(sd)
    assert "features.1.running_var" in sd and "classifier.1.running_mean" in sd
    x = rng.standard_normal((1, 1) + HW6).astype(np.float32)
    want = np.asarray(jvgg.forward(jspecs, jparams, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(t(x)).numpy(), want, rtol=1e-4, atol=1e-5)


def test_rescale_gamma_matches_jax():
    assert (tconst.rescale_gamma(tconst.LRP_NAME_MAP_GTZAN_6S, 0.4)
            == jconst.rescale_gamma(jconst.LRP_NAME_MAP_GTZAN_6S, 0.4))


# -------------------------------------------------------- deep first block

def _conv_nhwc(x, w, b):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + b


@pytest.mark.parametrize("rule", ["wsquare", "flat"])
def test_first_block_deep_plain_matches_jax_rule_walk(rule, rng):
    """first_block_deep (CPU: its plain version) against the JAX NHWC rule
    walk over [conv0 relu conv3 relu pool(2,4)] with K clones, at 12
    channels (not a multiple of 8). a1 holds exact zeros (relu ties) and
    one channel of conv 3 is negative everywhere, so every one of its pool
    windows is all-tied at zero after the relu."""
    H, W, C = 8, 16, 12
    w0 = (rng.standard_normal((C, 1, 3, 3)) * 0.5).astype(np.float32)
    b0 = (rng.standard_normal(C) * 0.1).astype(np.float32)
    w3 = (rng.standard_normal((C, C, 3, 3)) * np.sqrt(2.0 / (9 * C))).astype(np.float32)
    b3 = (rng.standard_normal(C) * 0.05).astype(np.float32)
    b3[0] = -50.0
    mel = rng.standard_normal((2, H, W, 1)).astype(np.float32)
    a1 = _conv_nhwc(mel, w0, b0)
    a1[0, 0, :3, :] = 0.0
    apre = _conv_nhwc(np.maximum(a1, 0.0), w3, b3)
    specs = [JSpec("conv", "c0", {}), JSpec("relu", "r0", {}), JSpec("conv", "c3", {}),
             JSpec("relu", "r3", {}), JSpec("maxpool", "p", {"kernel": (2, 4)})]
    acts = [mel, a1, np.maximum(a1, 0.0), apre, np.maximum(apre, 0.0)]
    g_rule = {"gamma": 0.3, "stabilizer": 1e-7}
    comp = JComposite.from_list([("c0", (rule, {"stabilizer": 1e-7})), ("c3", ("gamma", g_rule))])
    R = rng.standard_normal((2, K, H // 2, W // 4, C)).astype(np.float32)
    acts_k = [np.tile(a[None], (K,) + (1,) * a.ndim).reshape((K * 2,) + a.shape[1:])
              for a in acts]
    params_j = {"c0": {"w": jnp.asarray(w0), "b": jnp.asarray(b0)},
                "c3": {"w": jnp.asarray(w3), "b": jnp.asarray(b3)}}
    want = jexp._lrp_segment_backward_nhwc(
        specs, params_j, [jnp.asarray(a) for a in acts_k],
        jnp.asarray(R.transpose(1, 0, 2, 3, 4).reshape((K * 2, H // 2, W // 4, C))), comp)
    want = np.asarray(want)[..., 0].reshape(K, 2, H, W).transpose(1, 0, 2, 3)

    params_t = from_jax_params(to_np(params_j), device="cpu")
    gconv = tchain.prep_inner_weights(params_t, tvgg.LayerSpec("conv", "c3", {}), g_rule)
    fl = taps.prep_first_weights(params_t, tvgg.LayerSpec("conv", "c0", {}),
                                 (rule, {"stabilizer": 1e-7}), (H, W))
    got = tchain.first_block_deep(t(R), t(a1), t(apre), gconv, fl, (2, 4))
    assert_close_lrp(got.numpy(), want)


def _small_deep(seed=0):
    """A small model with the 6s topology: block depth 2, a (2,4) pool
    above block 0, 64 then 16 channels, 16x32 input; DRSA layer 8. Block 0
    has 64 channels because the JAX plan takes a (2,4) pool only at a lane
    packing of 2 (pallas_chain.py plan_chain)."""
    kw = dict(n_filters=(64, 16), n_dense=8, pool_kernels=((2, 4), (2, 2)), dropout=0.0,
              input_size=(16, 32), n_classes=2, conv_bn=False, dense_bn=False, block_depth=2)
    jspecs = jvgg.build_layer_specs(jvgg.VGGConfig(**kw))
    jparams = jvgg.init_params(jspecs, jax.random.PRNGKey(seed))
    tspecs = tvgg.build_layer_specs(tvgg.VGGConfig(**kw))
    nm = [("features.0", ("wsquare", {"stabilizer": 1e-7})),
          ("features.2", ("gamma", {"gamma": 0.3, "stabilizer": 1e-7})),
          ("features.5", ("gamma", {"gamma": 0.3, "stabilizer": 1e-7})),
          ("features.7", ("gamma", {"gamma": 0.3, "stabilizer": 1e-7}))]
    return (jspecs, jparams, tspecs, from_jax_params(to_np(jparams), device="cpu"),
            nm, 8, 16, (16, 32))


@pytest.mark.parametrize("name,layer,d,b", [("small", 8, 16, 2), ("gtzan6s", 33, 128, 1),
                                            ("gtzan6s", 19, 100, 1)])
def test_deep_chain_matches_jax_fused(name, layer, d, b, rng):
    """The port's whole chain (the deep first block included) against JAX
    fused_lower_conv_backward (Pallas in interpret mode) on the same
    recorded activations and relevance. Layer 33 starts the chain at the
    8x8 block (4 chain_block calls), layer 19 at the 32x32 C=100 block."""
    if name == "small":
        jspecs, jparams, tspecs, tparams, nm, _, _, hw = _small_deep()
    else:
        jspecs, jparams, tspecs, tparams, nm, _, _, hw, _ = both_models(name)
    U = signed_permutation(3, d)
    x = rng.standard_normal((b, 1) + hw).astype(np.float32)
    jsp = j_insert(jspecs, layer, jnp.asarray(U), 4, input_size=hw)
    comp_j = jexp.class_composite(nm, 4)
    _, acts, _ = jexp.explain_forward_upper(jsp, jparams, jnp.asarray(x), comp_j,
                                            class_idx=0, nhwc=True)
    conv_sec, _ = jexp._conv_section(jexp._split_at_filter(jsp)[0])
    plan_j = j_plan(conv_sec, jparams, comp_j, fine_hw=hw)
    assert plan_j is not None and len(plan_j["blocks"][0]["convs"]) == 2
    R = rng.standard_normal((b, 4) + tuple(acts[-2].shape[1:3]) + (d,)).astype(np.float32)
    want = np.asarray(j_fused(plan_j, jparams, list(acts[:-1]), jnp.asarray(R), 4))

    tsp = t_insert(tspecs, layer, t(U), 4, input_size=hw)
    t_conv_sec, _ = texp._conv_section(texp._split_at_filter(tsp)[0])
    plan_t = tchain.plan_chain(t_conv_sec, tparams, texp.class_composite(nm, 4), fine_hw=hw)
    assert len(plan_t["blocks"]) == len(plan_j["blocks"])
    got = tchain.fused_lower_conv_backward(plan_t, tparams, [t(a) for a in acts[:-1]], t(R), 4)
    assert got.shape == (b, 4) + hw
    assert_close_lrp(got.numpy(), want)


# ------------------------------------------------------ upper path, service

@pytest.mark.parametrize("layer,d", [(19, 100), (26, 128)])
def test_6s_forward_upper_matches_jax(layer, d):
    """Logits, the recorded activations and the filter relevance at the
    layers whose upper segment holds gamma convs (full four-term rule) and
    the folded classifier 0/4/8. The input is drawn from seed 0: a max-pool
    window of the upper segment whose two largest entries lie within the
    two frameworks' float32 round-off (about 2e-6 relative) routes its
    relevance to different positions, and some inputs hold one (seed 42
    does, at pool 27 above layer 19)."""
    jspecs, jparams, tspecs, tparams, nm, _, _, hw, _ = both_models("gtzan6s")
    U = signed_permutation(5, d)
    x = np.random.default_rng(0).standard_normal((1, 1) + hw).astype(np.float32)
    jsp = j_insert(jspecs, layer, jnp.asarray(U), 4, input_size=hw)
    R_j, acts_j, logits_j = jexp.explain_forward_upper(
        jsp, jparams, jnp.asarray(x), jexp.class_composite(nm, 4), class_idx=0, nhwc=True)
    tsp = t_insert(tspecs, layer, t(U), 4, input_size=hw)
    R_t, acts_t, logits_t = texp.explain_forward_upper(
        tsp, tparams, t(x), texp.class_composite(nm, 4), class_idx=0)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-4, atol=1e-5)
    assert len(acts_t) == len(acts_j)
    for a_t, a_j in zip(acts_t, acts_j):
        a_j = np.asarray(a_j)
        np.testing.assert_allclose(a_t.numpy(), a_j, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(a_j).max()))
    assert_close_lrp(R_t.numpy(), np.asarray(R_j))


def test_6s_service_matches_jax():
    """ExplainerService on the 6s model at layer 33 (folded, bridged
    weights), one 6 s clip, against the JAX service; standard = sum of the
    subspace maps, and the chain agrees with the plain tiled walk.

    The clip is drawn from numpy seed 14, whose JAX forward holds no pool
    window within POOL_MARGIN of a tie: margin 5.1e-7, 1.3x the 6s
    threshold and the largest of the scan in test_torch_util.py (seeds
    0-299). Where that scan ran, the closest window's gap was 4.5x the
    change the port's forward made to it (route_agreement), so a host
    routes it otherwise only if its round-off differs that much more; a
    6s input cannot do better (see POOL_MARGIN). Seed 1 held a window at
    pool features.13 with a gap of 1.6e-8 of the map's maximum: the CPU's
    convolution summation order decided its first argmax, and the heatmaps
    then differed from the JAX ones by 3.1e-3 of their maximum on some
    hosts (ROADMAP Queue 3 item 3)."""
    jspecs, jparams, tspecs, tparams, nm, layer, d, _, case = both_models("gtzan6s")
    Us = {"jazz": signed_permutation(11, d)}
    wavs = (np.random.default_rng(14).standard_normal((1, 96000)) * 0.3).astype(np.float32)
    margins = service_margins(jspecs, jparams, layer, Us["jazz"], wavs, case)
    assert margins[0] >= POOL_MARGIN["gtzan6s"], margins
    js = JService(jspecs, jparams, nm, Us, 4, layer, case=case)
    ts = ExplainerService(tspecs, tparams, nm, Us, 4, layer, case=case, device="cpu")
    want, got = js.explain(wavs, "jazz"), ts.explain(wavs, "jazz")
    assert got["subspace_heatmaps"].shape == (1, 4) + HW6
    for key in ("standard_heatmaps", "subspace_heatmaps", "subspace_relevances",
                "standard_relevance", "logits"):
        assert_close_lrp(got[key], want[key])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_allclose(got["standard_heatmaps"][:, 0],
                               got["subspace_heatmaps"].sum(axis=1), rtol=1e-5,
                               atol=1e-6 * np.abs(got["standard_heatmaps"]).max())
    plain = ts.explain(wavs, "jazz", fused=False)
    assert_close_lrp(got["subspace_heatmaps"], plain["subspace_heatmaps"])


def test_plan_chain_6s_like_jax():
    """The cases of tests/test_pallas_chain.py::test_plan_chain_parser_edges:
    the 6s plan has 5 blocks with two convs in block 0; three convs in
    block 0, or a (2,4) pool above block 1, are refused."""
    _, _, tspecs, tparams, nm, _, _, _, _ = both_models("gtzan6s")
    sp = t_insert(tspecs, 33, t(signed_permutation(7, 128)), 4, input_size=HW6)
    conv_sec, _ = texp._conv_section(texp._split_at_filter(sp)[0])
    comp = texp.class_composite(nm, 4)
    base = tchain.plan_chain(conv_sec, tparams, comp, fine_hw=HW6)
    assert base is not None and len(base["blocks"]) == 5
    assert [len(b["convs"]) for b in base["blocks"]] == [2] * 5
    assert base["blocks"][0]["pool_above"][1:] == (2, 4)

    extra_conv = dataclasses.replace(conv_sec[2], name="features.extra")
    extra_relu = dataclasses.replace(conv_sec[3], name="features.extra_relu")
    params2 = dict(tparams)
    params2["features.extra"] = tparams[conv_sec[2].name]
    sec3 = conv_sec[:4] + [extra_conv, extra_relu] + conv_sec[4:]
    comp3 = texp.class_composite(list(nm) + [("features.extra", ("gamma", {"gamma": 0.3}))], 4)
    assert tchain.plan_chain(sec3, params2, comp3) is None

    sec24 = list(conv_sec)
    i_pool2 = next(i for i, s in enumerate(sec24[5:], start=5) if s.kind == "maxpool")
    sec24[i_pool2] = dataclasses.replace(
        sec24[i_pool2], config={**sec24[i_pool2].config, "kernel": (2, 4)})
    assert tchain.plan_chain(sec24, tparams, comp) is None
