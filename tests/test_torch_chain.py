"""The port's lower chain (plain versions of chain_block and first_layer, as
the CPU runs them) against the JAX package: its rule walk per function, and
its fused Pallas chain (interpret mode) for the whole conv section."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.models.vgg import LayerSpec as JSpec
from drsa_audio_tpu.xai import explain as jexp
from drsa_audio_tpu.xai.lrp.engine import Composite as JComposite
from drsa_audio_tpu.xai.lrp.pallas_chain import fused_lower_conv_backward as j_fused
from drsa_audio_tpu.xai.lrp.pallas_chain import plan_chain as j_plan
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection as t_insert
from drsa_audio_tpu_torch.ops import fused_frontend
from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
from drsa_audio_tpu_torch.xai import explain as texp
from drsa_audio_tpu_torch.xai.lrp import chain as tchain
from drsa_audio_tpu_torch.xai.lrp import fused_gamma, taps
from test_torch_util import assert_close_lrp, both_models, signed_permutation, t

K = 3


def _gamma_conv(rng, ci, co):
    w = (rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2.0 / (9 * ci))).astype(np.float32)
    b = (rng.standard_normal(co) * 0.05).astype(np.float32)
    return w, b


@pytest.mark.parametrize("n_convs,kw", [(1, 2), (2, 4), (1, None)])
def test_chain_block_plain_matches_jax_rule_walk(n_convs, kw, rng):
    """chain_block_plain (relu gate + gamma_nonneg per conv, top-down, then
    the pool below) against the JAX package's NHWC rule walk over the same
    layers, with all K clones."""
    H, W, C = 4, 4, 8
    names = [f"c{i}" for i in range(n_convs)]
    ws = [_gamma_conv(rng, C, C) for _ in names]
    gam = [0.4, 0.2]
    # JAX segment, bottom-up: [maxpool] conv relu [conv relu]
    specs, acts = [], []
    Hf, Wf = (2 * H, kw * W) if kw else (H, W)
    apre = rng.standard_normal((2, Hf, Wf, C)).astype(np.float32)
    apre[0, :2, :kw or 2] = -1.0          # an all-tied (zero) pool window
    x = np.maximum(apre, 0.0)
    if kw:
        specs.append(JSpec("maxpool", "p", {"kernel": (2, kw)}))
        acts.append(x)
        x = np.asarray(jax.lax.reduce_window(x, -np.inf, jax.lax.max,
                                             (1, 2, kw, 1), (1, 2, kw, 1), "VALID"))
    xs = []
    params_j, params_t = {}, {}
    for n, (w, b) in zip(names, ws):
        specs += [JSpec("conv", n, {}), JSpec("relu", n + "r", {})]
        xs.append(x)
        z = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))) + b
        acts += [x, z]
        x = np.maximum(z, 0.0)
        params_j[n] = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
        params_t[n] = {"weight": t(w), "bias": t(b)}
    comp = JComposite.from_list([(n, ("gamma", {"gamma": g, "stabilizer": 1e-7}))
                                 for n, g in zip(names, gam)])
    R = rng.standard_normal((2, K, H, W, C)).astype(np.float32)
    acts_k = [np.tile(a[None], (K,) + (1,) * a.ndim).reshape((K * 2,) + a.shape[1:])
              for a in acts]
    want = jexp._lrp_segment_backward_nhwc(
        specs, params_j, [jnp.asarray(a) for a in acts_k],
        jnp.asarray(R.transpose(1, 0, 2, 3, 4).reshape((K * 2, H, W, C))), comp)
    want = np.asarray(want).reshape((K, 2) + want.shape[1:]).transpose(1, 0, 2, 3, 4)

    tspecs = {n: tvgg.LayerSpec("conv", n, {}) for n in names}
    cws = [tchain.prep_inner_weights(params_t, tspecs[n], {"gamma": g, "stabilizer": 1e-7})
           for n, g in zip(names, gam)][::-1]
    got = tchain.chain_block(t(R), [t(v) for v in xs[::-1]], cws,
                             t(apre) if kw else None, (2, kw) if kw else None)
    assert_close_lrp(got.numpy(), want)


@pytest.mark.parametrize("rule", ["wsquare", "flat"])
def test_first_layer_plain_matches_jax_rule_walk(rule, rng):
    H, W, C = 8, 8, 8
    w = (rng.standard_normal((C, 1, 3, 3)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    mel = rng.standard_normal((2, H, W, 1)).astype(np.float32)
    a1 = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(mel), jnp.asarray(w.transpose(2, 3, 1, 0)), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + b
    a1[0, 0, :2, :] = 0.0                 # relu ties, an all-tied window
    specs = [JSpec("conv", "c0", {}), JSpec("relu", "r", {}),
             JSpec("maxpool", "p", {"kernel": (2, 2)})]
    acts = [mel, a1, np.maximum(a1, 0.0)]
    comp = JComposite.from_list([("c0", (rule, {"stabilizer": 1e-7}))])
    R = rng.standard_normal((2, K, H // 2, W // 2, C)).astype(np.float32)
    acts_k = [np.tile(a[None], (K,) + (1,) * a.ndim).reshape((K * 2,) + a.shape[1:])
              for a in acts]
    want = jexp._lrp_segment_backward_nhwc(
        specs, {"c0": {"w": jnp.asarray(w), "b": jnp.asarray(b)}},
        [jnp.asarray(a) for a in acts_k],
        jnp.asarray(R.transpose(1, 0, 2, 3, 4).reshape((K * 2, H // 2, W // 2, C))), comp)
    want = np.asarray(want)[..., 0].reshape(K, 2, H, W).transpose(1, 0, 2, 3)
    fl = taps.prep_first_weights({"c0": {"weight": t(w), "bias": t(b)}},
                                 tvgg.LayerSpec("conv", "c0", {}), (rule, {"stabilizer": 1e-7}),
                                 (H, W))
    got = tchain.first_layer(t(R), t(a1), fl)
    assert_close_lrp(got.numpy(), want)


@pytest.mark.parametrize("name,b", [("toy", 2), ("gtzan3s", 1)])
def test_chain_matches_jax_fused(name, b, rng):
    """The port's whole chain against JAX fused_lower_conv_backward (Pallas
    in interpret mode) on the same recorded activations and relevance."""
    jspecs, jparams, tspecs, tparams, nm, layer, d, hw, _ = both_models(name)
    U = signed_permutation(3, d)
    x = rng.standard_normal((b, 1) + hw).astype(np.float32)
    jsp = j_insert(jspecs, layer, jnp.asarray(U), 4, input_size=hw)
    comp_j = jexp.class_composite(nm, 4)
    _, acts, _ = jexp.explain_forward_upper(jsp, jparams, jnp.asarray(x), comp_j,
                                            class_idx=0, nhwc=True)
    conv_sec, _ = jexp._conv_section(jexp._split_at_filter(jsp)[0])
    plan_j = j_plan(conv_sec, jparams, comp_j, fine_hw=hw)
    R = rng.standard_normal((b, 4) + tuple(acts[-2].shape[1:3]) + (d,)).astype(np.float32)
    want = np.asarray(j_fused(plan_j, jparams, list(acts[:-1]), jnp.asarray(R), 4))

    tsp = t_insert(tspecs, layer, t(U), 4, input_size=hw)
    t_conv_sec, _ = texp._conv_section(texp._split_at_filter(tsp)[0])
    plan_t = tchain.plan_chain(t_conv_sec, tparams, texp.class_composite(nm, 4), fine_hw=hw)
    got = tchain.fused_lower_conv_backward(
        plan_t, tparams, [t(a) for a in acts[:-1]], t(R), 4)
    assert got.shape == (b, 4) + hw
    assert_close_lrp(got.numpy(), want)


def _toy_sections():
    jspecs, jparams, tspecs, tparams, nm, layer, d, hw, _ = both_models("toy")
    U = signed_permutation(3, d)
    tsp = t_insert(tspecs, layer, t(U), 4)
    conv_sec, _ = texp._conv_section(texp._split_at_filter(tsp)[0])
    return conv_sec, tparams, nm


def test_plan_chain_accepts_and_rejects_like_jax():
    """The cases of tests/test_pallas_chain.py::test_plan_chain_rejects_unsupported."""
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_TOY
    conv_sec, params, _ = _toy_sections()
    bad = [("features.0", ("epsilon", {"epsilon": 1e-6}))] + [
        (n, r) for n, r in LRP_NAME_MAP_TOY if n != "features.0"]
    assert tchain.plan_chain(conv_sec, params, texp.class_composite(bad, 4)) is None
    good = texp.class_composite(LRP_NAME_MAP_TOY, 4)
    assert tchain.plan_chain(conv_sec, params, good) is not None
    w0 = params[conv_sec[0].name]["weight"]
    mc = dict(params)
    mc[conv_sec[0].name] = {**params[conv_sec[0].name], "weight": torch.cat([w0] * 3, dim=1)}
    assert tchain.plan_chain(conv_sec, mc, good) is None
    assert tchain.plan_chain(conv_sec, params, good, fine_hw=(64, 64)) is not None
    assert tchain.plan_chain(conv_sec, params, good, fine_hw=(64, 60)) is None
    assert tchain.plan_chain(conv_sec, params, good, fine_hw=(63, 64)) is None
    w1n = next(s for s in conv_sec[1:] if s.kind == "conv").name
    p5 = dict(params)
    p5[w1n] = {**params[w1n], "weight": torch.zeros(params[w1n]["weight"].shape[:2] + (5, 5))}
    assert tchain.plan_chain(conv_sec, p5, good) is None


def test_deep_first_block_chain_matches_plain_walk(rng):
    """A gamma conv between the first conv and its pool (the 6s topology)
    is planned and runs through the chain (first_block_deep); the heatmaps
    agree with the plain tiled walk (fused=False)."""
    cfg = tvgg.VGGConfig(n_filters=(8, 16), n_dense=8, pool_kernels=((2, 4), (2, 2)),
                         dropout=0.0, input_size=(16, 32), n_classes=2,
                         conv_bn=False, dense_bn=False, block_depth=2)
    specs = tvgg.build_layer_specs(cfg)
    params = tvgg.init_params(specs, 0, device="cpu")
    nm = [("features.0", ("wsquare", {})), ("features.2", ("gamma", {"gamma": 0.3})),
          ("features.5", ("gamma", {"gamma": 0.3})), ("features.7", ("gamma", {"gamma": 0.3}))]
    tsp = t_insert(specs, 8, t(signed_permutation(0, 16)), 4, input_size=(16, 32))
    conv_sec, _ = texp._conv_section(texp._split_at_filter(tsp)[0])
    comp = texp.class_composite(nm, 4)
    plan = tchain.plan_chain(conv_sec, params, comp, fine_hw=(16, 32))
    assert plan is not None and len(plan["blocks"][0]["convs"]) == 2
    x = t(rng.standard_normal((1, 1, 16, 32)))
    heat, _ = texp.subspace_heatmaps(tsp, params, x, comp, 4, class_idx=0, fused=True)
    want, _ = texp.subspace_heatmaps(tsp, params, x, comp, 4, class_idx=0, fused=False)
    assert heat.shape == (1, 5, 16, 32) and torch.isfinite(heat).all()
    assert_close_lrp(heat.numpy(), want.numpy())


def test_wrappers_never_fall_back(rng, monkeypatch):
    """A tensor that is neither on the CPU nor on a GPU is refused; the
    plain version is never taken for it. The same for the gamma_nonneg and
    log-mel wrappers."""
    conv_sec, params, nm = _toy_sections()
    cv = tchain.prep_inner_weights(params, conv_sec[9], {"gamma": 0.8})
    R = torch.empty((1, 2, 8, 8, 16), device="meta")
    x = torch.empty((1, 8, 8, 16), device="meta")
    with pytest.raises(ValueError, match="GPU"):
        tchain.chain_block(R, [x], [cv])
    fl = taps.prep_first_weights(params, conv_sec[0], ("flat", {}), (64, 64))
    with pytest.raises(ValueError, match="GPU"):
        tchain.first_layer(torch.empty((1, 2, 32, 32, 8), device="meta"),
                           torch.empty((1, 64, 64, 8), device="meta"), fl)
    gc = tchain.prep_inner_weights(params, conv_sec[3], {"gamma": 0.8})
    fl8 = taps.prep_first_weights(params, conv_sec[0], ("flat", {}), (8, 8))
    with pytest.raises(ValueError, match="GPU"):
        tchain.first_block_deep(torch.empty((1, 2, 4, 4, 8), device="meta"),
                                torch.empty((1, 8, 8, 8), device="meta"),
                                torch.empty((1, 8, 8, 8), device="meta"), gc, fl8, (2, 2))
    c6 = tchain.prep_inner_weights(params, conv_sec[6], {"gamma": 0.8})
    with pytest.raises(ValueError, match="GPU"):
        tchain.merged_tail(torch.empty((1, 2, 2, 2, 16), device="meta"),
                           [torch.empty((1, 2, 2, 8), device="meta"),
                            torch.empty((1, 4, 4, 8), device="meta")], [c6, gc],
                           [torch.empty((1, 4, 4, 8), device="meta")],
                           torch.empty((1, 8, 8, 8), device="meta"), fl8)
    assert tchain.LAUNCHES == {"chain_block": 0, "first_layer": 0, "first_block_deep": 0,
                               "merged_tail": 0}
    plain = []
    for mod, name in ((fused_gamma, "gamma_nonneg_folded_plain"),
                      (fused_frontend, "fused_logmel_plain")):
        monkeypatch.setattr(mod, name, lambda *a, name=name, **k: plain.append(name))
    with pytest.raises(ValueError, match="GPU"):
        fused_gamma.gamma_nonneg_folded(
            torch.empty((1, 8, 8, 8), device="meta"), torch.empty((2, 16, 8, 8), device="meta"),
            torch.empty((16, 8, 3, 3), device="meta"), torch.empty(16, device="meta"), 2)
    with pytest.raises(ValueError, match="GPU"):
        fused_frontend.fused_logmel(torch.empty((2, 16000), device="meta"),
                                    FrontendConfig.for_case("toy"))
    assert plain == []
    assert fused_gamma.LAUNCHES == {"gamma_nonneg": 0} and fused_frontend.LAUNCHES == {"logmel": 0}
