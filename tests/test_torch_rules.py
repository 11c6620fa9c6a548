"""The port's LRP rules, relu gate and pool route against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models.vgg import LayerSpec as JSpec
from drsa_audio_tpu.models.vgg import maxpool2d
from drsa_audio_tpu.xai.lrp import engine as jeng
from drsa_audio_tpu.xai.lrp import rules as jrules
from drsa_audio_tpu.xai.lrp.pallas_chain import relu_gate as j_relu_gate
from drsa_audio_tpu_torch.models.vgg import LayerSpec as TSpec
from drsa_audio_tpu_torch.xai.explain import maxpool_route_mask
from drsa_audio_tpu_torch.xai.lrp import chain as tchain
from drsa_audio_tpu_torch.xai.lrp import engine as teng
from drsa_audio_tpu_torch.xai.lrp import rules as trules
from test_torch_util import t

RULE_CASES = [
    ("epsilon", {"epsilon": 1e-6}),
    ("gamma", {"gamma": 0.25, "stabilizer": 1e-6}),
    ("gamma_nonneg", {"gamma": 0.4, "stabilizer": 1e-7}),
    ("wsquare", {"stabilizer": 1e-7}),
    ("flat", {"stabilizer": 1e-7}),
    ("norm", {"stabilizer": 1e-6}),
    ("zplus", {"stabilizer": 1e-6}),
    ("alphabeta", {"alpha": 2.0, "beta": 1.0, "stabilizer": 1e-6}),
    ("zbox", {"low": -1.5, "high": 1.5, "stabilizer": 1e-6}),
]
# the rules with a shared-activation variant (rules.SHARED_RULES); the
# second alphabeta case is tests/test_lrp_rules.py's linear one
SHARED_CASES = [c for c in RULE_CASES if c[0] in trules.SHARED_RULES] + [
    ("alphabeta", {"alpha": 1.5, "beta": 0.5, "stabilizer": 1e-6})]


def _layer(kind, rng, nhwc=False):
    if kind == "conv":
        w = (rng.standard_normal((6, 4, 3, 3)) * 0.3).astype(np.float32)
        b = (rng.standard_normal(6) * 0.1).astype(np.float32)
        shape = (2, 8, 8, 4) if nhwc else (2, 4, 8, 8)
    else:
        w = (rng.standard_normal((5, 12)) * 0.3).astype(np.float32)
        b = (rng.standard_normal(5) * 0.1).astype(np.float32)
        shape = (3, 12)
    js = JSpec(kind, "l", {})
    ts = TSpec(kind, "l", {})
    jp = {"l": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    tp = {"l": {"weight": t(w), "bias": t(b)}}
    if nhwc:
        jop = jeng._apply_factory_nhwc(js, jp)
    else:
        jop = jeng._apply_factory(js, jp)
    return jop, teng.LayerOp(ts, tp, nhwc), shape


@pytest.mark.parametrize("kind,nhwc", [("conv", False), ("conv", True), ("linear", False)])
@pytest.mark.parametrize("rule,kw", RULE_CASES)
def test_rule_matches_jax(rule, kw, kind, nhwc, rng):
    jop, top, shape = _layer(kind, rng, nhwc)
    x = rng.standard_normal(shape).astype(np.float32)
    if rule == "gamma_nonneg":
        x = np.maximum(x, 0.0)
        x[0, 0] = 0.0
    z = np.asarray(jop(lambda p: p, lambda p: p)(jnp.asarray(x)))
    R = rng.standard_normal(z.shape).astype(np.float32)
    want = np.asarray(jrules.RULES[rule](jop, jnp.asarray(x), jnp.asarray(R), **kw))
    got = trules.RULES[rule](top, t(x), t(R), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _shared_inputs(rule, kind, rng, K=3):
    jop, top, shape = _layer(kind, rng)
    x = rng.standard_normal(shape).astype(np.float32)
    if rule == "gamma_nonneg":
        x = np.maximum(x, 0.0)
        x[0, 0] = 0.0
    z = np.asarray(jop(lambda p: p, lambda p: p)(jnp.asarray(x)))
    R = rng.standard_normal((K * z.shape[0],) + z.shape[1:]).astype(np.float32)
    return jop, top, x, R, K


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("rule,kw", SHARED_CASES)
def test_shared_rule_matches_jax(rule, kw, kind, rng):
    """x at batch b, R at K*b (clone-major), against the JAX package's
    shared variant (its grouped fast path for convs and linears)."""
    jop, top, x, R, K = _shared_inputs(rule, kind, rng)
    want = np.asarray(jrules.SHARED_RULES[rule](jop, jnp.asarray(x), jnp.asarray(R), K, **kw))
    got = trules.SHARED_RULES[rule](top, t(x), t(R), K, **kw).numpy()
    assert got.shape == want.shape == (R.shape[0],) + x.shape[1:]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("rule,kw", SHARED_CASES)
def test_shared_rule_matches_tiled_rule(rule, kw, kind, rng):
    """Each shared variant equals its tiled rule on _expand_batch(x)."""
    _, top, x, R, K = _shared_inputs(rule, kind, rng)
    want = trules.RULES[rule](top, trules._expand_batch(t(x), K), t(R), **kw).numpy()
    got = trules.SHARED_RULES[rule](top, t(x), t(R), K, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_rule_tables_match_jax():
    assert set(trules.RULES) == set(jrules.RULES)
    assert set(trules.SHARED_RULES) == set(jrules.SHARED_RULES)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(trules._expand_batch(t(x), 3).numpy(),
                                  np.asarray(jrules._expand_batch(jnp.asarray(x), 3)))
    big = np.arange(18, dtype=np.float32).reshape(6, 3)
    np.testing.assert_array_equal(
        trules._mul_small(t(big), t(x), 3).numpy(),
        np.asarray(jrules._mul_small(jnp.asarray(big), jnp.asarray(x), 3)))


def test_stabilize_sign_of_zero():
    z = np.array([0.0, -0.0, 1.0, -1.0, 1e-9], np.float32)
    np.testing.assert_array_equal(trules.stabilize(t(z), 1e-6).numpy(),
                                  np.asarray(jrules.stabilize(jnp.asarray(z), 1e-6)))


def test_relu_gate_ties_match_vjp(rng):
    a = rng.standard_normal((4, 8)).astype(np.float32)
    a[0, :3] = 0.0
    _, vjp = jax.vjp(lambda v: jnp.maximum(v, 0.0), jnp.asarray(a))
    want = np.asarray(vjp(jnp.ones_like(jnp.asarray(a)))[0])
    np.testing.assert_array_equal(tchain.relu_gate(t(a)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(j_relu_gate(jnp.asarray(a))), want)


@pytest.mark.parametrize("kernel", [(2, 2), (2, 4)])
def test_pool_route_all_tied_window_matches_vjp(kernel, rng):
    """First-argmax routing incl. all-tied post-relu zero windows and a row of
    equal values, against jax's reduce_window vjp."""
    kh, kw = kernel
    a = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    a[0, 0, :2, :kw] = 0.0
    a[1, 1, :2, :] = 5.0
    a = np.maximum(a, 0.0)
    g = rng.standard_normal((2, 3, 4 // kh, 8 // kw)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: maxpool2d(v, kernel), jnp.asarray(a))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = tchain.pool_backward(t(g), maxpool_route_mask(t(a), kernel), kernel,
                               nhwc=False).numpy()
    np.testing.assert_array_equal(got, want)
    # the NHWC form used by the chain
    got_nhwc = tchain.pool_backward(
        t(g).permute(0, 2, 3, 1), tchain.route_mask(t(a).permute(0, 2, 3, 1), kernel),
        kernel)
    np.testing.assert_array_equal(got_nhwc.permute(0, 3, 1, 2).numpy(), want)


def test_specialize_rule_upper_conv_keeps_full_gamma():
    """Conv 12 sits under the inverse projection and a pool, not a relu: the
    upper walk keeps the full four-term gamma."""
    kinds = ["invprojection", "maxpool", "conv", "relu"]
    specs = [TSpec(k, f"l{i}", {}) for i, k in enumerate(kinds)]
    assert teng._specialize_rule("gamma", specs, 2) == "gamma"
    lower = [TSpec(k, f"l{i}", {}) for i, k in enumerate(["conv", "relu", "maxpool", "conv"])]
    assert teng._specialize_rule("gamma", lower, 3) == "gamma_nonneg"
    jspecs = [JSpec(k, f"l{i}", {}) for i, k in enumerate(kinds)]
    assert jeng._specialize_rule("gamma", jspecs, 2) == "gamma"


def test_output_masks_match_jax(rng):
    lg = rng.standard_normal((4, 2)).astype(np.float32)
    for one_hot in (False, True):
        np.testing.assert_array_equal(
            teng.output_mask_class(1, one_hot)(t(lg)).numpy(),
            np.asarray(jeng.output_mask_class(1, one_hot)(jnp.asarray(lg))))
        np.testing.assert_array_equal(
            teng.output_mask_all_classes(2, one_hot)(t(lg)).numpy(),
            np.asarray(jeng.output_mask_all_classes(2, one_hot)(jnp.asarray(lg))))
