"""The port's gamma_nonneg_folded (its plain version, as the CPU runs it)
against the JAX package's pallas_gamma_nonneg in interpret mode and against
its shared_gamma_nonneg rule, and the rule's choice between the kernel and
the plain rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models.vgg import LayerSpec as JSpec
from drsa_audio_tpu.xai.lrp import engine as jeng
from drsa_audio_tpu.xai.lrp import rules as jrules
from drsa_audio_tpu.xai.lrp.pallas_gamma import pallas_gamma_nonneg
from drsa_audio_tpu_torch.models.vgg import LayerSpec as TSpec
from drsa_audio_tpu_torch.xai.lrp import engine as teng
from drsa_audio_tpu_torch.xai.lrp import fused_gamma
from drsa_audio_tpu_torch.xai.lrp import rules as trules
from test_torch_util import assert_close_lrp, t

# (b, K, Ci, Co, H, W): tests/test_pallas_gamma.py's two shapes and the 6s
# model's 100 -> 128 level at a ragged size
SHAPES = [(2, 3, 8, 16, 8, 8), (2, 2, 16, 16, 8, 16), (1, 2, 100, 128, 5, 6)]
GAMMA = 0.3


def _inputs(shape, rng):
    b, K, Ci, Co, H, W = shape
    x = np.maximum(rng.standard_normal((b, Ci, H, W)), 0).astype(np.float32)
    R = rng.standard_normal((K * b, Co, H, W)).astype(np.float32)
    w = (rng.standard_normal((Co, Ci, 3, 3)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((Co,)) * 0.1).astype(np.float32)
    return x, R, w, bias, K


@pytest.mark.parametrize("shape", SHAPES)
def test_folded_plain_matches_pallas_kernel(shape, rng):
    """Against the TPU kernel in interpret mode, at its own test's tolerance
    (nine shifted dots against a conv op): rtol 1e-3, atol 1e-4 * max|ref|."""
    x, R, w, bias, K = _inputs(shape, rng)
    want = np.asarray(pallas_gamma_nonneg(jnp.asarray(x), jnp.asarray(R), jnp.asarray(w),
                                          jnp.asarray(bias), K, gamma=GAMMA, interpret=True))
    got = fused_gamma.gamma_nonneg_folded(t(x), t(R), t(w), t(bias), K, gamma=GAMMA).numpy()
    assert got.shape == want.shape == (R.shape[0],) + x.shape[1:]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_folded_plain_and_shared_rule_match_jax_rule(shape, rng):
    """The same inputs through the JAX shared_gamma_nonneg: the kernel's
    plain version and the port's shared rule (which the shared walk runs on
    the CPU) at the LRP tolerance."""
    x, R, w, bias, K = _inputs(shape, rng)
    jop = jeng._apply_factory(JSpec("conv", "c", {}), {"c": {"w": jnp.asarray(w),
                                                            "b": jnp.asarray(bias)}})
    want = np.asarray(jrules.shared_gamma_nonneg(jop, jnp.asarray(x), jnp.asarray(R), K,
                                                 gamma=GAMMA))
    got = fused_gamma.gamma_nonneg_folded(t(x), t(R), t(w), t(bias), K, gamma=GAMMA)
    assert_close_lrp(got.numpy(), want)
    top = teng.LayerOp(TSpec("conv", "c", {}), {"c": {"weight": t(w), "bias": t(bias)}})
    rule = trules.shared_gamma_nonneg(top, t(x), t(R), K, gamma=GAMMA)
    assert_close_lrp(rule.numpy(), want)


def _meta_layer(kind, shape):
    w = torch.empty(shape, device="meta")
    return teng.LayerOp(TSpec(kind, "c", {}), {"c": {"weight": w,
                                                    "bias": torch.empty(shape[0], device="meta")}})


def test_dispatch_by_layer_spec(monkeypatch):
    """Off the CPU (a meta tensor here), a 3x3 conv goes to the kernel's
    wrapper, which refuses a tensor that is not on a GPU; a 5x5 conv, a
    1x1 conv and a linear layer take the plain rule. On the CPU the plain
    rule runs for every layer."""
    calls = []
    wrapped = fused_gamma.gamma_nonneg_folded

    def spy(*args, **kwargs):
        calls.append(args[2].shape)
        return wrapped(*args, **kwargs)
    monkeypatch.setattr(fused_gamma, "gamma_nonneg_folded", spy)
    K = 2
    x = torch.empty((1, 4, 6, 6), device="meta")
    with pytest.raises(ValueError, match="GPU"):
        trules.shared_gamma_nonneg(_meta_layer("conv", (8, 4, 3, 3)), x,
                                   torch.empty((K, 8, 6, 6), device="meta"), K)
    assert calls == [(8, 4, 3, 3)]
    for kh in (5, 1):
        out = trules.shared_gamma_nonneg(_meta_layer("conv", (8, 4, kh, kh)), x,
                                         torch.empty((K, 8, 6, 6), device="meta"), K)
        assert out.shape == (K, 4, 6, 6) and out.device.type == "meta"
    out = trules.shared_gamma_nonneg(_meta_layer("linear", (5, 12)),
                                     torch.empty((1, 12), device="meta"),
                                     torch.empty((K, 5), device="meta"), K)
    assert out.shape == (K, 12)
    assert len(calls) == 1 and fused_gamma.LAUNCHES["gamma_nonneg"] == 0
    cpu = teng.LayerOp(TSpec("conv", "c", {}), {"c": {"weight": torch.ones(8, 4, 3, 3),
                                                     "bias": torch.zeros(8)}})
    assert fused_gamma.takes(cpu)
    trules.shared_gamma_nonneg(cpu, torch.ones(1, 4, 6, 6), torch.ones(K, 8, 6, 6), K)
    assert len(calls) == 1
    assert not fused_gamma.takes(teng.LayerOp(TSpec("conv", "c", {}), {"c": {
        "weight": torch.ones(8, 4, 3, 3), "bias": torch.zeros(8)}}, nhwc=True))
