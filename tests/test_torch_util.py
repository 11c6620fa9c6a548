"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: the same model, weights and inputs in both, passed as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.utils import constants as jconst
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.utils.convert import from_jax_params

# name -> (config fn name, name map, DRSA layer, d, mel size, case)
MODELS = {
    "toy": ("toy_config", "LRP_NAME_MAP_TOY", 10, 16, (64, 64), "toy"),
    "gtzan3s": ("gtzan_3s_config", "LRP_NAME_MAP_GTZAN", 10, 64, (128, 128), "gtzan"),
    "gtzan6s": ("gtzan_6s_config", "LRP_NAME_MAP_GTZAN_6S", 33, 128, (128, 256), "gtzan_6s"),
}


def to_np(jparams) -> dict:
    return jax.tree_util.tree_map(np.asarray, jparams)


def random_bn(jparams: dict, seed: int) -> dict:
    """The JAX params with random BatchNorm scale, bias, mean and var drawn
    with numpy, so that folding them is not the identity."""
    rng = np.random.default_rng(seed)
    out = dict(jparams)
    for name, p in jparams.items():
        if "var" in p:
            ch = p["var"].shape[0]
            draw = {"scale": rng.uniform(0.5, 1.5, ch), "bias": rng.normal(0.0, 0.1, ch),
                    "mean": rng.normal(0.0, 0.1, ch), "var": rng.uniform(0.5, 2.0, ch)}
            out[name] = {k: jnp.asarray(v.astype(np.float32)) for k, v in draw.items()}
    return out


def both_models(name: str, seed: int = 0):
    """(JAX specs, JAX params, port specs, port params on the CPU, name map,
    layer, d, hw, case) with the port's weights bridged from the JAX ones.
    A model with BatchNorm (the 6s one) gets random BN statistics and is
    folded, as its callers fold it before they explain: the JAX package
    folds its params and the port takes them through the bridge."""
    cfg_fn, nm, layer, d, hw, case = MODELS[name]
    jspecs = jvgg.build_layer_specs(getattr(jvgg, cfg_fn)())
    jparams = jvgg.init_params(jspecs, jax.random.PRNGKey(seed))
    tspecs = tvgg.build_layer_specs(getattr(tvgg, cfg_fn)())
    if getattr(jvgg, cfg_fn)().conv_bn:
        jparams = random_bn(jparams, seed)
        tspecs, _ = tvgg.fold_batchnorm(tspecs, from_jax_params(to_np(jparams), device="cpu"))
        jspecs, jparams = jvgg.fold_batchnorm(jspecs, jparams)
    tparams = from_jax_params(to_np(jparams), device="cpu")
    return jspecs, jparams, tspecs, tparams, getattr(jconst, nm), layer, d, hw, case


def assert_close_lrp(got, want):
    """The JAX package's own fused-vs-tiled bound (tests/test_pallas_chain.py):
    rtol 1e-4, atol 1e-5 * max|ref|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


def signed_permutation(seed: int, d: int) -> np.ndarray:
    """An orthogonal U whose products are exact in float32: the inverse
    projection then rebuilds exact relu zeros as exact zeros in both
    frameworks (see the note in test_torch_serving.py)."""
    rng = np.random.default_rng(seed)
    U = np.zeros((d, d), np.float32)
    U[np.arange(d), rng.permutation(d)] = rng.choice([-1.0, 1.0], d)
    return U
