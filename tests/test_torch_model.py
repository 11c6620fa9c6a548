"""The port's model, constants, weight bridge and forward/upper pass against
the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.utils import constants as jconst
from drsa_audio_tpu.xai import explain as jexp
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection as t_insert
from drsa_audio_tpu_torch.utils import constants as tconst
from drsa_audio_tpu_torch.utils.convert import to_state_dict
from drsa_audio_tpu_torch.xai import explain as texp
from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal as t_ortho
from test_torch_util import both_models, signed_permutation, t

TABLES = ["CLASS_IDX_MAPPER", "CLASS_IDX_MAPPER_TOY", "AUDIO_PARAMS",
          "LRP_NAME_MAP_GTZAN", "LRP_NAME_MAP_TOY", "LRP_NAME_MAP_GTZAN_6S",
          "DRSA_LAYERS_GTZAN_6S", "SUBSPACE_DIMS_GTZAN", "SUBSPACE_DIMS_TOY"]


@pytest.mark.parametrize("name", TABLES)
def test_constants_equal_jax(name):
    assert getattr(tconst, name) == getattr(jconst, name)


@pytest.mark.parametrize("cfg", ["gtzan_3s_config", "toy_config", "gtzan_6s_config"])
def test_layer_specs_match(cfg):
    from drsa_audio_tpu.models import vgg as jvgg
    js = jvgg.build_layer_specs(getattr(jvgg, cfg)())
    ts = tvgg.build_layer_specs(getattr(tvgg, cfg)())
    assert [(s.kind, s.name, s.config) for s in ts] == \
        [(s.kind, s.name, s.config) for s in js]


def test_bridge_loads_into_module(rng):
    _, jparams, tspecs, tparams, *_ = both_models("toy")
    model = tvgg.VGG(tvgg.toy_config())
    model.load_state_dict(to_state_dict(tparams))
    assert set(model.state_dict()) == set(to_state_dict(tparams))
    x = rng.standard_normal((2, 1, 64, 64)).astype(np.float32)
    from drsa_audio_tpu.models.vgg import forward as jforward
    from drsa_audio_tpu.models.vgg import build_layer_specs, toy_config
    want = np.asarray(jforward(build_layer_specs(toy_config()), jparams, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(model(t(x)).numpy(), want, rtol=1e-5, atol=1e-5)


def test_init_is_seeded():
    specs = tvgg.build_layer_specs(tvgg.toy_config())
    a = tvgg.init_params(specs, 3, device="cpu")
    b = tvgg.init_params(specs, 3, device="cpu")
    assert all(torch.equal(a[n]["weight"], b[n]["weight"]) for n in a)
    assert a["features.0"]["weight"].shape == (8, 1, 3, 3)


def test_random_orthogonal():
    U = t_ortho(5, 16)
    np.testing.assert_allclose(U @ U.T, np.eye(16), atol=1e-5)
    np.testing.assert_array_equal(U, t_ortho(5, 16))


@pytest.mark.parametrize("name", ["toy", "gtzan3s"])
def test_forward_upper_matches_jax(name, rng):
    """Logits, every recorded NHWC activation and the filter relevance
    against explain_forward_upper(nhwc=True). U is a signed permutation
    (see the note in test_torch_serving.py)."""
    jspecs, jparams, tspecs, tparams, nm, layer, d, hw, _ = both_models(name)
    U = signed_permutation(5, d)
    x = rng.standard_normal((1, 1) + hw).astype(np.float32)
    jsp = j_insert(jspecs, layer, jnp.asarray(U), 4, input_size=hw)
    R_j, acts_j, logits_j = jexp.explain_forward_upper(
        jsp, jparams, jnp.asarray(x), jexp.class_composite(nm, 4), class_idx=0,
        nhwc=True)
    tsp = t_insert(tspecs, layer, t(U), 4, input_size=hw)
    R_t, acts_t, logits_t = texp.explain_forward_upper(
        tsp, tparams, t(x), texp.class_composite(nm, 4), class_idx=0)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-5)
    assert len(acts_t) == len(acts_j)
    for a_t, a_j in zip(acts_t, acts_j):
        a_j = np.asarray(a_j)
        np.testing.assert_allclose(a_t.numpy(), a_j, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(a_j).max()))
    R_j = np.asarray(R_j)
    np.testing.assert_allclose(R_t.numpy(), R_j, rtol=1e-4,
                               atol=1e-5 * np.abs(R_j).max())
