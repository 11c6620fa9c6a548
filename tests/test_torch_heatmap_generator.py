"""The port's HeatmapGenerator, subspace_heatmaps_repeated and
compute_subspace_relevances (drsa_audio_tpu_torch.xai.explain) against the
JAX package's, mirroring tests/test_explain.py and
tests/test_prototypes_and_harness.py, on the CPU.

U is a signed permutation (see test_torch_serving.py: with a generic U the
two packages' subspace maps agree only to correlation 0.99), and each input
holds no max-pool window within POOL_MARGIN of a tie in the JAX forward.
Tolerance for LRP outputs: rtol 1e-4, atol 1e-5 * max|ref|
(assert_close_lrp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.utils import constants as jconst
from drsa_audio_tpu.xai import explain as jexp
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection as t_insert
from drsa_audio_tpu_torch.xai import explain as texp
from test_torch_util import (
    MODELS, POOL_MARGIN, assert_close_lrp, both_models, signed_permutation, t, tie_margins)

K, LAYER = 4, 10
INFO_KEYS = ("input", "standard_heatmaps", "standard_relevance", "subspace_heatmaps",
             "subspace_relevances", "mask")


@pytest.fixture(scope="module")
def toy():
    """(JAX specs, JAX params, port specs, port params, name map, U, input
    [4, 1, 64, 64])."""
    jspecs, jparams, tspecs, tparams, nm, _, d, hw, _ = both_models("toy")
    U = signed_permutation(3, d)
    x = np.random.default_rng(1).standard_normal((4, 1) + hw).astype(np.float32)
    jsp = j_insert(jspecs, LAYER, jnp.asarray(U), K, input_size=hw)
    assert tie_margins(jsp, jparams, x)[0] >= POOL_MARGIN["toy"]
    return jspecs, jparams, tspecs, tparams, nm, U, x


def _generators(toy, sample_class="class2", **kw):
    jspecs, jparams, tspecs, tparams, nm, U, _ = toy
    jg = jexp.HeatmapGenerator(specs=jspecs, params=jparams, U=jnp.asarray(U), name_map=nm,
                               sample_class=sample_class, num_concepts=K, layer_idx=LAYER, **kw)
    tg = texp.HeatmapGenerator(specs=tspecs, params=tparams, U=U, name_map=nm,
                               sample_class=sample_class, num_concepts=K, layer_idx=LAYER,
                               device="cpu", **kw)
    return jg, tg


def _assert_info_close(got: dict, want: dict):
    assert set(got) == set(want) == set(INFO_KEYS)
    np.testing.assert_array_equal(got["input"], want["input"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for key in INFO_KEYS[1:-1]:
        assert_close_lrp(got[key], want[key])


@pytest.mark.parametrize("kw", [
    {},                                       # one class: its logit
    {"one_hot_encoded": True},                # one class: 1.0 at its logit
    {"flip_all_classes": True},               # a balanced consecutive-class batch
    {"shared_denominators": True},            # the shared-denominator walk
    {"clone_chunk": 2},                       # the tiled walk two clones at a time
])
def test_generator_info_matches_jax(toy, kw):
    jg, tg = _generators(toy)
    x = toy[-1]
    want = jg.generate_subspace_heatmaps(x, **kw)
    got = tg.generate_subspace_heatmaps(x, **kw)
    assert got.shape == (4, K, 64, 64)
    assert_close_lrp(got, want)
    _assert_info_close(tg.info, jg.info)
    assert np.all(np.diff(tg.info["subspace_relevances"], axis=-1) <= 1e-6)
    np.testing.assert_allclose(tg.info["standard_heatmaps"][:, 0], got.sum(axis=1), rtol=1e-5,
                               atol=1e-6 * np.abs(got).max())


def test_concept_flipping_returns_the_raw_maps(toy):
    jg, tg = _generators(toy, "class1")
    x = toy[-1]
    tg.generate_subspace_heatmaps(x[:2])
    before = dict(tg.info)
    got = tg.generate_subspace_heatmaps(x, concept_flipping=True)
    assert_close_lrp(got, jg.generate_subspace_heatmaps(x, concept_flipping=True))
    assert all(tg.info[k] is before[k] for k in INFO_KEYS[1:])
    heat, _ = texp.subspace_heatmaps(tg.specs_proj, tg.params, t(x), tg.composite, K,
                                     class_idx=0)
    np.testing.assert_array_equal(got, heat[:, 1:].numpy())


def test_chunked_equals_unchunked_and_refuses_flip_all_classes(toy):
    _, tg = _generators(toy, "class1")
    x = np.concatenate([toy[-1], toy[-1][:1]])                       # 5 clips
    whole = tg.generate_subspace_heatmaps(x, concept_flipping=True)
    chunked = tg.generate_subspace_heatmaps(x, concept_flipping=True, attr_batch_size=2)
    np.testing.assert_allclose(chunked, whole, rtol=1e-5, atol=1e-6 * np.abs(whole).max())
    with pytest.raises(ValueError, match="flip_all_classes"):
        tg.generate_subspace_heatmaps(x, flip_all_classes=True, attr_batch_size=2)


@pytest.mark.parametrize("name,sample_class,case", [
    ("toy", "class2", None),
    ("gtzan3s", "jazz", None),
    ("gtzan6s", "metal", "gtzan_6s"),
])
def test_case_class_and_input_size_as_jax(name, sample_class, case):
    """Construction only (no parameters needed): the case from the class
    name, the class index and count, the mel size the inverse projection
    restores, and the composite."""
    cfg_fn, nm, layer, d, hw, _ = MODELS[name]
    nm = getattr(jconst, nm)
    U = signed_permutation(0, d)
    kw = dict(params={}, name_map=nm, sample_class=sample_class, num_concepts=K,
              layer_idx=layer, case=case)
    jg = jexp.HeatmapGenerator(specs=jvgg.build_layer_specs(getattr(jvgg, cfg_fn)()),
                               U=jnp.asarray(U), **kw)
    tg = texp.HeatmapGenerator(specs=tvgg.build_layer_specs(getattr(tvgg, cfg_fn)()), U=U,
                               device="cpu", **kw)
    assert (tg.class_idx, tg.num_classes, tg._input_size) == \
        (jg.class_idx, jg.num_classes, jg._input_size)
    assert tg._input_size == hw
    inv = next(s for s in tg.specs_proj if s.kind == "invprojection")
    jinv = next(s for s in jg.specs_proj if s.kind == "invprojection")
    assert inv.config["map_hw"] == jinv.config["map_hw"]
    assert tg.composite.name_map == texp.class_composite(nm, K).name_map
    assert tg.device == torch.device("cpu") and tg.info == {}


def test_generator_needs_cuda_without_a_device(monkeypatch, toy):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tspecs, tparams, nm, U, _ = toy
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.HeatmapGenerator(specs=tspecs, params=tparams, U=U, name_map=nm,
                              sample_class="class1")
    a = np.zeros((1, 3, U.shape[0]), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.compute_subspace_relevances(a, a, U, K)


@pytest.mark.parametrize("mode", [{"class_idx": 1}, {"num_classes": 2}])
def test_fast_path_equals_repeated_path(toy, mode):
    """The port's fast path against its own repeat-interleave scheme, and
    that scheme against the JAX package's, in the single-class and the
    balanced all-class mode."""
    jspecs, jparams, tspecs, tparams, nm, U, x = toy
    x = x[:2]
    tsp = t_insert(tspecs, LAYER, t(U), K, input_size=(64, 64))
    comp = texp.class_composite(nm, K)
    slow, logits_s = texp.subspace_heatmaps_repeated(tsp, tparams, t(x), comp, K, **mode)
    assert slow.shape == (2, K + 1, 64, 64) and logits_s.shape == (2 * (K + 1), 2)
    fast, logits = texp.subspace_heatmaps(tsp, tparams, t(x), comp, K, **mode)
    assert_close_lrp(fast, slow)
    assert_close_lrp(logits, logits_s[::K + 1])
    jsp = j_insert(jspecs, LAYER, jnp.asarray(U), K, input_size=(64, 64))
    want, want_logits = jexp.subspace_heatmaps_repeated(jsp, jparams, jnp.asarray(x),
                                                        jexp.class_composite(nm, K), K, **mode)
    assert_close_lrp(slow, want)
    assert_close_lrp(logits_s, want_logits)


def test_compute_subspace_relevances_matches_jax(rng):
    d, n = 8, 5
    U = signed_permutation(4, d) @ np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    a, c = (rng.standard_normal((3, n, d)).astype(np.float32) for _ in range(2))
    got = texp.compute_subspace_relevances(a, c, U, 2, device="cpu")
    want = np.asarray(jexp.compute_subspace_relevances(a, c, jnp.asarray(U), 2))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    x = (a @ U) * (c @ U)
    np.testing.assert_allclose(got.numpy(), x.reshape(3, n, 2, 4).sum(axis=(1, 3)), rtol=1e-4,
                               atol=1e-5)
    two_d = texp.compute_subspace_relevances(t(a[0]), t(c[0]), t(U), 2, device="cpu")
    np.testing.assert_allclose(two_d.numpy(), got.numpy()[:1], rtol=1e-6)
