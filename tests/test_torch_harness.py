"""The port's evaluation harness (drsa_audio_tpu_torch.xai.eval.harness)
against the JAX package's, mirroring tests/test_prototypes_and_harness.py
and tests/test_eval_stats.py, on the CPU: the toy model and a narrow 3s
model, bridged weights, signed-permutation U.

Tolerances: heatmaps rtol 1e-4, atol 1e-5 * max|ref| (assert_close_lrp);
AUPC rtol 1e-4, atol 1e-5 * max|preds| (preds the port's per-instance
scores). The two packages' heatmaps agree only to that bound, so a patch
ranking can differ where two patch sums lie within it: AUPC is compared on
the clips whose keep masks agree at every step under both packages' maps,
and the tests assert how many do. Inputs hold no max-pool window within
POOL_MARGIN of a tie in the JAX forward (asserted)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.xai.eval import harness as jh
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.utils.convert import from_jax_params
from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
from drsa_audio_tpu_torch.xai.eval import flipping as tflip
from drsa_audio_tpu_torch.xai.eval import harness as th
from drsa_audio_tpu_torch.xai.eval.harness import configuration_name
from test_torch_util import (
    POOL_MARGIN, assert_close_lrp, both_models, jit_init_params, signed_permutation, tie_margins,
    to_np)

K, LAYER = 4, 10
GRID = [{"convolutional": ("gamma", 0.4), "dense": ("epsilon", 1e-7),
         "first_layer": ("wsquare",)},
        {"convolutional": ("zplus",), "dense": ("epsilon", 1e-7), "first_layer": ("flat",)}]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small LRP passes: with several test workers on the host,
    torch's intra-op thread pools contend. One thread per test here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    """(JAX specs, JAX params, port specs, port params, name map, d, input
    [4, 1, 64, 64], two per class)."""
    jspecs, jparams, tspecs, tparams, nm, _, d, hw, _ = both_models("toy")
    x = np.random.default_rng(1).standard_normal((4, 1) + hw).astype(np.float32)
    return jspecs, jparams, tspecs, tparams, nm, d, x


@pytest.fixture(scope="module")
def narrow3s():
    """The 3s layer list at narrow widths in both packages, and one clip
    per class [10, 1, 128, 128]."""
    widths = {"n_filters": (4, 4, 8, 8, 16), "n_dense": 16}
    jspecs = jvgg.build_layer_specs(dataclasses.replace(jvgg.gtzan_3s_config(), **widths))
    jparams = jit_init_params(jspecs, 0)
    tspecs = tvgg.build_layer_specs(dataclasses.replace(tvgg.gtzan_3s_config(), **widths))
    # seed 1: pool margin 1.4e-6 (seeds 0-11 range from 4.8e-8 to 1.4e-6)
    x = np.random.default_rng(1).standard_normal((10, 1, 128, 128)).astype(np.float32)
    assert tie_margins(jspecs, jparams, x)[0] >= POOL_MARGIN["gtzan3s"]
    return jspecs, jparams, tspecs, from_jax_params(to_np(jparams), device="cpu"), x


def _keep(R, p):
    """Keep masks [steps, b, P] of maps R [b, k, h, w] (the port's functions)."""
    R = torch.as_tensor(np.asarray(R, np.float32))
    gh, gw = R.shape[-2] // p, R.shape[-1] // p
    return tflip._cumulative_masks(tflip.rank_patches(R, p),
                                   tflip.quadratic_schedule(gh * gw)).numpy()


def _aupc_where_orders_agree(got_aupc, want_aupc, got_R, want_R, p, preds, least):
    """AUPC of the clips whose keep masks agree at every step under both
    maps; at least ``least`` clips must."""
    agree = (_keep(got_R, p) == _keep(want_R, p)).all(axis=(0, 2))
    assert agree.sum() >= least, agree
    np.testing.assert_allclose(np.asarray(got_aupc).reshape(-1)[agree],
                               np.asarray(want_aupc).reshape(-1)[agree],
                               rtol=1e-4, atol=1e-5 * np.abs(preds).max())


def test_rule_tables_match_jax():
    jspecs = jvgg.build_layer_specs(jvgg.gtzan_6s_config())
    tspecs = tvgg.build_layer_specs(tvgg.gtzan_6s_config())
    for kind, value in (("gamma", 0.25), ("epsilon", None), ("epsilon", 1e-7),
                        ("alphabeta", 2.0), ("zplus", None), ("wsquare", None)):
        assert th.make_rule(kind, value) == jh.make_rule(kind, value)
    for conf in GRID + [{"convolutional": ("alphabeta", 2.0), "dense": ("epsilon", 1e-7),
                         "first_layer": ("flat",)}]:
        assert th.configuration_name(conf) == jh.configuration_name(conf)
    assert th.configuration_name(GRID[0]) == "gamma_0.4_epsilon_1e-07_wsquare"
    for gamma, first in ((0.4, "wsquare"), (0.25, "flat")):
        nm = th.scaled_gamma_name_map(tspecs, gamma, 1e-7, first)
        assert nm == jh.scaled_gamma_name_map(jspecs, gamma, 1e-7, first)
        assert dict(nm)["features.0"][0] == first and dict(nm)["classifier.0"][0] == "epsilon"


def test_pixelflipping_matches_jax(toy):
    """The sweep of two configurations, then the first under the
    scaled-gamma composite (which needs a gamma value)."""
    jspecs, jparams, tspecs, tparams, _, _, x = toy
    assert tie_margins(jspecs, jparams, x)[0] >= POOL_MARGIN["toy"]
    jpf = jh.PixelFlipping(jspecs, jparams, x, perturbation_size=16, num_classes=2)
    tpf = th.PixelFlipping(tspecs, tparams, x, perturbation_size=16, num_classes=2, device="cpu")
    for grid, scaled in ((GRID, False), (GRID[:1], True)):
        want_aupc, want_mean, want_flips, want_R = jpf(grid, scaled_gamma=scaled)
        got_aupc, got_mean, got_flips, got_R = tpf(grid, scaled_gamma=scaled)
        assert got_aupc.keys() == want_aupc.keys() == {configuration_name(c) for c in GRID}
        np.testing.assert_array_equal(got_flips, want_flips)
        for name in want_aupc:
            assert got_aupc[name].shape == (2, 2)
            assert_close_lrp(got_R[name], want_R[name])
            preds = tpf.flipper.predictions(tpf._fwd, x, got_R[name])[0]
            _aupc_where_orders_agree(got_aupc[name], want_aupc[name], got_R[name],
                                     want_R[name], 16, preds, 4)


def test_pixelflipping_narrow_3s_matches_jax(narrow3s):
    """Ten classes, one clip each, scaled gamma (the standard-LRP baseline
    of scripts/run_concept_eval.py)."""
    jspecs, jparams, tspecs, tparams, x = narrow3s
    want = jh.PixelFlipping(jspecs, jparams, x, perturbation_size=16)(GRID[:1], scaled_gamma=True)
    tpf = th.PixelFlipping(tspecs, tparams, x, perturbation_size=16, device="cpu")
    got = tpf(GRID[:1], scaled_gamma=True)
    (name,) = want[0]
    assert got[0][name].shape == (10, 1)
    assert_close_lrp(got[3][name], want[3][name])
    preds = tpf.flipper.predictions(tpf._fwd, x, got[3][name])[0]
    _aupc_where_orders_agree(got[0][name], want[0][name], got[3][name], want[3][name], 16,
                             preds, 8)


def test_pixelflipping_chunked_attribution_matches(toy):
    """Per-class chunks of one clip, forwards of three: the maps and the
    AUPC of the one-pass attribution; an unbalanced batch is refused."""
    _, _, tspecs, tparams, _, _, x = toy
    one = th.PixelFlipping(tspecs, tparams, x, perturbation_size=16, num_classes=2,
                           device="cpu")
    chunked = th.PixelFlipping(tspecs, tparams, x, perturbation_size=16, num_classes=2,
                               attr_batch_size=1, forward_batch=3, device="cpu")
    a1, _, _, h1 = one(GRID[:1])
    a2, _, _, h2 = chunked(GRID[:1])
    (name,) = a1
    assert_close_lrp(h2[name], h1[name])
    preds = one.flipper.predictions(one._fwd, x, h1[name])[0]
    np.testing.assert_allclose(a2[name], a1[name], rtol=1e-4, atol=1e-5 * np.abs(preds).max())
    uneven = th.PixelFlipping(tspecs, tparams, x[:3], perturbation_size=16, num_classes=2,
                              attr_batch_size=1, device="cpu")
    with pytest.raises(ValueError, match="balanced"):
        uneven(GRID[:1])


def test_pixelflipping_scaled_gamma_after_plain_is_fresh(toy):
    """The same configuration under scaled_gamma after a plain sweep gives
    what a fresh instance gives (the composite follows the mode)."""
    _, _, tspecs, tparams, _, _, x = toy
    reused = th.PixelFlipping(tspecs, tparams, x, perturbation_size=16, num_classes=2,
                              device="cpu")
    plain = reused(GRID[:1])[3]
    plain = {k: v.copy() for k, v in plain.items()}
    got = reused(GRID[:1], scaled_gamma=True)
    want = th.PixelFlipping(tspecs, tparams, x, perturbation_size=16, num_classes=2,
                            device="cpu")(GRID[:1], scaled_gamma=True)
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
        np.testing.assert_array_equal(got[3][k], want[3][k])
        assert not np.array_equal(got[3][k], plain[k])


def test_concept_flipping_matches_jax(toy):
    jspecs, jparams, tspecs, tparams, nm, d, x = toy
    Us = {"class1": signed_permutation(3, d), "class2": signed_permutation(4, d)}
    for i, cls in enumerate(Us):
        jsp = j_insert(jspecs, LAYER, jnp.asarray(Us[cls]), K, input_size=(64, 64))
        assert tie_margins(jsp, jparams, x[2 * i:2 * i + 2])[0] >= POOL_MARGIN["toy"]
    want = jh.concept_flipping(jspecs, jparams, x, nm, LAYER, Us, case="toy", perturbation_size=16)
    got = th.concept_flipping(tspecs, tparams, x, nm, LAYER, Us, case="toy", perturbation_size=16,
                              device="cpu")
    assert got[0].shape == (2, 2) and got[3].shape == (4, K, 64, 64)
    assert_close_lrp(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    f = tflip.Flipper(16, device="cpu")
    preds = f.predictions(lambda t: tvgg.forward(tspecs, tparams, t), x, got[3][:, :, None])[0]
    _aupc_where_orders_agree(got[0], want[0], got[3], want[3], 16, preds, 4)
    chunked = th.concept_flipping(tspecs, tparams, x, nm, LAYER, Us, case="toy",
                                  perturbation_size=16, attr_batch_size=1, forward_batch=5,
                                  device="cpu")
    assert_close_lrp(chunked[3], got[3])
    np.testing.assert_allclose(chunked[0], got[0], rtol=1e-4, atol=1e-5 * np.abs(preds).max())


def test_interclass_concept_flipping_matches_jax(toy):
    """Every class's U over every class's clips, per-instance samples."""
    jspecs, jparams, tspecs, tparams, nm, d, x = toy
    Us = {"class1": signed_permutation(5, d), "class2": signed_permutation(6, d)}
    for U in Us.values():
        jsp = j_insert(jspecs, LAYER, jnp.asarray(U), K, input_size=(64, 64))
        assert tie_margins(jsp, jparams, x)[0] >= POOL_MARGIN["toy"]
    kw = dict(layer_idcs=(LAYER,), num_concepts=K, case="toy", perturbation_size=16)
    want = jh.interclass_concept_flipping(jspecs, jparams, x, nm, {LAYER: Us},
                                          return_samples=True, **kw)
    got = th.interclass_concept_flipping(tspecs, tparams, x, nm, {LAYER: Us},
                                         return_samples=True, device="cpu", **kw)
    assert len(got) == 1 and got[0].shape == (2, 2, 2)
    for row, cls in enumerate(Us):
        # each row's maps, from the same generators as the harness
        R = th._class_heatmaps(tspecs, tparams, torch.as_tensor(x), [Us[cls]] * 2,
                               ["class1", "class2"], nm, K, LAYER, "toy", 32, torch.device("cpu"))
        jR = jh.concept_flipping(jspecs, jparams, x, nm, LAYER, {c: Us[cls] for c in Us},
                                 case="toy", perturbation_size=16)[3]
        assert_close_lrp(R, jR)
        preds = tflip.Flipper(16, device="cpu").predictions(
            lambda t: tvgg.forward(tspecs, tparams, t), x, R[:, :, None])[0]
        _aupc_where_orders_agree(got[0][row], want[0][row], R, jR, 16, preds, 4)
    means = th.interclass_concept_flipping(tspecs, tparams, x, nm, {LAYER: Us}, device="cpu",
                                           **kw)
    np.testing.assert_allclose(means[0], got[0].mean(axis=-1), rtol=1e-6)


def test_cf_random_subspace_draws_documented_us(toy):
    """The last permutation's maps are those of the documented draw: U from
    the first child of SeedSequence(seed), each permutation from the next;
    seeded, so a second call repeats them."""
    _, _, tspecs, tparams, nm, d, x = toy
    got = th.cf_random_subspace(tspecs, tparams, x, nm, LAYER, d, case="toy", permutations=2,
                                seed=3, device="cpu")
    kq, _, k2 = np.random.SeedSequence(3).spawn(3)
    Up = random_orthogonal(kq, d)[:, np.random.default_rng(k2).permutation(d)]
    want = th._class_heatmaps(tspecs, tparams, torch.as_tensor(x), [Up] * 2, ["class1", "class2"],
                              nm, K, LAYER, "toy", 32, torch.device("cpu"))
    assert got.shape == (4, K, 64, 64) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    again = th.cf_random_subspace(tspecs, tparams, x, nm, LAYER, d, case="toy", permutations=2,
                                  seed=3, device="cpu")
    np.testing.assert_array_equal(again, got)


def test_harness_needs_cuda_unless_named(monkeypatch, toy):
    _, _, tspecs, tparams, nm, d, x = toy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.PixelFlipping(tspecs, tparams, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.concept_flipping(tspecs, tparams, x, nm, LAYER, {}, case="toy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.cf_random_subspace(tspecs, tparams, x, nm, LAYER, d, case="toy")
