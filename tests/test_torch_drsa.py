"""The port's DRSA path (drsa_audio_tpu_torch.xai.drsa: preprocessing,
optimizer, prototypes; utils.evaluation's run store) against the JAX
package's, mirroring tests/test_drsa.py and tests/test_prototypes_and_harness.py.

Where the JAX function draws random numbers (init_runs, the sampled
locations), the port is given JAX's draws: U0 passed to drsa_fit, the JAX
indices to gather_vectors. The port's own draws (numpy U0, torch.Generator
locations) are checked for their properties, not for JAX's values.

Tolerances: float32 vector and objective maths at rtol 1e-5 or 1e-4 as
stated at each test; optimiser trajectories at rtol 1e-4 over the first 5
steps and 2e-2 over all 30 (the JAX package's own trajectory bound against
a float64 oracle, tests/test_drsa.py); LRP maps at rtol 1e-4, atol
1e-5 * max|ref| (assert_close_lrp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.utils import evaluation as jeval
from drsa_audio_tpu.xai.drsa import optimizer as jopt
from drsa_audio_tpu.xai.drsa import preprocessing as jpre
from drsa_audio_tpu.xai.drsa import prototypes as jproto
from drsa_audio_tpu.xai.lrp.engine import Composite as JComposite
from drsa_audio_tpu_torch.utils import evaluation as teval
from drsa_audio_tpu_torch.xai.drsa import optimizer as topt
from drsa_audio_tpu_torch.xai.drsa import preprocessing as tpre
from drsa_audio_tpu_torch.xai.drsa import prototypes as tproto
from drsa_audio_tpu_torch.xai.lrp.engine import Composite as TComposite
from test_torch_util import POOL_MARGIN, assert_close_lrp, both_models, t, tie_margins

LAYER = 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The optimiser's steps are hundreds of tiny ops: with several test
    workers on the host, torch's intra-op thread pools contend on each of
    them and a 300-step fit takes minutes instead of a second. One thread
    per test here; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    """(JAX specs, JAX params, port specs, port params, JAX composite, port
    composite, input [6, 1, 64, 64] clear of max-pool ties)."""
    jspecs, jparams, tspecs, tparams, nm, _, _, _, _ = both_models("toy")
    x = np.random.default_rng(0).standard_normal((6, 1, 64, 64)).astype(np.float32)
    assert tie_margins(jspecs, jparams, x)[0] >= POOL_MARGIN["toy"]
    return jspecs, jparams, tspecs, tparams, JComposite.from_list(nm), TComposite.from_list(nm), x


def _vecs(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _near_orthogonal(rng, d):
    U = np.linalg.qr(rng.standard_normal((d, d)))[0]
    return (U + 0.05 * rng.standard_normal((d, d))).astype(np.float32)


# ------------------------------------------------------------ the objective

def test_subspace_relevances_and_objective_match_jax(rng):
    d, K, N = 16, 4, 64
    A, C, U = _vecs(rng, N, d), _vecs(rng, N, d), np.linalg.qr(rng.standard_normal((d, d)))[0]
    U = U.astype(np.float32)
    want = np.asarray(jopt.subspace_relevances(jnp.asarray(A), jnp.asarray(C), jnp.asarray(U), K))
    got = topt.subspace_relevances(t(A), t(C), t(U), K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    assert (got >= 0).all() and (got == 0).any()
    np.testing.assert_allclose(topt.objective_fn(got).item(),
                               float(jopt.objective_fn(jnp.asarray(want))), rtol=1e-5)
    np.testing.assert_allclose(topt.obj_val(t(A), t(C), t(U), K).item(),
                               float(jopt.obj_val(jnp.asarray(A), jnp.asarray(C),
                                                  jnp.asarray(U), K)), rtol=1e-5)


def test_masked_objective_matches_jax_and_trimmed(rng):
    rel = np.abs(rng.standard_normal((30, 4))).astype(np.float32)
    mask = np.zeros(30, np.float32)
    mask[:18] = 1.0
    got = topt.objective_fn(t(rel), t(mask)).item()
    np.testing.assert_allclose(got, float(jopt.objective_fn(jnp.asarray(rel), jnp.asarray(mask))),
                               rtol=1e-6)
    np.testing.assert_allclose(got, topt.objective_fn(t(rel[:18])).item(), rtol=1e-6)
    np.testing.assert_allclose(topt.generalized_fmean(t(rel), 2.0).numpy(),
                               np.asarray(jopt.generalized_fmean(jnp.asarray(rel), 2.0)),
                               rtol=1e-6)


def test_project_grad_matches_jax(rng):
    g, U = _vecs(rng, 8, 8), _near_orthogonal(rng, 8)
    np.testing.assert_allclose(topt.project_grad(t(g), t(U)).numpy(),
                               np.asarray(jopt.project_grad(jnp.asarray(g), jnp.asarray(U))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["eigh", "ns"])
def test_orthogonalize_matches_jax(rng, method):
    """The result, and that it is orthogonal; batched over leading axes as
    the batched fit calls it."""
    d = 32
    U = _near_orthogonal(rng, d)
    name = "orthogonalize_" + method
    want = np.asarray(getattr(jopt, name)(jnp.asarray(U)))
    got = getattr(topt, name)(t(U)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got.T @ got, np.eye(d), atol=5e-4)
    U2 = np.stack([U, _near_orthogonal(rng, d)])[None]           # [1, 2, d, d]
    batched = getattr(topt, name)(t(U2)).numpy()
    np.testing.assert_allclose(batched[0, 0], got, atol=1e-6)
    np.testing.assert_allclose(batched[0, 1], getattr(topt, name)(t(U2[0, 1])).numpy(),
                               atol=1e-6)


# -------------------------------------------------------------- the fit

@pytest.mark.parametrize("method", ["ns", "eigh"])
def test_drsa_fit_trajectory_matches_jax(rng, method):
    """30 steps from JAX's init_runs U0 (d 16, K 4, N 128, 3 runs)."""
    d, K, N, steps = 16, 4, 128, 30
    A = np.array(jpre.normalize_vectors(jnp.asarray(_vecs(rng, N, d))))
    C = np.array(jpre.normalize_vectors(jnp.asarray(_vecs(rng, N, d))))
    U0 = np.array(jopt.init_runs(jax.random.PRNGKey(3), d, 3))
    want = jopt.drsa_fit(jnp.asarray(U0), jnp.asarray(A), jnp.asarray(C), K, steps, method)
    got = topt.drsa_fit(U0, A, C, K, steps, method, device="cpu")
    objs, want_objs = got.objectives.numpy(), np.asarray(want.objectives)
    assert objs.shape == (3, steps + 1)
    np.testing.assert_allclose(objs[:, :6], want_objs[:, :6], rtol=1e-4)
    np.testing.assert_allclose(objs, want_objs, rtol=2e-2)
    assert int(got.best_run) == int(np.argmax(objs[:, -1]))
    assert (objs[:, -1] > objs[:, 0]).all()
    U = got.U.numpy()
    np.testing.assert_allclose(np.einsum("rji,rjk->rik", U, U), np.broadcast_to(np.eye(d), U.shape),
                               atol=1e-4)


def test_fit_batched_unequal_n_matches_jax(rng):
    """Two pairs of 40 and 25 vectors, padded and masked: the port's
    drsa_fit_batched from JAX's U0 against JAX's fit_batched, and the
    port's fit_batched against its own fit of each pair alone."""
    d, K, steps, runs, seed = 8, 2, 40, 2, 7
    data = [(_vecs(rng, 40, d), _vecs(rng, 40, d)), (_vecs(rng, 25, d), _vecs(rng, 25, d))]
    want = jopt.fit_batched(data, num_concepts=K, steps=steps, runs=runs, seed=seed)
    U0 = np.repeat(np.array(jopt.init_runs(jax.random.PRNGKey(seed), d, runs))[None], 2, 0)
    A, C, M = np.zeros((2, 40, d), np.float32), np.zeros((2, 40, d), np.float32), np.zeros((2, 40))
    for i, (a, c) in enumerate(data):
        A[i, :len(a)], C[i, :len(a)], M[i, :len(a)] = a, c, 1.0
    got = topt.drsa_fit_batched(U0, A, C, M, K, steps, device="cpu")
    np.testing.assert_allclose(got.objectives[..., :6].numpy(),
                               np.asarray(want.objectives)[..., :6], rtol=1e-4)
    np.testing.assert_allclose(got.objectives.numpy(), np.asarray(want.objectives), rtol=2e-2)

    mine = topt.fit_batched(data, num_concepts=K, steps=steps, runs=runs, seed=seed, device="cpu")
    assert mine.U.shape == (2, runs, d, d) and mine.best_run.shape == (2,)
    for i, (a, c) in enumerate(data):
        alone = topt.fit(a, c, num_concepts=K, steps=steps, runs=runs, seed=seed, device="cpu")
        np.testing.assert_allclose(mine.objectives[i].numpy(), alone.objectives.numpy(),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(mine.U[i].numpy(), alone.U.numpy(), rtol=1e-3, atol=1e-4)
        assert int(mine.best_run[i]) == int(alone.best_run)


def test_init_runs_are_permuted_columns_of_one_orthogonal_matrix():
    U0 = topt.init_runs(42, 16, 3)
    assert U0.shape == (3, 16, 16) and U0.dtype == np.float32
    np.testing.assert_allclose(U0[0].T @ U0[0], np.eye(16), atol=1e-5)
    for r in (1, 2):
        perm = [int(np.flatnonzero((U0[0] == U0[r][:, j][:, None]).all(0))[0]) for j in range(16)]
        assert sorted(perm) == list(range(16))
    assert not np.array_equal(U0[1], U0[2])
    np.testing.assert_array_equal(U0, topt.init_runs(42, 16, 3))


def test_fit_recovers_block_structure(rng):
    """Relevance in K hidden orthogonal blocks under a random rotation: the
    port's fit reaches well above a random U's objective and keeps U
    orthogonal (tests/test_drsa.py's synthetic case)."""
    d, K, N = 16, 4, 512
    d_k = d // K
    Za, Zc = np.zeros((N, d), np.float32), np.zeros((N, d), np.float32)
    for i in range(N):
        blk = slice((i % K) * d_k, (i % K + 1) * d_k)
        Za[i, blk] = rng.standard_normal(d_k)
        Zc[i, blk] = np.abs(rng.standard_normal(d_k)) * np.sign(Za[i, blk])
    Q = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    A, C = tpre.normalize_vectors(t(Za @ Q.T)), tpre.normalize_vectors(t(Zc @ Q.T))
    res = topt.fit(A, C, num_concepts=K, steps=300, runs=2, seed=0, device="cpu")
    best = int(res.best_run)
    baseline = topt.obj_val(A, C, t(topt.random_orthogonal(123, d)), K).item()
    assert res.objectives[best, -1].item() > 1.5 * baseline
    U = res.U[best].numpy()
    np.testing.assert_allclose(U.T @ U, np.eye(d), atol=3e-3)


def test_entry_points_need_cuda_without_a_device(monkeypatch, toy):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = np.zeros((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        topt.fit(A, A, num_concepts=2, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tproto.subset_objectives(A[:, None], A[:, None], np.eye(8, dtype=np.float32), 2, 2)
    _, _, tspecs, tparams, _, tcomp, x = toy
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.preprocess_data(tspecs, tparams, x, tcomp, LAYER, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.make_extract_fn(tspecs, tparams, tcomp, LAYER)
    with pytest.raises(RuntimeError, match="CUDA"):
        tproto.get_prototypes(tspecs, tparams, LAYER, np.eye(16, dtype=np.float32), tcomp, x,
                              num_concepts=2, n=2)


def test_fit_runs_under_inference_mode(rng):
    """A caller in inference mode (the service's and the generator's mode)
    fits as one outside it does, from inference tensors."""
    d, K, steps = 8, 2, 10
    data = [(_vecs(rng, 30, d), _vecs(rng, 30, d)), (_vecs(rng, 20, d), _vecs(rng, 20, d))]
    want = topt.fit(*data[0], num_concepts=K, steps=steps, runs=2, seed=5, device="cpu")
    want_b = topt.fit_batched(data, num_concepts=K, steps=steps, runs=2, seed=5, device="cpu")
    with torch.inference_mode():
        a, c = t(data[0][0]), t(data[0][1])
        assert a.is_inference()
        got = topt.fit(a, c, num_concepts=K, steps=steps, runs=2, seed=5, device="cpu")
        got_b = topt.fit_batched([(t(a_), t(c_)) for a_, c_ in data], num_concepts=K,
                                 steps=steps, runs=2, seed=5, device="cpu")
    assert torch.equal(got.objectives, want.objectives) and torch.equal(got.U, want.U)
    assert torch.equal(got_b.objectives, want_b.objectives) and torch.equal(got_b.U, want_b.U)


# ------------------------------------------------------------ extraction

def test_vector_helpers_match_jax(rng):
    v = _vecs(rng, 100, 16) * 3
    got = tpre.normalize_vectors(t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpre.normalize_vectors(jnp.asarray(v))), rtol=1e-6)
    np.testing.assert_allclose(np.sqrt((got ** 2).mean()) * 16 ** 0.25, 1.0, rtol=1e-5)
    a = np.asarray([[1.0, 2.0], [0.0, 4.0]], np.float32)
    r = np.asarray([[2.0, 2.0], [3.0, 8.0]], np.float32)
    c = tpre.compute_context_vectors(t(a), t(r)).numpy()
    np.testing.assert_array_equal(c, np.asarray(jpre.compute_context_vectors(jnp.asarray(a),
                                                                             jnp.asarray(r))))
    maps = _vecs(rng, 3, 5, 4, 6)
    np.testing.assert_array_equal(tpre.all_vectors(t(maps)).numpy(),
                                  np.asarray(jpre.all_vectors(jnp.asarray(maps))))


def test_gather_vectors_with_jax_indices(rng):
    maps = _vecs(rng, 4, 3, 8, 8)
    idcs = np.array(jpre.sample_spatial_locations(jax.random.PRNGKey(0), 4, (8, 8), 20))
    want = np.asarray(jpre.gather_vectors(jnp.asarray(maps), jnp.asarray(idcs)))
    got = tpre.gather_vectors(t(maps), idcs).numpy()
    assert got.shape == (80, 3)
    np.testing.assert_array_equal(got, want)


def test_sampled_locations_unique_and_in_range():
    idcs = tpre.sample_spatial_locations(0, 8, (8, 8), 20)
    assert idcs.shape == (8, 20) and idcs.dtype == torch.int64
    for row in idcs.tolist():
        assert len(set(row)) == 20 and 0 <= min(row) and max(row) < 64
    assert torch.equal(idcs, tpre.sample_spatial_locations(torch.Generator().manual_seed(0),
                                                           8, (8, 8), 20))
    assert not torch.equal(idcs[0], idcs[1])


def test_extract_maps_and_inference_mode_match_jax(toy):
    """Inference mode (every position), one pass and chunked by 4, against
    the JAX package."""
    jspecs, jparams, tspecs, tparams, jcomp, tcomp, x = toy
    want_a, want_c = jpre.preprocess_data(jspecs, jparams, jnp.asarray(x), jcomp, LAYER, 1)
    for chunk in (None, 4):
        a, c = tpre.preprocess_data(tspecs, tparams, x, tcomp, LAYER, 1, attr_batch_size=chunk,
                                    device="cpu")
        assert a.shape == (6, 64, 16) and not a.is_inference()
        assert_close_lrp(a, want_a)
        # c = R / (a + 1e-7): compared as R = c * (a + 1e-7), since the
        # division amplifies round-off where a is near 0
        assert_close_lrp(c * (a + 1e-7), np.asarray(want_c) * (np.asarray(want_a) + 1e-7))
    act, rel = tpre.extract_act_rel_maps(tspecs, tparams, t(x), tcomp, LAYER, 0)
    want = jpre.extract_act_rel_maps(jspecs, jparams, jnp.asarray(x), jcomp, LAYER, 0)
    assert_close_lrp(act, want[0])
    assert_close_lrp(rel, want[1])


def test_training_mode_matches_jax_at_the_ports_locations(toy):
    """Training mode, chunked by 4: the port's vectors are the JAX maps read
    at the positions the port's generator draws (the same draws again from
    the same seed)."""
    jspecs, jparams, tspecs, tparams, jcomp, tcomp, x = toy
    a, c = tpre.preprocess_data(tspecs, tparams, x, tcomp, LAYER, 0, num_locations=5,
                                generator=11, attr_batch_size=4, device="cpu")
    assert a.shape == c.shape == (30, 16)
    idcs = tpre.sample_spatial_locations(11, 6, (8, 8), 5).numpy()
    act, rel = jpre.extract_act_rel_maps(jspecs, jparams, jnp.asarray(x), jcomp, LAYER, 0)
    want_a = np.asarray(jpre.gather_vectors(act, jnp.asarray(idcs)))
    want_r = np.asarray(jpre.gather_vectors(rel, jnp.asarray(idcs)))
    assert_close_lrp(a, want_a)
    assert_close_lrp(c * (a + 1e-7), want_r)


def test_make_extract_fn_matches_eager_and_refuses_a_mismatch(toy):
    _, _, tspecs, tparams, _, tcomp, x = toy
    fn = tpre.make_extract_fn(tspecs, tparams, tcomp, LAYER, device="cpu")
    for cls in (0, 1):
        got, want = fn(t(x), cls), tpre.extract_act_rel_maps(tspecs, tparams, t(x), tcomp,
                                                              LAYER, cls)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    a1, c1 = tpre.preprocess_data(tspecs, tparams, x, tcomp, LAYER, 1, num_locations=5,
                                  generator=3, attr_batch_size=2, device="cpu")
    a2, c2 = tpre.preprocess_data(tspecs, tparams, x, tcomp, LAYER, 1, num_locations=5,
                                  generator=3, attr_batch_size=2, extract_fn=fn, device="cpu")
    assert torch.equal(a1, a2) and torch.equal(c1, c2)
    for bad in (dict(layer_idx=7), dict(composite=TComposite.from_list([])),
                dict(one_hot_encoded=True), dict(params=dict(tparams))):
        kw = {"layer_idx": LAYER, "composite": tcomp, "params": tparams, **bad}
        with pytest.raises(ValueError, match="extract_fn was built for a different"):
            tpre.preprocess_data(tspecs, kw["params"], x, kw["composite"], kw["layer_idx"], 0,
                                 one_hot_encoded=kw.get("one_hot_encoded", False),
                                 extract_fn=fn, device="cpu")
    elsewhere = tpre.make_extract_fn(tspecs, tparams, tcomp, LAYER, device="meta")
    with pytest.raises(ValueError, match="extract_fn was built for a different"):
        tpre.preprocess_data(tspecs, tparams, x, tcomp, LAYER, 0, extract_fn=elsewhere,
                             device="cpu")


# ------------------------------------------------------------ prototypes

def test_get_prototypes_matches_jax(toy):
    """Three subsets of 2 clips under one U: the same subset, its songs and
    startpoints, the objectives at rtol 1e-4."""
    jspecs, jparams, tspecs, tparams, jcomp, tcomp, x = toy
    U = topt.random_orthogonal(1, 16)
    songs = [f"song_{i}.wav" for i in range(6)]
    starts = np.linspace(0.0, 26.0, 6)
    want = jproto.get_prototypes(jspecs, jparams, LAYER, jnp.asarray(U), jcomp, x,
                                 num_concepts=2, n=2, class_idx=0, songs=songs, startpoints=starts)
    got = tproto.get_prototypes(tspecs, tparams, LAYER, U, tcomp, np.concatenate([x, x[:1]]),
                                num_concepts=2, n=2, class_idx=0, songs=songs + ["extra"],
                                startpoints=np.append(starts, 30.0), device="cpu")
    assert got.subset_index == want.subset_index
    assert got.objectives.shape == (3,)
    np.testing.assert_allclose(got.objectives, np.asarray(want.objectives), rtol=1e-4)
    assert got.songs == want.songs
    np.testing.assert_array_equal(got.startpoints, want.startpoints)
    assert got.act_vecs.shape == (2 * 64, 16)
    assert_close_lrp(got.act_vecs, want.act_vecs)


def test_subset_objectives_match_jax(rng):
    d, K, n, L = 8, 2, 5, 3
    U = topt.random_orthogonal(0, d)
    act, ctx = _vecs(rng, 20, L, d), _vecs(rng, 20, L, d)
    got = tproto.subset_objectives(t(act), t(ctx), U, K, n, device="cpu")
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jproto.subset_objectives(
        jnp.asarray(act), jnp.asarray(ctx), jnp.asarray(U), K, n)), rtol=1e-5)


# ------------------------------------------------------------- run store

def test_run_store_round_trip_both_ways(tmp_path, rng):
    """Runs saved by the port load in the port and in the JAX package, and
    a run the JAX package saved loads in the port; the best run by final
    objective, U bit-equal."""
    Us = [topt.random_orthogonal(i, 8) for i in range(3)]
    objs = [np.array([0.1, 0.4, f], np.float32) for f in (0.5, 0.9, 0.7)]
    for i in range(2):
        teval.save_drsa_run(str(tmp_path / "port" / f"run{i}"), t(Us[i]), t(objs[i]))
    jeval.save_drsa_run(str(tmp_path / "port" / "run2"), Us[2], objs[2])
    best_run, best, path, losses = teval.get_best_run(str(tmp_path / "port"))
    assert (best_run, path) == (1, str(tmp_path / "port" / "run1"))
    assert losses == [float(v) for v in objs[1]] and best == float(objs[1][-1])
    assert teval.get_run_stats(str(tmp_path / "port" / "run2" / "train_stats.csv")) == \
        jeval.get_run_stats(str(tmp_path / "port" / "run2" / "train_stats.csv"))
    got = teval.load_projection_matrix(str(tmp_path / "port"))
    assert got.dtype == np.float32 and np.array_equal(got, Us[1])
    assert np.array_equal(np.asarray(jeval.load_projection_matrix(str(tmp_path / "port"))), Us[1])
    jeval.save_drsa_run(str(tmp_path / "jax" / "run0"), Us[2], objs[2])
    assert np.array_equal(teval.load_projection_matrix(str(tmp_path / "jax")), Us[2])
