"""The port's scale-out (drsa_audio_tpu_torch.parallel, ExplainerService(mesh=),
clip_seeds, graft_entry) on the CPU: gloo groups of 2 and 3 spawned ranks
(tests/test_torch_parallel_workers.py, one spawn a group) against the JAX
package's sharded programs on the conftest's 8-device virtual mesh, and
against the port's own single-process programs. The toy model, its weights
bridged from the JAX ones.

Tolerances: heatmaps rtol 1e-4, atol 1e-6 (the JAX package's sharded
against single-device bound, tests/test_parallel.py); the explain pipeline
and the extraction at the LRP bound (rtol 1e-4, atol 1e-5 * max|ref|); the
train step loss rtol 1e-5, params rtol 1e-4, atol 1e-6; the service's
standard maps rtol 1e-4, atol 1e-7 (tests/test_serving.py). The training-mode
extraction is bit-equal to the single-process one at every world size.
Inputs hold no max-pool window within POOL_MARGIN of a tie (mels seed 0:
1.2e-6; waveforms seed 6: 1.9e-6)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.models.train import make_optimizer as j_optimizer
from drsa_audio_tpu.models.train import split_trainable as j_split
from drsa_audio_tpu.ops.frontend import FrontendConfig as JFrontend
from drsa_audio_tpu.parallel import sharding as jsh
from drsa_audio_tpu.xai.drsa.optimizer import random_orthogonal as j_ortho
from drsa_audio_tpu.xai.explain import class_composite as j_composite
from drsa_audio_tpu.xai.lrp.engine import Composite as JComposite
from drsa_audio_tpu_torch import graft_entry
from drsa_audio_tpu_torch.models import train as ttrain
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.parallel import sharding as tsh
from drsa_audio_tpu_torch.parallel.launch import launch
from drsa_audio_tpu_torch.serving import ExplainerService
from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_TOY
from drsa_audio_tpu_torch.xai.drsa import preprocessing as tpre
from drsa_audio_tpu_torch.xai.lrp.engine import Composite, lrp, output_mask_class
from test_torch_parallel_workers import (
    NO_DROPOUT, SMALL_BN, bn_draws, cases, np_tree, toy_step, torch_tree)
from test_torch_util import (
    POOL_MARGIN, assert_close_lrp, both_models, service_margins, signed_permutation, tie_margins)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jspecs, jparams, tspecs, tparams, nm, *_ = both_models("toy")
    x = np.random.default_rng(0).standard_normal((10, 1, 64, 64)).astype(np.float32)
    wavs = (np.random.default_rng(6).standard_normal((8, 16000)) * 0.3).astype(np.float32)
    U = signed_permutation(11, 16)
    assert tie_margins(jspecs, jparams, x)[0] >= POOL_MARGIN["toy"]
    assert service_margins(jspecs, jparams, 10, U, wavs, "toy")[0] >= POOL_MARGIN["toy"]
    data = {"params": np_tree(tparams), "x": x, "wavs": wavs, "U": U,
            "U_svc": np.asarray(j_ortho(jax.random.PRNGKey(5), 16))}
    return jspecs, jparams, tspecs, tparams, data


class Groups:
    """The spawned gloo groups of 2 and 3 ranks, started together in the
    background when the module's first test asks for them; ``groups[w]`` is
    every rank's results, waited for where a test reads them (after its
    JAX reference)."""

    def __init__(self, data):
        self.pool = ThreadPoolExecutor(2)
        self.futures = {w: self.pool.submit(launch, w, cases, (data,), device="cpu",
                                            timeout_s=300) for w in (2, 3)}

    def __getitem__(self, world):
        return self.futures[world].result()


@pytest.fixture(scope="module")
def ranks(setup):
    groups = Groups(setup[-1])
    yield groups
    groups.pool.shutdown(wait=True)


def _all_ranks_equal(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


def test_pad_to_multiple_matches_jax():
    for n, m in ((5, 8), (8, 8), (10, 3)):
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1
        got, want = tsh.pad_to_multiple(x, m), jsh.pad_to_multiple(x, m)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == n


def test_sharded_explain_pipeline_from_waveforms_matches_jax(setup, ranks):
    jspecs, jparams, *_, data = setup
    jsp = j_insert(jspecs, 10, jnp.asarray(data["U"]), 4)
    fn = jsh.sharded_explain_pipeline(jsp, jparams, j_composite(LRP_NAME_MAP_TOY, 4),
                                      jsh.get_mesh(), 4, class_idx=1,
                                      frontend_config=JFrontend.for_case("toy"))
    want = np.asarray(fn(data["wavs"]))
    got = _all_ranks_equal(ranks[2], "pipeline")
    assert got.shape == (8, 5, 64, 64)
    assert_close_lrp(got, want)
    assert [r["pipeline_rows"] for r in ranks[2]] == [[4], [4]]   # each rank its rows


@pytest.mark.parametrize("world,b", [(2, 8), (2, 10), (3, 10)])
def test_sharded_heatmaps_match_jax(setup, ranks, world, b):
    jspecs, jparams, *_, data = setup
    fn = jsh.sharded_heatmaps(jspecs, jparams, JComposite.from_list(LRP_NAME_MAP_TOY),
                              jsh.get_mesh(), class_idx=0)
    want = np.asarray(fn(data["x"][:b]))
    got = _all_ranks_equal(ranks[world], f"heat{b}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_sharded_heatmaps_with_a_rank_without_rows(setup, ranks):
    """Two clips over three ranks: ranks 0 and 1 explain one clip each, the
    third runs a zero row and keeps none."""
    _, _, tspecs, tparams, data = setup
    got = _all_ranks_equal(ranks[3], "heat2")
    assert got.shape == (2, 1, 64, 64)
    for i in range(2):
        want, _, _ = lrp(tspecs, tparams, torch.as_tensor(data["x"][i:i + 1]),
                         Composite.from_list(LRP_NAME_MAP_TOY), output_mask_class(0))
        np.testing.assert_array_equal(got[i:i + 1], want.numpy())


def test_sharded_train_step_matches_jax(setup, ranks):
    jspecs, jparams, *_, data = setup
    opt = j_optimizer(1e-2)
    trainable, state = j_split(jparams)
    step = jsh.make_sharded_train_step(jspecs, opt, jsh.get_mesh())
    want, _, _, loss, acc = step(trainable, state, opt.init(trainable), data["x"][:8],
                                 (np.arange(8) % 2).astype(np.int32), jax.random.PRNGKey(1))
    for r in ranks[2]:
        losses, accs, params = r["step8"]
        np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5)
        assert accs[0] == float(acc)
        for n, p in want.items():
            np.testing.assert_allclose(params[n]["weight"], np.asarray(p["w"]), rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(params[n]["bias"], np.asarray(p["b"]), rtol=1e-4,
                                       atol=1e-6)


def _single_steps(params, mels, labels, draws, specs=None, has_bn=False):
    """The port's single-process make_train_step on the global batches."""
    specs = specs or tvgg.build_layer_specs(tvgg.toy_config())
    trainable, _ = ttrain.split_trainable(params)
    step = ttrain.make_train_step(specs, ttrain.make_optimizer(trainable, 1e-2), has_bn=has_bn)
    out = [step(params, torch.as_tensor(m), torch.as_tensor(y), d)
           for m, y, d in zip(mels, labels, draws)]
    return [o[0].item() for o in out], [o[1].item() for o in out], np_tree(params)


def _steps_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == want[1]
    for n, p in want[2].items():
        for k, v in p.items():
            np.testing.assert_allclose(got[2][n][k], v, rtol=1e-4, atol=1e-6, err_msg=f"{n}.{k}")


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_train_step_at_uneven_blocks_matches_single_process(setup, ranks, world):
    """Ten clips: blocks of 5+5 and 4+3+3, the gradients weighted by each
    block's share of the global mean."""
    data = setup[-1]
    want = _single_steps(torch_tree(data["params"]), [data["x"]], [np.arange(10) % 2], [NO_DROPOUT])
    for r in ranks[world]:
        _steps_close(r["step10"], want)


def test_sharded_bn_step_uses_the_global_batch_statistics(setup, ranks):
    """Two steps of the narrow BatchNorm model at world 2 against the port's
    single-process steps on the global batch: loss, accuracy, params and
    running statistics."""
    x = setup[-1]["x"]
    specs = tvgg.build_layer_specs(tvgg.VGGConfig(**SMALL_BN))
    labels = np.arange(8) % 2
    want = _single_steps(tvgg.init_params(specs, seed=0, device="cpu"), [x[:8], x[2:]],
                         [labels, labels[::-1].copy()], bn_draws(specs, 8, 2), specs, True)
    for r in ranks[2]:
        _steps_close(r["bn_steps"], want)


def test_two_ranks_feeding_their_own_rows_match_single_process(setup, ranks):
    """global_from_local + replicate (rank 1's params are off until rank 0's
    are broadcast) give the single-process step on the whole batch."""
    data = setup[-1]
    want = _single_steps(torch_tree(data["params"]), [data["x"][:8]], [np.arange(8) % 2],
                         [NO_DROPOUT])
    for r in ranks[2]:
        _steps_close(r["step8_local"], want)
        np.testing.assert_array_equal(r["step8_local"][0], r["step8"][0])


def test_sharded_extraction_inference_matches_jax(setup, ranks):
    jspecs, jparams, *_, data = setup
    fn = jsh.sharded_drsa_extraction(jspecs, jparams, JComposite.from_list(LRP_NAME_MAP_TOY),
                                     jsh.get_mesh(), layer_idx=10, class_idx=0)
    want_a, want_c = (np.asarray(v) for v in fn(data["x"][:8], jax.random.PRNGKey(0)))
    got_a, got_c = _all_ranks_equal(ranks[2], "extract_infer")
    assert got_a.shape == want_a.shape == (8, 64, 16)
    assert_close_lrp(got_a, want_a)
    # the context vector as the relevance it carries: R = c * (a + 1e-7)
    assert_close_lrp(got_c * (got_a + 1e-7), want_c * (want_a + 1e-7))


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_extraction_training_mode_is_bit_equal(setup, ranks, world):
    """Per-clip seeds drawn for the whole batch before the split: ten clips
    over 2 or 3 ranks give the single-process preprocess_data's vectors."""
    _, _, tspecs, tparams, data = setup
    want = tpre.preprocess_data(tspecs, tparams, data["x"], Composite.from_list(LRP_NAME_MAP_TOY),
                                10, 0, num_locations=6, device="cpu",
                                clip_seeds=tpre.draw_clip_seeds(5, 10))
    for r in ranks[world]:
        assert r["extract_train"][0].shape == (60, 16)
        for got, w in zip(r["extract_train"], want):
            np.testing.assert_array_equal(got, w.numpy())


def test_get_mesh_size_and_axis_name(ranks):
    for world in (2, 3):
        assert [(r["rank"], r["size"], r["names"]) for r in ranks[world]] == [
            (i, world, ("data",)) for i in range(world)]
    mesh = tsh.get_mesh(device="cpu")                     # outside a group: a world of one
    assert isinstance(mesh, tsh.LocalMesh) and mesh.size() == 1
    assert mesh.mesh_dim_names == ("data",)
    with pytest.raises(ValueError, match="2 devices asked"):
        tsh.get_mesh(2, device="cpu")
    assert tsh.distributed_init(None) is None             # no address: a no-op


def test_clip_seeds_make_each_clip_independent_of_its_neighbours():
    """A clip's positions depend on its own seed alone; without clip_seeds
    the draws stay one generator's, clip after clip."""
    seeds = tpre.draw_clip_seeds(7, 5)
    both = tpre.sample_spatial_locations(None, 5, (8, 8), 6, clip_seeds=seeds)
    np.testing.assert_array_equal(
        tpre.sample_spatial_locations(None, 2, (8, 8), 6, clip_seeds=seeds[3:]), both[3:])
    g = torch.Generator().manual_seed(4)
    want = torch.stack([torch.randperm(64, generator=g)[:6] for _ in range(5)])
    np.testing.assert_array_equal(tpre.sample_spatial_locations(4, 5, (8, 8), 6), want)
    with pytest.raises(ValueError, match="2 clip seeds for 5 clips"):
        tpre.sample_spatial_locations(None, 5, (8, 8), 6, clip_seeds=seeds[:2])


def test_service_with_mesh_matches_service_without(setup, ranks):
    _, _, tspecs, tparams, data = setup
    svc = ExplainerService(tspecs, tparams, LRP_NAME_MAP_TOY, Us={"class1": data["U_svc"]},
                           num_concepts=2, layer_idx=10, case="toy", device="cpu")
    want = svc.explain(data["wavs"], "class1")
    for r in ranks[2]:
        got = r["service"]
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["standard_heatmaps"], want["standard_heatmaps"],
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-7)
        for k in got:
            np.testing.assert_array_equal(got[k], ranks[2][0]["service"][k])


def test_world_of_one_is_the_single_process_program_bit_for_bit(setup):
    """Outside a group (LocalMesh) every sharded program is its unsharded
    call: the heatmaps, the service and a train step."""
    _, _, tspecs, tparams, data = setup
    mesh = tsh.get_mesh(device="cpu")
    composite = Composite.from_list(LRP_NAME_MAP_TOY)
    got = tsh.sharded_heatmaps(tspecs, tparams, composite, mesh, 0)(data["x"][:4])
    want, _, _ = lrp(tspecs, tparams, torch.as_tensor(data["x"][:4]), composite,
                     output_mask_class(0))
    assert torch.equal(got, want)
    kw = dict(Us={"class1": data["U_svc"]}, num_concepts=2, layer_idx=10, case="toy",
              device="cpu")
    got = ExplainerService(tspecs, tparams, LRP_NAME_MAP_TOY, mesh=mesh, **kw)
    want = ExplainerService(tspecs, tparams, LRP_NAME_MAP_TOY, **kw)
    for k, v in want.explain(data["wavs"][:2], "class1").items():
        np.testing.assert_array_equal(got.explain(data["wavs"][:2], "class1")[k], v)
    labels = np.arange(4) % 2
    got = toy_step(mesh, torch_tree(data["params"]), [data["x"][:4]], [labels], [NO_DROPOUT])
    want = _single_steps(torch_tree(data["params"]), [data["x"][:4]], [labels], [NO_DROPOUT])
    assert got[0] == want[0] and got[1] == want[1]
    for n, p in want[2].items():
        for k, v in p.items():
            np.testing.assert_array_equal(got[2][n][k], v)


def test_entry_forward_shape():
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (8, 10) and torch.isfinite(out).all()


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip(n):
    out = graft_entry.dryrun_multichip(n, device="cpu")
    assert len(out) == n
    for r in out:
        assert r["heat_shape"] == (2 * n, 5, 64, 64) and r["heat_finite"]
        assert r["objectives"].shape == (n, 4)
        assert r["loss"] == out[0]["loss"]
        np.testing.assert_array_equal(r["objectives"], out[0]["objectives"])


def test_distributed_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
