"""The port's workflow CLIs against the JAX package's scripts on the same
inputs, on the CPU. Both sides run their CLI's main in this process, the
JAX scripts under runpy with their command line in sys.argv.

- Generators: the same seed writes the same WAV bytes and split or fold
  lists (toy; GTZAN-synth with one song a genre, both recipes).
- The shared checkpoint: a JAX toy checkpoint (JAX init_params from
  PRNGKey(39) and save_checkpoint), converted with from_jax_params and the port's
  save_checkpoint into ckpt_1.pt; each package's CLIs read their own.
- Extraction: --num-locations the layer map's h*w, so every position is
  drawn once under either package's draws: each clip's rows, sorted, match.
- Evaluation (--algorithms drsa) and prototypes on the same JAX-written Us
  (signed permutations, whose products are exact in float32; a generic U
  splits the maps by round-off of U U^T, ROADMAP Queue 3 item 1). The JAX
  evaluation is the library calls of its script's main in the script's
  order (``jax_eval``), which also return the maps the keep masks are
  compared on: a run of the script, then of the maps, would push this file
  past a minute on one worker.
- Cross-loading: each package reads the other's run directories and .npz.

Tolerances: LRP rtol 1e-4, atol 1e-5 * max|ref| (activations, relevances,
sep/peak scores); the Flipper's rtol 1e-4, atol 1e-5 * max|ref| (AUPC,
on the clips whose keep masks agree under both packages' maps); the
sonification's atol 1e-5 * max|ref|, rtol 1e-4 (test_torch_sonify.py) on
float waveforms, which the CLIs write as 16-bit PCM: the WAVs are held to
one PCM step, and to the same code on all but 0.1% of the samples (a
waveform within the tolerance rounds to the other code only at a rounding
boundary).
No clip holds a max-pool window within POOL_MARGIN of a tie in the JAX
forward (asserted per clip): of weight seeds 0-69 on this corpus, 39 is the
first whose 24 clips all hold the margin (most seeds leave 2-5 below it).
Both packages read the port's corpus, which the JAX script's equals."""

import filecmp
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models import train as jtrain
from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.models.projection import insert_projection as j_insert
from drsa_audio_tpu.utils import evaluation as jeval
from drsa_audio_tpu.utils.constants import LRP_NAME_MAP_TOY
from drsa_audio_tpu.data import datasets as jdata
from drsa_audio_tpu_torch.models import train as ttrain
from drsa_audio_tpu_torch.scripts import (
    extract_drsa_data, generate_gtzan_synth, generate_toydata, run_concept_eval,
    sonify_prototypes)
from drsa_audio_tpu_torch.utils import evaluation as teval
from drsa_audio_tpu_torch.utils.convert import from_jax_params
from drsa_audio_tpu_torch.runtime.wavio import read_wav
from test_torch_util import (
    POOL_MARGIN, jit_init_params, signed_permutation, tie_margins, to_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, LAYER, D = 4, 10, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: with several test workers on the host, torch's
    intra-op thread pools contend and the CLIs take minutes instead of
    seconds. One thread for this module's work, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_script(name: str, *argv: str) -> None:
    """The JAX package's scripts/{name}.py main, in this process."""
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    old = sys.argv
    sys.argv = [path, *argv]
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old


def assert_close_ref(got, want, rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _same_files(a: str, b: str) -> list:
    names = sorted(os.path.relpath(os.path.join(dp, f), a)
                   for dp, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(dp, f), b)
                           for dp, _, fs in os.walk(b) for f in fs)
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == []
    return names


# ----------------------------------------------------------- generators

@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("cli_parity")


@pytest.fixture(scope="module")
def toy_data(work):
    port, ref = str(work / "toy_port"), str(work / "toy_jax")
    generate_toydata.main(["--out", port, "--per-class", "12", "--seed", "1", "--device", "cpu"])
    jax_script("generate_toydata", "--out", ref, "--per-class", "12", "--seed", "1")
    return port, ref


def test_generate_toydata_writes_the_jax_scripts_bytes(toy_data):
    names = _same_files(*toy_data)
    assert sum(n.endswith(".wav") for n in names) == 24
    assert {"train_split.txt", "valid_split.txt", "test_split.txt", "all4.txt"} <= set(names)


@pytest.mark.parametrize("recipe", [[], ["--multi-concept"]])
def test_generate_gtzan_synth_writes_the_jax_scripts_bytes(tmp_path, recipe):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--songs-per-genre", "1", "--seed", "3", *recipe]
    generate_gtzan_synth.main(["--out", port, *argv, "--device", "cpu"])
    jax_script("generate_gtzan_synth", "--out", ref, *argv)
    names = _same_files(port, ref)
    assert sum(n.endswith(".wav") for n in names) == 10
    assert sorted(n for n in names if n.startswith("5folds")) == [
        f"5folds/fold_{k}.txt" for k in range(1, 6)]


# ------------------------------------------------------- the checkpoint

@pytest.fixture(scope="module")
def checkpoints(work):
    """(JAX orbax directory, the port's directory): the same toy weights,
    epoch 1."""
    jspecs = jvgg.build_layer_specs(jvgg.toy_config())
    params = jit_init_params(jspecs, 39)          # init_params' values, jitted
    trainable, state = jtrain.split_trainable(params)
    opt_state = jtrain.make_optimizer(1e-4).init(trainable)
    jdir, tdir = str(work / "model_jax"), str(work / "model_port")
    jtrain.save_checkpoint(jdir, trainable, state, opt_state, 1, jax.random.PRNGKey(1))
    ck = jtrain.load_checkpoint(jdir)
    bridged = from_jax_params(to_np(jtrain.merge_params(ck["trainable"], ck["state"] or {})),
                              device="cpu")
    t_trainable, t_state = ttrain.split_trainable(bridged)
    ttrain.save_checkpoint(tdir, t_trainable, t_state, {}, 1, torch.Generator().get_state())
    return jdir, tdir


def test_the_converted_checkpoint_holds_the_jax_weights(checkpoints):
    jdir, tdir = checkpoints
    ck = jtrain.load_checkpoint(jdir)
    tk = ttrain.load_checkpoint(tdir)
    assert sorted(os.listdir(tdir)) == ["ckpt_1.pt"] and tk["epoch"] == 1
    for name, p in ck["trainable"].items():
        assert np.array_equal(tk["trainable"][name]["weight"].numpy(), np.asarray(p["w"]))
        assert np.array_equal(tk["trainable"][name]["bias"].numpy(), np.asarray(p["b"]))


@pytest.fixture(scope="module")
def jax_model(checkpoints):
    jspecs = jvgg.build_layer_specs(jvgg.toy_config())
    ck = jtrain.load_checkpoint(checkpoints[0])
    return jspecs, jax.tree.map(jnp.asarray,
                                jtrain.merge_params(ck["trainable"], ck["state"] or {}))


def test_no_clip_holds_a_pool_near_tie(toy_data, jax_model):
    """Per clip, the JAX forward's pool margin with the projection of a
    signed permutation at layer 10 (the same forward as without it)."""
    jspecs, jparams = jax_model
    jsp = j_insert(jspecs, LAYER, jnp.asarray(signed_permutation(0, D)), K, input_size=(64, 64))
    for cls in ("class1", "class2"):
        mels = jdata.get_songs_toy(toy_data[0], cls)[0]
        pools = [tie_margins(jsp, jparams, mels[i:i + 1])[0] for i in range(len(mels))]
        assert min(pools) >= POOL_MARGIN["toy"], (cls, pools)


# ----------------------------------------------------------- extraction

@pytest.fixture(scope="module")
def extracted(work, toy_data, checkpoints):
    """(the port's, the JAX script's) extraction roots at every position of
    the 8x8 layer-10 map."""
    out = (str(work / "drsa_port"), str(work / "drsa_jax"))
    common = ["--case", "toy", "--data", toy_data[0], "--layers", str(LAYER),
              "--num-locations", "64"]
    extract_drsa_data.main([*common, "--checkpoint", checkpoints[1], "--out", out[0],
                            "--device", "cpu"])
    jax_script("extract_drsa_data", *common, "--checkpoint", checkpoints[0], "--out", out[1])
    return out


def _sorted_rows(arr, clips):
    """Per clip, its [positions, 2d] rows (activation, relevance R = c * (a
    + 1e-7)) sorted by a fixed random projection: the positions' order is
    each package's own draw."""
    a = arr["activations"].reshape(clips, -1, D).astype(np.float64)
    r = arr["contexts"].reshape(clips, -1, D) * (a + 1e-7)
    rows = np.concatenate([a, r], axis=-1)
    key = rows @ np.random.default_rng(0).standard_normal(2 * D)
    return np.take_along_axis(rows, np.argsort(key, axis=1)[..., None], axis=1)


@pytest.mark.parametrize("cls", ["class1", "class2"])
def test_extraction_matches_jax_at_every_position(extracted, cls):
    port, ref = (np.load(os.path.join(root, cls, f"dataset_layer{LAYER}.npz"))
                 for root in extracted)
    assert port["activations"].shape == ref["activations"].shape == (12 * 64, D)
    got, want = _sorted_rows(port, 12), _sorted_rows(ref, 12)
    assert_close_ref(got[..., :D], want[..., :D])
    assert_close_ref(got[..., D:], want[..., D:])


# ---------------------------------------------------------- evaluation

@pytest.fixture(scope="module")
def jax_us(work):
    """A JAX-written run per class at layer 10 (save_drsa_run): signed
    permutations, one run each; {class: U}."""
    root = str(work / "subspaces")
    us = {cls: signed_permutation(5 + i, D) for i, cls in enumerate(("class1", "class2"))}
    for cls, U in us.items():
        jeval.save_drsa_run(os.path.join(root, f"{K}_concepts", cls, f"layer{LAYER}", "run1"),
                            jnp.asarray(U), jnp.linspace(0.1, 0.5, 5))
    return root, us


def jax_eval(out: str, data: str, checkpoint: str, subspaces: str):
    """What the JAX package's scripts/run_concept_eval.py main does for
    ``--case toy --algorithms drsa --num-concepts 4 --layers 10``: its
    library calls in its order, writing the same files (a run of the script
    would compile every program a second time for the maps this test
    compares the keep masks on). Returns (concept maps [b, K, h, w], the
    scaled-gamma 0.4 standard maps)."""
    from drsa_audio_tpu.utils.config import ExperimentConfig
    from drsa_audio_tpu.xai.eval import harness as jh
    from drsa_audio_tpu.xai.eval import metrics as jm
    from drsa_audio_tpu.xai.eval.flipping import Flipper
    cfg = ExperimentConfig.toy_default()
    ck = jtrain.load_checkpoint(checkpoint)
    specs, params = jvgg.fold_batchnorm(jvgg.build_layer_specs(cfg.vgg_config()),
                                        jtrain.merge_params(ck["trainable"], ck["state"] or {}))
    spc, ps = cfg.eval.samples_per_class, cfg.eval.perturbation_size
    batch = np.concatenate([jdata.get_songs_toy(data, c, split="test", N=spc)[0][:spc]
                            for c in ("class1", "class2")])
    os.makedirs(out)
    Us = {c: jeval.load_projection_matrix(os.path.join(subspaces, f"{K}_concepts", c,
                                                       f"layer{LAYER}"))
          for c in ("class1", "class2")}
    aupc, _, _, RU = jh.concept_flipping(specs, params, batch, LRP_NAME_MAP_TOY, LAYER, Us,
                                         num_concepts=K, case="toy", perturbation_size=ps,
                                         forward_batch=512, attr_batch_size=32)
    np.save(os.path.join(out, f"drsa_aupcs_k{K}_layer{LAYER}.npy"), aupc)
    fwd = jax.jit(lambda t: jvgg.forward(specs, params, t))
    a_std, _, _ = Flipper(ps, forward_batch=512)(fwd, jnp.asarray(batch),
                                                 jnp.asarray(RU).sum(axis=1)[:, None, None])
    np.save(os.path.join(out, f"standard_same_layer{LAYER}.npy"), np.asarray(a_std))
    RU_pos = np.clip(RU, 0.0, None)
    np.savez(os.path.join(out, f"drsa_sep_peak_scores_k{K}_layer{LAYER}.npz"),
             sep=jm.separability_scores(RU), peak=jm.peakness_scores(RU),
             sep_pos=jm.separability_scores(RU_pos), peak_pos=jm.peakness_scores(RU_pos),
             neg_mass=jm.negative_mass_fraction(RU), cancellation=jm.cancellation_factor(RU))
    np.save(os.path.join(out, f"drsa_sep_peak_k{K}.npy"),
            np.array([[jm.separability(RU)], [jm.peakness(RU)]]))
    grid = [{"convolutional": ("gamma", 0.4), "dense": ("epsilon", 1e-7),
             "first_layer": ("wsquare",)}]
    pf = jh.PixelFlipping(specs, params, batch, perturbation_size=ps, num_classes=2,
                          forward_batch=512, attr_batch_size=32)
    scores, _, _, heatmaps = pf(grid, scaled_gamma=True)
    (name,) = scores
    np.save(os.path.join(out, "standard_R.npy"), scores[name])
    return np.asarray(RU), heatmaps[name]


@pytest.fixture(scope="module")
def evaluated(work, toy_data, checkpoints, jax_us):
    """(the port CLI's output, the JAX package's), and per eval clip whether
    its keep masks agree at every flipping step under the two packages'
    maps: the concept maps' sum (the DRSA and same-composite standard
    flips) and the scaled-gamma 0.4 standard maps. The port's maps come
    from its library on the CLI's model and batch."""
    from drsa_audio_tpu_torch.data.datasets import get_songs_toy
    from drsa_audio_tpu_torch.scripts.common import load_model
    from drsa_audio_tpu_torch.utils.config import ExperimentConfig
    from drsa_audio_tpu_torch.xai.eval import flipping as tflip
    from drsa_audio_tpu_torch.xai.eval import harness as th

    out = (str(work / "eval_port"), str(work / "eval_jax"))
    run_concept_eval.main(["--case", "toy", "--data", toy_data[0], "--subspaces", jax_us[0],
                           "--num-concepts", str(K), "--layers", str(LAYER),
                           "--algorithms", "drsa", "--checkpoint", checkpoints[1],
                           "--out", out[0], "--device", "cpu"])
    jax_maps = jax_eval(out[1], toy_data[0], checkpoints[0], jax_us[0])

    specs, params = load_model(ExperimentConfig.toy_default(), checkpoints[1], None, "cpu")
    x = np.concatenate([get_songs_toy(toy_data[0], c, split="test", N=20, device="cpu")[0]
                        for c in ("class1", "class2")])
    RU = th.concept_flipping(specs, params, x, LRP_NAME_MAP_TOY, LAYER, jax_us[1],
                             num_concepts=K, case="toy", device="cpu")[3]
    grid = [{"convolutional": ("gamma", 0.4), "dense": ("epsilon", 1e-7),
             "first_layer": ("wsquare",)}]
    (std,) = th.PixelFlipping(specs, params, x, perturbation_size=16, num_classes=2,
                              device="cpu")(grid, scaled_gamma=True)[3].values()

    def keep(R):
        R = torch.as_tensor(np.array(R, np.float32))
        return tflip._cumulative_masks(tflip.rank_patches(R, 16),
                                       tflip.quadratic_schedule(16)).numpy()

    def agree(a, b):
        return (keep(a) == keep(b)).all(axis=(0, 2))

    return {"out": out, "maps": (RU, jax_maps[0]),
            "concept": agree(RU.sum(1, keepdims=True), jax_maps[0].sum(1, keepdims=True)),
            "standard": agree(std, jax_maps[1])}


def test_eval_writes_the_jax_files(evaluated):
    port = set(os.listdir(evaluated["out"][0]))
    assert set(os.listdir(evaluated["out"][1])) < port
    assert port - set(os.listdir(evaluated["out"][1])) == {"drsa_vs_standard_ci.json"}


def test_concept_maps_match_jax(evaluated):
    assert_close_ref(*evaluated["maps"])


@pytest.mark.parametrize("name,masks", [(f"drsa_aupcs_k{K}_layer{LAYER}", "concept"),
                                        (f"standard_same_layer{LAYER}", "concept"),
                                        ("standard_R", "standard")])
def test_eval_aupcs_match_jax_where_the_keep_masks_agree(evaluated, name, masks):
    port, ref = (np.load(os.path.join(root, f"{name}.npy")) for root in evaluated["out"])
    assert port.shape == ref.shape == (2, 3)
    ok = evaluated[masks].reshape(port.shape)
    assert ok.sum() >= 4, ok
    np.testing.assert_allclose(port[ok], ref[ok], rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_eval_sep_peak_scores_match_jax(evaluated):
    name = f"drsa_sep_peak_scores_k{K}_layer{LAYER}.npz"
    port, ref = (np.load(os.path.join(root, name)) for root in evaluated["out"])
    assert sorted(port.files) == sorted(ref.files)
    for key in ref.files:
        assert_close_ref(port[key], ref[key])
    port_t, ref_t = (np.load(os.path.join(root, f"drsa_sep_peak_k{K}.npy"))
                     for root in evaluated["out"])
    assert_close_ref(port_t, ref_t)


def test_eval_drsa_vs_standard_cis_match_jax(evaluated):
    """The JAX script's CIs of the same AUPCs (paired_diff_ci, its fixed
    resampling seed), where every clip's keep masks agree."""
    from drsa_audio_tpu.xai.eval.stats import paired_diff_ci
    assert evaluated["concept"].all() and evaluated["standard"].all()
    out_port, out_jax = evaluated["out"]
    got = json.load(open(os.path.join(out_port, "drsa_vs_standard_ci.json")))
    drsa = np.load(os.path.join(out_jax, f"drsa_aupcs_k{K}_layer{LAYER}.npy"))
    for key, ref in (("same_composite", f"standard_same_layer{LAYER}.npy"),
                     ("scaled_gamma_04", "standard_R.npy")):
        d, lo, hi = paired_diff_ci(drsa, np.load(os.path.join(out_jax, ref)))
        entry = got[f"k{K}_layer{LAYER}"][key]
        assert_close_ref([entry["mean_diff"], *entry["ci95"]], [d, lo, hi])
        assert entry["verdict"] == ("DRSA better" if hi < 0 else "standard better" if lo > 0
                                    else "not significant")


# ----------------------------------------------------------- prototypes

@pytest.fixture(scope="module")
def sonified(work, toy_data, checkpoints, jax_us):
    out = (str(work / "son_port"), str(work / "son_jax"))
    common = ["--case", "toy", "--data", toy_data[0],
              "--subspaces", os.path.join(jax_us[0], f"{K}_concepts"),
              "--sample-class", "class1", "--layer", str(LAYER), "--num-concepts", str(K),
              "--subset-size", "4"]
    sonify_prototypes.main([*common, "--checkpoint", checkpoints[1], "--out", out[0],
                            "--device", "cpu"])
    jax_script("sonify_prototypes", *common, "--checkpoint", checkpoints[0], "--out", out[1])
    return out


def test_prototypes_match_jax(sonified):
    port, ref = (json.load(open(os.path.join(root, "prototypes.json"))) for root in sonified)
    assert port["subset_index"] == ref["subset_index"]
    assert port["prototypes"] == ref["prototypes"]
    assert_close_ref(port["objectives"], ref["objectives"])
    assert {k: v for k, v in port.items() if k not in ("objectives", "subset_objective")} == {
        k: v for k, v in ref.items() if k not in ("objectives", "subset_objective")}


def test_prototype_wavs_match_jax(sonified):
    names = sorted(f for f in os.listdir(sonified[1]) if f.endswith(".wav"))
    assert names == sorted(f for f in os.listdir(sonified[0]) if f.endswith(".wav"))
    assert len(names) == 2 * (K + 1)
    for name in names:
        (got, sr), (want, sr_ref) = (read_wav(os.path.join(root, name)) for root in sonified)
        assert sr == sr_ref == 16000 and got.shape == want.shape
        steps = np.abs(got - want) * 32768.0
        assert steps.max() <= 1.0 and (steps > 0).mean() <= 1e-3, name


# ------------------------------------------------------- cross-loading

def test_each_package_reads_the_others_runs(work, extracted, jax_us):
    """The port's optimiser on the JAX script's extraction; the JAX
    package's load_projection_matrix on the port's runs, the port's on the
    JAX package's, and either's .npz through np.load."""
    from drsa_audio_tpu_torch.scripts import optimize_subspaces
    out = str(work / "sub_port")
    optimize_subspaces.main(["--data", extracted[1], "--out", out, "--num-concepts", "2",
                             "--steps", "5", "--runs", "2", "--device", "cpu"])
    for cls in ("class1", "class2"):
        layer_dir = os.path.join(out, cls, f"layer{LAYER}")
        best = teval.get_best_run(layer_dir)[2]
        U = np.load(os.path.join(best, "projection_matrix.npy"))
        assert np.array_equal(jeval.load_projection_matrix(layer_dir), U)
        assert jeval.get_best_run(layer_dir)[:2] == teval.get_best_run(layer_dir)[:2]
        jax_dir = os.path.join(jax_us[0], f"{K}_concepts", cls, f"layer{LAYER}")
        assert np.array_equal(teval.load_projection_matrix(jax_dir), jax_us[1][cls])
        for root in extracted:
            arr = np.load(os.path.join(root, cls, f"dataset_layer{LAYER}.npz"))
            assert arr["activations"].dtype == arr["contexts"].dtype == np.float32
