"""The port's workflow CLIs end to end on the CPU, in-process through each
``main(argv)`` with ``--device cpu`` (guide: tests/test_scripts_cli.py):
the toy chain generate -> train -> extract -> optimise -> evaluate ->
sonify at tiny sizes, the demo and the recovery experiment at tiny depth,
the GTZAN-synth workflow, and every CLI raising without a card unless the
CPU is named. What is checked: the files of the JAX layout and their
shapes, U orthogonal to 1e-4 (the Newton-Schulz step's round-off), finite
AUPCs, scores and CIs, finite WAVs of the sonified length."""

import json
import os

import numpy as np
import pytest
import torch

from drsa_audio_tpu_torch.models.train import save_checkpoint, split_trainable
from drsa_audio_tpu_torch.models.vgg import build_layer_specs, gtzan_6s_config, init_params
from drsa_audio_tpu_torch.runtime.wavio import read_wav
from drsa_audio_tpu_torch.scripts import (
    concept_recovery_experiment, demo_toy_workflow, extract_drsa_data, generate_gtzan_synth,
    generate_toydata, optimize_subspaces, run_concept_eval, run_gtzan_synth_workflow,
    sonify_prototypes, train)
from drsa_audio_tpu_torch.utils.evaluation import load_projection_matrix

TOY_WAV_LEN = 240 * 63          # the toy's hop x (mel width - 1): istft of 64 frames
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: with several test workers on the host, torch's
    intra-op thread pools contend and the CLIs take minutes instead of
    seconds. One thread for this module's work, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _orthogonal(U, tol=1e-4):
    return np.abs(U.T @ U - np.eye(U.shape[0])).max() <= tol


@pytest.fixture(scope="module")
def toy_chain(tmp_path_factory):
    """The toy workflow's directories after every stage ran once."""
    w = tmp_path_factory.mktemp("toy_cli")
    d = {k: str(w / k) for k in ("data", "model", "drsa", "sub", "eval", "son")}
    generate_toydata.main(["--out", d["data"], "--per-class", "12", "--seed", "1", *CPU])
    train.main(["--case", "toy", "--data", d["data"], "--out", d["model"], "--epochs", "2",
                "--batch-size", "8", *CPU])
    model = ["--case", "toy", "--data", d["data"], "--checkpoint", d["model"], *CPU]
    extract_drsa_data.main([*model, "--out", d["drsa"], "--layers", "10",
                            "--num-locations", "8"])
    optimize_subspaces.main(["--data", d["drsa"], "--out", os.path.join(d["sub"], "2_concepts"),
                             "--num-concepts", "2", "--steps", "20", "--runs", "2", *CPU])
    run_concept_eval.main([*model, "--subspaces", d["sub"], "--out", d["eval"],
                           "--num-concepts", "2", "--layers", "10", "--algorithms", "drsa",
                           "random", "--interclass-layer", "10"])
    sonify_prototypes.main([*model, "--subspaces", os.path.join(d["sub"], "2_concepts"),
                            "--out", d["son"], "--sample-class", "class1", "--layer", "10",
                            "--num-concepts", "2", "--subset-size", "4"])
    return d


def test_generate_and_train_write_the_corpus_and_checkpoint(toy_chain):
    splits = {s: open(os.path.join(toy_chain["data"], f"{s}_split.txt")).read().split()
              for s in ("train", "valid", "test")}
    assert [len(splits[s]) for s in ("train", "valid", "test")] == [16, 2, 6]
    assert sorted(os.listdir(toy_chain["model"])) == ["ckpt_2.pt", "train_stats_0.csv"]


@pytest.mark.parametrize("cls", ["class1", "class2"])
def test_extract_writes_the_jax_layout(toy_chain, cls):
    arr = np.load(os.path.join(toy_chain["drsa"], cls, "dataset_layer10.npz"))
    assert sorted(arr.files) == ["activations", "contexts"]
    assert arr["activations"].shape == arr["contexts"].shape == (12 * 8, 16)
    assert np.isfinite(arr["contexts"]).all() and (arr["activations"] >= 0).all()


@pytest.mark.parametrize("cls", ["class1", "class2"])
def test_optimize_writes_orthogonal_runs(toy_chain, cls):
    layer_dir = os.path.join(toy_chain["sub"], "2_concepts", cls, "layer10")
    assert sorted(os.listdir(layer_dir)) == ["run1", "run2"]
    for run in ("run1", "run2"):
        assert sorted(os.listdir(os.path.join(layer_dir, run))) == [
            "projection_matrix.npy", "train_stats.csv"]
        U = np.load(os.path.join(layer_dir, run, "projection_matrix.npy"))
        assert U.shape == (16, 16) and _orthogonal(U)
    assert _orthogonal(load_projection_matrix(layer_dir))


def test_concept_eval_writes_finite_scores_and_cis(toy_chain):
    out = toy_chain["eval"]
    assert sorted(os.listdir(out)) == sorted([
        "drsa_aupcs_k2_layer10.npy", "standard_same_layer10.npy",
        "drsa_sep_peak_scores_k2_layer10.npz", "random_sep_peak_scores_k2_layer10.npz",
        "drsa_sep_peak_k2.npy", "random_sep_peak_k2.npy", "sep_peak_analysis.json",
        "interclass_layer10.npy", "interclass_layer10_samples.npy", "interclass_layer10_ci.json",
        "standard_R.npy", "drsa_vs_standard_ci.json"])
    # the eval batch: each class's test split (3 clips) under samples_per_class
    for name in ("drsa_aupcs_k2_layer10", "standard_same_layer10", "standard_R"):
        a = np.load(os.path.join(out, f"{name}.npy"))
        assert a.shape == (2, 3) and np.isfinite(a).all(), name
    assert np.load(os.path.join(out, "interclass_layer10.npy")).shape == (2, 2)
    assert np.load(os.path.join(out, "interclass_layer10_samples.npy")).shape == (2, 2, 3)
    assert np.load(os.path.join(out, "drsa_sep_peak_k2.npy")).shape == (2, 1, 2)
    scores = np.load(os.path.join(out, "random_sep_peak_scores_k2_layer10.npz"))
    assert scores["sep"].shape == (6,) and np.isfinite(scores["peak_pos"]).all()
    analysis = json.load(open(os.path.join(out, "sep_peak_analysis.json")))["k2_layer10"]
    cis = json.load(open(os.path.join(out, "drsa_vs_standard_ci.json")))["k2_layer10"]
    gap = json.load(open(os.path.join(out, "interclass_layer10_ci.json")))
    for lo_hi in ([analysis[m]["ci95"] for m in ("sep", "peak", "sep_pos", "peak_pos")]
                  + [cis[k]["ci95"] for k in ("same_composite", "scaled_gamma_04")]
                  + [gap["ci95"]]):
        assert np.isfinite(lo_hi).all() and lo_hi[0] <= lo_hi[1]


def test_sonify_writes_finite_wavs_and_the_manifest(toy_chain):
    out = toy_chain["son"]
    manifest = json.load(open(os.path.join(out, "prototypes.json")))
    assert manifest["sample_class"] == "class1" and manifest["layer"] == 10
    assert len(manifest["objectives"]) == 3            # 12 clips in subsets of 4
    assert manifest["subset_index"] == int(np.argmax(manifest["objectives"]))
    assert len(manifest["prototypes"]) == 4
    assert [p.get("sonified", False) for p in manifest["prototypes"]] == [True, True, False,
                                                                         False]
    wavs = [f for f in os.listdir(out) if f.endswith(".wav")]
    assert len(wavs) == 2 * 3
    for f in wavs:
        w, sr = read_wav(os.path.join(out, f))
        assert sr == 16000 and w.shape == (1, TOY_WAV_LEN) and np.isfinite(w).all()


def test_demo_toy_workflow_at_tiny_depth(tmp_path, capsys):
    out = str(tmp_path / "demo")
    demo_toy_workflow.main(["--out", out, "--per-class", "16", "--epochs", "1", "--steps", "10",
                            *CPU])
    assert sorted(os.listdir(out)) == [
        "aupc.png", "drsa_objective.png", "explanation_concept1.wav",
        "explanation_concept2.wav", "explanation_standard.wav", "explanations.png",
        "original.wav"]
    for f in ("explanation_concept1.wav", "explanation_standard.wav"):
        w, _ = read_wav(os.path.join(out, f))
        assert w.shape == (1, TOY_WAV_LEN) and np.isfinite(w).all()
    text = capsys.readouterr().out
    for phase in ("generate", "train", "drsa_data", "drsa_fit", "explain", "concept_recovery",
                  "flipping", "sonify"):
        assert f"\n{phase} " in text


def test_concept_recovery_experiment_at_tiny_depth(tmp_path):
    out = str(tmp_path / "report.json")
    concept_recovery_experiment.main(["--out", out, "--per-class", "16", "--epochs", "1",
                                      "--steps", "10", "--runs", "2", *CPU])
    report = json.load(open(out))
    assert 0.0 <= report["heldout_all4_accuracy"] <= 1.0
    assert sorted(report["classes"]) == ["class1", "class2"]
    for entry in report["classes"].values():
        assert sorted(entry) == sorted([
            "final_objective", "assignment", "coverage", "diversity", "separability",
            "random_separability_mean", "random_coverage_mean", "random_diversity_mean"])
        assert np.isfinite([v for k, v in entry.items() if k != "assignment"]).all()
        assert len(entry["assignment"]) == 4


def test_gtzan_synth_workflow_extracts_and_optimises(tmp_path, capsys):
    """Two songs a genre: fold 1 is held out of extraction, and with one
    song a genre that song is fold 1's. The model is the 6 s flagship at
    seeded random weights, saved as the train CLI saves it."""
    corpus, rd = str(tmp_path / "corpus"), str(tmp_path / "run")
    generate_gtzan_synth.main(["--out", corpus, "--songs-per-genre", "2", "--multi-concept",
                               *CPU])
    trainable, state = split_trainable(init_params(build_layer_specs(gtzan_6s_config()), 0,
                                                   device="cpu"))
    save_checkpoint(os.path.join(rd, "model"), trainable, state, {}, 1,
                    torch.Generator().get_state())
    run_gtzan_synth_workflow.main(["--data", corpus, "--run-dir", rd, "--layers", "33",
                                   "--num-clips", "2", "--steps", "5", "--runs", "1",
                                   "--skip", "eval", "prototypes", *CPU])
    text = capsys.readouterr().out
    assert text.count("=== ") == 4 and "workflow complete" in text
    assert json.load(open(os.path.join(rd, "config.json")))["eval"]["samples_per_class"] == 20
    for cls in ("blues", "pop"):
        arr = np.load(os.path.join(rd, "drsa_data", cls, "dataset_layer33.npz"))
        assert arr["activations"].shape == (2 * 20, 128)
        U = load_projection_matrix(os.path.join(rd, "subspaces", "4_concepts", cls, "layer33"))
        assert _orthogonal(U)
    assert not os.path.exists(os.path.join(rd, "eval"))


CLIS = {
    "generate_toydata": (generate_toydata, ["--out", "x"]),
    "generate_gtzan_synth": (generate_gtzan_synth, ["--out", "x"]),
    "train": (train, ["--case", "toy", "--data", "x", "--out", "y"]),
    "extract_drsa_data": (extract_drsa_data, ["--data", "x", "--checkpoint", "y", "--out", "z"]),
    "optimize_subspaces": (optimize_subspaces, ["--data", "x", "--out", "y"]),
    "run_concept_eval": (run_concept_eval, ["--data", "x", "--checkpoint", "y",
                                            "--subspaces", "z", "--out", "w"]),
    "sonify_prototypes": (sonify_prototypes, ["--data", "x", "--checkpoint", "y",
                                              "--subspaces", "z", "--out", "w",
                                              "--sample-class", "pop", "--layer", "33"]),
    "demo_toy_workflow": (demo_toy_workflow, ["--out", "x"]),
    "concept_recovery_experiment": (concept_recovery_experiment, ["--out", "x"]),
    "run_gtzan_synth_workflow": (run_gtzan_synth_workflow, ["--data", "x", "--run-dir", "y"]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_without_device_raises_without_a_card(name, tmp_path, monkeypatch):
    """CUDA unless --device names another: with no card, before any file
    is read or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    module, argv = CLIS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert os.listdir(tmp_path) == []
