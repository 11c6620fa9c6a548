"""The port's data layer (drsa_audio_tpu_torch.data.datasets), config tree
(utils.config), evaluation utilities (utils.evaluation) and training CLI
(scripts.train) against the JAX package's, on corpora written inside the
test, on the CPU.

Tolerances: lists, feeds, labels and configs equal; mels at the log-mel
tolerance, rtol 1e-4, atol 1e-4 in log10 units; predictions equal (inputs
far from a tie).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from drsa_audio_tpu.data import datasets as jds
from drsa_audio_tpu.models import vgg as jvgg
from drsa_audio_tpu.utils import config as jcfg
from drsa_audio_tpu.utils import evaluation as jeval
from drsa_audio_tpu_torch.data import datasets as tds
from drsa_audio_tpu_torch.data.toydata import generate_dataset
from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.runtime.wavio import write_wav
from drsa_audio_tpu_torch.utils import config as tcfg
from drsa_audio_tpu_torch.utils import evaluation as teval
from drsa_audio_tpu_torch.utils.convert import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gtzan_corpus(tmp_path_factory):
    """2 genres x 4 clips x 30 s at 16 kHz, 5 folds; also the fold lists at
    the root, as get_songlist_random reads them."""
    root = tmp_path_factory.mktemp("gtzan")
    rng = np.random.default_rng(0)
    folds = {k: [] for k in range(1, 6)}
    for g in ("pop", "metal"):
        os.makedirs(root / "genres_original" / g)
        for i in range(4):
            rel = f"{g}/{g}.{i:05d}.wav"
            wav = np.clip(rng.standard_normal((1, 30 * 16000)) * 0.2, -1, 1).astype(np.float32)
            write_wav(str(root / "genres_original" / rel), wav, 16000)
            folds[i % 5 + 1].append(rel)
    os.makedirs(root / "5folds")
    for k, items in folds.items():
        for d in (root / "5folds", root):
            with open(d / f"fold_{k}.txt", "w") as f:
                f.write("\n".join(items) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def toy_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    generate_dataset(str(root), datapoints_per_class=12, seed=0)   # 8/1/3 a class
    return str(root)


def test_list_utilities_match_jax(gtzan_corpus, toy_corpus):
    for excluded in (None, [1], [2, 3]):
        assert (tds.get_songs_of_genre(gtzan_corpus, "pop", excluded)
                == jds.get_songs_of_genre(gtzan_corpus, "pop", excluded))
    for genre in (None, "metal"):
        for as_list in (True, False):
            assert (tds.get_songlist(gtzan_corpus, genre, [1], return_list=as_list)
                    == jds.get_songlist(gtzan_corpus, genre, [1], return_list=as_list))
    assert tds.get_songlist_random(gtzan_corpus) == jds.get_songlist_random(gtzan_corpus)
    for cls in (None, "class2"):
        for split in (None, "valid"):
            assert (tds.get_toy_samplelist(toy_corpus, cls, split)
                    == jds.get_toy_samplelist(toy_corpus, cls, split))
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    songs = [f"s{i}" for i in range(10)]
    starts = np.arange(10) * 0.5
    t = tds.shuffle_and_truncate(data, songs, 6, seed=3, startpoints=starts)
    j = jds.shuffle_and_truncate(data, songs, 6, seed=3, startpoints=starts)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1] == j[1]
    np.testing.assert_array_equal(t[2], j[2])


def test_feeds_match_jax(gtzan_corpus, toy_corpus):
    """The toy and GTZAN feeds give the JAX package's batches, in its order
    (the same numpy seeds), two epochs each; the device cache gives the
    same as tensors."""
    for split in ("train", "valid"):
        t = tds.ToyWaveDataset(toy_corpus, split, batch_size=4, seed=1)
        j = jds.ToyWaveDataset(toy_corpus, split, batch_size=4, seed=1)
        for _ in range(2):
            for (tw, tl), (jw, jl) in zip(t, j, strict=True):
                np.testing.assert_array_equal(tw, jw)
                np.testing.assert_array_equal(tl, jl)
        t = tds.GtzanWaveDataset(gtzan_corpus, split, batch_size=3, seed=2)
        j = jds.GtzanWaveDataset(gtzan_corpus, split, batch_size=3, seed=2)
        d = tds.GtzanWaveDataset(gtzan_corpus, split, batch_size=3, seed=2, device_cache=True,
                                 device="cpu")
        for _ in range(2):
            for (tw, tl), (jw, jl), (dw, dl) in zip(t, j, d, strict=True):
                assert tw.shape[1] == 29 * 16000
                np.testing.assert_array_equal(tw, np.asarray(jw))
                np.testing.assert_array_equal(tl, jl)
                assert torch.is_tensor(dw) and torch.is_tensor(dl)
                np.testing.assert_array_equal(dw.numpy(), tw)
                np.testing.assert_array_equal(dl.numpy(), tl)
    tr, va = tds.get_data_loaders(gtzan_corpus, batch_size=16)
    assert (tr.batch_size, va.batch_size, tr.shuffle, va.shuffle) == (16, 2, True, False)
    loaders = tds.get_toydata_loaders(toy_corpus, batch_size=8)
    assert [ld.shuffle for ld in loaders] == [True, False, False]
    if not torch.cuda.is_available():       # the device cache is on CUDA unless named
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tds.GtzanWaveDataset(gtzan_corpus, "train", device_cache=True)


def test_loaders_match_jax(gtzan_corpus, toy_corpus):
    """Loader, get_songs_drsa, get_songs_toy and get_data_main: mels at the
    log-mel tolerance, paths and startpoints equal."""
    path = tds.get_songlist(gtzan_corpus, "pop")[0]
    for case, n in (("gtzan", 3), ("gtzan_6s", 1)):
        got = tds.Loader(case, device="cpu").load(path, num_chunks=n, startpoint=2.5)
        want = np.asarray(jds.Loader(case).load(path, num_chunks=n, startpoint=2.5))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    t = tds.get_songs_drsa(gtzan_corpus, "metal", N=7, num_chunks=4, num_songs=3, device="cpu")
    j = jds.get_songs_drsa(gtzan_corpus, "metal", N=7, num_chunks=4, num_songs=3)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4, atol=1e-4)
    assert t[1] == j[1]
    np.testing.assert_array_equal(t[2], j[2])
    t = tds.get_songs_toy(toy_corpus, "class1", "train", N=3, device="cpu")
    j = jds.get_songs_toy(toy_corpus, "class1", "train", N=3)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4, atol=1e-4)
    assert t[1] == j[1]
    genres = {"pop": 0, "metal": 1}
    t = tds.get_data_main(gtzan_corpus, 2, fold=None, num_chunks=2, genres=genres, device="cpu")
    j = jds.get_data_main(gtzan_corpus, 2, fold=None, num_chunks=2, genres=genres)
    assert t[0].shape == (8, 1, 128, 128)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4, atol=1e-4)
    assert t[1] == j[1]


def test_config_json_crosses_packages(tmp_path):
    """A config written by either package loads in the other to the same
    asdict; the VGG configs and rule maps agree."""
    for name in ("toy_default", "gtzan_6s_default", None):
        tc = getattr(tcfg.ExperimentConfig, name)() if name else tcfg.ExperimentConfig()
        jc = getattr(jcfg.ExperimentConfig, name)() if name else jcfg.ExperimentConfig()
        tc.train.batch_size = 7
        jc.train.batch_size = 7
        tc.save(str(tmp_path / "t.json"))
        jc.save(str(tmp_path / "j.json"))
        assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
        from_t = jcfg.ExperimentConfig.load(str(tmp_path / "t.json"))
        from_j = tcfg.ExperimentConfig.load(str(tmp_path / "j.json"))
        assert dataclasses.asdict(from_t) == dataclasses.asdict(
            tcfg.ExperimentConfig.load(str(tmp_path / "t.json")))
        assert dataclasses.asdict(from_j) == dataclasses.asdict(
            jcfg.ExperimentConfig.load(str(tmp_path / "j.json")))
        # the port's VGGConfig also takes a depth per block and the dense
        # layers one by one; None keeps the JAX package's uniform fields
        port_vgg = dataclasses.asdict(from_j.vgg_config())
        assert port_vgg.pop("block_depths") is None and port_vgg.pop("dense_layers") is None
        assert port_vgg == dataclasses.asdict(from_t.vgg_config())
        assert from_j.lrp_name_map == from_t.lrp_name_map
        assert isinstance(from_j.vgg_config(), tvgg.VGGConfig)


def test_evaluation_utilities_match_jax():
    """get_acc over flat toy batches and 5-D chunked GTZAN-shaped batches,
    get_cm and class_accs."""
    jspecs = jvgg.build_layer_specs(jvgg.toy_config())
    tspecs = tvgg.build_layer_specs(tvgg.toy_config())
    jparams = jvgg.init_params(jspecs, jax.random.PRNGKey(1))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    chunked = [(rng.standard_normal((3, 2, 1, 64, 64)).astype(np.float32), np.array([0, 1, 1]))
               for _ in range(2)]
    flat = [(rng.standard_normal((5, 1, 64, 64)).astype(np.float32), np.array([0, 1, 0, 1, 1]))]
    for batches, is_toy in ((chunked, False), (flat, True)):
        ta, tt, tp = teval.get_acc(tspecs, tparams, batches, is_toy=is_toy)
        ja, jt, jp = jeval.get_acc(jspecs, jparams, batches, is_toy=is_toy)
        assert ta == ja
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tp, jp)
    ytrue, ypred = rng.integers(0, 10, 50), rng.integers(0, 10, 50)
    np.testing.assert_array_equal(teval.get_cm(ytrue, ypred, 10), jeval.get_cm(ytrue, ypred, 10))
    cm = teval.get_cm(ytrue, ypred)
    assert teval.class_accs(cm) == jeval.class_accs(cm)
    assert teval.class_accs(cm[:2, :2], {"class1": 0, "class2": 1}) == \
        jeval.class_accs(cm[:2, :2], {"class1": 0, "class2": 1})


def test_train_cli_one_toy_epoch_then_resume(toy_corpus, tmp_path):
    """python -m drsa_audio_tpu_torch.scripts.train --case toy --device cpu:
    one epoch writes ckpt_1.pt and the stats CSV; --resume-epoch 1 trains a
    second from it."""
    out = tmp_path / "run"
    base = [sys.executable, "-m", "drsa_audio_tpu_torch.scripts.train", "--case", "toy",
            "--data", toy_corpus, "--out", str(out), "--device", "cpu", "--batch-size", "8"]
    r = subprocess.run(base + ["--epochs", "1"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "epoch 1: train" in r.stdout and "final valid acc" in r.stdout
    assert sorted(os.listdir(out)) == ["ckpt_1.pt", "train_stats_0.csv"]
    stats = teval.get_train_stats(str(out / "train_stats_0.csv"))
    assert len(stats["train_loss"]) == 1 and np.isfinite(stats["train_loss"]).all()
    r = subprocess.run(base + ["--epochs", "1", "--resume-epoch", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert sorted(os.listdir(out)) == ["ckpt_1.pt", "ckpt_2.pt", "train_stats_0.csv",
                                       "train_stats_1.csv"]
    if not torch.cuda.is_available():       # without --device: CUDA, raising here
        from drsa_audio_tpu_torch.scripts.train import main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--case", "toy", "--data", toy_corpus, "--out", str(tmp_path / "no_card")])
