"""The port's numpy copies (drsa_audio_tpu_torch.xai.eval.metrics, .stats,
.concept_recovery and data.toydata) against the JAX package's modules, on
the same inputs. Same numpy code on the same inputs: every result bit-equal."""

import os

import numpy as np
import pytest

from drsa_audio_tpu.data import toydata as jtoy
from drsa_audio_tpu.xai.eval import concept_recovery as jcr
from drsa_audio_tpu.xai.eval import metrics as jmet
from drsa_audio_tpu.xai.eval import stats as jstats
from drsa_audio_tpu_torch.data import toydata as ttoy
from drsa_audio_tpu_torch.xai.eval import concept_recovery as tcr
from drsa_audio_tpu_torch.xai.eval import metrics as tmet
from drsa_audio_tpu_torch.xai.eval import stats as tstats


def _equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def RU():
    """Signed subspace heatmaps [b, K, h, w]."""
    return np.random.default_rng(0).standard_normal((6, 4, 16, 12)).astype(np.float32)


@pytest.mark.parametrize("name", ["separability_scores", "peakness_scores", "separability",
                                  "peakness", "cancellation_factor", "negative_mass_fraction"])
def test_metrics_match_jax(RU, name):
    _equal(getattr(tmet, name)(RU), getattr(jmet, name)(RU))


def test_frobenius_and_table_match_jax(RU):
    _equal(tmet.frobenius_distance(RU, 4), jmet.frobenius_distance(RU, 4))
    table = {2: [RU[:, :2], RU[:, 2:]], 4: [RU, RU * 0.5]}
    got = tmet.sep_and_peak_table(table)
    assert got.shape == (2, 4, 2)
    _equal(got, jmet.sep_and_peak_table(table))


def test_stats_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(0.3, 1.0, 40), rng.normal(0.0, 1.0, 40)
    _equal(tstats.bootstrap_ci(a, n_boot=500, seed=3), jstats.bootstrap_ci(a, n_boot=500, seed=3))
    _equal(tstats.paired_diff_ci(a, b, n_boot=500), jstats.paired_diff_ci(a, b, n_boot=500))
    t = rng.normal(1.0, 0.2, (3, 3, 7))
    _equal(tstats.interclass_gap_ci(t, n_boot=300, seed=2),
           jstats.interclass_gap_ci(t, n_boot=300, seed=2))
    _equal(tstats.sep_peak_stderr(a), jstats.sep_peak_stderr(a))


@pytest.mark.parametrize("cls", ["class1", "class2"])
def test_concept_recovery_matches_jax(cls):
    heat = np.random.default_rng(2).standard_normal((3, 4, 64, 32)).astype(np.float32)
    _equal(tcr.band_energy_profiles(heat), jcr.band_energy_profiles(heat))
    _equal(tcr.toy_concept_mel_bands(cls), jcr.toy_concept_mel_bands(cls))
    for relative in (True, False):
        _equal(tcr.band_assignment(heat, cls, relative=relative),
               jcr.band_assignment(heat, cls, relative=relative))
    _equal(tcr.profile_diversity(heat), jcr.profile_diversity(heat))


def test_toydata_tables_match_jax():
    assert ttoy.CLASS_PARAMS == jtoy.CLASS_PARAMS
    assert (ttoy.N, ttoy.SAMPLE_RATE, ttoy.EXP_SCALE) == (jtoy.N, jtoy.SAMPLE_RATE, jtoy.EXP_SCALE)


@pytest.mark.parametrize("cls", ["class1", "class2"])
@pytest.mark.parametrize("concepts", [None, (1,), (2, 3), (1, 2, 3, 4)])
def test_toydata_sample_matches_jax(cls, concepts):
    for seed in range(3):
        _equal(ttoy.generate_sample(np.random.default_rng(seed), cls, concepts),
               jtoy.generate_sample(np.random.default_rng(seed), cls, concepts))


def test_toydata_batch_matches_jax():
    _equal(ttoy.generate_batch(7, "class2", 5), jtoy.generate_batch(7, "class2", 5))
    _equal(ttoy.generate_batch(np.random.default_rng(8), "class1", 3, concept_idcs=(4,)),
           jtoy.generate_batch(np.random.default_rng(8), "class1", 3, concept_idcs=(4,)))


def test_toydata_dataset_matches_jax(tmp_path):
    """The same files (WAVs through each package's write_wav) and splits."""
    got = ttoy.generate_dataset(str(tmp_path / "port"), datapoints_per_class=4, seed=5)
    want = jtoy.generate_dataset(str(tmp_path / "jax"), datapoints_per_class=4, seed=5)
    _equal(got, want)
    for root, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), tmp_path / "jax")
            with open(os.path.join(root, f), "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
                assert a.read() == b.read(), rel
