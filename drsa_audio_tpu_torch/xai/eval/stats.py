"""Uncertainty quantification for the evaluation claims (the port's copy of
drsa_audio_tpu.xai.eval.stats, numpy only).

The reference reports standard errors only for sep/peak (mean/sqrt(n),
cxai/xai/pixelflipping/cpf.py:350-354); its interclass matrix and the
DRSA-vs-standard AUPC comparison carry no uncertainty at all. Round-2
VERDICT weak #4: the headline "concept specificity" rested on a 1.7%
diagonal-vs-off-diagonal gap with no error bars. This module adds
nonparametric bootstrap CIs over the per-instance AUPC samples.
"""

from __future__ import annotations

import numpy as np


def bootstrap_ci(samples: np.ndarray, stat_fn=np.mean, n_boot: int = 10000,
                 alpha: float = 0.05, seed: int = 0):
    """Percentile bootstrap CI of ``stat_fn`` over axis 0 of ``samples``.

    Returns (point, lo, hi)."""
    samples = np.asarray(samples)
    rng = np.random.default_rng(seed)
    n = samples.shape[0]
    idx = rng.integers(0, n, size=(n_boot, n))
    boots = np.asarray([stat_fn(samples[i]) for i in idx])
    lo, hi = np.percentile(boots, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(stat_fn(samples)), float(lo), float(hi)


def paired_diff_ci(a: np.ndarray, b: np.ndarray, n_boot: int = 10000,
                   alpha: float = 0.05, seed: int = 0):
    """Bootstrap CI of mean(a - b) over paired per-instance samples.

    Use for DRSA-vs-standard AUPC on the SAME eval instances — pairing
    removes the between-clip variance that dominates the pooled spread."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    assert a.shape == b.shape
    return bootstrap_ci(a - b, np.mean, n_boot, alpha, seed)


def interclass_gap_ci(aupc_samples: np.ndarray, n_boot: int = 10000,
                      alpha: float = 0.05, seed: int = 0):
    """CI of (off-diagonal mean - diagonal mean) of an interclass AUPC
    tensor [n_classes, n_classes, samples] (rows = class whose U attributes,
    cols = class of the attributed samples).

    Resamples the per-instance AUPCs within every (U-class, sample-class)
    cell; positive gap = a class's own subspaces remove its evidence faster
    than foreign subspaces do (concept specificity, cpf.py:87-181)."""
    t = np.asarray(aupc_samples)
    n, m, s = t.shape
    assert n == m
    eye = np.eye(n, dtype=bool)

    def gap(x):
        cell_means = x.mean(axis=-1)
        return cell_means[~eye].mean() - cell_means[eye].mean()

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, s, size=(n_boot, s))
    boots = np.asarray([gap(t[:, :, i]) for i in idx])
    lo, hi = np.percentile(boots, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(gap(t)), float(lo), float(hi)


def sep_peak_stderr(values: np.ndarray):
    """The reference's sep/peak stderr convention: mean and mean/sqrt(n)
    (cpf.py:350-354 — kept verbatim, quirk and all, for parity)."""
    v = np.asarray(values, dtype=np.float64).ravel()
    return float(v.mean()), float(v.mean() / np.sqrt(len(v)))
