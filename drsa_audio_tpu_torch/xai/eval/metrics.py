"""Separability / peakness / Frobenius concept metrics (the port's copy of
drsa_audio_tpu.xai.eval.metrics, numpy only).

Reference cxai/xai/pixelflipping/cpf.py:297-395.
"""

from __future__ import annotations

import numpy as np


def separability_scores(RU: np.ndarray) -> np.ndarray:
    """Per-instance separability: max_k-then-sum minus sum-then-max gap
    (cpf.py:348-350). RU: [b, K, h, w] subspace heatmaps -> [b]."""
    return (np.max(RU, axis=1).sum(axis=(-2, -1))
            - np.max(RU.sum(axis=(-2, -1)), axis=1)).squeeze()


def peakness_scores(RU: np.ndarray) -> np.ndarray:
    """Per-instance peakness: sum over concepts of each concept's max
    (cpf.py:352-354). RU: [b, K, h, w] -> [b]."""
    return np.max(RU, axis=(-2, -1)).sum(axis=1).squeeze()


def separability(RU: np.ndarray):
    """(mean, reference-convention stderr) of separability_scores.

    RU: [b, K, h, w] subspace heatmaps. Returns (mean, standard error).
    """
    scores = separability_scores(RU)
    mean = scores.mean()
    return mean, mean / np.sqrt(scores.shape[0])


def peakness(RU: np.ndarray):
    """(mean, reference-convention stderr) of peakness_scores."""
    scores = peakness_scores(RU)
    mean = scores.mean()
    return mean, mean / np.sqrt(scores.shape[0])


def cancellation_factor(RU: np.ndarray) -> float:
    """Mean over pixels of sum_k |R_k| / |sum_k R_k| — how much concept-map
    amplitude cancels in the standard map. 1.0 = no cancellation (perfectly
    disentangled signs); unoptimized (random-U) decompositions mix every
    activation direction into every subspace and run >> 1. The signed
    sep/peak metrics (cpf.py:348-354) scale with per-map amplitude, so they
    reward this cancellation rather than penalize it — the mechanism probe
    for the random-beats-DRSA sep/peak cells. Not a reference metric."""
    num = np.abs(RU).sum(axis=1)
    den = np.abs(RU.sum(axis=1)) + 1e-12
    # weight by standard-map mass so near-zero pixels don't dominate
    return float((num * den).sum() / (den * den).sum())


def negative_mass_fraction(RU: np.ndarray) -> float:
    """Fraction of total absolute relevance that is negative, over all
    concept maps — the mechanism probe for the signed sep/peak metrics:
    unoptimized (random-U) decompositions mix every activation direction
    into every subspace, producing large +/- values that cancel in the sum
    but INFLATE pixelwise maxima. Not a reference metric (diagnostic)."""
    neg = np.clip(-RU, 0, None).sum()
    return float(neg / (np.abs(RU).sum() + 1e-12))


def frobenius_distance(RU: np.ndarray, num_concepts: int) -> float:
    """Mean pairwise Frobenius distance between concept heatmaps, averaged
    over instances and normalized by pair count (cpf.py:374-395)."""
    diff = RU[:, None, :, :, :] - RU[:, :, None, :, :]
    fro = np.sqrt((diff**2).sum(axis=(-2, -1)))
    mask = np.triu(np.ones((num_concepts, num_concepts), bool), k=1)
    total = fro[:, mask].sum(axis=-1)
    pairs = num_concepts * (num_concepts - 1) / 2
    return float(total.mean() / pairs)


def sep_and_peak_table(heatmaps_by_config):
    """Stack [4, n_layers] (sep, sep_err, peak, peak_err) per K
    (cpf.py:297-371). heatmaps_by_config: {k: [RU per layer]}."""
    out = []
    for k, layer_heatmaps in heatmaps_by_config.items():
        sep, seperr, peak, peakerr = [], [], [], []
        for RU in layer_heatmaps:
            s, se = separability(RU)
            p, pe = peakness(RU)
            sep.append(s)
            seperr.append(se)
            peak.append(p)
            peakerr.append(pe)
        out.append(np.stack((sep, seperr, peak, peakerr), axis=0))
    return np.stack(out, axis=0)
