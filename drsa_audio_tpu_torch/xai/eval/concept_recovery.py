"""Concept-recovery analysis against the toy ground truth (the port's copy
of drsa_audio_tpu.xai.eval.concept_recovery, numpy only).

The toy generator embeds 4 known frequency-band concepts per class
(data/toydata.py CLASS_PARAMS). Given subspace heatmaps, these tools
quantify how well the discovered subspaces align with those bands — the
quantitative version of the reference's visual check (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from drsa_audio_tpu_torch.ops.mel import hz_to_mel
from drsa_audio_tpu_torch.data.toydata import CLASS_PARAMS


def band_energy_profiles(subspace_heatmaps: np.ndarray) -> np.ndarray:
    """Per-subspace normalized mel-bin energy profile.

    subspace_heatmaps: [b, K, n_mels, time] -> [K, n_mels], each row summing
    to 1 (ReLU'd, time-summed, batch-averaged).
    """
    pos = np.maximum(np.asarray(subspace_heatmaps), 0.0)
    prof = pos.sum(axis=-1).mean(axis=0)  # [K, n_mels]
    return prof / np.maximum(prof.sum(axis=-1, keepdims=True), 1e-12)


def toy_concept_mel_bands(class_name: str, n_mels: int = 64,
                          sample_rate: int = 16000, margin_hz: float = 100.0):
    """Mel-bin ranges of the 4 ground-truth concepts for a toy class.

    Returns {concept_idx: (lo_bin, hi_bin)} on the HTK mel axis.
    """
    m_max = hz_to_mel(sample_rate / 2)
    bands = {}
    for ci in range(1, 5):
        f_lo, f_hi = CLASS_PARAMS[class_name][f"concept{ci}"]["f_range"]
        lo = int(np.floor(hz_to_mel(max(f_lo - margin_hz, 0)) / m_max * n_mels))
        hi = int(np.ceil(hz_to_mel(f_hi + margin_hz) / m_max * n_mels))
        bands[ci] = (max(lo, 0), min(hi, n_mels))
    return bands


def band_assignment(subspace_heatmaps: np.ndarray, class_name: str,
                    sample_rate: int = 16000, relative: bool = True):
    """Energy share of each ground-truth band per subspace, plus the greedy
    subspace -> band assignment.

    With ``relative=True`` (default) each band's share is normalized by the
    TOTAL (all-subspace) energy in that band, removing the global
    low-frequency energy prior of log-mel relevance: share[k, band] then
    answers "which subspace claims this band", and a subspace is assigned
    the band it owns most exclusively.

    Returns (shares [K, 4], assignment dict subspace->concept, coverage =
    number of distinct concepts claimed as some subspace's top band).
    """
    prof = band_energy_profiles(subspace_heatmaps)
    n_mels = prof.shape[-1]
    bands = toy_concept_mel_bands(class_name, n_mels, sample_rate)
    K = prof.shape[0]
    shares = np.zeros((K, 4))
    for k in range(K):
        for ci, (lo, hi) in bands.items():
            shares[k, ci - 1] = prof[k, lo:hi].sum()
    if relative:
        shares = shares / np.maximum(shares.sum(axis=0, keepdims=True), 1e-12)
    assignment = {k: int(np.argmax(shares[k])) + 1 for k in range(K)}
    coverage = len(set(assignment.values()))
    return shares, assignment, coverage


def profile_diversity(subspace_heatmaps: np.ndarray) -> float:
    """Mean pairwise (1 - cosine similarity) between subspace band profiles —
    higher = more disentangled frequency usage."""
    prof = band_energy_profiles(subspace_heatmaps)
    K = prof.shape[0]
    sims = []
    for i in range(K):
        for j in range(i + 1, K):
            a, b = prof[i], prof[j]
            sims.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)))
    return 1.0 - float(np.mean(sims)) if sims else 0.0
