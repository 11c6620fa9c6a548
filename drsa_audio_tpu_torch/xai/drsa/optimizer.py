"""DRSA subspace optimiser (the port of drsa_audio_tpu.xai.drsa.optimizer).

Only the random orthogonal initialiser is ported so far; the explain service
takes U as given.
"""

from __future__ import annotations

import numpy as np


def random_orthogonal(seed: int, d: int) -> np.ndarray:
    """Random orthogonal [d, d] float32 matrix: QR of a Gaussian drawn from
    ``np.random.default_rng(seed)``, sign-fixed for a unique decomposition
    (replaces scipy.stats.ortho_group.rvs, reference drsa.py:272)."""
    g = np.random.default_rng(seed).standard_normal((d, d))
    q, r = np.linalg.qr(g)
    return (q * np.sign(np.diagonal(r))[None, :]).astype(np.float32)
