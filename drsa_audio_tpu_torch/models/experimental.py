"""Experimental LRP output-head transforms (the port of
drsa_audio_tpu.models.experimental): the differential-logit layer (pairwise
logit differences) and the reverse log-sum-exp of the LRP log-ratio trick
(Montavon et al. 2017)."""

from __future__ import annotations

import torch


def differential_logits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise log-probability ratios from the final linear layer
    (w [C, F], b [C]): out[n, j, k] = x @ (w_j - w_k) + (b_j - b_k)."""
    wd = w.T[:, :, None] - w.T[:, None, :]     # [F, C, C]: w_j - w_k
    bd = b[:, None] - b[None, :]               # [C, C]: b_j - b_k
    return torch.einsum("nf,fjk->njk", x, wd) + bd[None]


def reverse_logsumexp(x: torch.Tensor) -> torch.Tensor:
    """-log sum_{c' != c} exp(-x[..., c, c']): differential logits to the
    log-ratio output of the LRP log-ratio trick."""
    expd = torch.exp(-x)
    mask = 1.0 - torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return -torch.log(torch.sum(expd * mask, dim=-1))
