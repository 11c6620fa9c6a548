"""Faults planted in a request's result, as the timed path could produce
them, for the tests and the control's readings: each has to come out not
correct. They take the service's result dict and return it broken in
place. (A wrong class projection is planted where the service is built:
``wrong_projections``.)"""

from __future__ import annotations

import numpy as np

RESULT_KEYS = ("standard_heatmaps", "subspace_heatmaps", "subspace_relevances", "mask", "logits")


def half_left_out(res):
    """Half of the batch left out: the other half's results in its place."""
    b = res["logits"].shape[0]
    for k in RESULT_KEYS:
        res[k][b // 2:] = res[k][:b - b // 2]
    return res


def tenth_flipped(res):
    """The last tenth of the clips (at least one) with their standard and
    concept maps reversed in time, as a wrong last tile would leave them:
    every sum, so the relevances, the sort and the logits, unchanged."""
    b = res["logits"].shape[0]
    n = max(1, -(-b // 10))
    for k in ("standard_heatmaps", "subspace_heatmaps"):
        res[k][b - n:] = res[k][b - n:, ..., ::-1].copy()
    return res


def logit_altered(res):
    """An answer altered where it is produced: one clip's logit."""
    res["logits"][0, 0] += 0.5 * np.abs(res["logits"]).max()
    return res


def unsorted(res):
    """A sort that does not sort: maps, relevances and order reversed."""
    for k in ("subspace_heatmaps", "subspace_relevances", "mask"):
        res[k] = res[k][:, ::-1].copy()
    return res


def maps_permuted(res):
    """The concept maps returned in another order than their relevances and
    the order say."""
    res["subspace_heatmaps"] = res["subspace_heatmaps"][:, ::-1].copy()
    return res


def relevances_zeroed(res):
    """Relevances that are wrong but still do not rise: all zero."""
    res["subspace_relevances"] = np.zeros_like(res["subspace_relevances"])
    return res


RESULT_FAULTS = (half_left_out, tenth_flipped, logit_altered, unsorted, maps_permuted,
                 relevances_zeroed)


def wrong_projections(U):
    """The class projections shifted by one class: the service explains each
    class with another class's U (the standard map and logits unchanged)."""
    import torch
    return torch.roll(U, 1, dims=0)
