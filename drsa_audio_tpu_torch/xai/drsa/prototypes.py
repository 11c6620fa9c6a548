"""Prototype discovery (the port of drsa_audio_tpu.xai.drsa.prototypes):
the disjoint subset of n clips that maximises the DRSA objective under a
fitted U (reference prototypes.py:14-130), every subset's objective in one
batched evaluation."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from drsa_audio_tpu_torch.utils.device import resolve_device
from drsa_audio_tpu_torch.xai.drsa.optimizer import obj_val
from drsa_audio_tpu_torch.xai.drsa.preprocessing import preprocess_data


class PrototypeResult(NamedTuple):
    act_vecs: torch.Tensor          # [n * L, d] vectors of the argmax subset
    ctx_vecs: torch.Tensor          # [n * L, d]
    subset_index: int
    objectives: np.ndarray          # [num_subsets]
    songs: list | None              # song paths of the argmax subset (n entries)
    startpoints: np.ndarray | None  # slice startpoints (seconds, n entries)


def subset_objectives(act_vecs, ctx_vecs, U, num_concepts: int, n: int,
                      device=None) -> torch.Tensor:
    """The objective of each disjoint subset of n clips: vectors
    [num_subsets * n, L, d] (L positions per clip) -> [num_subsets], on
    ``device``, which defaults to CUDA and raises where there is none."""
    device = resolve_device(device, "subset_objectives")
    a, c, U = (torch.as_tensor(v, dtype=torch.float32, device=device)
               for v in (act_vecs, ctx_vecs, U))
    d = a.shape[-1]
    return obj_val(a.reshape(-1, n * a.shape[1], d), c.reshape(-1, n * c.shape[1], d),
                   U, num_concepts)


def get_prototypes(specs, params, layer_idx: int, U, composite, data_batch,
                   num_concepts: int = 4, n: int = 10, class_idx: int = 0, songs=None,
                   startpoints=None, extract_fn=None, device=None) -> PrototypeResult:
    """Every disjoint subset of ``n`` clips of ``data_batch`` (the last
    len % n dropped) scored under U on all positions (inference-mode
    extraction); the vectors, song names and slice startpoints of the best
    subset (the names and startpoints are what the reference's
    audiogen.py:160-170 sonifies). ``device`` defaults to CUDA and raises
    where there is none."""
    device = resolve_device(device, "get_prototypes")
    N = (len(data_batch) // n) * n
    act_vecs, ctx_vecs = preprocess_data(specs, params, data_batch[:N], composite, layer_idx,
                                         class_idx, num_locations=None, extract_fn=extract_fn,
                                         device=device)
    with torch.no_grad():
        objs = subset_objectives(act_vecs, ctx_vecs, U, num_concepts, n, device).cpu().numpy()
    best = int(np.argmax(objs))
    sl = slice(best * n, (best + 1) * n)
    d = act_vecs.shape[-1]
    return PrototypeResult(act_vecs[sl].reshape(-1, d), ctx_vecs[sl].reshape(-1, d), best,
                           objs, list(songs[sl]) if songs is not None else None,
                           np.asarray(startpoints)[sl] if startpoints is not None else None)
