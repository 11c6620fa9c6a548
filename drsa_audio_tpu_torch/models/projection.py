"""Virtual projection layers for subspace attribution (the port of
drsa_audio_tpu.models.projection).

Shapes (d channels, n = h*w positions, K concepts):
  Projection:    [b, d, h, w] -> [b, n, K, d_k]   (a^T U).reshape
  InvProjection: [b, n, K, d_k] -> [b, d, h, w]   (h U^T).reshape
"""

from __future__ import annotations

from typing import Sequence

import torch

from drsa_audio_tpu_torch.models.vgg import LayerSpec


def apply_projection(x: torch.Tensor, U: torch.Tensor, num_concepts: int) -> torch.Tensor:
    b, ch, h, w = x.shape
    vecs = x.reshape(b, ch, h * w).transpose(-2, -1)          # [b, n, d]
    return (vecs @ U).reshape(b, h * w, num_concepts, U.shape[0] // num_concepts)


def projection_vjp(g: torch.Tensor, U: torch.Tensor, hw: tuple) -> torch.Tensor:
    """Transpose of apply_projection: [b, n, K, d_k] -> [b, d, h, w]."""
    b, n = g.shape[:2]
    return (g.reshape(b, n, -1) @ U.T).transpose(-2, -1).reshape(b, -1, *hw)


def _map_hw(n: int, map_hw):
    if map_hw is not None:
        h, w = map_hw
        if h * w != n:
            raise ValueError(f"map_hw {map_hw} inconsistent with n={n}")
        return h, w
    h = w = int(round(n ** 0.5))
    if h * w != n:
        raise ValueError(f"non-square activation map (n={n}); pass map_hw "
                         "to insert_projection")
    return h, w


def apply_inv_projection(x: torch.Tensor, U: torch.Tensor, num_concepts: int,
                         map_hw=None) -> torch.Tensor:
    b, n = x.shape[:2]
    h, w = _map_hw(n, map_hw)
    rec = x.reshape(b, n, U.shape[0]) @ U.T                   # [b, n, d]
    return rec.transpose(-2, -1).reshape(b, U.shape[0], h, w)


def inv_projection_vjp(g: torch.Tensor, U: torch.Tensor, num_concepts: int) -> torch.Tensor:
    """Transpose of apply_inv_projection: [b, d, h, w] -> [b, n, K, d_k]."""
    b, d = g.shape[:2]
    vecs = g.reshape(b, d, -1).transpose(-2, -1) @ U          # [b, n, d]
    return vecs.reshape(b, vecs.shape[1], num_concepts, d // num_concepts)


def feature_map_hw(specs: Sequence[LayerSpec], layer_idx: int,
                   input_size) -> tuple[int, int]:
    """(h, w) of the map right after ``features.{layer_idx}``."""
    h, w = input_size
    target = f"features.{layer_idx}"
    for spec in specs:
        if spec.kind == "maxpool":
            kh, kw = spec.config["kernel"]
            h, w = h // kh, w // kw
        if spec.name == target:
            return int(h), int(w)
    raise ValueError(f"layer {target} not found in model specs")


def insert_projection(specs: Sequence[LayerSpec], layer_idx: int,
                      U: torch.Tensor, num_concepts: int,
                      input_size=None) -> list[LayerSpec]:
    """Splice Projection -> SubspaceFilter -> InvProjection in right after
    ``features.{layer_idx}`` (reference modify_model.py:44-50)."""
    target = f"features.{layer_idx}"
    map_hw = (feature_map_hw(specs, layer_idx, input_size)
              if input_size is not None else None)
    out: list[LayerSpec] = []
    found = False
    for spec in specs:
        out.append(spec)
        if spec.name == target:
            found = True
            out.append(LayerSpec("projection", "features.projection",
                                 {"U": U, "num_concepts": num_concepts}))
            out.append(LayerSpec("subspacefilter", "features.subspacefilter", {}))
            out.append(LayerSpec("invprojection", "features.invprojection",
                                 {"U": U, "num_concepts": num_concepts,
                                  "map_hw": map_hw}))
    if not found:
        raise ValueError(f"layer {target} not found in model specs")
    return out
