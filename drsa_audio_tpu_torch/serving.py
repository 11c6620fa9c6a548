"""Explain service (the port of drsa_audio_tpu.serving).

``ExplainerService.explain(wavs, class_name)`` runs waveform -> log-mel ->
VGG forward -> upper LRP backward -> K concept clones through the lower
chain -> standard and subspace heatmaps, on the GPU unless the caller asks
for ``device="cpu"``. The projection U and the class are per-request inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from drsa_audio_tpu_torch.models.projection import insert_projection
from drsa_audio_tpu_torch.models.vgg import LayerSpec
from drsa_audio_tpu_torch.ops.frontend import FrontendConfig, logmel, peak_normalize
from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER, CLASS_IDX_MAPPER_TOY
from drsa_audio_tpu_torch.utils.device import params_on, resolve_device
from drsa_audio_tpu_torch.xai.explain import (
    class_composite, sort_subspaces, subspace_heatmaps)


@dataclasses.dataclass
class ExplainRequest:
    """One batch of fixed-length waveforms to explain for one class."""
    wavs: np.ndarray          # [b, samples]
    class_idx: int


class ExplainerService:
    """explain(wavs, class_name) -> dict of standard/subspace heatmaps and
    relevances (mirroring HeatmapGenerator.info) and the logits.

    ``device`` defaults to CUDA and raises where there is none. On a CUDA
    device the service turns TF32 off for cuDNN convolutions and matmuls:
    LRP runs in full float32."""

    def __init__(self, specs: Sequence[LayerSpec], params: dict, name_map,
                 Us: dict, num_concepts: int, layer_idx: int,
                 case: str = "gtzan", class_idx_mapper: dict | None = None,
                 device=None):
        self.device = resolve_device(device, "ExplainerService")
        self.config = FrontendConfig.for_case(case)
        self.specs = list(specs)
        self.params = params_on(params, self.device)
        self.num_concepts = num_concepts
        self.layer_idx = layer_idx
        self.mapper = class_idx_mapper or (
            CLASS_IDX_MAPPER_TOY if case == "toy" else CLASS_IDX_MAPPER)
        self.n_classes = len(self.mapper)
        self.Us = {cls: torch.as_tensor(np.array(U, np.float32), device=self.device)
                   for cls, U in Us.items()}
        self.composite = class_composite(name_map, num_concepts)

    def _dispatch(self, wavs, class_name: str, fused: bool | None = None):
        """Enqueue one request; returns (heatmaps, logits) on the device."""
        onehot = torch.zeros(self.n_classes, device=self.device)
        onehot[self.mapper[class_name]] = 1.0
        cfg = self.config
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(wavs, np.float32), device=self.device)
            mels = logmel(peak_normalize(x), cfg)[:, None]
            specs_proj = insert_projection(
                self.specs, self.layer_idx, self.Us[class_name],
                self.num_concepts, input_size=(cfg.n_mels, cfg.width))
            return subspace_heatmaps(
                specs_proj, self.params, mels, self.composite,
                self.num_concepts, output_mask=lambda lg: lg * onehot[None, :],
                fused=fused)

    def explain(self, wavs: np.ndarray, class_name: str,
                fused: bool | None = None) -> dict:
        """``fused=False`` runs the lower segment through the plain tiled
        walk instead of the chain kernels (for comparison)."""
        out = self._finalize(self._dispatch(wavs, class_name, fused))
        out["standard_relevance"] = out["standard_heatmaps"].sum(axis=(-2, -1)).flatten()
        return out

    def explain_stream(self, requests: Iterable[ExplainRequest]) -> Iterator[dict]:
        """Enqueue request i+1 before reading back request i, so the host's
        work on one overlaps the device's on the other."""
        pending = None
        for req in requests:
            cls = next(k for k, v in self.mapper.items() if v == req.class_idx)
            out = self._dispatch(req.wavs, cls)
            if pending is not None:
                yield self._finalize(pending)
            pending = out
        if pending is not None:
            yield self._finalize(pending)

    def _finalize(self, out) -> dict:
        heat, logits = out
        heat = heat.cpu().numpy()
        standard = heat[:, 0:1]
        sub, rel, order = sort_subspaces(heat[:, 1:])
        return {"standard_heatmaps": standard, "subspace_heatmaps": sub,
                "subspace_relevances": rel, "mask": order,
                "logits": logits.cpu().numpy()}
