"""Pixel-flipping and concept-flipping experiment harnesses (the port of
drsa_audio_tpu.xai.eval.harness; reference cxai/xai/pixelflipping/pf.py:29-412
and cpf.py:20-395), on the Flipper of xai.eval.flipping.

Every entry point takes ``device`` (CUDA unless named; raises where there is
none). Standard LRP attributes through engine.lrp; concept maps come from
HeatmapGenerator, which on a supported topology runs the lower segment
through the chain kernels (xai.lrp.chain).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from drsa_audio_tpu_torch.models.vgg import LayerSpec, forward
from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER, CLASS_IDX_MAPPER_TOY
from drsa_audio_tpu_torch.utils.device import params_on, resolve_device
from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
from drsa_audio_tpu_torch.xai.eval.flipping import Flipper
from drsa_audio_tpu_torch.xai.explain import HeatmapGenerator
from drsa_audio_tpu_torch.xai.lrp.engine import (
    Composite, layer_map_composite, lrp, output_mask_all_classes)


def make_rule(kind: str, value=None, stabilizer: float = 1e-7):
    """Rule-spec factory mirroring the reference rule_mapper (pf.py:18-27,
    257-292): gamma takes gamma=value, epsilon takes epsilon=value, alphabeta
    derives beta = alpha - 1."""
    if kind == "gamma":
        return ("gamma", {"gamma": value, "stabilizer": stabilizer})
    if kind == "epsilon":
        return ("epsilon", {"epsilon": value if value is not None else 1e-6})
    if kind == "alphabeta":
        return ("alphabeta", {"alpha": value, "beta": value - 1.0,
                              "stabilizer": stabilizer})
    return (kind, {"stabilizer": stabilizer})


def configuration_name(conf: Dict[str, Tuple]) -> str:
    """String key for a configuration (pf.py:294-310)."""
    out = ""
    for key, spec in conf.items():
        kind = spec[0]
        if kind == "alphabeta":
            out += "alpha_%3.1f_beta_%3.1f" % (spec[1], spec[1] - 1.0)
        elif kind == "zplus":
            out += kind + "_"
        elif key == "first_layer":
            out += kind
        else:
            out += f"{kind}_{spec[1]}_"
    return out


def scaled_gamma_name_map(specs: Sequence[LayerSpec], gamma: float,
                          eps: float = 1e-7, first_layer: str = "wsquare"):
    """'Scaled gamma' composite: full gamma on blocks 1-3, gamma/2 on
    block 4, gamma/4 on block 5+, epsilon on dense (pf.py:336-412),
    assigned per block (blocks delimited by max-pools), so depth-2 blocks
    get the same decay schedule."""
    conv_names = []  # (name, block_idx)
    block = 0
    for s in specs:
        if s.kind == "conv":
            conv_names.append((s.name, block))
        elif s.kind == "maxpool":
            block += 1
    dense_names = [s.name for s in specs if s.kind == "linear"]
    block_gamma = [gamma, gamma, gamma, gamma / 2, gamma / 4]
    name_map = [(conv_names[0][0], make_rule(first_layer))]
    for name, blk in conv_names[1:]:
        g = block_gamma[min(blk, len(block_gamma) - 1)]
        name_map.append((name, make_rule("gamma", g)))
    for name in dense_names:
        name_map.append((name, make_rule("epsilon", eps)))
    return name_map


def _forward_fn(specs, params):
    return lambda x: forward(specs, params, x)


def _mapper(case):
    return CLASS_IDX_MAPPER if case != "toy" else CLASS_IDX_MAPPER_TOY


class PixelFlipping:
    """Sweep LRP configurations and pixel-flip each (pf.py:29-196)."""

    def __init__(self, specs, params, input_batch, perturbation_size: int = 8,
                 perturbation_mode: str = "constant", num_classes: int = 10,
                 data_normalization: str = "normalized", forward_batch: int = 0,
                 attr_batch_size: int = 0, device=None):
        self.device = resolve_device(device, "PixelFlipping")
        self.specs = specs
        self.params = params_on(params, self.device)
        self.input_batch = torch.as_tensor(input_batch, dtype=torch.float32, device=self.device)
        self.num_classes = num_classes
        self.samples_per_class = self.input_batch.shape[0] // num_classes
        self.attr_batch_size = attr_batch_size
        self.flipper = Flipper(perturbation_size, perturbation_mode, data_normalization,
                               forward_batch, device=self.device)
        self._fwd = _forward_fn(specs, self.params)
        self.aupc_scores: dict = {}
        self.averaged_pertubed_prediction_logits: dict = {}
        self.heatmaps: dict = {}

    def _composite_for(self, conf: Dict[str, Tuple], scaled_gamma=False) -> Composite:
        """The composite of a configuration; under ``scaled_gamma`` the same
        configuration gives the scaled-gamma composite."""
        if scaled_gamma:
            nm = scaled_gamma_name_map(
                self.specs, conf["convolutional"][1], conf["dense"][1],
                first_layer=conf["first_layer"][0])
            return Composite.from_list(nm)
        return layer_map_composite(
            self.specs,
            conv_rule=make_rule(*conf["convolutional"]),
            dense_rule=make_rule(*conf["dense"]),
            first_layer_rule=make_rule(*conf["first_layer"]),
        )

    def _attribute(self, composite: Composite) -> torch.Tensor:
        """Input relevance of every clip for its own class. The balanced
        consecutive-class batch is attributed in one LRP pass, or, with
        ``attr_batch_size``, per class in chunks of that many clips (each
        clip's output relevance is its own class's logit either way)."""
        x = self.input_batch
        with torch.inference_mode():
            if not (self.attr_batch_size and x.shape[0] > self.attr_batch_size):
                return lrp(self.specs, self.params, x, composite,
                           output_mask_all_classes(self.num_classes))[0]
            if x.shape[0] % self.num_classes:
                raise ValueError(
                    "attr_batch_size requires a balanced batch: "
                    f"{x.shape[0]} samples do not divide into {self.num_classes} "
                    "classes (the per-class slicing would silently drop the remainder)")
            spc = self.samples_per_class
            parts = []
            for ci in range(self.num_classes):
                onehot = torch.zeros(self.num_classes, device=self.device)
                onehot[ci] = 1.0
                for j in range(ci * spc, (ci + 1) * spc, self.attr_batch_size):
                    chunk = x[j:min(j + self.attr_batch_size, (ci + 1) * spc)]
                    parts.append(lrp(self.specs, self.params, chunk, composite,
                                     lambda lg: lg * onehot[None, :])[0])
            return torch.cat(parts)

    def __call__(self, configuration_grid: List[Dict], scaled_gamma=False,
                 flipping_mode=None):
        flips = None
        for conf in configuration_grid:
            name = configuration_name(conf)
            R = self._attribute(self._composite_for(conf, scaled_gamma))
            self.heatmaps[name] = R.cpu().numpy()
            aupc, mean_logits, flips = self.flipper(
                self._fwd, self.input_batch, R, flipping_mode=flipping_mode)
            self.aupc_scores[name] = aupc
            self.averaged_pertubed_prediction_logits[name] = mean_logits
        return (self.aupc_scores, self.averaged_pertubed_prediction_logits,
                flips, self.heatmaps)


# ---------------------------------------------------- concept-level evals

def _class_heatmaps(specs, params, x, Us: Sequence, classes: Sequence[str], name_map,
                    num_concepts, layer_idx, case, attr_batch_size, device) -> np.ndarray:
    """Unsorted subspace heatmaps [b, K, h, w] of a balanced
    consecutive-class batch: block i attributed for classes[i] under Us[i]."""
    per_class = x.shape[0] // len(classes)
    heatmaps = []
    for i, (cls, U) in enumerate(zip(classes, Us)):
        gen = HeatmapGenerator(specs=specs, params=params, U=U, name_map=name_map,
                               sample_class=cls, num_concepts=num_concepts,
                               layer_idx=layer_idx, case=case, device=device)
        heatmaps.append(gen.generate_subspace_heatmaps(
            x[i * per_class:(i + 1) * per_class], concept_flipping=True,
            attr_batch_size=attr_batch_size, clone_chunk=2))
    return np.concatenate(heatmaps, axis=0)


def concept_flipping(specs, params, input_batch, name_map, layer_idx: int,
                     Us: Dict[str, np.ndarray], num_concepts: int = 4,
                     case: str | None = None, perturbation_size: int = 16,
                     forward_batch: int = 0, attr_batch_size: int = 32, device=None):
    """Flip all concepts' top patches simultaneously (cpf.py:20-84).

    Us maps class name -> the fitted U of this layer. Returns (AUPC
    [n_classes, per_class], mean score per step, flips per step, subspace
    heatmaps [b, K, h, w])."""
    device = resolve_device(device, "concept_flipping")
    params = params_on(params, device)
    x = torch.as_tensor(input_batch, dtype=torch.float32, device=device)
    classes = list(_mapper(case))
    R = _class_heatmaps(specs, params, x, [Us[c] for c in classes], classes, name_map,
                        num_concepts, layer_idx, case, attr_batch_size, device)
    flipper = Flipper(perturbation_size, forward_batch=forward_batch, device=device)
    aupc, mean_logits, flips = flipper(_forward_fn(specs, params), x, R[:, :, None])
    return aupc, mean_logits, flips, R


def interclass_concept_flipping(specs, params, input_batch, name_map,
                                Us_by_layer: Dict[int, Dict[str, np.ndarray]],
                                layer_idcs=(1, 4, 7, 10, 13), num_concepts: int = 4,
                                case=None, perturbation_size: int = 16,
                                forward_batch: int = 0, attr_batch_size: int = 32,
                                return_samples: bool = False, device=None):
    """AUPC matrix: rows = class whose U is inserted, attributing every
    class's samples (cpf.py:87-181). Returns a list per layer of [n_classes,
    n_classes] arrays or, with ``return_samples``, the per-instance tensors
    [n_classes, n_classes, samples_per_class] (for
    xai.eval.stats.interclass_gap_ci)."""
    device = resolve_device(device, "interclass_concept_flipping")
    params = params_on(params, device)
    x = torch.as_tensor(input_batch, dtype=torch.float32, device=device)
    classes = list(_mapper(case))
    fwd = _forward_fn(specs, params)
    flipper = Flipper(perturbation_size, forward_batch=forward_batch, device=device)
    all_layers = []
    for layer_idx in layer_idcs:
        rows = []
        for sub_cls in classes:
            U = Us_by_layer[layer_idx][sub_cls]
            R = _class_heatmaps(specs, params, x, [U] * len(classes), classes, name_map,
                                num_concepts, layer_idx, case, attr_batch_size, device)
            aupc, _, _ = flipper(fwd, x, R[:, :, None])
            rows.append(aupc if return_samples else aupc.mean(axis=-1))
        all_layers.append(np.stack(rows, axis=0))
    return all_layers


def cf_random_subspace(specs, params, input_batch, name_map, layer_idx: int, dim: int,
                       num_concepts: int = 4, case=None, permutations: int = 3,
                       seed: int = 0, attr_batch_size: int = 32, device=None) -> np.ndarray:
    """Random-orthogonal-U baseline (cpf.py:192-233): one random orthogonal
    U (random_orthogonal, numpy), column-permuted ``permutations`` times.
    The matrix and each permutation draw from their own child of
    ``np.random.SeedSequence(seed)``, so the draws differ from the JAX
    package's. Returns the last permutation's subspace heatmaps [b, K, h,
    w]."""
    device = resolve_device(device, "cf_random_subspace")
    params = params_on(params, device)
    x = torch.as_tensor(input_batch, dtype=torch.float32, device=device)
    classes = list(_mapper(case))
    kq, *kperms = np.random.SeedSequence(seed).spawn(permutations + 1)
    U = random_orthogonal(kq, dim)
    heatmaps = None
    for k in kperms:
        Up = U[:, np.random.default_rng(k).permutation(dim)]
        heatmaps = _class_heatmaps(specs, params, x, [Up] * len(classes), classes, name_map,
                                   num_concepts, layer_idx, case, attr_batch_size, device)
    return heatmaps
