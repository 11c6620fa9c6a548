"""The measured program, reached by name: ``drsa_audio_tpu_torch``'s explain
service built from a configuration and the benchmark's weights, as a user
builds it (layer specs, BatchNorm folded by the program's
``fold_batchnorm``, the configuration's rule map and class projections)."""

from __future__ import annotations

import numpy as np

from pb.model import layer_plan

PACKAGE = "drsa_audio_tpu_torch"

# the config keys of each layer kind, as the program's build_layer_specs writes them
SPEC_KEYS = {"conv": ("in_ch", "out_ch", "kernel"), "batchnorm": ("ch",), "relu": (),
             "maxpool": ("kernel",), "flatten": ("features",), "linear": ("in_f", "out_f"),
             "batchnorm1d": ("ch",), "dropout": ("rate",)}


def layer_specs(cfg: dict) -> list:
    """The program's ``LayerSpec`` list of the configuration's layer plan."""
    from drsa_audio_tpu_torch.models.vgg import LayerSpec
    specs = []
    for ly in layer_plan(cfg):
        conf = {k: tuple(ly[k]) if isinstance(ly[k], list) else ly[k]
                for k in SPEC_KEYS[ly["kind"]]}
        specs.append(LayerSpec(ly["kind"], ly["name"], conf))
    return specs


def service(cfg: dict, params: dict, U, device):
    from drsa_audio_tpu_torch.models.vgg import fold_batchnorm
    from drsa_audio_tpu_torch.serving import ExplainerService
    specs = layer_specs(cfg)
    if any(s.kind in ("batchnorm", "batchnorm1d") for s in specs):
        specs, params = fold_batchnorm(specs, params)
    name_map = [(n, (r, dict(kw))) for n, r, kw in cfg["rules"]]
    mapper = {c: i for i, c in enumerate(cfg["classes"])}
    Us = {c: U[i].cpu().numpy().astype(np.float32) for c, i in mapper.items()}
    return ExplainerService(specs, params, name_map, Us, cfg["num_concepts"], cfg["drsa_layer"],
                            case=cfg["case"], class_idx_mapper=mapper, device=device)
