"""The measured program, reached by name: ``drsa_audio_tpu_torch``'s explain
service built from a configuration and the benchmark's weights, as a user
builds it (layer specs, BatchNorm folded by the program's
``fold_batchnorm``, the configuration's rule map and class projections)."""

from __future__ import annotations

import numpy as np

PACKAGE = "drsa_audio_tpu_torch"


def service(cfg: dict, params: dict, U, device):
    from drsa_audio_tpu_torch.models.vgg import VGGConfig, build_layer_specs, fold_batchnorm
    from drsa_audio_tpu_torch.serving import ExplainerService
    vgg = VGGConfig(n_filters=tuple(cfg["n_filters"]), conv_kernel=tuple(cfg["conv_kernel"]),
                    pool_kernels=tuple(tuple(p) for p in cfg["pool_kernels"]),
                    n_dense=cfg["n_dense"], n_classes=cfg["n_classes"], dropout=cfg["dropout"],
                    block_depth=cfg["block_depth"], dense_depth=cfg["dense_depth"],
                    input_size=(cfg["n_mels"], cfg["mel_width"]), conv_bn=cfg["conv_bn"],
                    dense_bn=cfg["dense_bn"])
    specs = build_layer_specs(vgg)
    if cfg["conv_bn"] or cfg["dense_bn"]:
        specs, params = fold_batchnorm(specs, params)
    name_map = [(n, (r, dict(kw))) for n, r, kw in cfg["rules"]]
    mapper = {c: i for i, c in enumerate(cfg["classes"])}
    Us = {c: U[i].cpu().numpy().astype(np.float32) for c, i in mapper.items()}
    return ExplainerService(specs, params, name_map, Us, cfg["num_concepts"], cfg["drsa_layer"],
                            case=cfg["case"], class_idx_mapper=mapper, device=device)
