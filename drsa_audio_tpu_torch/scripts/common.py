"""What the workflow CLIs share: the experiment configuration named by
``--config`` or ``--case``, and the trained model of a checkpoint
directory of ``ckpt_N.pt`` files (models/train.py ``save_checkpoint``)."""

from __future__ import annotations


def experiment_config(config: str | None, case: str):
    """The ExperimentConfig of the JSON file ``config``, else the default of
    ``case`` ('toy', 'gtzan_6s' or 'gtzan')."""
    from drsa_audio_tpu_torch.utils.config import ExperimentConfig
    if config:
        return ExperimentConfig.load(config)
    if case == "toy":
        return ExperimentConfig.toy_default()
    if case == "gtzan_6s":
        return ExperimentConfig.gtzan_6s_default()
    return ExperimentConfig()


def load_model(cfg, checkpoint: str, epoch: int | None, device):
    """(specs, params) of ``cfg``'s model from ``{checkpoint}/ckpt_{epoch}.pt``
    (the latest where ``epoch`` is None), on ``device``, BatchNorm folded
    into the layers before it, as the explain path takes it."""
    from drsa_audio_tpu_torch.models.train import load_checkpoint, merge_params
    from drsa_audio_tpu_torch.models.vgg import build_layer_specs, fold_batchnorm
    from drsa_audio_tpu_torch.utils.device import params_on
    ckpt = load_checkpoint(checkpoint, epoch)
    params = params_on(merge_params(ckpt["trainable"], ckpt.get("state") or {}), device)
    return fold_batchnorm(build_layer_specs(cfg.vgg_config()), params)


def class_mapper(case: str) -> dict:
    from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER, CLASS_IDX_MAPPER_TOY
    return CLASS_IDX_MAPPER_TOY if case == "toy" else CLASS_IDX_MAPPER


def toy_mels(wavs, device):
    """Toy waveforms [b, 16000] (numpy or tensor) -> log-mels [b, 1, 64, 64]
    on ``device``, without augmentation."""
    import torch
    from drsa_audio_tpu_torch.models.train import toy_augment_and_mel
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
    with torch.no_grad():
        return toy_augment_and_mel(torch.as_tensor(wavs, device=device), {},
                                   FrontendConfig.for_case("toy"), False, False)


def train_toy(wavs, labels, epochs: int, batch_size: int, device):
    """The toy model trained on in-memory waveforms as the JAX package's
    demo and recovery scripts train it: SGD (lr 5e-3, momentum 0.9, weight
    decay 1e-4) from ``init_params`` seed 0, the mel masks of
    ``toy_pipeline`` (no waveform augmentation), the clips shuffled by
    ``np.random.default_rng(epoch)``. The step's draws come from a
    ``torch.Generator`` seeded 1 on ``device``. Returns (specs, params, last
    loss, last accuracy)."""
    import numpy as np
    import torch
    from drsa_audio_tpu_torch.models.train import (
        make_optimizer, make_train_step, merge_params, sample_step_draws, split_trainable,
        toy_pipeline)
    from drsa_audio_tpu_torch.models.vgg import build_layer_specs, init_params, toy_config
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig

    specs = build_layer_specs(toy_config())
    trainable, state = split_trainable(init_params(specs, 0, device=device))
    opt = make_optimizer(trainable, lr=5e-3, momentum=0.9, weight_decay=1e-4)
    params = merge_params(trainable, state)
    pipeline = toy_pipeline(FrontendConfig.for_case("toy"), wav_augment=False, mel_augment=True)
    step = make_train_step(specs, opt, pipeline)
    generator = torch.Generator(device=device).manual_seed(1)
    order = np.arange(len(wavs))
    loss = acc = None
    for epoch in range(epochs):
        np.random.default_rng(epoch).shuffle(order)
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            batch = torch.as_tensor(wavs[sel], device=device)
            loss, acc = step(params, batch, torch.as_tensor(labels[sel], device=device),
                             sample_step_draws(specs, pipeline, batch.shape, generator))
    params = {n: {k: v.detach() for k, v in p.items()} for n, p in params.items()}
    return specs, params, loss, acc
