"""Train a classifier with the port, from an ExperimentConfig:

    python -m drsa_audio_tpu_torch.scripts.train --case toy --data DIR --out DIR

The flags of the JAX package's scripts/train.py, plus ``--device`` (CUDA
unless named: ``--device cpu`` runs on the CPU). Writes ``ckpt_N.pt`` and
``train_stats_N.csv`` under the output directory.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", help="ExperimentConfig JSON; defaults by --case")
    ap.add_argument("--case", choices=["gtzan", "gtzan_6s", "toy"], default="toy")
    ap.add_argument("--data", help="data root (overrides config)")
    ap.add_argument("--out", help="model output dir (overrides config)")
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--lr", type=float)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--resume-epoch", type=int,
                    help="resume from checkpoint at this epoch in --out")
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    import torch

    from drsa_audio_tpu_torch.data.datasets import GtzanWaveDataset, ToyWaveDataset
    from drsa_audio_tpu_torch.models.train import (
        fit, gtzan_pipeline, toy_augment_and_mel, toy_pipeline, valid_chunks_to_mels)
    from drsa_audio_tpu_torch.models.vgg import build_layer_specs, init_params
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
    from drsa_audio_tpu_torch.utils.config import ExperimentConfig
    from drsa_audio_tpu_torch.utils.device import resolve_device

    if args.config:
        cfg = ExperimentConfig.load(args.config)
    elif args.case == "toy":
        cfg = ExperimentConfig.toy_default()
    elif args.case == "gtzan_6s":
        cfg = ExperimentConfig.gtzan_6s_default()
    else:
        cfg = ExperimentConfig()
    if args.data:
        cfg.data_path = args.data
    if args.out:
        cfg.model_path = args.out
    if args.epochs:
        cfg.train.num_epochs = args.epochs
    if args.lr:
        cfg.train.learning_rate = args.lr
    if args.batch_size:
        cfg.train.batch_size = args.batch_size

    device = resolve_device(args.device, "train")
    fe = FrontendConfig.for_case(cfg.case)
    specs = build_layer_specs(cfg.vgg_config())
    params = init_params(specs, cfg.train.seed, device=device)

    if cfg.case == "toy":
        train_ds = ToyWaveDataset(cfg.data_path, "train", cfg.train.batch_size)
        valid_ds = ToyWaveDataset(cfg.data_path, "valid", cfg.train.batch_size)
        pipeline = toy_pipeline(fe, True, True)

        def valid_batches():
            for wavs, labels in valid_ds:
                with torch.no_grad():
                    mels = toy_augment_and_mel(torch.as_tensor(wavs, device=device), {}, fe,
                                               False, False)
                yield mels, labels
    else:
        # the decoded corpus lives on the device; each batch is a gather there
        train_ds = GtzanWaveDataset(cfg.data_path, "train", cfg.train.validation_fold,
                                    cfg.train.batch_size, device_cache=True, device=device)
        vbs = max(cfg.train.batch_size // fe.num_chunks, 1)
        valid_ds = GtzanWaveDataset(cfg.data_path, "valid", cfg.train.validation_fold, vbs,
                                    device_cache=True, device=device)
        pipeline = gtzan_pipeline(fe, True, True)

        def valid_batches():
            for wavs, labels in valid_ds:
                with torch.no_grad():
                    mels = valid_chunks_to_mels(wavs, fe)
                yield mels, labels.repeat_interleave(fe.num_chunks)

    params, stats = fit(
        specs, params,
        train_batches=lambda: iter(train_ds),
        valid_batches=valid_batches,
        num_epochs=cfg.train.num_epochs,
        lr=cfg.train.learning_rate,
        momentum=cfg.train.momentum,
        weight_decay=cfg.train.weight_decay,
        per_example_mel=pipeline,
        has_bn=cfg.model.conv_bn or cfg.model.dense_bn,
        seed=cfg.train.seed,
        model_path=cfg.model_path,
        save_step=cfg.train.save_step,
        resume_from=cfg.model_path if args.resume_epoch else None,
        from_epoch=args.resume_epoch or 0,
        verbose=True,
        device=device,
    )
    print("final valid acc:", stats.valid_acc[-1], flush=True)


if __name__ == "__main__":
    main()
