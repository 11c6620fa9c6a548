"""Extract DRSA training data (activation and context vectors) per class and
layer with the port (reference cxai/xai/drsa/cluster/getdrsadata.py:63-141):

    python -m drsa_audio_tpu_torch.scripts.extract_drsa_data --case toy \\
        --data DIR --checkpoint MODEL_DIR --out DIR

The flags of the JAX package's scripts/extract_drsa_data.py, plus
``--device``. Reads the port's ``ckpt_N.pt``; writes the JAX layout, one
``{out}/{class}/dataset_layer{L}.npz`` with keys ``activations`` and
``contexts`` per class and layer, which either package reads. The
locations are drawn from one ``torch.Generator`` seeded with
``cfg.drsa.seed`` and advanced per (class, layer) in the JAX script's
order; its draws differ from the JAX package's keys.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", help="ExperimentConfig JSON")
    ap.add_argument("--case", choices=["gtzan", "gtzan_6s", "toy"], default="toy")
    ap.add_argument("--data", required=True)
    ap.add_argument("--checkpoint", required=True, help="directory of ckpt_N.pt files")
    ap.add_argument("--epoch", type=int, help="default: latest ckpt")
    ap.add_argument("--out", required=True)
    ap.add_argument("--layers", type=int, nargs="+")
    ap.add_argument("--num-locations", type=int, default=20)
    ap.add_argument("--num-clips", type=int,
                    help="truncate each class's chunk batch to N clips "
                         "(reference budget: 300 clips x 20 locations = "
                         "6000 vectors per class-layer)")
    ap.add_argument("--gamma", type=float,
                    help="rescale the case name map's gamma rules to this "
                         "base value (decay pattern preserved)")
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from drsa_audio_tpu_torch.data.datasets import get_songs_drsa, get_songs_toy
    from drsa_audio_tpu_torch.scripts.common import class_mapper, experiment_config, load_model
    from drsa_audio_tpu_torch.utils.constants import rescale_gamma
    from drsa_audio_tpu_torch.utils.device import resolve_device
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import make_extract_fn, preprocess_data
    from drsa_audio_tpu_torch.xai.lrp.engine import Composite

    device = resolve_device(args.device, "extract_drsa_data")
    cfg = experiment_config(args.config, args.case)
    layers = args.layers or list(cfg.drsa.layer_idcs)
    specs, params = load_model(cfg, args.checkpoint, args.epoch, device)
    name_map = cfg.lrp_name_map
    if args.gamma is not None:
        name_map = rescale_gamma(name_map, args.gamma)
    composite = Composite.from_list(name_map)

    generator = torch.Generator().manual_seed(cfg.drsa.seed)
    # one extraction function per layer, its params placed on the device once
    extract_fns = {li: make_extract_fn(specs, params, composite, li, device=device)
                   for li in layers}
    for cls, class_idx in class_mapper(cfg.case).items():
        if cfg.case != "toy":
            n_songs = (-(-args.num_clips // cfg.drsa.chunks_per_song)
                       if args.num_clips else None)
            batch, _, _ = get_songs_drsa(
                args.data, cls, excluded_folds=[cfg.train.validation_fold],
                N=args.num_clips, num_songs=n_songs,
                num_chunks=cfg.drsa.chunks_per_song, case=cfg.case, device=device)
        else:
            batch, _ = get_songs_toy(args.data, cls, device=device)
        for layer_idx in layers:
            t_pair = time.perf_counter()
            act, ctx = preprocess_data(
                specs, params, batch, composite, layer_idx, class_idx,
                num_locations=args.num_locations, generator=generator,
                extract_fn=extract_fns[layer_idx], device=device)
            act = act.cpu().numpy()         # the readback waits for the device
            dt = time.perf_counter() - t_pair
            out_dir = os.path.join(args.out, cls)
            os.makedirs(out_dir, exist_ok=True)
            np.savez(os.path.join(out_dir, f"dataset_layer{layer_idx}.npz"),
                     activations=act, contexts=ctx.cpu().numpy())
            print(f"{cls} layer {layer_idx}: {act.shape} "
                  f"[{dt:.1f}s, {len(batch) / dt:.1f} clips/s]", flush=True)


if __name__ == "__main__":
    main()
