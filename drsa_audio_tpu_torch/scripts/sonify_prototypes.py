"""Find DRSA prototypes for a class and sonify their subspace explanations
with the port:

    python -m drsa_audio_tpu_torch.scripts.sonify_prototypes --case toy --data DIR \\
        --checkpoint MODEL_DIR --subspaces DIR --out DIR --sample-class class1 --layer 10

``get_prototypes`` returns the song names and slice startpoints of the
argmax-objective subset (reference cxai/xai/drsa/prototypes.py:14-130), and
those exact slices are loaded again for sonification (reference
cxai/xai/explain/audiogen.py:160-170): get_songs_drsa (mels, songs,
startpoints) -> get_prototypes (the argmax subset under the fitted U) ->
HeatmapGenerator subspace heatmaps of the prototype slices, through the
chain kernels -> Mel2Audio.transform_audio_from_file and transform ->
write_wav. The flags of the JAX package's scripts/sonify_prototypes.py,
plus ``--device``. Reads the port's ``ckpt_N.pt`` and either package's
runs under ``{subspaces}/{class}/layer{L}``; writes the JAX script's
``proto{i}_standard.wav``, ``proto{i}_concept{k}.wav`` and
``prototypes.json``.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config")
    ap.add_argument("--case", choices=["gtzan", "gtzan_6s", "toy"], default="gtzan_6s")
    ap.add_argument("--data", required=True)
    ap.add_argument("--checkpoint", required=True, help="directory of ckpt_N.pt files")
    ap.add_argument("--epoch", type=int)
    ap.add_argument("--subspaces", required=True,
                    help="optimize_subspaces output root (of one K)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--sample-class", required=True)
    ap.add_argument("--layer", type=int, required=True)
    ap.add_argument("--num-concepts", type=int, default=4)
    ap.add_argument("--subset-size", type=int, default=10)
    ap.add_argument("--max-sonify", type=int, default=2,
                    help="number of prototype slices to sonify")
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    import numpy as np

    from drsa_audio_tpu_torch.data.datasets import get_songs_drsa, get_songs_toy
    from drsa_audio_tpu_torch.runtime.wavio import write_wav
    from drsa_audio_tpu_torch.scripts.common import class_mapper, experiment_config, load_model
    from drsa_audio_tpu_torch.utils.device import resolve_device
    from drsa_audio_tpu_torch.utils.evaluation import load_projection_matrix
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import make_extract_fn
    from drsa_audio_tpu_torch.xai.drsa.prototypes import get_prototypes
    from drsa_audio_tpu_torch.xai.explain import HeatmapGenerator
    from drsa_audio_tpu_torch.xai.lrp.engine import Composite
    from drsa_audio_tpu_torch.xai.sonify.mel2audio import Mel2Audio

    device = resolve_device(args.device, "sonify_prototypes")
    cfg = experiment_config(args.config, args.case)
    specs, params = load_model(cfg, args.checkpoint, args.epoch, device)
    composite = Composite.from_list(cfg.lrp_name_map)

    if cfg.case == "toy":
        batch, songs = get_songs_toy(args.data, args.sample_class, device=device)
        starts = np.zeros(len(songs))
    else:
        batch, songs, starts = get_songs_drsa(
            args.data, args.sample_class, excluded_folds=[cfg.train.validation_fold],
            num_chunks=cfg.drsa.chunks_per_song, case=cfg.case, device=device)

    U = load_projection_matrix(
        os.path.join(args.subspaces, args.sample_class, f"layer{args.layer}"))
    res = get_prototypes(
        specs, params, args.layer, U, composite, batch, num_concepts=args.num_concepts,
        n=args.subset_size, class_idx=class_mapper(cfg.case)[args.sample_class], songs=songs,
        startpoints=starts,
        extract_fn=make_extract_fn(specs, params, composite, args.layer, device=device),
        device=device)

    os.makedirs(args.out, exist_ok=True)
    manifest = {
        "sample_class": args.sample_class,
        "layer": args.layer,
        "subset_index": int(res.subset_index),
        "subset_objective": float(res.objectives[res.subset_index]),
        "objectives": res.objectives.tolist(),
        "prototypes": [{"song": s, "startpoint_s": float(sp)}
                       for s, sp in zip(res.songs, res.startpoints)],
    }

    # sonify the first few prototype slices: standard + per-concept audios
    gen = HeatmapGenerator(specs=specs, params=params, U=U, name_map=cfg.lrp_name_map,
                           sample_class=args.sample_class, num_concepts=args.num_concepts,
                           layer_idx=args.layer, case=cfg.case, device=device)
    m2a = Mel2Audio(case=cfg.case, device=device)
    proto_batch_idx = [res.subset_index * args.subset_size + i for i in range(args.max_sonify)]
    gen.generate_subspace_heatmaps(np.asarray(batch)[proto_batch_idx])

    sr = m2a.config.sample_rate
    for i in range(len(proto_batch_idx)):
        song, sp = res.songs[i], float(res.startpoints[i])
        mel, phase = m2a.transform_audio_from_file(song, startpoint=sp)
        wav_std = m2a.transform(gen.info["standard_heatmaps"][i, 0], mel, phase, percentile=50)
        write_wav(os.path.join(args.out, f"proto{i}_standard.wav"),
                  wav_std.cpu().numpy()[None], sr)
        for k in range(args.num_concepts):
            wav_k = m2a.transform(gen.info["subspace_heatmaps"][i, k], mel, phase,
                                  percentile=70)
            write_wav(os.path.join(args.out, f"proto{i}_concept{k}.wav"),
                      wav_k.cpu().numpy()[None], sr)
        manifest["prototypes"][i]["sonified"] = True

    with open(os.path.join(args.out, "prototypes.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"prototype subset {res.subset_index} "
          f"(objective {manifest['subset_objective']:.4f}); "
          f"{len(proto_batch_idx)} slices sonified -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
