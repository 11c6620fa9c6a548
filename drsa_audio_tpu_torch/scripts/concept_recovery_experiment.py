"""Full concept-recovery experiment with the port: train the toy classifier,
run DRSA with K=4 at the reference's budget, and measure how many of the 4
ground-truth concepts the subspaces recover (band assignment and
separability against random-U baselines). Writes a small JSON report:

    python -m drsa_audio_tpu_torch.scripts.concept_recovery_experiment --out report.json

The flags of the JAX package's scripts/concept_recovery_experiment.py, plus
``--device``; the report has that script's keys. Training is the port's
train step with its draws from a ``torch.Generator``. The random-U
baselines are the port's ``random_orthogonal(seed, d)`` for seeds 101, 202
and 303 (numpy draws), and the extraction locations and DRSA restarts
draw from the port's seeds: these differ from the JAX package's draws, so
the report's numbers do too.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="recovery_report.json")
    ap.add_argument("--per-class", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--num-concepts", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--layer", type=int, default=10)
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from drsa_audio_tpu_torch.data.toydata import generate_batch
    from drsa_audio_tpu_torch.models.vgg import forward
    from drsa_audio_tpu_torch.scripts.common import toy_mels, train_toy
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_TOY
    from drsa_audio_tpu_torch.utils.device import resolve_device
    from drsa_audio_tpu_torch.xai.drsa.optimizer import fit as drsa_fit, random_orthogonal
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import normalize_vectors, preprocess_data
    from drsa_audio_tpu_torch.xai.eval.concept_recovery import band_assignment, profile_diversity
    from drsa_audio_tpu_torch.xai.eval.metrics import separability
    from drsa_audio_tpu_torch.xai.explain import HeatmapGenerator
    from drsa_audio_tpu_torch.xai.lrp.engine import Composite

    device = resolve_device(args.device, "concept_recovery_experiment")
    K, layer_idx = args.num_concepts, args.layer
    rng = np.random.default_rng(0)

    print(f"training on {2 * args.per_class} clips, {args.epochs} epochs ...", flush=True)
    wavs = np.concatenate([generate_batch(rng, "class1", args.per_class),
                           generate_batch(rng, "class2", args.per_class)])
    labels = np.concatenate([np.zeros(args.per_class),
                             np.ones(args.per_class)]).astype(np.int64)
    specs, params, _, _ = train_toy(wavs, labels, args.epochs, 64, device)

    # held-out accuracy (all-4-concept samples)
    t1 = generate_batch(np.random.default_rng(123), "class1", 64, (1, 2, 3, 4))
    t2 = generate_batch(np.random.default_rng(321), "class2", 64, (1, 2, 3, 4))
    lt = np.concatenate([np.zeros(64), np.ones(64)])
    with torch.no_grad():
        pred = forward(specs, params, toy_mels(np.concatenate([t1, t2]), device)).argmax(-1).cpu().numpy()
    acc = float((pred == lt).mean())
    print(f"held-out all-4 accuracy: {acc:.3f}")

    report = {"heldout_all4_accuracy": acc, "classes": {}}
    composite = Composite.from_list(LRP_NAME_MAP_TOY)

    def subspace_maps(U, cls, mels):
        gen = HeatmapGenerator(specs=specs, params=params, U=U, name_map=LRP_NAME_MAP_TOY,
                               sample_class=cls, num_concepts=K, layer_idx=layer_idx,
                               device=device)
        return gen.generate_subspace_heatmaps(mels, concept_flipping=True)

    for cls, class_idx in (("class1", 0), ("class2", 1)):
        x = generate_batch(np.random.default_rng(7 + class_idx), cls, 128,
                           concept_idcs=(1, 2, 3, 4))
        mels = toy_mels(x, device)
        act, ctx = preprocess_data(specs, params, mels, composite, layer_idx,
                                   class_idx=class_idx, num_locations=20, generator=3,
                                   device=device)
        res = drsa_fit(normalize_vectors(act), normalize_vectors(ctx), num_concepts=K,
                       steps=args.steps, runs=args.runs, seed=42, device=device)
        best = int(res.best_run)
        U = res.U[best].cpu().numpy()
        RU = subspace_maps(U, cls, mels)
        _, assignment, coverage = band_assignment(RU, cls)
        sep_opt, _ = separability(np.maximum(RU, 0))

        seps_rand, covs_rand, divs_rand = [], [], []
        for seed in (101, 202, 303):
            RU_r = subspace_maps(random_orthogonal(seed, U.shape[0]), cls, mels)
            s, _ = separability(np.maximum(RU_r, 0))
            seps_rand.append(float(s))
            _, _, c = band_assignment(RU_r, cls)
            covs_rand.append(c)
            divs_rand.append(profile_diversity(RU_r))

        entry = {
            "final_objective": float(res.objectives[best, -1]),
            "assignment": {str(k): v for k, v in assignment.items()},
            "coverage": coverage,
            "diversity": profile_diversity(RU),
            "separability": float(sep_opt),
            "random_separability_mean": float(np.mean(seps_rand)),
            "random_coverage_mean": float(np.mean(covs_rand)),
            "random_diversity_mean": float(np.mean(divs_rand)),
        }
        report["classes"][cls] = entry
        print(cls, json.dumps(entry, indent=2), flush=True)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report -> {args.out}")


if __name__ == "__main__":
    main()
