"""End-to-end demo on the synthetic toy set with the port: generate data in
memory, train, explain, optimise DRSA subspaces, evaluate, and save plots
and explanation audios (the reference's promised-but-missing notebooks,
README.md:37):

    python -m drsa_audio_tpu_torch.scripts.demo_toy_workflow --out demo_out [--per-class 160]

The flags of the JAX package's scripts/demo_toy_workflow.py, plus
``--device``. Training is ``scripts.common.train_toy``, the port's train
step with its mel masks and dropout drawn from a ``torch.Generator`` in
place of JAX keys; the extraction locations and restarts draw from the port's seeds too, so
the numbers differ from the JAX script's. The plots need matplotlib
(utils/visualization.py).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--per-class", type=int, default=160)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--num-concepts", type=int, default=2)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from drsa_audio_tpu_torch.data.toydata import generate_batch
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
    from drsa_audio_tpu_torch.runtime.wavio import write_wav
    from drsa_audio_tpu_torch.scripts.common import toy_mels, train_toy
    from drsa_audio_tpu_torch.utils import visualization as viz
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_TOY
    from drsa_audio_tpu_torch.utils.device import resolve_device
    from drsa_audio_tpu_torch.utils.profiling import PhaseTimer
    from drsa_audio_tpu_torch.xai.drsa.optimizer import fit as drsa_fit
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import normalize_vectors, preprocess_data
    from drsa_audio_tpu_torch.xai.eval.concept_recovery import band_assignment, profile_diversity
    from drsa_audio_tpu_torch.xai.eval.harness import concept_flipping
    from drsa_audio_tpu_torch.xai.explain import HeatmapGenerator
    from drsa_audio_tpu_torch.xai.lrp.engine import Composite
    from drsa_audio_tpu_torch.xai.sonify.mel2audio import Mel2Audio

    device = resolve_device(args.device, "demo_toy_workflow")
    os.makedirs(args.out, exist_ok=True)
    timer = PhaseTimer()
    fe = FrontendConfig.for_case("toy")
    rng = np.random.default_rng(0)
    K, layer_idx = args.num_concepts, 10

    with timer.phase("generate"):
        wavs = np.concatenate([generate_batch(rng, "class1", args.per_class),
                               generate_batch(rng, "class2", args.per_class)])
        labels = np.concatenate([np.zeros(args.per_class),
                                 np.ones(args.per_class)]).astype(np.int64)

    with timer.phase("train"):
        specs, params, loss, acc = train_toy(wavs, labels, args.epochs, 32, device)
        print(f"final train loss {loss.item():.4f} acc {acc.item():.3f}")

    composite = Composite.from_list(LRP_NAME_MAP_TOY)

    with timer.phase("drsa_data"):
        x1 = generate_batch(np.random.default_rng(7), "class1", 64, concept_idcs=(1, 2, 3, 4))
        mels1 = toy_mels(x1, device)
        act, ctx = preprocess_data(specs, params, mels1, composite, layer_idx, class_idx=0,
                                   num_locations=16, generator=3, device=device)

    with timer.phase("drsa_fit"):
        res = drsa_fit(normalize_vectors(act), normalize_vectors(ctx), num_concepts=K,
                       steps=args.steps, runs=3, seed=0, device=device)
        best = int(res.best_run)
        U = res.U[best].cpu().numpy()
        print(f"DRSA best run {best + 1}, objective {float(res.objectives[best, -1]):.4f}")
        viz.plot_drsa_objective(res.objectives).figure.savefig(
            os.path.join(args.out, "drsa_objective.png"), dpi=120)

    with timer.phase("explain"):
        gen = HeatmapGenerator(specs=specs, params=params, U=U, name_map=LRP_NAME_MAP_TOY,
                               sample_class="class1", num_concepts=K, layer_idx=layer_idx,
                               device=device)
        gen.generate_subspace_heatmaps(mels1[:8])
        info = gen.info
        fig = viz.make_drsa_subplot(
            mels1[0, 0], info["standard_heatmaps"][0, 0],
            [info["subspace_heatmaps"][0, k] for k in range(K)], case="toy",
            suptitle="class1 sample: standard + subspace explanations")
        fig.savefig(os.path.join(args.out, "explanations.png"), dpi=120)

    with timer.phase("concept_recovery"):
        RU = gen.generate_subspace_heatmaps(mels1, concept_flipping=True)
        shares, assignment, coverage = band_assignment(RU, "class1")
        print(f"subspace->concept band assignment: {assignment} "
              f"(coverage {coverage}/{K}; diversity {profile_diversity(RU):.3f})")

    with timer.phase("flipping"):
        x2 = generate_batch(np.random.default_rng(8), "class2", 8, concept_idcs=(1, 2, 3, 4))
        batch = torch.cat([mels1[:8], toy_mels(x2, device)])
        aupc, mean_logits, flips, _ = concept_flipping(
            specs, params, batch, LRP_NAME_MAP_TOY, layer_idx,
            Us={"class1": U, "class2": U}, num_concepts=K, case="toy",
            perturbation_size=16, device=device)
        print(f"concept-flipping AUPC (lower = better): {aupc.mean():.4f}")
        viz.plot_aupcs({"drsa": aupc}, {"drsa": mean_logits}, flips).savefig(
            os.path.join(args.out, "aupc.png"), dpi=120)

    with timer.phase("sonify"):
        m2a = Mel2Audio(case="toy", nnls_iters=80, device=device)
        audios = m2a.make_audios(info, x1[0], num_concepts=K)
        write_wav(os.path.join(args.out, "original.wav"), x1[0][None], fe.sample_rate)
        write_wav(os.path.join(args.out, "explanation_standard.wav"), audios[0][None],
                  fe.sample_rate)
        for k in range(K):
            write_wav(os.path.join(args.out, f"explanation_concept{k + 1}.wav"),
                      audios[k + 1][None], fe.sample_rate)

    print()
    print(timer.summary())
    print(f"\nartifacts in {args.out}/")


if __name__ == "__main__":
    main()
