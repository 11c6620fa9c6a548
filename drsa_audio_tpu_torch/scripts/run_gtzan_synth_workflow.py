"""Post-training GTZAN-scale rehearsal with the port: extract -> optimise ->
evaluate -> prototypes and sonification, writing under ``--run-dir``:

    python -m drsa_audio_tpu_torch.scripts.run_gtzan_synth_workflow --data CORPUS

Assumes the 6 s BN model is already trained into ``{run_dir}/model``
(``python -m drsa_audio_tpu_torch.scripts.train --case gtzan_6s``). Mirrors
the reference cluster scripts' flagship workload: DRSA at layers
{19,26,33}, num_locations=20 (getdrsadata.py:63-141), K=4 at 5000 steps x 3
runs (optsubspaces.py:8-64), concept and interclass flipping on a balanced
eval batch (cpf.py:398-476).

The stages, flags, ``--skip`` and timing lines of the JAX package's
scripts/run_gtzan_synth_workflow.py, plus ``--device``, which every stage
gets. Each stage is the port's CLI ``main(argv)`` called in this process,
not a subprocess, so one process holds the kernels' launch counters of
the whole workflow. ``--samples-per-class`` reaches the evaluation through
``{run_dir}/config.json`` (the 6 s default with ``eval.samples_per_class``
set), which every stage reads; the JAX script accepts the flag and leaves
the evaluation at the default's 20.
"""

from __future__ import annotations

import argparse
import os
import time


def run(desc: str, main, argv: list) -> None:
    t0 = time.perf_counter()
    print(f"=== {desc}: {' '.join(argv)}", flush=True)
    main(argv)
    print(f"=== {desc} done in {time.perf_counter() - t0:.1f}s", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True, help="synthetic corpus root")
    ap.add_argument("--run-dir", default="runs/gtzan_synth")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--num-concepts", type=int, default=4)
    ap.add_argument("--layers", type=int, nargs="+", default=[19, 26, 33])
    ap.add_argument("--samples-per-class", type=int, default=20)
    ap.add_argument("--num-clips", type=int, default=300,
                    help="DRSA clips per class (reference: 30 songs x 10 "
                         "chunks -> 6000 vectors at 20 locations)")
    ap.add_argument("--skip", nargs="+", default=[],
                    choices=["extract", "optimize", "eval", "prototypes"])
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    from drsa_audio_tpu_torch.scripts import (
        extract_drsa_data, optimize_subspaces, run_concept_eval, sonify_prototypes)
    from drsa_audio_tpu_torch.utils.config import ExperimentConfig
    from drsa_audio_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(args.device, "run_gtzan_synth_workflow"))
    rd = args.run_dir
    model = os.path.join(rd, "model")
    drsa_data = os.path.join(rd, "drsa_data")
    subspaces = os.path.join(rd, "subspaces", f"{args.num_concepts}_concepts")
    eval_dir = os.path.join(rd, "eval")
    layer_args = [str(li) for li in args.layers]
    os.makedirs(rd, exist_ok=True)
    config = os.path.join(rd, "config.json")
    cfg = ExperimentConfig.gtzan_6s_default()
    cfg.eval.samples_per_class = args.samples_per_class
    cfg.save(config)
    common = ["--config", config, "--data", args.data, "--checkpoint", model,
              "--device", device]

    if "extract" not in args.skip:
        run("DRSA extraction (layers {19,26,33}, 20 locations)", extract_drsa_data.main, [
            *common, "--out", drsa_data, "--layers", *layer_args,
            "--num-clips", str(args.num_clips)])

    if "optimize" not in args.skip:
        run(f"DRSA optimization (K={args.num_concepts}, "
            f"{args.steps}x{args.runs}, batched sweep)", optimize_subspaces.main, [
            "--data", drsa_data, "--out", subspaces,
            "--num-concepts", str(args.num_concepts),
            "--steps", str(args.steps), "--runs", str(args.runs), "--device", device])

    if "eval" not in args.skip:
        run("concept + interclass flipping eval", run_concept_eval.main, [
            *common, "--subspaces", os.path.join(rd, "subspaces"), "--out", eval_dir,
            "--num-concepts", str(args.num_concepts), "--layers", *layer_args,
            "--interclass-layer", layer_args[-1]])

    if "prototypes" not in args.skip:
        run("prototypes + sonification (pop, deepest layer)", sonify_prototypes.main, [
            *common, "--subspaces", subspaces, "--out", os.path.join(rd, "sonified"),
            "--sample-class", "pop", "--layer", str(args.layers[-1]),
            "--num-concepts", str(args.num_concepts)])

    print("workflow complete:", rd, flush=True)


if __name__ == "__main__":
    main()
