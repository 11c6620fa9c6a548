"""Optimise DRSA subspaces for every class and layer with the port
(reference cxai/xai/drsa/cluster/optsubspaces.py:8-64):

    python -m drsa_audio_tpu_torch.scripts.optimize_subspaces --data DIR --out DIR

The flags of the JAX package's scripts/optimize_subspaces.py, plus
``--device``. Reads the ``.npz`` files of either package's extraction;
all pairs of one layer (one d) and all their restarts run as one
``fit_batched``. Writes the JAX layout: ``{out}/{class}/layer{L}/run{r}/``
with ``projection_matrix.npy`` and ``train_stats.csv`` (save_drsa_run).
The restarts start from the port's ``init_runs(seed)``, whose draws differ
from the JAX package's.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True, help="extract_drsa_data output root")
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-concepts", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ortho", choices=["ns", "eigh"], default="ns")
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from drsa_audio_tpu_torch.utils.device import resolve_device
    from drsa_audio_tpu_torch.utils.evaluation import save_drsa_run
    from drsa_audio_tpu_torch.xai.drsa.optimizer import fit_batched
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import normalize_vectors

    device = resolve_device(args.device, "optimize_subspaces")
    groups = defaultdict(list)  # layer -> [(cls, act, ctx)]
    for cls in sorted(os.listdir(args.data)):
        cls_dir = os.path.join(args.data, cls)
        if not os.path.isdir(cls_dir):
            continue
        for fname in sorted(os.listdir(cls_dir)):
            if not fname.startswith("dataset_layer"):
                continue
            layer = fname[len("dataset_layer"):-len(".npz")]
            data = np.load(os.path.join(cls_dir, fname))
            act = normalize_vectors(torch.as_tensor(data["activations"], device=device))
            ctx = normalize_vectors(torch.as_tensor(data["contexts"], device=device))
            groups[layer].append((cls, act, ctx))

    for layer, entries in sorted(groups.items()):
        t0 = time.perf_counter()
        res = fit_batched([(a, c) for _, a, c in entries], num_concepts=args.num_concepts,
                          steps=args.steps, runs=args.runs, seed=args.seed,
                          ortho_method=args.ortho, device=device)
        final = res.objectives[..., -1].cpu()          # the readback waits for the fit
        dt = time.perf_counter() - t0
        for i, (cls, _, _) in enumerate(entries):
            for run in range(args.runs):
                run_dir = os.path.join(args.out, cls, f"layer{layer}", f"run{run + 1}")
                save_drsa_run(run_dir, res.U[i, run], res.objectives[i, run])
            best = int(res.best_run[i])
            print(f"{cls} layer {layer}: best run {best + 1}, "
                  f"objective {float(final[i, best]):.4f}")
        print(f"layer {layer}: {len(entries)} classes x {args.runs} runs x "
              f"{args.steps} steps in {dt:.1f}s (one batched fit)", flush=True)


if __name__ == "__main__":
    main()
