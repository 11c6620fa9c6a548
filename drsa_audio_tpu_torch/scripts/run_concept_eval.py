"""Concept-level evaluation sweep with the port: concept flipping, the
random-U baseline and separability/peakness over K x layer grids, plus the
standard-LRP AUPC baselines (reference cxai/xai/pixelflipping/cpf.py:241-476,
perform_cf, sep_and_peak, main):

    python -m drsa_audio_tpu_torch.scripts.run_concept_eval --case toy --data DIR \\
        --checkpoint MODEL_DIR --subspaces DIR --out DIR

The flags of the JAX package's scripts/run_concept_eval.py, plus
``--device``. Reads the port's ``ckpt_N.pt`` and either package's
``{subspaces}/{K}_concepts/{class}/layer{L}/run*`` runs; writes the JAX
script's files under the same names: ``{alg}_aupcs_k{K}_layer{L}.npy``,
``standard_same_layer{L}.npy``, ``{alg}_sep_peak_scores_k{K}_layer{L}.npz``,
``{alg}_sep_peak_k{K}.npy``, ``sep_peak_analysis.json``,
``interclass_layer{L}.npy`` (and ``_samples.npy``, ``_ci.json``),
``standard_R.npy`` and ``drsa_vs_standard_ci.json``. The concept maps run
through the chain kernels (HeatmapGenerator). The random baseline's U and
the random flipping order draw from numpy and torch, not from JAX keys.
"""

from __future__ import annotations

import argparse
import json
import os


def _verdict(lo: float, hi: float) -> str:
    return "DRSA better" if hi < 0 else "standard better" if lo > 0 else "not significant"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config")
    ap.add_argument("--case", choices=["gtzan", "gtzan_6s", "toy"], default="gtzan")
    ap.add_argument("--data", required=True)
    ap.add_argument("--checkpoint", required=True, help="directory of ckpt_N.pt files")
    ap.add_argument("--epoch", type=int, help="default: latest ckpt")
    ap.add_argument("--subspaces", required=True, help="optimize_subspaces output root")
    ap.add_argument("--out", required=True)
    ap.add_argument("--algorithms", nargs="+", default=["drsa", "random"])
    ap.add_argument("--num-concepts", type=int, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 4, 7, 10, 13])
    ap.add_argument("--interclass-layer", type=int, default=None,
                    help="also run the interclass concept-flipping matrix "
                         "(cpf.py:87-181) at this layer")
    ap.add_argument("--forward-batch", type=int, default=512,
                    help="flipper forward chunk (bounds device memory)")
    ap.add_argument("--attr-batch", type=int, default=32,
                    help="heatmap/LRP attribution chunk (bounds device memory)")
    ap.add_argument("--gamma", type=float,
                    help="rescale the case name map's gamma rules to this "
                         "base value (decay pattern preserved) — composite-"
                         "sensitivity legs")
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from drsa_audio_tpu_torch.data.datasets import get_data_main, get_songs_toy
    from drsa_audio_tpu_torch.models.vgg import forward
    from drsa_audio_tpu_torch.scripts.common import class_mapper, experiment_config, load_model
    from drsa_audio_tpu_torch.utils.constants import rescale_gamma
    from drsa_audio_tpu_torch.utils.device import resolve_device
    from drsa_audio_tpu_torch.utils.evaluation import load_projection_matrix
    from drsa_audio_tpu_torch.xai.eval.flipping import Flipper
    from drsa_audio_tpu_torch.xai.eval.harness import (
        PixelFlipping, cf_random_subspace, concept_flipping, interclass_concept_flipping)
    from drsa_audio_tpu_torch.xai.eval.metrics import (
        cancellation_factor, negative_mass_fraction, peakness, peakness_scores,
        separability, separability_scores)
    from drsa_audio_tpu_torch.xai.eval.stats import interclass_gap_ci, paired_diff_ci

    device = resolve_device(args.device, "run_concept_eval")
    cfg = experiment_config(args.config, args.case)
    name_map = cfg.lrp_name_map
    if args.gamma is not None:
        name_map = rescale_gamma(name_map, args.gamma)
    specs, params = load_model(cfg, args.checkpoint, args.epoch, device)
    mapper = class_mapper(cfg.case)

    # subspace dim at a layer = out-channels of the conv feeding it, from the
    # model specs (SUBSPACE_DIMS_GTZAN/_TOY for the 5-block nets at layers
    # [1,4,7,10,13], reference cpf.py:260,312; {100,128,128} at the 6 s
    # model's layers {19,26,33})
    def dim_at(layer_idx):
        d = None
        for s in specs:
            if s.kind == "conv":
                d = s.config["out_ch"]
            if s.name == f"features.{layer_idx}":
                return d
        raise ValueError(f"features.{layer_idx} not in model")

    dim_by_layer = {li: dim_at(li) for li in args.layers}

    def class_us(k, layer_idx):
        return {cls: load_projection_matrix(os.path.join(
            args.subspaces, f"{k}_concepts", cls, f"layer{layer_idx}")) for cls in mapper}

    if cfg.case == "toy":
        parts = []
        for cls in mapper:
            b, _ = get_songs_toy(args.data, cls, split="test", N=cfg.eval.samples_per_class,
                                 device=device)
            parts.append(b[:cfg.eval.samples_per_class])
        batch = np.concatenate(parts, axis=0)
    else:
        batch, _ = get_data_main(args.data, cfg.eval.samples_per_class,
                                 fold=cfg.train.validation_fold,
                                 num_chunks=cfg.eval.num_chunks, case=cfg.case, device=device)
    os.makedirs(args.out, exist_ok=True)

    std_same = {}   # layer -> same-composite standard AUPC per instance
    sp_scores = {}  # (alg, k, layer) -> per-instance sep/peak (+relu variants)
    for alg in args.algorithms:
        for k in args.num_concepts:
            sep_rows, peak_rows = [], []
            for layer_idx in args.layers:
                if alg == "random":
                    RU = cf_random_subspace(specs, params, batch, name_map, layer_idx,
                                            dim=dim_by_layer[layer_idx], num_concepts=k,
                                            case=cfg.case, attr_batch_size=args.attr_batch,
                                            device=device)
                    aupc = None
                else:
                    aupc, _, _, RU = concept_flipping(
                        specs, params, batch, name_map, layer_idx, class_us(k, layer_idx),
                        num_concepts=k, case=cfg.case,
                        perturbation_size=cfg.eval.perturbation_size,
                        forward_batch=args.forward_batch, attr_batch_size=args.attr_batch,
                        device=device)
                    np.save(os.path.join(args.out, f"{alg}_aupcs_k{k}_layer{layer_idx}.npy"),
                            aupc)
                    if layer_idx not in std_same:
                        # the SAME-composite standard baseline: the K subspace
                        # maps sum exactly to the standard map of the name map
                        # the DRSA side uses (LRP is linear, K-independent), so
                        # flipping their sum is standard flipping under that
                        # composite, the comparison the reference makes
                        # (cpf.py main: one name_map for both sides)
                        flp = Flipper(cfg.eval.perturbation_size,
                                      forward_batch=args.forward_batch, device=device)
                        R_sum = torch.as_tensor(RU).sum(dim=1)[:, None, None]
                        a_std, _, _ = flp(lambda t: forward(specs, params, t), batch, R_sum)
                        std_same[layer_idx] = np.asarray(a_std)
                        np.save(os.path.join(args.out, f"standard_same_layer{layer_idx}.npy"),
                                std_same[layer_idx])
                        print(f"standard (same composite) layer={layer_idx}: "
                              f"AUPC {std_same[layer_idx].mean():.4f}")
                s, se = separability(RU)
                p, pe = peakness(RU)
                sep_rows.append((s, se))
                peak_rows.append((p, pe))
                # per-instance scores for the bootstrap CIs, with the same
                # scores on relu'd maps and the raw maps' negative-mass
                # fraction, which probe the signed metrics
                RU_pos = np.clip(RU, 0.0, None)
                sp_scores[(alg, k, layer_idx)] = {
                    "sep": separability_scores(RU),
                    "peak": peakness_scores(RU),
                    "sep_pos": separability_scores(RU_pos),
                    "peak_pos": peakness_scores(RU_pos),
                    "neg_mass": negative_mass_fraction(RU),
                    "cancellation": cancellation_factor(RU),
                }
                np.savez(os.path.join(args.out,
                                      f"{alg}_sep_peak_scores_k{k}_layer{layer_idx}.npz"),
                         **sp_scores[(alg, k, layer_idx)])
                print(f"{alg} K={k} layer={layer_idx}: sep={s:.4f} peak={p:.4f}"
                      + (f" aupc={aupc.mean():.4f}" if aupc is not None else ""), flush=True)
            np.save(os.path.join(args.out, f"{alg}_sep_peak_k{k}.npy"),
                    np.array([sep_rows, peak_rows]))

    # sep/peak DRSA against random with paired bootstrap CIs (the same eval
    # instances on both sides), on raw and relu'd maps
    if "drsa" in args.algorithms and "random" in args.algorithms:
        analysis = {}
        for k in args.num_concepts:
            for layer_idx in args.layers:
                dd = sp_scores.get(("drsa", k, layer_idx))
                rr = sp_scores.get(("random", k, layer_idx))
                if dd is None or rr is None:
                    continue
                entry = {"neg_mass": {"drsa": dd["neg_mass"], "random": rr["neg_mass"]},
                         "cancellation": {"drsa": dd["cancellation"],
                                          "random": rr["cancellation"]}}
                for m in ("sep", "peak", "sep_pos", "peak_pos"):
                    diff, lo, hi = paired_diff_ci(dd[m], rr[m])
                    entry[m] = {"drsa": float(dd[m].mean()), "random": float(rr[m].mean()),
                                "diff": diff, "ci95": [lo, hi],
                                "significant": bool(lo > 0 or hi < 0)}
                analysis[f"k{k}_layer{layer_idx}"] = entry
                print(f"sep/peak CIs K={k} layer={layer_idx}: "
                      + " ".join(f"{m}: d-r={entry[m]['diff']:.3g} "
                                 f"[{entry[m]['ci95'][0]:.3g},{entry[m]['ci95'][1]:.3g}]"
                                 for m in ("sep", "peak", "sep_pos", "peak_pos")))
        with open(os.path.join(args.out, "sep_peak_analysis.json"), "w") as f:
            json.dump(analysis, f, indent=1)

    # interclass concept-specificity matrix (cpf.py:87-181) at one layer
    if args.interclass_layer is not None:
        li = args.interclass_layer
        k0 = args.num_concepts[0]
        samples = interclass_concept_flipping(
            specs, params, batch, name_map, {li: class_us(k0, li)}, layer_idcs=(li,),
            num_concepts=k0, case=cfg.case, perturbation_size=cfg.eval.perturbation_size,
            forward_batch=args.forward_batch, attr_batch_size=args.attr_batch,
            return_samples=True, device=device)[0]     # [n, n, per-class samples]
        mat = samples.mean(axis=-1)
        np.save(os.path.join(args.out, f"interclass_layer{li}.npy"), mat)
        np.save(os.path.join(args.out, f"interclass_layer{li}_samples.npy"), samples)
        gap, lo, hi = interclass_gap_ci(samples)
        offdiag = (mat.sum() - np.trace(mat)) / (mat.size - len(mat))
        print(f"interclass layer {li}: diag {np.diag(mat).mean():.4f} offdiag {offdiag:.4f} "
              f"gap {gap:.4f} [95% CI {lo:.4f}, {hi:.4f}]"
              + ("" if lo > 0 else " — NOT significant"))
        with open(os.path.join(args.out, f"interclass_layer{li}_ci.json"), "w") as f:
            json.dump({"gap": gap, "ci95": [lo, hi], "significant": bool(lo > 0)}, f)

    # standard-LRP AUPC baseline (cpf.py:461-472), the scaled-gamma 0.4 grid
    pf = PixelFlipping(specs, params, batch, perturbation_size=cfg.eval.perturbation_size,
                       num_classes=len(mapper), forward_batch=args.forward_batch,
                       attr_batch_size=args.attr_batch, device=device)
    grid = [{"convolutional": ("gamma", 0.4), "dense": ("epsilon", 1e-7),
             "first_layer": ("wsquare",)}]
    aupc_scores, _, _, _ = pf(grid, scaled_gamma=True)
    std_scores = None
    for name, scores in aupc_scores.items():
        std_scores = np.asarray(scores)
        np.save(os.path.join(args.out, "standard_R.npy"), scores)
        print(f"standard LRP ({name}): AUPC {scores.mean():.4f}")

    # paired bootstrap CI of (DRSA - standard) AUPC per layer: the same
    # balanced batch and instances, so pairing removes between-clip variance.
    # The same-composite standard is the primary comparison; the
    # scaled-gamma 0.4 line is the strongest standard composite beside it.
    if "drsa" in args.algorithms:
        cis = {}
        for k in args.num_concepts:
            for layer_idx in args.layers:
                p = os.path.join(args.out, f"drsa_aupcs_k{k}_layer{layer_idx}.npy")
                if not os.path.exists(p):
                    continue
                entry = {}
                for key, label, ref in (
                        ("same_composite", "same composite", std_same.get(layer_idx)),
                        ("scaled_gamma_04", "scaled-gamma 0.4", std_scores)):
                    if ref is None:
                        continue
                    d, lo, hi = paired_diff_ci(np.load(p), ref)
                    entry[key] = {"mean_diff": d, "ci95": [lo, hi], "verdict": _verdict(lo, hi)}
                    print(f"DRSA-vs-standard({label}) K={k} layer={layer_idx}: diff {d:+.4f} "
                          f"[95% CI {lo:+.4f}, {hi:+.4f}] {_verdict(lo, hi)}")
                cis[f"k{k}_layer{layer_idx}"] = entry
        with open(os.path.join(args.out, "drsa_vs_standard_ci.json"), "w") as f:
            json.dump(cis, f, indent=1)


if __name__ == "__main__":
    main()
