#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (drsa_audio_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the six CUDA kernels
   (csrc/*.cu, one nvcc each, in parallel) and beside them the native
   runtime (csrc/audio_runtime.cpp with g++: WAV decode, Telea), and counts
   the HMMA
   (tensor-core) instructions in the SASS of chain_block, first_block_deep,
   merged_tail and gamma_nonneg (cuobjdump): it fails where there are none.
2. Serves three requests of 32 clips, one class each, through
   ExplainerService on the GTZAN-3s model at full width (seeded random
   weights and U), with every launch counter set to 0 just before and read
   just after: each request must launch chain_block 3 times and first_layer
   once. The heatmaps must be finite, the standard map must be the sum of
   the subspace maps, and one request must agree with the plain path
   (fused=False).
3. Holds the card against the CPU path on four clips: the log-mel, then the
   heatmaps and logits computed from the same mels. Each CPU reference is
   computed until two runs give the same bits (host_reference).
4. Records the inputs of the four kernel launches of one 256-clip request,
   holds each kernel against its plain PyTorch version on them (TF32 off),
   and times both with CUDA events beside the kernel's lower bound. Each
   kernel runs twice on each recorded input and must give the same bits.
5. Times one 256-clip request end to end, then the service's own stages of
   the same request (upload, front-end, forward + upper LRP, lower segment,
   readback, sort; medians of STAGE_REPS), and traces one request with
   torch.profiler for the device time of each kernel and the idle share.
5m. The merged-tail path (the switch chain.CHAIN_MERGED set here, the
   DRSA_CHAIN_MERGED variable cleared at start): three 32-clip 3s requests
   with the counters set to 0 just before and read just after (chain_block
   and merged_tail once each, first_layer never, per request), the checks
   of 2 and one request against the default multi-kernel path; one 32-clip
   toy request (8/16 channels, 64x64 mels) the same; then the two launches
   of one 256-clip request held against their plain versions and timed
   (merged_tail also by launch: its chain_gamma_prep launches, the main
   kernel and the rest of the wrapper's call on one line,
   merged_tail_split_*), and that request end to end, by stages and traced,
   as 4 and 5, with the default request's peak device memory beside its
   own.
6. The GTZAN-6s flagship at full width (filters 64/64/100/128/128, 6 s clips
   of 96,000 samples, 128x256 mels; seeded random weights and BatchNorm
   statistics, folded): three requests of 32 clips at DRSA layer 33 with the
   counters set to 0 just before and read just after (chain_block 4 times,
   first_block_deep once, first_layer never, per request), the same checks
   as 2; then one 32-clip request each at layers 26 and 19 (chain_block 3
   and 2 times). One layer-33 request with the merged-tail switch on must
   launch merged_tail 0 times: the 6s model does not merge.
7. Records the five kernel launches of one 64-clip layer-33 request and
   holds and times each against its plain version, as 4.
8. Times one 64-clip 6s request end to end, by stages, and traced, as 5.
9. The shared-denominator path (subspace_heatmaps with
   shared_denominators=True after the service's peak_normalize and logmel,
   signed-permutation U): three 32-clip 3s requests with the counters set
   to 0 just before each and read just after (gamma_nonneg 3 times, no
   chain kernel), finite heatmaps, standard = sum of the subspace maps; the
   shared walk below the filter on the card against a CPU copy of its own
   recorded inputs (strict), and the request against the default chain on
   the same mels by subspace relevances and heatmap correlation (loose);
   the three launches of one 256-clip request held against the plain
   version, run twice (same bits) and timed, whole and by launch (the
   prep, the apply and the rest of the wrapper's call on one line,
   gamma_nonneg_split_*), that request's lower segment and peak memory
   beside the default path's, and the request traced. Then one 32-clip 6s
   layer-33 request (gamma_nonneg 9 times), its checks, its nine
   launches held and timed the same way, and its lower segment and peak
   memory beside the default path's.
10. The log-mel kernel (fused_logmel) on the peak-normalised waveforms of
   the 256-clip 3s, 64-clip 6s and 32-clip toy requests: launch count,
   error against the plain version and the service's matmul-DFT logmel, the
   same bits on a second run, and the kernel's, the plain version's, the
   matmul-DFT logmel's and the FFT logmel's (torch.fft.rfft, library_ms)
   times beside the bound.
11. Fit then serve. GTZAN-3s at layer 10, all 10 classes: 300 seeded
   noise clips a class through the service's front-end, preprocess_data
   (20 locations a clip, attribution in chunks of 64: 6,000 vectors a
   class), the extraction of 4 clips on the card against the CPU (the
   captured maps, LRP tolerance), normalize_vectors, 30 steps of drsa_fit
   on the card against the CPU from one U0 (objectives at rtol 2e-2), one
   fit_batched of the 10 classes (3 runs x 5,000 Newton-Schulz steps, seed
   42; 100 more steps traced for the device's busy time a step), every U
   orthogonal (1e-4) and every best run ending above its start; every run
   saved (save_drsa_run) and each class's best loaded back bit-equal; an
   ExplainerService with the loaded Us serving one 32-clip request for two
   classes (checked as 2); HeatmapGenerator with a fitted U on 64 clips in
   chunks of 32 (chain_block 6, first_layer 2, counters set to 0 just
   before and read just after), its maps against subspace_heatmaps(...,
   fused=False) on the same chunks, then one 32-clip chunk with
   shared_denominators=True (gamma_nonneg 3, no chain kernel);
   get_prototypes (10 subsets of 10 clips). GTZAN-6s at layer 33: 64 clips
   extracted, fit (3 runs x 5,000 steps), HeatmapGenerator on 32 clips
   (chain_block 4, first_block_deep 1). Times: extraction per 64-clip
   chunk, fit wall time and ms per step, the generator per chunk with its
   peak memory.
12. Evaluate and sonify, with phase 11's loaded 3s layer-10 Us. Files: 256
   seeded 3 s 16 kHz WAVs, two at 22,050 Hz and one of 0.5 s, written with
   the port's write_wav; the native decode of each equal to read_wav;
   explain_files (batches of 64, 4 decode threads, prefetch depth 2; the
   counted run) timed beside explain on the same batches in memory, and, with
   cuDNN held to deterministic algorithms, bit-equal to explain on the
   waveforms decoded, resampled and padded here. Concept flipping of 10
   classes x 20 seeded noise clips at perturbation 16 (6 steps, 1,200
   forwards in chunks of 512, attribution in chunks of 32; chain_block 30,
   first_layer 10), finite AUPC, and Flipper on 20 of them on the card
   against the CPU given the same maps (clips whose keep masks differ
   between the devices left out, at least half must agree). Standard LRP:
   PixelFlipping, scaled gamma 0.4 / epsilon / wsquare (no kernel), one
   inpainting Flipper on 20 clips. interclass_concept_flipping at layer 10
   with samples (chain_block 300, first_layer 100), interclass_gap_ci,
   paired_diff_ci of DRSA against standard, cf_random_subspace (d 64, 3
   permutations; chain_block 90, first_layer 30), sep_and_peak_table and
   cancellation_factor of the DRSA and random maps. Mel2Audio('gtzan')
   make_audios and transform_mel of 2 clips, card against CPU. Toy: 2
   classes x 16 clips of generate_batch through concept flipping
   (chain_block 6, first_layer 2), band_assignment and Mel2AudioToy. Each
   step's ms on a line of its own.
13. Train, then explain. A corpus written with the port's write_wav: 10
   genres x 20 clips of 30 s at 16 kHz (seeded noise over a tone of the
   genre's pitch) with its 5folds lists, fold 1 held out (160 clips train,
   40 validate), fed by GtzanWaveDataset(device_cache=True). GTZAN-3s at
   full width with gtzan_augment_and_mel (augmentation on), 50 timed steps
   at batch 16 and at 128 (TrainConfig's learning rate), every launch
   counter read around them (training launches no kernel): ms per step,
   clips/s, the augment + mel's share (CUDA events around it alone), the
   device's idle share of one traced step, peak memory. Card against CPU on
   8 held-out clips: the augment + mel from CPU-drawn draws (mel power rtol
   1e-4, atol 1e-5 * the clip's peak; log10 rtol 1e-4, atol 1e-4 on the
   clips neither filtered nor pitch-shifted), then one step from the same
   mels, params and keep masks (loss rtol 1e-5; gradients and updated
   params rtol 1e-4, atol 1e-5 * max|CPU| per tensor). 10 steps, a
   checkpoint saved and loaded, 10 more: bit-equal to 20 uninterrupted
   steps, cuDNN held deterministic. fit for one epoch, validated on every
   chunk of the held-out fold (valid_chunks_to_mels), then get_acc and
   get_cm. The trained weights served at layer 10 (one 32-clip request,
   chain_block 3, first_layer 1, checked as 2). The GTZAN-6s flagship with
   BatchNorm at full width: 20 steps at batch 16, timed as 3s; every BN
   layer's running statistics moved, finite; one step card against CPU at
   batch 4; folded and served at layer 33 (chain_block 4, first_block_deep
   1), checked as 2 but for the match with the plain walk: after 20 steps
   its LRP walk is ill-conditioned (a 1e-7 change of the mels moves the
   plain walk's maps by up to their own size), so the request reports the
   kernels' distance from the plain walk beside the plain walk's own
   spread under that change, and fails if the kernels' median is over 10x
   it. The toy model through the port's CLI (python -m
   drsa_audio_tpu_torch.scripts.train --case toy, 12 epochs of
   generate_dataset's 50 clips a class) in a subprocess: exit 0, ckpt_12.pt
   and the stats CSV written, the last epoch's mean training loss below the
   first's.
14. The research workflow through the port's CLIs, each stage's
   ``main([...])`` called in this process on the card with every launch
   counter set to 0 just before and read just after, timed with the device
   synchronised, one line a stage; the counts must equal those derived
   from the stage's HeatmapGenerator chunks (chain_block 3 and first_layer
   1 a toy chunk, chain_block 4 and first_block_deep 1 a 6s chunk; none in
   generation, training, extraction and optimisation). Toy at full width
   (K=4, layer 10, d=16): generate_toydata (50 clips a class), train (8
   epochs), extract_drsa_data (20 locations), optimize_subspaces (500 steps
   x 3 runs: every U orthogonal to 1e-4, every best run ending above its
   start), run_concept_eval (DRSA and random, interclass at 10: AUPCs and
   CIs finite), sonify_prototypes (class1: finite WAVs of 15,120 samples)
   and concept_recovery_experiment (64 clips a class, 4 epochs, 300 steps);
   the prototype chunk's maps on the trained weights against the plain
   walk (rtol 1e-4, atol 1e-5 * max|plain|). demo_toy_workflow is not run:
   its plots need matplotlib, which the card's host lacks. GTZAN-6s at full
   width with BatchNorm: generate_gtzan_synth --multi-concept (10 songs a
   genre), train --case gtzan_6s (1 epoch), run_gtzan_synth_workflow at
   layer 33 (40 clips a class, 200 steps x 1 run, 2 songs a genre x 3
   chunks evaluated), one call a stage with --skip for the others; WAVs of
   91,800 samples; the prototype chunk's maps on the trained weights held
   as phase 13 holds the trained 6s model (within 10x the plain walk's own
   spread). Depth is cut (clips, epochs, steps, runs), never width: the
   cuts are listed in ``workflow``'s docstring.

The kernels line gives, for each kernel, its numbers per path under
"paths" (3s, 3s_merged and 3s_shared at batch 256, 6s at batch 64,
6s_shared at batch 32, per request: the launches of one request summed;
frontend_3s, frontend_6s and frontend_toy for the log-mel kernel at the
batches of 10) and at its top level their sums over the paths (launches:
the counts of the served requests of 2, 5m, 6 and 9, the calls of 10 and
the counted runs of 11, 12, 13 and 14, also apart under
fit_then_serve_launches, evaluate_launches, train_then_explain_launches and
workflow_launches (by CLI stage);
max_abs_err: the largest). The log-mel row also carries the matmul-DFT
logmel's time, and as library_ms the port's logmel(use_matmul_dft=False)
(cuFFT through torch.fft.rfft), which the port never calls on a path.
bound_ms is the least time for the work: the larger of bytes at 3.35 TB/s
and flops at three TF32 products each at 495 TFLOP/s (3xTF32 on the tensor
cores, the least time for f32-accurate products on this card); bound_tc_ms is the same number under its tensor-core name, and
bound_fma_ms the same with the flops at f32's 67 TFLOP/s on the FMA units.

Tolerance for every comparison: rtol 1e-4, atol 1e-5 * max|plain| (the JAX
package's own fused-vs-tiled bound); for the log-mel, rtol 1e-4, atol 1e-4
in log10 units (the JAX package's Pallas log-mel test). Prints JSON lines; the line before the
last is nvidia-smi's name and power limit, the last is the status line.
Exits non-zero, printing no result, where CUDA is unavailable.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

B_SERVE, B_KERNEL, B_KERNEL_6S, K = 32, 256, 64, 4
STAGE_REPS = 5
PEAK_FLOPS = 67e12        # H100 SXM, f32 outside the tensor cores
PEAK_TF32 = 495e12        # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TPU_KERNELS = {
    "chain_block": "drsa_audio_tpu/xai/lrp/pallas_chain.py:624",
    "first_layer": "drsa_audio_tpu/xai/lrp/pallas_chain.py:709",
    "first_block_deep": "drsa_audio_tpu/xai/lrp/pallas_chain.py:668",
    "merged_tail": "drsa_audio_tpu/xai/lrp/pallas_chain.py:746",
    "gamma_nonneg": "drsa_audio_tpu/xai/lrp/pallas_gamma.py:49",
    "logmel": "drsa_audio_tpu/ops/pallas_frontend.py:34",
}
CHAIN_KERNELS = ("chain_block", "first_layer", "first_block_deep", "merged_tail")
SOURCES = {
    "chain_block": "drsa_audio_tpu_torch/csrc/chain_block.cu",
    "first_layer": "drsa_audio_tpu_torch/csrc/first_layer.cu",
    "first_block_deep": "drsa_audio_tpu_torch/csrc/first_block_deep.cu",
    "merged_tail": "drsa_audio_tpu_torch/csrc/merged_tail.cu",
    "gamma_nonneg": "drsa_audio_tpu_torch/csrc/gamma_nonneg.cu",
    "logmel": "drsa_audio_tpu_torch/csrc/logmel.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_close(name: str, got, want, atol=None) -> float:
    """rtol 1e-4, atol 1e-5 * max|want| unless ``atol`` is given."""
    err = (got - want).abs().max().item()
    atol = 1e-5 * want.abs().max().item() if atol is None else atol
    bad = ((got - want).abs() > atol + 1e-4 * want.abs()).sum().item()
    if bad:
        raise AssertionError(f"{name}: {bad} of {want.numel()} elements outside "
                             f"rtol 1e-4, atol {atol:.3g} (max abs err {err:.3g})")
    return err


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bounds(flops: float, nbytes: float) -> dict:
    """The least time, ms, for the work: the larger of the bytes at the
    memory rate and the flops with every f32 product done on the tensor
    cores in 3xTF32 (three TF32 products each), the least time for
    f32-accurate products on this card (``bound_ms``, also under its
    tensor-core name ``bound_tc_ms``); and the same with the flops on the
    FMA units at f32's 67 TFLOP/s (``bound_fma_ms``)."""
    t_ops, t_bytes = 3.0 * flops / PEAK_TF32, nbytes / PEAK_BYTES
    least = max(t_ops, t_bytes) * 1e3
    return {"bound_ms": least, "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_tc_ms": least, "bound_fma_ms": max(flops / PEAK_FLOPS, t_bytes) * 1e3}


def hmma_counts(libs: dict) -> dict:
    """The HMMA (tensor-core) instructions in the SASS of the four
    tensor-core kernels' libraries, by cuobjdump; fails where there are
    none."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for name in ("chain_block", "first_block_deep", "merged_tail", "gamma_nonneg"):
        sass = subprocess.run([tool, "-sass", str(libs[name])], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        counts[name] = sum("HMMA" in line for line in sass.splitlines())
        if not counts[name]:
            raise AssertionError(f"{name}: no HMMA instruction in {libs[name].name}")
    return counts


def reset_counts() -> None:
    """Every kernel's launch counter to 0."""
    from drsa_audio_tpu_torch.ops import fused_frontend
    from drsa_audio_tpu_torch.xai.lrp import chain, fused_gamma
    for mod in (chain, fused_gamma, fused_frontend):
        mod.reset_launches()


def launch_counts() -> dict:
    from drsa_audio_tpu_torch.ops import fused_frontend
    from drsa_audio_tpu_torch.xai.lrp import chain, fused_gamma
    return {**chain.LAUNCHES, **fused_gamma.LAUNCHES, **fused_frontend.LAUNCHES}


def gamma_nonneg_work(x, R, w, b, K, **_):
    """The forward pair once per instance (2*b*H*W*9*Ci*2Co) and one
    transposed conv per clone over Co channels (2*K*b*H*W*9*Co*Ci): the
    masks m1 = [z_true > 0] and m3 = [z_true < 0] are disjoint, so each
    relevance entry meets one of the two weight sets only. x, R and the
    weights read once, R_in written once. Also the flops the kernel runs:
    its apply multiplies over all 2*Co channels of R * (m1, m3), twice the
    transposed conv's products counted above."""
    n, ci, H, W = x.shape
    co = w.shape[0]
    flops = 2.0 * n * H * W * 9 * ci * 2 * co + 2.0 * K * n * H * W * 9 * co * ci
    nbytes = 4.0 * (x.numel() + R.numel() + w.numel() + co + K * n * ci * H * W)
    return flops, nbytes, flops + 2.0 * K * n * H * W * 9 * co * ci


def gamma_nonneg_split_ms(x, R, w, b, K, gamma=0.25, stabilizer=1e-6) -> dict:
    """gamma_nonneg_folded's two launches timed apart on its own inputs
    (CUDA events, 5 calls each): the prep, the apply, and the rest of the
    wrapper's call (the weights' re-lay, the allocations, the host's time
    where the device waits for it) as the whole call less both."""
    import ctypes

    import torch
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma

    lib = fused_gamma._lib()
    n, ci, H, W = x.shape
    co = w.shape[0]
    wf, wt, bias3 = fused_gamma.pair_weights(w, b, gamma)
    x, R = x.contiguous(), R.contiguous()
    M = torch.empty((n, H, W, 2 * co), device=x.device)
    out = torch.empty((K * n, ci, H, W), device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    inv = float(np.float32(1.0 / (2.0 + gamma)))
    prep = lambda: lib.gamma_nonneg_prep(                                # noqa: E731
        x.data_ptr(), wf.data_ptr(), bias3.data_ptr(), M.data_ptr(), n, H, W, ci, co, inv,
        float(stabilizer), stream)
    apply = lambda: lib.gamma_nonneg_apply(                              # noqa: E731
        R.data_ptr(), M.data_ptr(), x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, K, H, W,
        ci, co, stream)
    if prep() or apply():
        raise AssertionError("gamma_nonneg: a timed launch was refused")
    whole = cuda_ms(lambda: fused_gamma.gamma_nonneg_folded(x, R, w, b, K, gamma, stabilizer), 5)
    out_ms = {"prep_ms": cuda_ms(prep, 5), "apply_ms": cuda_ms(apply, 5), "ms": whole}
    out_ms["rest_ms"] = whole - out_ms["prep_ms"] - out_ms["apply_ms"]
    return out_ms


def merged_tail_split_ms(R, xs, convs, apres, a1, fl) -> dict:
    """merged_tail's launches timed apart on its own inputs (CUDA events, 5
    calls each): the chain_gamma_prep launches together (one or two), the
    main kernel on their output, and the rest of the wrapper's call (checks,
    allocations, the host's time where the device waits for it) as the
    whole call less both."""
    from drsa_audio_tpu_torch.xai.lrp import chain

    preps = chain._merged_preps(xs, convs, apres)
    whole = cuda_ms(lambda: chain.merged_tail(R, xs, convs, apres, a1, fl), 5)
    out = {"prep_ms": cuda_ms(lambda: chain._merged_preps(xs, convs, apres), 5),
           "main_ms": cuda_ms(lambda: chain._merged_main(R, xs, convs, a1, fl, preps), 5),
           "ms": whole}
    out["rest_ms"] = whole - out["prep_ms"] - out["main_ms"]
    return out


def logmel_work(wav, cfg):
    """The least work the function needs per kept frame: the window, a real
    FFT (2.5 * n_fft * log2 n_fft, half a complex FFT's 5 N log2 N; the
    kernel's four-step FFT of dense small DFTs does about 6 times more at
    n_fft 800), the magnitude, the filterbank's nonzeros (2 each) and the
    log epilogue.
    The waveform read once, the window and the filterbank's nonzeros read
    once, the log-mels written once."""
    from drsa_audio_tpu_torch.ops.mel import mel_filterbank
    n_freq = cfg.n_fft // 2 + 1
    nnz = int(np.count_nonzero(mel_filterbank(n_freq, cfg.n_mels, cfg.sample_rate)))
    frames = wav.shape[0] * cfg.width
    per_frame = (cfg.n_fft + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 4.0 * n_freq
                 + 2.0 * nnz + 3.0 * cfg.n_mels)
    nbytes = 4.0 * (wav.numel() + cfg.n_fft + nnz + frames * cfg.n_mels)
    return frames * per_frame, nbytes


def chain_block_work(R, xs, convs, apre=None, pool=None):
    """Flops and bytes one chain_block call needs: per conv the two forward
    convs of the clone-shared prep and one transposed conv per clone (the
    second transposed conv of the gamma rule is identically zero under the
    relu gate, see csrc/chain_block.cu); each input read once, the output
    written once."""
    b, k = R.shape[:2]
    flops, nbytes = 0.0, 4.0 * R.numel()
    for x, cv in zip(xs, convs):
        H, W = x.shape[1:3]
        flops += 2.0 * (2 + k) * b * H * W * cv.ci * cv.co * 9
        nbytes += 4.0 * (x.numel() + 3 * cv.wz1.numel())     # the pair and the apply taps
    out = b * k * xs[-1].shape[1] * xs[-1].shape[2] * convs[-1].ci
    if apre is not None:
        nbytes += 4.0 * apre.numel()
        out *= pool[0] * pool[1]
    return flops, nbytes + 4.0 * out


def first_layer_work(R, a1, fl):
    b, k = R.shape[:2]
    H, W, C = a1.shape[1:]
    flops = 2.0 * b * k * H * W * C * 9
    nbytes = 4.0 * (R.numel() + a1.numel() + fl.z0.numel() + fl.taps.numel() + b * k * H * W)
    return flops, nbytes


def first_block_deep_work(R, a1, apre, gconv, fl, pool):
    """The gamma conv's two forward convs per instance and one transposed
    conv per clone (its zero term skipped, as in chain_block_work), then
    the 3x3 tail to one channel per clone; R, a1, apre, the weights and
    z0 read once, the K maps written once."""
    b, k = R.shape[:2]
    H, W, C0 = a1.shape[1:]
    C = apre.shape[-1]
    flops = 2.0 * (2 + k) * b * H * W * C0 * C * 9 + 2.0 * k * b * H * W * C0 * 9
    nbytes = 4.0 * (R.numel() + a1.numel() + apre.numel() + 3 * gconv.wz1.numel()
                    + fl.z0.numel() + fl.taps.numel()
                    + b * k * H * W)
    return flops, nbytes


def merged_tail_work(R, xs, convs, apres, a1, fl):
    """Per merged conv the two forward convs of the clone-shared prep and one
    transposed conv per clone (its zero term skipped), then the 3x3 tail
    per clone; R, the convs' inputs and weights, the pool inputs, a1, z0
    and the taps read once, the K maps written once."""
    b, k = R.shape[:2]
    H, W, C = a1.shape[1:]
    flops = 2.0 * k * b * H * W * C * 9
    nbytes = 4.0 * (R.numel() + a1.numel() + fl.z0.numel() + fl.taps.numel() + b * k * H * W
                    + sum(a.numel() for a in apres))
    for x, cv in zip(xs, convs):
        flops += 2.0 * (2 + k) * b * x.shape[1] * x.shape[2] * cv.ci * cv.co * 9
        nbytes += 4.0 * (x.numel() + 3 * cv.wz1.numel())
    return flops, nbytes


def staged_request(svc, wavs, class_name: str) -> dict:
    """One request through ``svc.explain`` with its own stages timed. The
    functions the service calls are wrapped for the call: CUDA events mark
    where each device stage ends, so the device stages are contiguous spans
    of the device's timeline; the device is synchronised before the readback,
    and the host clock times the readback and the sort. ``other_host`` is
    what the request took beyond all of these."""
    import torch
    from drsa_audio_tpu_torch import serving
    from drsa_audio_tpu_torch.xai import explain as explain_mod

    events, host = {}, {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    def device_stage(mod, attr, before=None, after=None):
        fn = getattr(mod, attr)

        def run(*args, **kwargs):
            if before:
                mark(before)
            out = fn(*args, **kwargs)
            if after:
                mark(after)
            return out
        return mod, attr, fn, run

    def host_stage(mod, attr, name):
        fn = getattr(mod, attr)

        def run(*args, **kwargs):
            if name == "readback":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host[name] = (time.perf_counter() - t0) * 1e3
            return out
        return mod, attr, fn, run

    patches = [device_stage(serving, "peak_normalize", before="uploaded"),
               device_stage(serving, "logmel", after="frontend"),
               device_stage(explain_mod, "explain_forward_upper", after="forward_upper"),
               device_stage(explain_mod, "explain_lower", after="lower"),
               host_stage(svc, "_finalize", "readback"),
               host_stage(serving, "sort_subspaces", "sort")]
    for mod, attr, _, run in patches:
        setattr(mod, attr, run)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        svc.explain(wavs, class_name)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, fn, _ in patches:
            setattr(mod, attr, fn)
        del svc._finalize                    # back to the class's method
    order = ["start", "uploaded", "frontend", "forward_upper", "lower"]
    out = {b: events[a].elapsed_time(events[b]) for a, b in zip(order, order[1:])}
    out["readback"] = host["readback"] - host["sort"]   # _finalize less the sort
    out["sort"] = host["sort"]
    out["other_host"] = total - sum(out.values())
    out["request"] = total
    return out


def traced_request(run) -> dict:
    """One request (``run()``, which returns once the device is done) under
    torch.profiler: the device time of each kernel or copy (events on the
    device only, so no host op's share of them is counted twice), the ten
    largest, and the device's busy and idle share of the request's
    host-clock time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        total = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        rows.append({"name": e.key[:80], "count": e.count, "ms": us / 1e3})
    if not rows:
        raise AssertionError("the profiler recorded no device events")
    rows.sort(key=lambda r: -r["ms"])
    busy = sum(r["ms"] for r in rows)
    return {"request_ms": total, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / total, "top": rows[:10]}


def counted(name: str, run, counts: dict):
    """``run()`` with every launch counter set to 0 just before and read
    just after; fails unless the counts are ``counts`` (a kernel left out
    at 0). Returns (what ``run`` returned, the counts)."""
    reset_counts()
    out = run()
    got = launch_counts()
    want = {k: counts.get(k, 0) for k in SOURCES}
    if got != want:
        raise AssertionError(f"{name}: launch counts {got}, expected {want}")
    return out, got


def host_reference(name: str, run):
    """A CPU reference, trusted once two runs of it agree bit for bit. The
    CPU path is deterministic (the same bits at any thread count), so runs
    that differ mean the host miscomputed. On one H100 host the first CPU
    log-mel of a run came back with one MKL thread's 67-row block of the
    DFT matmul at about 11-bit precision, and the next run was right. Runs
    ``run`` (tensors, or a tuple of them) twice, and a third time if they
    differ; returns (the result two runs agree on, the runs taken). Raises
    if no two agree."""
    import torch

    def same(a, b):
        a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    runs = [run(), run()]
    if same(*runs):
        return runs[0], 2
    runs.append(run())
    for i, j in ((0, 2), (1, 2)):
        if same(runs[i], runs[j]):
            return runs[i], 3
    raise AssertionError(f"{name}: three CPU runs of the reference all differ")


def logmel_f64(wav, cfg):
    """The port's log-mel of ``wav`` [b, time] on the CPU with every step in
    float64 (its float32 DFT basis and filterbank widened): the yardstick
    that tells which device moved when the card and the CPU disagree."""
    import torch
    from drsa_audio_tpu_torch.ops.frontend import peak_normalize
    from drsa_audio_tpu_torch.ops.mel import mel_filterbank
    from drsa_audio_tpu_torch.ops.stft import _frame_signal, dft_basis, hann_window
    frames = _frame_signal(peak_normalize(wav.double()), cfg.n_fft, cfg.hop_length)
    frames = frames * hann_window(cfg.n_fft, torch.float64)
    re, im = (frames @ torch.as_tensor(m, dtype=torch.float64) for m in dft_basis(cfg.n_fft))
    fb = torch.as_tensor(mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate),
                         dtype=torch.float64)
    mel = (torch.sqrt(re * re + im * im) @ fb).transpose(-1, -2)
    return torch.clamp(torch.log10(mel + 1e-7), min=-4.0)[..., 1:cfg.width + 1]


def check_heatmaps(name: str, std: np.ndarray, sub: np.ndarray, shape) -> None:
    """Standard maps [b, 1, h, w] and subspace maps [b, K, h, w] for
    ``shape`` (b, h, w): finite, and the standard map the sum of the
    subspace maps (rtol 1e-5)."""
    b, h, w = shape
    if std.shape != (b, 1, h, w) or sub.shape != (b, K, h, w):
        raise AssertionError(f"{name}: heatmap shapes {std.shape}, {sub.shape}")
    if not (np.isfinite(std).all() and np.isfinite(sub).all()):
        raise AssertionError(f"{name}: heatmaps not finite")
    np.testing.assert_allclose(std[:, 0], sub.sum(axis=1), rtol=1e-5,
                               atol=1e-6 * np.abs(std).max(), err_msg=name)


def serve_checks(svc, wavs, class_names, shape, counts, name, vs_default=False,
                 vs_plain=True) -> dict:
    """Serve one request per class with every launch counter set to 0 just
    before and read just after; check the launch counts, the heatmaps'
    shape, finiteness and standard = sum of the subspace maps, then (unless
    not ``vs_plain``) one request's unsorted heatmaps against the plain
    tiled walk and, with ``vs_default``, against the default multi-kernel
    chain (the merged-tail switch off for that request)."""
    import torch
    from drsa_audio_tpu_torch.xai.lrp import chain

    t0 = time.time()
    outs, launches = counted(name, lambda: [svc.explain(w, c) for w, c in zip(wavs, class_names)],
                             {k: n * len(class_names) for k, n in counts.items()})
    seconds = time.time() - t0
    for out in outs:
        check_heatmaps(name, out["standard_heatmaps"], out["subspace_heatmaps"], shape)
    b = shape[0]
    out = {"phase": name, "requests": len(class_names), "batch": b, "seconds": seconds,
           "launches": launches}
    if not vs_plain:
        return out
    got, _ = svc._dispatch(wavs[0], class_names[0])
    want, _ = svc._dispatch(wavs[0], class_names[0], fused=False)
    torch.cuda.synchronize()
    out.update(max_abs_err_vs_plain=check_close(f"{name} request vs plain path", got, want),
               max_abs_plain=want.abs().max().item())
    if vs_default:
        merged, chain.CHAIN_MERGED = chain.CHAIN_MERGED, False
        try:
            default, _ = svc._dispatch(wavs[0], class_names[0])
        finally:
            chain.CHAIN_MERGED = merged
        out["max_abs_err_vs_default"] = check_close(f"{name} request vs default chain",
                                                    got, default)
    return out


def phase_tag(path: str) -> str:
    """Suffix of a path's phase names; the 3s phases keep their names from
    before the other paths were added."""
    return {"3s": "", "3s_merged": "_merged"}.get(path, "_" + path)


def kernel_rows(svc, wavs, class_name, expected, batch, path) -> list:
    """Record the kernel launches of one request, hold each kernel against
    its plain PyTorch version on the recorded inputs, and time both with
    CUDA events beside the kernel's bound."""
    import torch
    from drsa_audio_tpu_torch.xai.lrp import chain

    names = list(CHAIN_KERNELS)
    originals = {n: getattr(chain, n) for n in names}
    plain_fns = {n: getattr(chain, n + "_plain") for n in names}
    work_fns = {"chain_block": chain_block_work, "first_layer": first_layer_work,
                "first_block_deep": first_block_deep_work, "merged_tail": merged_tail_work}
    calls = []

    def recorder(name):
        def run(*args):
            calls.append((name, args))
            return originals[name](*args)
        return run

    for n in names:
        setattr(chain, n, recorder(n))
    try:
        heat, _ = svc._dispatch(wavs, class_name)
    finally:
        for n in names:
            setattr(chain, n, originals[n])
    torch.cuda.synchronize()
    assert torch.isfinite(heat).all()
    del heat
    if [n for n, _ in calls] != expected:
        raise AssertionError(f"{path}: recorded {[n for n, _ in calls]}")
    rows = []
    for i, (name, args) in enumerate(calls):
        with torch.inference_mode():
            got = originals[name](*args)
            want = plain_fns[name](*args)
            torch.cuda.synchronize()
            err = check_close(f"{path} {name} launch {i}", got, want)
            del want
            if not torch.equal(got, originals[name](*args)):
                raise AssertionError(f"{path} {name} launch {i}: two runs differ")
            del got
            ms_plain = cuda_ms(lambda: plain_fns[name](*args), 3)
            ms = cuda_ms(lambda: originals[name](*args), 5)
            ms_plain2 = cuda_ms(lambda: plain_fns[name](*args), 3)
        flops, nbytes = work_fns[name](*args)
        row = {"name": name, "launch": i, "relevance_in": list(args[0].shape),
               "flops": flops, "bytes": nbytes, "max_abs_err": err, "ms": ms,
               "plain_ms": min(ms_plain, ms_plain2), **bounds(flops, nbytes)}
        rows.append(row)
        emit({"phase": "kernel_vs_plain" + phase_tag(path), "batch": batch, "K": K, **row})
        if name == "merged_tail":
            with torch.inference_mode():
                emit({"phase": "merged_tail_split" + phase_tag(path), "launch": i,
                      **merged_tail_split_ms(*args)})
    return rows


def request_phases(svc, wavs, class_name, path, **beside) -> float:
    """One request end to end (host readback included), then the same
    request stage by stage and under the profiler. ``beside`` is emitted
    with the first line. Returns the request's peak device memory, GB."""
    import torch

    batch = len(wavs)
    svc.explain(wavs, class_name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc.explain(wavs, class_name)
    request_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc._dispatch(wavs, class_name)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "request" + phase_tag(path), "batch": batch, "request_ms": request_s * 1e3,
          "dispatch_to_sync_ms": device_s * 1e3,
          "clips_per_sec": batch / request_s, "peak_mem_gb": peak, **beside})
    stages = [staged_request(svc, wavs, class_name) for _ in range(STAGE_REPS)]
    emit({"phase": "request_stages" + phase_tag(path), "batch": batch, "reps": STAGE_REPS,
          "median_ms": {k: float(np.median([s[k] for s in stages])) for k in stages[0]}})
    emit({"phase": "request_trace" + phase_tag(path), "batch": batch,
          **traced_request(lambda: svc.explain(wavs, class_name))})
    return peak


def shared_dispatch(svc, wavs, class_name, U, shared=True):
    """One request through subspace_heatmaps on the service's model, with
    the service's front-end (peak_normalize, logmel) and class, the
    projection U, and the shared-denominator walk (``shared``) or the
    default chain. Returns (heatmaps, mels, specs, output mask)."""
    import torch
    from drsa_audio_tpu_torch.models.projection import insert_projection
    from drsa_audio_tpu_torch.ops.frontend import logmel, peak_normalize
    from drsa_audio_tpu_torch.xai.explain import subspace_heatmaps
    cfg = svc.config
    onehot = torch.zeros(svc.n_classes, device="cuda")
    onehot[svc.mapper[class_name]] = 1.0
    mask = lambda lg: lg * onehot[None, :]                           # noqa: E731
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(wavs, np.float32), device="cuda")
        mels = logmel(peak_normalize(x), cfg)[:, None]
        sp = insert_projection(svc.specs, svc.layer_idx, U, K,
                               input_size=(cfg.n_mels, cfg.width))
        heat, _ = subspace_heatmaps(sp, svc.params, mels, svc.composite, K,
                                    output_mask=mask, shared_denominators=shared)
    return heat, mels, sp, mask


def serve_shared(svc, wavs, class_names, U, n_gamma, name, strict_clips=8) -> dict:
    """The shared-denominator path: one request per class, every launch
    counter set to 0 just before each and read just after (gamma_nonneg
    ``n_gamma`` times, no other kernel); finite heatmaps, standard = sum of
    the subspace maps. Then, on the first request, the strict check: the
    shared walk below the filter fed the card's own recorded NCHW
    activations and R_filter (its first ``strict_clips`` clips), on the
    card (the kernel) and on a CPU copy (the plain rule), at the LRP
    tolerance; and the loose check against the default chain on the same
    mels: subspace relevances at rtol 1e-4 and heatmap correlation >=
    0.9999 (the NCHW and NHWC forwards round differently)."""
    import torch
    from drsa_audio_tpu_torch.models.projection import insert_projection
    from drsa_audio_tpu_torch.xai.explain import explain_forward_upper, explain_lower
    from drsa_audio_tpu_torch.xai.explain import subspace_heatmaps

    counts, first = [], None
    t0 = time.time()
    for w, c in zip(wavs, class_names):
        (heat, mels, sp, mask), got = counted(name, lambda: shared_dispatch(svc, w, c, U),
                                              {"gamma_nonneg": n_gamma})
        counts.append(got)
        b, _, h, wd = heat.shape
        assert heat.shape[1] == K + 1 and torch.isfinite(heat).all()
        total = heat[:, 1:].sum(dim=1)
        if ((heat[:, 0] - total).abs() > 1e-6 * total.abs().max() + 1e-5 * total.abs()).any():
            raise AssertionError(f"{name}: standard map is not the sum of the subspace maps")
        if first is None:
            first = (heat, mels, sp, mask)
        else:
            del heat, mels
    seconds = time.time() - t0
    heat, mels, sp, mask = first
    with torch.inference_mode():
        default, _ = subspace_heatmaps(sp, svc.params, mels, svc.composite, K, output_mask=mask)
        rel, rel_d = heat[:, 1:].sum(dim=(-2, -1)), default[:, 1:].sum(dim=(-2, -1))
        rel_err = check_close(f"{name} subspace relevances vs default chain", rel, rel_d,
                              atol=1e-6 * rel_d.abs().max().item())
        corr = torch.corrcoef(torch.stack([heat.flatten(), default.flatten()]))[0, 1].item()
        if not corr >= 0.9999:
            raise AssertionError(f"{name}: heatmap correlation {corr} with the default chain")
        n = strict_clips
        R_f, acts, _ = explain_forward_upper(sp, svc.params, mels[:n], svc.composite,
                                             output_mask=mask, nhwc=False)
        got = explain_lower(sp, svc.params, acts, R_f, svc.composite, K,
                            shared_denominators=True, nhwc=False)
        p_cpu = {k: {n2: v.cpu() for n2, v in d.items()} for k, d in svc.params.items()}
        sp_cpu = insert_projection(svc.specs, svc.layer_idx, U.cpu(), K,
                                   input_size=tuple(mels.shape[-2:]))
        want = explain_lower(sp_cpu, p_cpu, [a.cpu() for a in acts], R_f.cpu(), svc.composite,
                             K, shared_denominators=True, nhwc=False)
        strict = check_close(f"{name} shared walk, card vs CPU", got.cpu(), want)
    return {"phase": name, "requests": len(class_names), "batch": b, "seconds": seconds,
            "launches": {k: sum(c[k] for c in counts) for k in SOURCES},
            "max_abs_err_card_vs_cpu": strict, "max_abs_cpu": want.abs().max().item(),
            "strict_clips": n, "relevance_max_abs_err_vs_default": rel_err,
            "heatmap_corr_vs_default": corr}


def shared_kernel_rows(svc, wavs, class_name, U, expected, path) -> list:
    """Record the gamma_nonneg launches of one shared-path request, hold each
    against its plain version on the recorded inputs, and time both with
    CUDA events beside the bound, as kernel_rows."""
    import torch
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma

    kernel, plain = fused_gamma.gamma_nonneg_folded, fused_gamma.gamma_nonneg_folded_plain
    calls = []

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return kernel(*args, **kwargs)
    fused_gamma.gamma_nonneg_folded = recorder
    try:
        heat, _, _, _ = shared_dispatch(svc, wavs, class_name, U)
    finally:
        fused_gamma.gamma_nonneg_folded = kernel
    torch.cuda.synchronize()
    assert torch.isfinite(heat).all()
    del heat
    if len(calls) != expected:
        raise AssertionError(f"{path}: recorded {len(calls)} gamma_nonneg launches")
    rows = []
    for i, (args, kw) in enumerate(calls):
        with torch.inference_mode():
            got = kernel(*args, **kw)
            err = check_close(f"{path} gamma_nonneg launch {i}", got, plain(*args, **kw))
            if not torch.equal(got, kernel(*args, **kw)):
                raise AssertionError(f"{path} gamma_nonneg launch {i}: two runs differ")
            del got
            ms_plain = cuda_ms(lambda: plain(*args, **kw), 3)
            ms = cuda_ms(lambda: kernel(*args, **kw), 5)
            ms_plain2 = cuda_ms(lambda: plain(*args, **kw), 3)
            split = gamma_nonneg_split_ms(*args, **kw)
        flops, nbytes, kernel_flops = gamma_nonneg_work(*args)
        row = {"name": "gamma_nonneg", "launch": i, "x": list(args[0].shape),
               "relevance_in": list(args[1].shape), "flops": flops, "bytes": nbytes,
               "kernel_flops": kernel_flops, "max_abs_err": err, "ms": ms,
               "plain_ms": min(ms_plain, ms_plain2), **bounds(flops, nbytes)}
        rows.append(row)
        emit({"phase": "kernel_vs_plain" + phase_tag(path), "batch": len(wavs), "K": K, **row})
        emit({"phase": "gamma_nonneg_split" + phase_tag(path), "launch": i, **split})
    return rows


def lower_segment_memory(svc, wavs, class_name, U, path) -> dict:
    """The lower segment's device time (CUDA events around explain_lower,
    median of 3) and the whole request's peak device memory (front-end,
    forward, lower segment), on the shared-denominator path and on the
    default chain, on the same mels; then the shared request traced (no
    readback: the heatmaps stay on the device)."""
    import torch
    from drsa_audio_tpu_torch.xai.explain import explain_forward_upper, explain_lower

    out = {}
    for label, shared in (("default", False), ("shared", True)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        heat, mels, sp, mask = shared_dispatch(svc, wavs, class_name, U, shared=shared)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        del heat
        with torch.inference_mode():
            R_f, acts, _ = explain_forward_upper(sp, svc.params, mels, svc.composite,
                                                 output_mask=mask, nhwc=not shared)
            lower = lambda: explain_lower(sp, svc.params, acts, R_f, svc.composite, K,  # noqa
                                          shared_denominators=shared, nhwc=not shared)
            ms = float(np.median([cuda_ms(lower, 1) for _ in range(3)]))
        out[label] = {"lower_ms": ms, "peak_mem_gb": peak}
        del R_f, acts, mels
    emit({"phase": "lower_shared_vs_default" + phase_tag(path), "batch": len(wavs), **out})

    def run():
        shared_dispatch(svc, wavs, class_name, U)
        torch.cuda.synchronize()
    emit({"phase": "request_trace" + phase_tag(path), "batch": len(wavs),
          **traced_request(run)})
    return out


def logmel_rows(wavs, cfg, path) -> list:
    """fused_logmel on the peak-normalised waveforms of a request: its launch
    count (counters set to 0 just before, read just after), its error
    against the plain version and the matmul-DFT logmel (rtol 1e-4, atol
    1e-4 in log10 units), the same bits on a second run, and the kernel's,
    the plain version's, the service's matmul-DFT logmel's and the FFT
    logmel's (library_ms: torch.fft.rfft, cuFFT) times beside the bound."""
    import torch
    from drsa_audio_tpu_torch.ops import fused_frontend
    from drsa_audio_tpu_torch.ops.frontend import logmel, peak_normalize

    with torch.inference_mode():
        x = peak_normalize(torch.as_tensor(np.asarray(wavs, np.float32), device="cuda"))
        got, counts = counted(path, lambda: fused_frontend.fused_logmel(x, cfg), {"logmel": 1})
        assert got.shape == (len(wavs), cfg.n_mels, cfg.width) and torch.isfinite(got).all()
        err = check_close(f"{path} logmel", got, fused_frontend.fused_logmel_plain(x, cfg),
                          atol=1e-4)
        mm_err = check_close(f"{path} logmel vs matmul-DFT logmel", got, logmel(x, cfg),
                             atol=1e-4)
        if not torch.equal(got, fused_frontend.fused_logmel(x, cfg)):
            raise AssertionError(f"{path} logmel: two runs differ")
        ms = cuda_ms(lambda: fused_frontend.fused_logmel(x, cfg), 10)
        plain_ms = cuda_ms(lambda: fused_frontend.fused_logmel_plain(x, cfg), 5)
        mm_ms = cuda_ms(lambda: logmel(x, cfg), 10)
        lib_ms = cuda_ms(lambda: logmel(x, cfg, use_matmul_dft=False), 10)
    flops, nbytes = logmel_work(x, cfg)
    row = {"name": "logmel", "launches": counts["logmel"], "wav": list(x.shape),
           "flops": flops, "bytes": nbytes, "max_abs_err": err,
           "max_abs_err_vs_matmul_dft": mm_err, "ms": ms, "plain_ms": plain_ms,
           "matmul_dft_logmel_ms": mm_ms, "library_ms": lib_ms, **bounds(flops, nbytes)}
    emit({"phase": "logmel_vs_plain_" + path, **row})
    return [row]


def signed_permutation(rng, d: int):
    """A U whose products are exact in float32 (U U^T rebuilds exact zeros),
    on the card."""
    import torch
    U = np.zeros((d, d), np.float32)
    U[np.arange(d), rng.permutation(d)] = rng.choice([-1.0, 1.0], d)
    return torch.as_tensor(U, device="cuda")


def random_bn_stats(params: dict, seed: int) -> dict:
    """Seeded random BatchNorm scale, bias, mean and var, so that the fold
    is not the identity."""
    import torch
    rng = np.random.default_rng(seed)
    out = dict(params)
    for name, p in params.items():
        if "running_var" in p:
            ch = p["running_var"].shape[0]
            draw = {"weight": rng.uniform(0.5, 1.5, ch), "bias": rng.normal(0.0, 0.1, ch),
                    "running_mean": rng.normal(0.0, 0.1, ch),
                    "running_var": rng.uniform(0.5, 2.0, ch)}
            out[name] = {k: torch.as_tensor(v.astype(np.float32), device=p["running_var"].device)
                         for k, v in draw.items()}
    return out


N_FIT_CLIPS, N_LOCATIONS, FIT_STEPS, FIT_RUNS, B_GEN = 300, 20, 5000, 3, 64


def seeded_mels(seed: int, n: int, cfg):
    """``n`` seeded noise clips (0.3 standard deviation, drawn on the card)
    through the service's front-end: [n, 1, mels, frames]."""
    import torch
    from drsa_audio_tpu_torch.ops.frontend import logmel, peak_normalize
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        wavs = torch.randn((n, cfg.slice_length * cfg.sample_rate), generator=g,
                           device="cuda") * 0.3
        return logmel(peak_normalize(wavs), cfg)[:, None]


def check_fit(res, name: str) -> dict:
    """Every fitted U orthogonal (max|U^T U - I| <= 1e-4) and every best
    run's final objective above its first; returns the first and last
    objective of each best run."""
    import torch
    U = res.U
    err = (U.transpose(-2, -1) @ U - torch.eye(U.shape[-1], device=U.device)).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"{name}: max|U^T U - I| = {err}")
    objs = res.objectives.reshape(-1, *res.objectives.shape[-2:]).cpu()
    best = res.best_run.reshape(-1).tolist()
    first = [objs[p, r, 0].item() for p, r in enumerate(best)]
    last = [objs[p, r, -1].item() for p, r in enumerate(best)]
    if not all(b > a for a, b in zip(first, last)):
        raise AssertionError(f"{name}: a best run ended at or below its start: {first} -> {last}")
    return {"orthogonality_max_err": err, "best_run": best, "first_objective": first,
            "last_objective": last}


def generator_checks(gen, x, attr_batch_size, counts, name) -> tuple:
    """HeatmapGenerator.generate_subspace_heatmaps on ``x`` with every
    launch counter set to 0 just before and read just after; the heatmaps
    finite, the standard map the sum of the subspace maps (rtol 1e-5), and
    the subspace maps, unsorted by the generator's mask, and the standard
    map against subspace_heatmaps(..., fused=False) on the generator's
    specs_proj and the same chunks. Then the call again, timed on the host
    clock (readback and sort included), with its peak device memory.
    Returns (the line, the launch counts)."""
    import torch
    from drsa_audio_tpu_torch.xai.explain import subspace_heatmaps

    sub, got = counted(name, lambda: gen.generate_subspace_heatmaps(
        x, attr_batch_size=attr_batch_size), counts)
    std = gen.info["standard_heatmaps"]
    check_heatmaps(name, std, sub, (len(x), *x.shape[-2:]))
    raw = np.empty_like(sub)
    raw[np.arange(len(sub))[:, None], gen.info["mask"]] = sub
    onehot = torch.zeros(gen.num_classes, device="cuda")
    onehot[gen.class_idx] = 1.0
    with torch.inference_mode():
        plain = torch.cat([subspace_heatmaps(gen.specs_proj, gen.params, x[i:i + attr_batch_size],
                                             gen.composite, gen.num_concepts,
                                             output_mask=lambda lg: lg * onehot, fused=False)[0]
                           for i in range(0, len(x), attr_batch_size)]).cpu()
    err = check_close(f"{name} subspace maps vs plain", torch.as_tensor(raw), plain[:, 1:])
    err_std = check_close(f"{name} standard maps vs plain", torch.as_tensor(std), plain[:, :1])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen.generate_subspace_heatmaps(x, attr_batch_size=attr_batch_size)
    ms = (time.perf_counter() - t0) * 1e3
    chunks = -(-len(x) // attr_batch_size)
    return ({"phase": name, "batch": len(x), "attr_batch_size": attr_batch_size, "launches": got,
             "max_abs_err_vs_plain": err, "standard_max_abs_err_vs_plain": err_std,
             "max_abs_plain": plain.abs().max().item(), "ms": ms, "ms_per_chunk": ms / chunks,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, got)


def fit_then_serve_3s(card: str) -> tuple:
    """Phase 11, GTZAN-3s: extract, fit, save and load, serve. Returns the
    launch counts of its counted runs, and (specs, params, the loaded Us)
    for phase 12."""
    import tempfile

    import torch
    from drsa_audio_tpu_torch.models.vgg import build_layer_specs, gtzan_3s_config, init_params
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER, LRP_NAME_MAP_GTZAN
    from drsa_audio_tpu_torch.utils.device import params_on
    from drsa_audio_tpu_torch.utils.evaluation import load_projection_matrix, save_drsa_run
    from drsa_audio_tpu_torch.xai.drsa import optimizer
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import (
        extract_act_rel_maps, normalize_vectors, preprocess_data)
    from drsa_audio_tpu_torch.xai.drsa.prototypes import get_prototypes
    from drsa_audio_tpu_torch.xai.explain import HeatmapGenerator
    from drsa_audio_tpu_torch.xai.lrp.engine import Composite

    specs = build_layer_specs(gtzan_3s_config())
    params = init_params(specs, seed=0, device="cuda")
    cfg = FrontendConfig.for_case("gtzan")
    comp = Composite.from_list(LRP_NAME_MAP_GTZAN)
    classes = list(CLASS_IDX_MAPPER)
    launches = {}

    # extraction: 300 clips a class, 20 locations a clip, every class
    data, extract_s = [], 0.0
    for i, cls in enumerate(classes):
        mels = seeded_mels(1000 + i, N_FIT_CLIPS, cfg)
        if i == 0:
            mels0 = mels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, c = preprocess_data(specs, params, mels, comp, 10, CLASS_IDX_MAPPER[cls],
                               num_locations=N_LOCATIONS, generator=i, attr_batch_size=64)
        torch.cuda.synchronize()
        extract_s += time.perf_counter() - t0
        if a.shape != (N_FIT_CLIPS * N_LOCATIONS, 64) or not (
                torch.isfinite(a).all() and torch.isfinite(c).all()):
            raise AssertionError(f"3s extraction {cls}: {tuple(a.shape)} or not finite")
        data.append((normalize_vectors(a), normalize_vectors(c)))
    with torch.no_grad():
        chunk_ms = cuda_ms(lambda: extract_act_rel_maps(specs, params, mels0[:64], comp, 10, 0), 5)
        got = extract_act_rel_maps(specs, params, mels0[:4], comp, 10, 0)
        want = extract_act_rel_maps(specs, params_on(params, "cpu"), mels0[:4].cpu(), comp,
                                    10, 0)
    emit({"phase": "fit_then_serve_3s_extract", "card": card, "classes": len(classes),
          "clips_per_class": N_FIT_CLIPS, "locations": N_LOCATIONS,
          "vectors_per_class": list(data[0][0].shape), "seconds": extract_s,
          "ms_per_64_clip_chunk": chunk_ms,
          "activation_max_abs_err_card_vs_cpu": check_close(
              "3s extraction activations, card vs CPU", got[0].cpu(), want[0]),
          "relevance_max_abs_err_card_vs_cpu": check_close(
              "3s extraction relevances, card vs CPU", got[1].cpu(), want[1])})

    # the optimiser on the card against the CPU, 30 steps from one U0
    a, c = data[0]
    U0 = optimizer.init_runs(42, 64, FIT_RUNS)
    on_card = optimizer.drsa_fit(U0, a, c, K, 30, "ns").objectives.cpu()
    on_cpu = optimizer.drsa_fit(U0, a.cpu(), c.cpu(), K, 30, "ns", device="cpu").objectives
    rel_err = ((on_card - on_cpu).abs() / on_cpu.abs()).max().item()
    if not rel_err <= 2e-2:
        raise AssertionError(f"3s drsa_fit card vs CPU: max rel err {rel_err} over 30 steps")

    # one fit of every class: 10 pairs x 3 runs, 5,000 steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = optimizer.fit_batched(data, K, FIT_STEPS, FIT_RUNS, 42, "ns")
    res.best_run.tolist()
    fit_s = time.perf_counter() - t0
    fit = check_fit(res, "3s fit")
    trace = traced_request(lambda: optimizer.fit_batched(data, K, 100, FIT_RUNS, 42,
                                                         "ns").best_run.tolist())
    emit({"phase": "fit_then_serve_3s_fit", "card": card, "pairs": len(classes),
          "runs": FIT_RUNS, "steps": FIT_STEPS, "d": 64, "fit_seconds": fit_s,
          "ms_per_step": fit_s * 1e3 / FIT_STEPS, "objective_max_rel_err_card_vs_cpu_30": rel_err,
          "trace_100_steps": {"ms_per_step_traced": trace["request_ms"] / 100,
                              "device_busy_ms_per_step": trace["device_busy_ms"] / 100,
                              "top": trace["top"][:5]}, **fit})

    # save every run, load each class's best
    Us = {}
    with tempfile.TemporaryDirectory() as tmp:
        for p, cls in enumerate(classes):
            for r in range(FIT_RUNS):
                save_drsa_run(os.path.join(tmp, cls, f"run{r}"), res.U[p, r], res.objectives[p, r])
            Us[cls] = load_projection_matrix(os.path.join(tmp, cls))
            if not np.array_equal(Us[cls], res.U[p, fit["best_run"][p]].cpu().numpy()):
                raise AssertionError(f"3s {cls}: the loaded U is not the saved best run's")

    # the service with the loaded Us: one 32-clip request for two classes
    svc = ExplainerService(specs, params, LRP_NAME_MAP_GTZAN, Us, K, 10, case="gtzan")
    rng = np.random.default_rng(11)
    wavs = [(rng.standard_normal((B_SERVE, 48000)) * 0.3).astype(np.float32) for _ in range(2)]
    serve = serve_checks(svc, wavs, classes[:2], (B_SERVE, 128, 128),
                         {"chain_block": 3, "first_layer": 1}, "fit_then_serve_3s_serve")
    launches["serve"] = serve["launches"]
    emit({**serve, "card": card})
    del svc

    # HeatmapGenerator with a fitted U: 64 clips in chunks of 32, then one
    # shared-denominator chunk
    gen = HeatmapGenerator(specs=specs, params=params, U=Us[classes[0]],
                           name_map=LRP_NAME_MAP_GTZAN, sample_class=classes[0])
    line, launches["generator"] = generator_checks(
        gen, mels0[:B_GEN], 32, {"chain_block": 6, "first_layer": 2},
        "fit_then_serve_3s_generator")
    emit({**line, "card": card})
    sub, launches["generator_shared"] = counted(
        "3s shared generator",
        lambda: gen.generate_subspace_heatmaps(mels0[:32], shared_denominators=True),
        {"gamma_nonneg": 3})
    check_heatmaps("3s shared generator", gen.info["standard_heatmaps"], sub, (32, 128, 128))

    # prototypes: 10 subsets of 10 clips under the fitted U
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proto = get_prototypes(specs, params, 10, Us[classes[0]], comp, mels0[:100], num_concepts=K,
                           n=10, class_idx=0)
    proto_ms = (time.perf_counter() - t0) * 1e3
    if (proto.objectives.shape != (10,) or not np.isfinite(proto.objectives).all()
            or proto.subset_index != int(np.argmax(proto.objectives))
            or tuple(proto.act_vecs.shape) != (10 * 16 * 16, 64)):
        raise AssertionError(f"3s prototypes: {proto.objectives}, {proto.subset_index}")
    emit({"phase": "fit_then_serve_3s_prototypes", "card": card, "clips": 100, "n": 10,
          "subset_index": proto.subset_index, "objectives": proto.objectives.tolist(),
          "ms": proto_ms, "shared_generator_launches": launches["generator_shared"]})
    return {k: sum(c[k] for c in launches.values()) for k in SOURCES}, (specs, params, Us)


def fit_then_serve_6s(card: str) -> dict:
    """Phase 11, GTZAN-6s at layer 33: extract 64 clips, fit, serve 32 with
    HeatmapGenerator. Returns the launch counts of its counted run."""
    import torch
    from drsa_audio_tpu_torch.models.vgg import (
        build_layer_specs, fold_batchnorm, gtzan_6s_config, init_params)
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
    from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER, LRP_NAME_MAP_GTZAN_6S
    from drsa_audio_tpu_torch.xai.drsa import optimizer
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import (
        extract_act_rel_maps, normalize_vectors, preprocess_data)
    from drsa_audio_tpu_torch.xai.explain import HeatmapGenerator
    from drsa_audio_tpu_torch.xai.lrp.engine import Composite

    specs = build_layer_specs(gtzan_6s_config())
    specs, params = fold_batchnorm(specs, random_bn_stats(
        init_params(specs, seed=0, device="cuda"), seed=1))
    comp = Composite.from_list(LRP_NAME_MAP_GTZAN_6S)
    mels = seeded_mels(2000, B_GEN, FrontendConfig.for_case("gtzan_6s"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, c = preprocess_data(specs, params, mels, comp, 33, CLASS_IDX_MAPPER["metal"],
                           num_locations=N_LOCATIONS, generator=0)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    if a.shape != (B_GEN * N_LOCATIONS, 128) or not torch.isfinite(c).all():
        raise AssertionError(f"6s extraction: {tuple(a.shape)} or not finite")
    with torch.no_grad():
        chunk_ms = cuda_ms(lambda: extract_act_rel_maps(specs, params, mels, comp, 33, 1), 3)
    a, c = normalize_vectors(a), normalize_vectors(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = optimizer.fit(a, c, K, FIT_STEPS, FIT_RUNS, 42, "ns")
    best = int(res.best_run)
    fit_s = time.perf_counter() - t0
    emit({"phase": "fit_then_serve_6s_fit", "card": card, "layer": 33, "d": 128, "clips": B_GEN,
          "vectors": list(a.shape), "extract_seconds": extract_s, "ms_per_64_clip_chunk": chunk_ms,
          "runs": FIT_RUNS, "steps": FIT_STEPS, "fit_seconds": fit_s,
          "ms_per_step": fit_s * 1e3 / FIT_STEPS, **check_fit(res, "6s fit")})
    gen = HeatmapGenerator(specs=specs, params=params, U=res.U[best],
                           name_map=LRP_NAME_MAP_GTZAN_6S, sample_class="metal", layer_idx=33,
                           case="gtzan_6s")
    line, counts = generator_checks(gen, mels[:B_SERVE], B_SERVE,
                                    {"chain_block": 4, "first_block_deep": 1},
                                    "fit_then_serve_6s_generator")
    emit({**line, "card": card})
    return counts


N_EVAL, B_FILES, B_FILE_BATCH, FORWARD_BATCH = 20, 256, 64, 512
STANDARD_GRID = [{"convolutional": ("gamma", 0.4), "dense": ("epsilon", 1e-7),
                  "first_layer": ("wsquare",)}]


def timed(name: str, run, **beside):
    """``run()`` on the host clock, the device synchronised before and
    after; emits the step's ms on a line of its own and returns what
    ``run`` returned."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    emit({"phase": "evaluate_3s_step", "step": name, "ms": (time.perf_counter() - t0) * 1e3,
          **beside})
    return out


def write_eval_files(tmp: str, rng) -> list:
    """256 seeded 3 s, 16 kHz clips, two 3 s clips at 22,050 Hz and one of
    0.5 s at 16 kHz, as 16-bit WAV files; the three odd ones first, so that
    they fall in the first batch."""
    from drsa_audio_tpu_torch.runtime.wavio import write_wav
    specs = [(22050, 3.0), (16000, 0.5), (22050, 3.0)] + [(16000, 3.0)] * B_FILES
    paths = []
    for i, (sr, seconds) in enumerate(specs):
        paths.append(os.path.join(tmp, f"{i:04d}_{sr}.wav"))
        write_wav(paths[-1], np.clip(rng.standard_normal(int(sr * seconds)) * 0.3, -1, 1), sr)
    return paths


def prepared_waveform(path: str, window: int = 48000, rate: int = 16000) -> np.ndarray:
    """What explain_files should feed for ``path``, made here from the
    numpy reader: the first channel resampled to ``rate``, padded or cut
    to ``window``."""
    import math

    from scipy.signal import resample_poly

    from drsa_audio_tpu_torch.runtime.wavio import read_wav
    wav, sr = read_wav(path)
    w = wav[0]
    if sr != rate:
        g = math.gcd(sr, rate)
        w = resample_poly(w, rate // g, sr // g).astype(np.float32)
    return np.pad(w, (0, max(0, window - len(w))))[:window]


def keep_masks(R, device):
    """Flipper's keep masks [steps, b, P] of maps R [b, K, h, w] at
    perturbation 16, computed on ``device``."""
    import torch
    from drsa_audio_tpu_torch.xai.eval import flipping
    R = torch.as_tensor(R, device=device)
    gh, gw = R.shape[-2] // 16, R.shape[-1] // 16
    return flipping._cumulative_masks(flipping.rank_patches(R, 16),
                                      flipping.quadratic_schedule(gh * gw)).cpu()


def flipper_card_vs_cpu(specs, params, x, R, name: str) -> dict:
    """Flipper's per-instance scores on the card against the CPU, given the
    same maps R: the two sum a patch in another order, so the clips whose
    keep masks differ between the devices (a patch-sum near-tie) are left
    out, and at least half must agree; the rest at rtol 1e-4, atol 1e-5 *
    max|preds|."""
    from drsa_audio_tpu_torch.models.vgg import forward
    from drsa_audio_tpu_torch.utils.device import params_on
    from drsa_audio_tpu_torch.xai.eval.flipping import Flipper
    p_cpu = params_on(params, "cpu")
    got, _, _ = Flipper(16, forward_batch=FORWARD_BATCH).predictions(
        lambda t: forward(specs, params, t), x, R)
    want, _, _ = Flipper(16, forward_batch=FORWARD_BATCH, device="cpu").predictions(
        lambda t: forward(specs, p_cpu, t), x.cpu(), R)
    agree = (keep_masks(R[:, :, 0], "cuda") == keep_masks(R[:, :, 0], "cpu")).all(dim=0).all(
        dim=-1).numpy()
    if agree.sum() < len(agree) / 2:
        raise AssertionError(f"{name}: keep masks differ between card and CPU on "
                             f"{int((~agree).sum())} of {len(agree)} clips")
    import torch
    err = check_close(name, torch.as_tensor(got[:, agree]), torch.as_tensor(want[:, agree]),
                      atol=1e-5 * np.abs(want).max())
    return {"clips": len(agree), "masks_agree": int(agree.sum()), "max_abs_err": err,
            "max_abs_preds": float(np.abs(want).max())}


def evaluate_3s(card: str, specs, params, Us) -> dict:
    """Phase 12: evaluate and sonify the concepts fitted in phase 11 (the
    loaded layer-10 Us), and the toy model's. Returns the launch counts of
    its counted runs."""
    import tempfile

    import torch
    from drsa_audio_tpu_torch.data.toydata import generate_batch
    from drsa_audio_tpu_torch.models.vgg import build_layer_specs, init_params, toy_config
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig, logmel, peak_normalize
    from drsa_audio_tpu_torch.runtime.loader import load_audio
    from drsa_audio_tpu_torch.runtime.wavio import read_wav
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN, LRP_NAME_MAP_TOY
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    from drsa_audio_tpu_torch.xai.eval import concept_recovery, harness, metrics, stats
    from drsa_audio_tpu_torch.xai.eval.flipping import Flipper
    from drsa_audio_tpu_torch.xai.sonify.mel2audio import Mel2Audio, Mel2AudioToy

    launches = {}
    cls = next(iter(Us))
    svc = ExplainerService(specs, params, LRP_NAME_MAP_GTZAN, Us, K, 10, case="gtzan")
    chain_counts = {"chain_block": 3, "first_layer": 1}

    # ------------------------------------------------ files through the service
    with tempfile.TemporaryDirectory() as tmp:
        paths = timed("write_files", lambda: write_eval_files(tmp, np.random.default_rng(12)),
                      files=B_FILES + 3)
        for p in paths:
            (got, sr), (want, sr0) = load_audio(p), read_wav(p)
            if sr != sr0 or not np.array_equal(got, want):
                raise AssertionError(f"{p}: the native decode differs from read_wav")
        wavs = [prepared_waveform(p) for p in paths]
        batches = [np.stack(wavs[i:i + B_FILE_BATCH]) for i in range(0, len(wavs), B_FILE_BATCH)]
        svc.explain(batches[0], cls)                                    # warm
        run = lambda: list(svc.explain_files(paths, cls, batch_size=B_FILE_BATCH,  # noqa: E731
                                             decode_threads=4, prefetch_depth=2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, launches["explain_files"] = counted(
            "evaluate_3s explain_files", run,
            {k: n * len(batches) for k, n in chain_counts.items()})
        files_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            svc.explain(b, cls)
        memory_s = time.perf_counter() - t0
        # the same bits as explain on the same prepared waveforms, cuDNN held
        # to deterministic algorithms for both runs
        deterministic, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
        try:
            outs = run()
            refs = [svc.explain(b, cls) for b in batches]
        finally:
            torch.backends.cudnn.deterministic = deterministic
    if [o["logits"].shape[0] for o in outs] != [len(b) for b in batches]:
        raise AssertionError(f"explain_files: batches {[o['logits'].shape for o in outs]}")
    for o, r in zip(outs, refs):
        for key in ("standard_heatmaps", "subspace_heatmaps", "subspace_relevances", "mask",
                    "logits"):
            if not np.array_equal(o[key], r[key]):
                raise AssertionError(f"explain_files differs from explain in {key}")
        check_heatmaps("explain_files", o["standard_heatmaps"], o["subspace_heatmaps"],
                       (len(o["logits"]), 128, 128))
    emit({"phase": "evaluate_3s_files", "card": card, "files": len(paths),
          "batch_size": B_FILE_BATCH, "decode_threads": 4, "prefetch_depth": 2,
          "files_per_sec": len(paths) / files_s, "explain_files_ms": files_s * 1e3,
          "in_memory_explain_ms": memory_s * 1e3, "launches": launches["explain_files"],
          "equal_to_explain": True, "native_decode_equal_to_read_wav": True})

    # ------------------------------------------------ concept flipping (DRSA)
    cfg = FrontendConfig.for_case("gtzan")
    x = seeded_mels(3000, 10 * N_EVAL, cfg)
    (aupc, _, _, R), launches["concept_flipping"] = counted(
        "evaluate_3s concept flipping", lambda: timed("concept_flipping", lambda: (
            harness.concept_flipping(specs, params, x, LRP_NAME_MAP_GTZAN, 10, Us, K, case="gtzan",
                                     perturbation_size=16, forward_batch=FORWARD_BATCH,
                                     attr_batch_size=32)), clips=len(x), forwards=6 * len(x)),
        {k: 10 * n for k, n in chain_counts.items()})
    if aupc.shape != (10, N_EVAL) or not np.isfinite(aupc).all():
        raise AssertionError(f"concept flipping AUPC {aupc.shape} or not finite")
    pick = np.array([c * N_EVAL + j for c in range(10) for j in (0, 1)])
    vs_cpu = flipper_card_vs_cpu(specs, params, x[pick], R[pick][:, :, None],
                                 "concept flipping Flipper card vs CPU")

    # ------------------------------------------------ standard LRP
    pf = harness.PixelFlipping(specs, params, x, perturbation_size=16, num_classes=10,
                               forward_batch=FORWARD_BATCH, attr_batch_size=32)
    (std_aupc, _, _, std_R), launches["pixel_flipping"] = counted(
        "evaluate_3s pixel flipping", lambda: timed(
            "pixel_flipping_scaled_gamma", lambda: pf(STANDARD_GRID, scaled_gamma=True)), {})
    (name,) = std_aupc
    std_aupc = std_aupc[name]
    inpaint = timed("inpainting_flipper_20_clips", lambda: Flipper(
        16, "inpainting", forward_batch=FORWARD_BATCH)(pf._fwd, x[pick], std_R[name][pick]))
    if not (np.isfinite(std_aupc).all() and np.isfinite(inpaint[0]).all()):
        raise AssertionError("standard LRP AUPC not finite")

    # ------------------------------------------------ interclass and baseline
    inter, launches["interclass"] = counted(
        "evaluate_3s interclass", lambda: timed("interclass_concept_flipping", lambda: (
            harness.interclass_concept_flipping(
                specs, params, x, LRP_NAME_MAP_GTZAN, {10: Us}, layer_idcs=(10,), num_concepts=K,
                case="gtzan", perturbation_size=16, forward_batch=FORWARD_BATCH,
                attr_batch_size=32, return_samples=True))),
        {k: 100 * n for k, n in chain_counts.items()})
    if inter[0].shape != (10, 10, N_EVAL) or not np.isfinite(inter[0]).all():
        raise AssertionError(f"interclass AUPC {inter[0].shape}")
    gap = timed("interclass_gap_ci", lambda: stats.interclass_gap_ci(inter[0]))
    diff = timed("paired_diff_ci", lambda: stats.paired_diff_ci(aupc, std_aupc))
    rand_R, launches["random_subspace"] = counted(
        "evaluate_3s random subspace", lambda: timed("cf_random_subspace", lambda: (
            harness.cf_random_subspace(specs, params, x, LRP_NAME_MAP_GTZAN, 10, len(Us[cls]), K,
                                       case="gtzan", permutations=3, seed=0,
                                       attr_batch_size=32))),
        {k: 30 * n for k, n in chain_counts.items()})
    table = timed("sep_and_peak_table", lambda: metrics.sep_and_peak_table({4: [R, rand_R]}))
    cancel = [metrics.cancellation_factor(m) for m in (R, rand_R)]
    if not (np.isfinite(table).all() and np.isfinite(cancel).all()):
        raise AssertionError("sep/peak or cancellation not finite")
    emit({"phase": "evaluate_3s_flipping", "card": card, "clips": len(x), "steps": 6,
          "aupc_drsa_mean": float(aupc.mean()), "aupc_standard_mean": float(std_aupc.mean()),
          "aupc_inpainting_mean": float(inpaint[0].mean()),
          "flipper_card_vs_cpu": vs_cpu, "drsa_minus_standard_ci95": diff,
          "interclass_gap_ci95": gap, "sep_peak_drsa_random": table[0].T.tolist(),
          "cancellation_drsa_random": cancel,
          "launches": {k: launches[k] for k in ("concept_flipping", "pixel_flipping",
                                                "interclass", "random_subspace")}})

    # ------------------------------------------------ sonification
    card_m, cpu_m = Mel2Audio("gtzan"), Mel2Audio("gtzan", device="cpu")
    son = {}
    for i in (3, 4):                                   # two 3 s, 16 kHz clips of the first batch
        got = timed("make_audios", lambda: card_m.make_audios(outs[0], wavs[i], K, sample_idx=i),
                    clip=i)
        want = cpu_m.make_audios(outs[0], wavs[i], K, sample_idx=i)
        son[f"make_audios_{i}"] = max(check_close(f"make_audios clip {i}", torch.as_tensor(g),
                                                  torch.as_tensor(w))
                                      for g, w in zip(got, want, strict=True))
        mel, phase = cpu_m.transform_audio(wavs[i])
        rt = timed("transform_mel", lambda: card_m.transform_mel(mel, phase).cpu(), clip=i)
        son[f"transform_mel_{i}"] = check_close(f"transform_mel clip {i}", rt,
                                                cpu_m.transform_mel(mel, phase))
    emit({"phase": "evaluate_3s_sonify", "card": card, "max_abs_err_card_vs_cpu": son})

    # ------------------------------------------------ toy
    specs_t = build_layer_specs(toy_config())
    params_t = init_params(specs_t, seed=0, device="cuda")
    Us_t = {"class1": random_orthogonal(40, 16), "class2": random_orthogonal(41, 16)}
    cfg_t = FrontendConfig.for_case("toy")
    wav_t = np.concatenate([generate_batch(50 + i, c, 16) for i, c in enumerate(Us_t)])
    with torch.inference_mode():
        x_t = logmel(peak_normalize(torch.as_tensor(wav_t, device="cuda")), cfg_t)[:, None]
    (aupc_t, _, _, R_t), launches["toy"] = counted(
        "evaluate_toy concept flipping", lambda: timed("toy_concept_flipping", lambda: (
            harness.concept_flipping(specs_t, params_t, x_t, LRP_NAME_MAP_TOY, 10, Us_t, K,
                                     case="toy", perturbation_size=16, attr_batch_size=32))),
        {k: 2 * n for k, n in chain_counts.items()})
    shares = [concept_recovery.band_assignment(R_t[16 * i:16 * (i + 1)], c)
              for i, c in enumerate(Us_t)]
    toy_audio = Mel2AudioToy().make_audios(
        {"standard_heatmaps": R_t[:1].sum(axis=1, keepdims=True), "subspace_heatmaps": R_t[:1]},
        wav_t[0], K)
    if not (np.isfinite(aupc_t).all() and all(np.isfinite(a).all() for a in toy_audio)):
        raise AssertionError("toy evaluation not finite")
    emit({"phase": "evaluate_toy", "card": card, "clips": len(x_t), "aupc": aupc_t.tolist(),
          "band_coverage": [s[2] for s in shares],
          "assignment": [s[1] for s in shares], "audios": len(toy_audio),
          "launches": launches["toy"]})
    return {k: sum(c[k] for c in launches.values()) for k in SOURCES}


N_GENRE_CLIPS, B_TRAIN, B_TRAIN_BIG, TRAIN_STEPS, BN_STEPS, RESUME_STEPS = 20, 16, 128, 50, 20, 10
TOY_PER_CLASS, TOY_EPOCHS, LR = 50, 12, 1e-4


def write_gtzan_corpus(root: str, seed: int) -> None:
    """10 genres x N_GENRE_CLIPS clips of 30 s at 16 kHz (seeded noise over
    a tone of the genre's own pitch), written with the port's write_wav, and
    the 5folds lists: clip i in fold i % 5 + 1, so that with fold 1 held out
    160 clips train and 40 validate."""
    from drsa_audio_tpu_torch.runtime.wavio import write_wav
    from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER
    rng = np.random.default_rng(seed)
    t = np.arange(30 * 16000) / 16000
    folds = {k: [] for k in range(1, 6)}
    for genre, label in CLASS_IDX_MAPPER.items():
        os.makedirs(os.path.join(root, "genres_original", genre))
        tone = 0.3 * np.sin(2 * np.pi * 150.0 * (label + 1) * t)
        for i in range(N_GENRE_CLIPS):
            rel = f"{genre}/{genre}.{i:05d}.wav"
            wav = np.clip(rng.standard_normal(t.size) * 0.2 + tone, -1, 1).astype(np.float32)
            write_wav(os.path.join(root, "genres_original", rel), wav, 16000)
            folds[i % 5 + 1].append(rel)
    os.makedirs(os.path.join(root, "5folds"))
    for k, items in folds.items():
        with open(os.path.join(root, "5folds", f"fold_{k}.txt"), "w") as f:
            f.write("\n".join(items) + "\n")


def full_batches(feed, batch: int):
    """The feed's batches of exactly ``batch`` clips, round its epochs
    without end."""
    while True:
        for wavs, labels in feed:
            if labels.shape[0] == batch:
                yield wavs, labels


def train_timing(name: str, card: str, specs, params, pipeline, has_bn: bool, feed,
                 batch: int, steps: int) -> dict:
    """``steps`` train steps at ``batch`` from ``feed`` (three untimed
    first), with every launch counter set to 0 just before and read just
    after (training launches no kernel of the port): ms per step and
    clips/s on the host clock, the device synchronised before and after;
    the augment + mel alone by CUDA events (10 calls on one batch's draws)
    and its share of a step; the device's idle share of one traced step;
    peak device memory."""
    import torch
    from drsa_audio_tpu_torch.models.train import (
        make_optimizer, make_train_step, sample_step_draws, split_trainable)
    trainable, _ = split_trainable(params)
    step = make_train_step(specs, make_optimizer(trainable, LR), pipeline, has_bn)
    gen = torch.Generator(device="cuda").manual_seed(42)
    batches = full_batches(feed, batch)

    def one():
        wavs, labels = next(batches)
        return step(params, wavs, labels, sample_step_draws(specs, pipeline, wavs.shape, gen))

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = torch.stack([one()[0] for _ in range(steps)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(launch_counts().values()):
        raise AssertionError(f"{name}: training launched {launch_counts()}")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{name}: a loss is not finite")
    wavs, _ = next(batches)
    draws = pipeline.sample(batch, wavs.shape[-1], gen)
    with torch.no_grad():
        mel_ms = cuda_ms(lambda: pipeline.apply(wavs, draws), 10)
    trace = traced_request(lambda: (one(), torch.cuda.synchronize()))
    return {"phase": name, "card": card, "batch": batch, "steps": steps, "ms_per_step": ms,
            "clips_per_s": batch * 1e3 / ms, "augment_mel_ms": mel_ms,
            "augment_mel_share": mel_ms / ms, "traced_step_ms": trace["request_ms"],
            "device_idle_share_traced_step": trace["device_idle_share"], "peak_mem_gb": peak,
            "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
            "top": trace["top"][:5]}


def mels_card_vs_cpu(name: str, got, want, plain) -> dict:
    """Card against CPU log-mels [b, 1, h, w] of an augment pipeline. Every
    clip on the mel power, rtol 1e-4, atol 5e-5 * the clip's peak; the
    clips in ``plain`` (neither filtered nor pitch-shifted) also in log10
    units, rtol 1e-4, atol 1e-4. A filter's stopband and the top of an
    octave-down shift hold bins 60-100 dB under the peak, whose value is
    float32 FFT round-off on either device; a pitch shift's two more FFT
    round trips and resample leave up to 1.02e-5 of the peak between the
    devices (measured)."""
    got, want = got.cpu().double(), want.double()
    pg, pw = 10.0 ** got, 10.0 ** want
    peak = pw.amax(dim=(1, 2, 3), keepdim=True)
    bad = ((pg - pw).abs() > 1e-4 * pw + 5e-5 * peak).sum().item()
    if bad:
        raise AssertionError(f"{name}: {bad} mel-power elements outside rtol 1e-4, "
                             "atol 5e-5 * the clip's peak")
    plain_err = check_close(f"{name}, plain clips (log10)", got[plain], want[plain], atol=1e-4)
    return {"clips": got.shape[0], "plain_clips": int(plain.sum()),
            "log10_max_abs_err_plain": plain_err,
            "log10_max_abs_err_all": (got - want).abs().max().item(),
            "power_max_abs_err_over_peak": ((pg - pw).abs() / peak).max().item()}


def step_card_vs_cpu(name: str, specs, mels, labels, has_bn: bool) -> dict:
    """One train step from the same mels, params (init seed 0) and keep
    masks on the card and on the CPU (a host_reference): loss rtol 1e-5;
    every param and BN statistic after the step, and the linear layers'
    gradients, rtol 1e-4, atol 1e-5 * max|CPU| per tensor (a param also
    the learning rate times its gradient's atol). The gradients
    of the conv and BatchNorm layers are summed over up to 5e5 positions
    a channel, and the card's float32 kernels for them sit further from
    float64 than the CPU's (measured against the card in float64):
    cuDNN's backward-filter up to 1.2e-3 of max|grad| on the 3s model (the
    CPU 6.7e-7; cuDNN off, 3.8e-7), and on the 6s model the BN backward,
    cuDNN's or PyTorch's own, 1.5e-3 at BN and 5.1e-3 at the convs below
    it (the CPU 3e-5 and 6.6e-5). Those at atol 2e-3 * max|CPU| without
    BatchNorm, 1e-2 * max|CPU| with it. With BatchNorm the other gradients
    too sit further from float64 on either device (5.2e-5 of max|grad| at
    the linear layers on the card, 3.1e-5 on the CPU; the loss 1.3e-6 off
    on both): atol 1e-4 * max|CPU| there. A bias that BatchNorm follows has
    a gradient of zero but for round-off: at the conv factor times the
    model's largest |gradient|."""
    import torch
    from drsa_audio_tpu_torch.models.train import make_optimizer, make_train_step, split_trainable
    from drsa_audio_tpu_torch.models.vgg import draw_keep_masks, init_params
    masks = draw_keep_masks(specs, mels.shape[0], torch.Generator().manual_seed(6))
    cancelled = {f"{a.name}.bias" for a, b in zip(specs, specs[1:])
                 if a.kind in ("conv", "linear") and b.kind.startswith("batchnorm")}
    summed = {f"{s.name}.{k}" for s in specs if s.kind in ("conv", "batchnorm")
              for k in ("weight", "bias")}
    factor, other = (1e-2, 1e-4) if has_bn else (2e-3, 1e-5)

    def run(dev):
        params = init_params(specs, 0, device=dev)
        trainable, _ = split_trainable(params)
        step = make_train_step(specs, make_optimizer(trainable, LR), None, has_bn)
        loss, _ = step(params, mels.to(dev), labels.to(dev),
                       {"dropout": {k: v.to(dev) for k, v in masks.items()}})
        grads = {f"{n}.{k}": v.grad.cpu() for n, p in trainable.items() for k, v in p.items()}
        after = {f"{n}.{k}": v.detach().cpu() for n, p in params.items() for k, v in p.items()}
        return loss.cpu(), grads, after

    loss, grads, after = run("cuda")
    flat, runs = host_reference(f"{name} CPU step",
                                lambda: (lambda r: (r[0], *r[1].values(), *r[2].values()))(
                                    run("cpu")))
    want_loss = flat[0]
    want_grads = dict(zip(grads, flat[1:1 + len(grads)]))
    want_after = dict(zip(after, flat[1 + len(grads):]))
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    if not rel <= 1e-5:
        raise AssertionError(f"{name}: loss {loss.item()} on the card, {want_loss.item()} on "
                             f"the CPU (rel err {rel})")
    top = max(g.abs().max().item() for g in want_grads.values())

    def grad_atol(k, g):
        if k in cancelled:
            return factor * top
        return (factor if k in summed else other) * g.abs().max().item()
    grad_err = max(check_close(f"{name} gradient {k}", grads[k], g, atol=grad_atol(k, g))
                   for k, g in want_grads.items())

    def param_atol(k, v):           # an update moves a param by lr * its gradient
        atol = 1e-5 * v.abs().max().item()
        return atol + LR * grad_atol(k, want_grads[k]) if k in want_grads else atol
    param_err = max(check_close(f"{name} {k} after the step", after[k], v, atol=param_atol(k, v))
                    for k, v in want_after.items())
    return {"loss_card": loss.item(), "loss_cpu": want_loss.item(), "loss_rel_err": rel,
            "grad_max_abs_err": grad_err, "grad_max_abs": top,
            "param_max_abs_err_after_step": param_err, "cpu_reference_runs": runs}


def resume_bit_equal(card: str, specs, pipeline, feed, tmp: str) -> dict:
    """2 x RESUME_STEPS steps on fixed batches, against RESUME_STEPS steps,
    save_checkpoint, load_checkpoint into a new optimizer and generator,
    and RESUME_STEPS more: the losses and every tensor bit-equal, cuDNN held
    to deterministic algorithms."""
    import torch
    from drsa_audio_tpu_torch.models.train import (
        load_checkpoint, make_optimizer, make_train_step, merge_params, sample_step_draws,
        save_checkpoint, split_trainable)
    from drsa_audio_tpu_torch.models.vgg import init_params
    batches = full_batches(feed, B_TRAIN)
    fixed = [tuple(t.clone() for t in next(batches)) for _ in range(2 * RESUME_STEPS)]

    def steps(trainable, state, opt, gen, todo):
        step = make_train_step(specs, opt, pipeline)
        params = merge_params(trainable, state)
        return [step(params, w, lab, sample_step_draws(specs, pipeline, w.shape, gen))[0]
                for w, lab in todo]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for split in (False, True):
            trainable, state = split_trainable(init_params(specs, 0, device="cuda"))
            opt = make_optimizer(trainable, LR)
            gen = torch.Generator(device="cuda").manual_seed(7)
            if not split:
                losses = steps(trainable, state, opt, gen, fixed)
            else:
                losses = steps(trainable, state, opt, gen, fixed[:RESUME_STEPS])
                path = save_checkpoint(tmp, trainable, state, opt.state_dict(), RESUME_STEPS,
                                       gen.get_state())
                ckpt = load_checkpoint(tmp)
                trainable = {n: {k: v.to("cuda") for k, v in p.items()}
                             for n, p in ckpt["trainable"].items()}
                state = {n: {k: v.to("cuda") for k, v in p.items()}
                         for n, p in ckpt["state"].items()}
                opt = make_optimizer(trainable, LR)
                opt.load_state_dict(ckpt["opt_state"])
                gen = torch.Generator(device="cuda")
                gen.set_state(ckpt["rng_state"])
                losses += steps(trainable, state, opt, gen, fixed[RESUME_STEPS:])
            runs.append((torch.stack(losses), trainable))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (la, ta), (lb, tb) = runs
    same = torch.equal(la, lb) and all(torch.equal(ta[n][k], tb[n][k]) for n in ta for k in ta[n])
    if not same:
        raise AssertionError("resumed training is not bit-equal to the uninterrupted run")
    return {"phase": "train_3s_resume", "card": card, "steps": 2 * RESUME_STEPS,
            "saved_at": RESUME_STEPS, "checkpoint": os.path.basename(path),
            "checkpoint_mb": os.path.getsize(path) / 1e6, "bit_equal": True,
            "loss_last": lb[-1].item()}


def conditioning(got, want, moved) -> dict:
    """How far apart two float32 walks of one batch may fall: per clip,
    max|kernels - plain| (``got`` against ``want``) and max|plain - the
    plain walk of the mels times (1 + 1e-7 * seeded noise)| (``moved``),
    each over the clip's max|plain|; their median and max over the clips.
    Fails unless the kernels' median is within 10x the perturbed plain
    walk's (measured 0.4-0.6x on the trained 6s model): a wrong kernel
    parts from the plain walk on every clip."""
    import torch
    if not (torch.isfinite(got).all() and torch.isfinite(moved).all()):
        raise AssertionError("conditioning: heatmaps not finite")
    peak = want.abs().amax(dim=(1, 2, 3))

    def spread(a):
        r = ((a - want).abs().amax(dim=(1, 2, 3)) / peak).cpu().numpy()
        return {"median": float(np.median(r)), "max": float(r.max())}
    out = {"kernels_vs_plain": spread(got), "plain_vs_plain_perturbed_1e-7": spread(moved),
           "max_abs_plain": want.abs().max().item()}
    if not out["kernels_vs_plain"]["median"] <= 10 * out["plain_vs_plain_perturbed_1e-7"]["median"]:
        raise AssertionError(f"conditioning: the kernels part from the plain walk beyond "
                             f"its own spread: {out}")
    return out


def lrp_conditioning(svc, wavs, class_name: str) -> dict:
    """``conditioning`` of one service request."""
    import torch
    from drsa_audio_tpu_torch.models.projection import insert_projection
    from drsa_audio_tpu_torch.ops.frontend import logmel, peak_normalize
    from drsa_audio_tpu_torch.xai.explain import subspace_heatmaps
    got, _ = svc._dispatch(wavs, class_name)
    want, _ = svc._dispatch(wavs, class_name, fused=False)
    cfg = svc.config
    with torch.inference_mode():
        mels = logmel(peak_normalize(torch.as_tensor(wavs, device="cuda")), cfg)[:, None]
        g = torch.Generator(device="cuda").manual_seed(0)
        mels = mels * (1 + 1e-7 * torch.randn(mels.shape, generator=g, device="cuda"))
        onehot = torch.zeros(svc.n_classes, device="cuda")
        onehot[svc.mapper[class_name]] = 1.0
        specs = insert_projection(svc.specs, svc.layer_idx, svc.Us[class_name], K,
                                  input_size=(cfg.n_mels, cfg.width))
        moved, _ = subspace_heatmaps(specs, svc.params, mels, svc.composite, K,
                                     output_mask=lambda lg: lg * onehot[None, :], fused=False)
    return conditioning(got, want, moved)


def train_then_explain(card: str) -> dict:
    """Phase 13: train GTZAN-3s and the 6s flagship on the card from a
    written corpus, check card against CPU, the resume, fit and get_acc,
    serve both trained models through the kernels, and train the toy model
    through the port's CLI. Returns the launch counts of its counted
    serves."""
    import tempfile

    import torch
    from drsa_audio_tpu_torch.data.datasets import GtzanWaveDataset
    from drsa_audio_tpu_torch.data.toydata import generate_dataset
    from drsa_audio_tpu_torch.models.train import (
        fit, gtzan_augment_and_mel, gtzan_pipeline, sample_gtzan_draws, valid_chunks_to_mels)
    from drsa_audio_tpu_torch.models.vgg import (
        build_layer_specs, fold_batchnorm, gtzan_3s_config, gtzan_6s_config, init_params)
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN, LRP_NAME_MAP_GTZAN_6S
    from drsa_audio_tpu_torch.utils.evaluation import get_acc, get_cm, get_train_stats

    launches = {}
    rng = np.random.default_rng(13)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "gtzan")
        t0 = time.perf_counter()
        write_gtzan_corpus(root, 13)
        write_s = time.perf_counter() - t0
        train16 = GtzanWaveDataset(root, "train", 1, B_TRAIN, device_cache=True, device="cuda")
        t0 = time.perf_counter()
        train16.preload()
        decode_s = time.perf_counter() - t0
        train128 = GtzanWaveDataset(root, "train", 1, B_TRAIN_BIG, device_cache=True,
                                    device="cuda")
        valid = GtzanWaveDataset(root, "valid", 1, B_TRAIN // 8, device_cache=True, device="cuda")
        # the held-out fold's first clips, on the host (its feed is not shuffled)
        clips, clip_labels = next(iter(GtzanWaveDataset(root, "valid", 1, B_SERVE)))
        emit({"phase": "train_corpus", "card": card, "train_clips": len(train16.paths),
              "valid_clips": len(valid.paths), "write_s": write_s, "decode_s": decode_s})

        # ------------------------------------------------------------ 3s
        specs = build_layer_specs(gtzan_3s_config())
        cfg = FrontendConfig.for_case("gtzan")
        pipeline = gtzan_pipeline(cfg)
        for b, feed in ((B_TRAIN, train16), (B_TRAIN_BIG, train128)):
            emit(train_timing(f"train_3s_b{b}", card, specs, init_params(specs, 0, device="cuda"),
                              pipeline, False, feed, b, TRAIN_STEPS))
        torch.cuda.empty_cache()

        # card against CPU: the augment + mel from CPU draws, then a step
        wavs = torch.as_tensor(clips[:8])
        draws = sample_gtzan_draws(8, wavs.shape[-1], cfg, True, True,
                                   generator=torch.Generator().manual_seed(5))
        plain = ~(draws["pitch_on"] | draws["filter_on"])
        with torch.no_grad():
            mel_cpu, mel_runs = host_reference("3s CPU augment + mel", lambda: gtzan_augment_and_mel(
                wavs, draws, cfg, True, True))
            mel_card = gtzan_augment_and_mel(wavs.cuda(), {k: v.cuda() for k, v in draws.items()},
                                             cfg, True, True)
        labels = torch.as_tensor(clip_labels[:8])
        emit({"phase": "train_3s_card_vs_cpu", "card": card, "cpu_reference_runs": mel_runs,
              "pitch_shifted": int(draws["pitch_on"].sum()),
              "filtered": int(draws["filter_on"].sum()),
              **mels_card_vs_cpu("3s augment + mel, card vs CPU", mel_card, mel_cpu, plain),
              "step": step_card_vs_cpu("3s train step, card vs CPU", specs, mel_card.cpu(), labels,
                                       False)})
        emit(resume_bit_equal(card, specs, pipeline, train16, os.path.join(tmp, "ckpt")))

        # one epoch of fit, validated on every chunk of the held-out fold
        def valid_batches():
            for w, lab in valid:
                with torch.no_grad():
                    yield valid_chunks_to_mels(w, cfg), lab.repeat_interleave(cfg.num_chunks)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params3, stats = fit(specs, init_params(specs, 0, device="cuda"), lambda: iter(train16),
                             valid_batches, num_epochs=1, lr=LR, per_example_mel=pipeline,
                             model_path=os.path.join(tmp, "fit3s"), save_step=1, device="cuda")
        fit_s = time.perf_counter() - t0
        acc, ytrue, ypred = get_acc(specs, params3, valid_batches())
        cm = get_cm(ytrue, ypred, 10)
        csv_stats = get_train_stats(os.path.join(tmp, "fit3s"))
        if not (abs(acc / 100 - stats.valid_acc[0]) < 1e-6 and csv_stats["valid_acc"]
                == stats.valid_acc and np.isfinite(stats.train_loss).all()):
            raise AssertionError(f"3s fit: get_acc {acc}, fit {stats.valid_acc}, csv {csv_stats}")
        emit({"phase": "train_3s_fit_epoch", "card": card, "seconds": fit_s,
              "train_steps": len(train16.paths) // B_TRAIN, "train_loss": stats.train_loss[0],
              "valid_mels": int(ytrue.size), "valid_acc_percent": acc,
              "cm_diagonal": np.diag(cm).round(2).tolist(),
              "checkpoints": sorted(os.listdir(os.path.join(tmp, "fit3s")))})

        # the trained 3s weights served at layer 10
        wavs3 = clips[:, :48000]
        svc = ExplainerService(specs, params3, LRP_NAME_MAP_GTZAN,
                               {"rock": signed_permutation(rng, 64).cpu().numpy()}, K, 10,
                               case="gtzan")
        serve3 = serve_checks(svc, [wavs3], ["rock"], (B_SERVE, 128, 128),
                              {"chain_block": 3, "first_layer": 1}, "train_then_explain_3s")
        launches["train_then_explain_3s"] = serve3["launches"]
        emit({**serve3, "card": card})
        del svc, params3
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ 6s
        specs6 = build_layer_specs(gtzan_6s_config())
        cfg6 = FrontendConfig.for_case("gtzan_6s")
        params6 = init_params(specs6, 0, device="cuda")
        before = {n: (p["running_mean"].clone(), p["running_var"].clone())
                  for n, p in params6.items() if "running_mean" in p}
        emit(train_timing("train_6s_b16", card, specs6, params6, gtzan_pipeline(cfg6), True,
                          train16, B_TRAIN, BN_STEPS))
        for n, (m, v) in before.items():
            p = params6[n]
            if (torch.equal(p["running_mean"], m) or torch.equal(p["running_var"], v)
                    or not (torch.isfinite(p["running_mean"]).all()
                            and torch.isfinite(p["running_var"]).all())
                    or (p["running_var"] <= 0).any()):
                raise AssertionError(f"6s BN {n}: running statistics did not move or are "
                                     "not finite and positive")
        draws6 = sample_gtzan_draws(4, wavs.shape[-1], cfg6, True, True,
                                    generator=torch.Generator().manual_seed(8))
        with torch.no_grad():
            mels6 = gtzan_augment_and_mel(wavs[:4].cuda(), {k: v.cuda() for k, v in draws6.items()},
                                          cfg6, True, True).cpu()
        emit({"phase": "train_6s_card_vs_cpu", "card": card,
              "bn_layers_moved": len(before),
              "step": step_card_vs_cpu("6s train step, card vs CPU", specs6, mels6, labels[:4],
                                       True)})
        specs6f, params6f = fold_batchnorm(specs6, {n: {k: v.detach() for k, v in p.items()}
                                                    for n, p in params6.items()})
        svc6 = ExplainerService(specs6f, params6f, LRP_NAME_MAP_GTZAN_6S,
                                {"metal": signed_permutation(rng, 128).cpu().numpy()}, K, 33,
                                case="gtzan_6s")
        # 20 steps leave the folded 6s model's LRP walk ill-conditioned (z
        # near 0 under large folded biases): two float32 walks part by up to
        # the plain walk's own spread under a 1e-7 change of its input, so
        # the request is held to the checks of 2 but the plain-path match,
        # and that spread is reported beside the kernels' (the kernels are
        # held against their plain versions at these shapes in 6-7)
        serve6 = serve_checks(svc6, [clips[:, :96000]], ["metal"],
                              (B_SERVE, 128, 256), {"chain_block": 4, "first_block_deep": 1},
                              "train_then_explain_6s", vs_plain=False)
        launches["train_then_explain_6s"] = serve6["launches"]
        emit({**serve6, "card": card,
              "conditioning": lrp_conditioning(svc6, clips[:, :96000], "metal")})
        del svc6, params6, params6f, train16, train128, valid
        torch.cuda.empty_cache()

        # ----------------------------------------------- toy, through the CLI
        toy, out = os.path.join(tmp, "toy"), os.path.join(tmp, "toyrun")
        generate_dataset(toy, datapoints_per_class=TOY_PER_CLASS, seed=0)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "drsa_audio_tpu_torch.scripts.train", "--case",
                              "toy", "--data", toy, "--out", out, "--epochs", str(TOY_EPOCHS)],
                             cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                             text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"toy CLI exited {run.returncode}: {run.stderr[-2000:]}")
        files = sorted(os.listdir(out))
        toy_stats = get_train_stats(os.path.join(out, "train_stats_0.csv"))
        if f"ckpt_{TOY_EPOCHS}.pt" not in files or not (
                toy_stats["train_loss"][-1] < toy_stats["train_loss"][0]):
            raise AssertionError(f"toy CLI: files {files}, train loss {toy_stats['train_loss']}")
        emit({"phase": "train_toy_cli", "card": card, "epochs": TOY_EPOCHS,
              "clips_per_class": TOY_PER_CLASS, "seconds": cli_s, "files": files,
              "train_loss": toy_stats["train_loss"], "valid_acc": toy_stats["valid_acc"]})
    return launches


# ------------------------------------------------------------ phase 14

WF_TOY_PER_CLASS, WF_TOY_EPOCHS, WF_TOY_STEPS, WF_TOY_RUNS = 50, 8, 500, 3
WF_REC_PER_CLASS, WF_REC_EPOCHS, WF_REC_STEPS = 64, 4, 300
WF_SONGS, WF_CLIPS, WF_6S_STEPS, WF_6S_SPC = 10, 40, 200, 2
ATTR_BATCH = 32            # run_concept_eval's --attr-batch default
CHAIN_PER_CHUNK = {"toy": {"chain_block": 3, "first_layer": 1},          # layer 10
                   "gtzan_6s": {"chain_block": 4, "first_block_deep": 1}}  # layer 33


def eval_chunks(per_class: int, n_classes: int) -> int:
    """HeatmapGenerator chunks of one run_concept_eval at one K and layer
    with both algorithms and the interclass matrix: each class's DRSA maps,
    the random baseline's 3 permutations of every class, and the matrix's
    n_classes^2 (class U, class) blocks, each per_class clips in chunks of
    ATTR_BATCH."""
    return (n_classes * (1 + 3) + n_classes ** 2) * -(-per_class // ATTR_BATCH)


def chain_counts(case: str, chunks: int) -> dict:
    return {k: v * chunks for k, v in CHAIN_PER_CHUNK[case].items()}


def workflow_stage(name: str, card: str, run, counts: dict, **beside) -> dict:
    """One CLI stage of phase 14: ``run()`` with every launch counter set to
    0 just before and read just after (``counted``: fails unless they are
    ``counts``), on the host clock with the device synchronised before and
    after; emits the stage's line and returns its counts."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, got = counted(name, run, counts)
    torch.cuda.synchronize()
    emit({"phase": name, "card": card, "seconds": time.perf_counter() - t0, "launches": got,
          **beside})
    return got


def check_runs(root: str, name: str) -> dict:
    """Every run under ``root`` (``{class}/layer{L}/run{r}``, the JAX
    layout): U orthogonal (max|U^T U - I| <= 1e-4), and each class's best
    run ending above its start."""
    from drsa_audio_tpu_torch.utils.evaluation import get_best_run
    worst, layer_dirs = 0.0, []
    for dirpath, dirs, files in os.walk(root):
        if "projection_matrix.npy" in files:
            U = np.load(os.path.join(dirpath, "projection_matrix.npy")).astype(np.float64)
            worst = max(worst, float(np.abs(U.T @ U - np.eye(len(U))).max()))
        if any(d.startswith("run") for d in dirs):
            layer_dirs.append(dirpath)
    best = [get_best_run(p)[3] for p in sorted(layer_dirs)]
    if not (layer_dirs and worst <= 1e-4 and all(b[-1] > b[0] for b in best)):
        raise AssertionError(f"{name}: max|U^T U - I| {worst}, best runs first -> last "
                             f"{[(b[0], b[-1]) for b in best]}")
    return {"pairs": len(layer_dirs), "orthogonality_max_err": worst,
            "best_first_objective": [float(b[0]) for b in best],
            "best_last_objective": [float(b[-1]) for b in best]}


def check_eval(out: str, name: str) -> dict:
    """run_concept_eval's files: every AUPC finite, every CI finite."""
    aupcs = {f: np.load(os.path.join(out, f)) for f in sorted(os.listdir(out))
             if f.endswith(".npy") and ("aupcs" in f or f.startswith("standard"))}
    cis = []
    for f in ("sep_peak_analysis.json", "drsa_vs_standard_ci.json"):
        for entry in json.load(open(os.path.join(out, f))).values():
            cis += [v["ci95"] for v in entry.values() if isinstance(v, dict) and "ci95" in v]
    cis += [json.load(open(os.path.join(out, f)))["ci95"] for f in os.listdir(out)
            if f.endswith("_ci.json") and f.startswith("interclass")]
    if not (aupcs and cis and all(np.isfinite(a).all() for a in aupcs.values())
            and np.isfinite(cis).all()):
        raise AssertionError(f"{name}: AUPCs {list(aupcs)} or CIs {cis} not finite")
    return {"aupc_mean": {f: float(a.mean()) for f, a in aupcs.items()}, "cis": len(cis)}


def check_sonified(out: str, name: str, length: int, num_concepts: int = K) -> dict:
    """sonify_prototypes' files: prototypes.json and, per sonified slice,
    the standard and K concept WAVs, finite and ``length`` samples."""
    from drsa_audio_tpu_torch.runtime.wavio import read_wav
    manifest = json.load(open(os.path.join(out, "prototypes.json")))
    wavs = sorted(f for f in os.listdir(out) if f.endswith(".wav"))
    sonified = sum(p.get("sonified", False) for p in manifest["prototypes"])
    shapes = {read_wav(os.path.join(out, f))[0].shape for f in wavs}
    finite = all(np.isfinite(read_wav(os.path.join(out, f))[0]).all() for f in wavs)
    if not (len(wavs) == sonified * (num_concepts + 1) and sonified and finite
            and shapes == {(1, length)}):
        raise AssertionError(f"{name}: {wavs}, shapes {shapes}, finite {finite}")
    return {"wavs": len(wavs), "samples": length, "subset_index": manifest["subset_index"],
            "subset_objective": manifest["subset_objective"]}


def prototype_generator(cfg, model_dir: str, subspaces: str, batch, sample_class: str,
                        layer: int, subset_size: int = 10, max_sonify: int = 2):
    """The HeatmapGenerator and the mels of sonify_prototypes' prototype
    chunk, rebuilt from its checkpoint, U and prototypes.json."""
    import torch
    from drsa_audio_tpu_torch.scripts.common import load_model
    from drsa_audio_tpu_torch.utils.evaluation import load_projection_matrix
    from drsa_audio_tpu_torch.xai.explain import HeatmapGenerator
    specs, params = load_model(cfg, model_dir, None, "cuda")
    U = load_projection_matrix(os.path.join(subspaces, sample_class, f"layer{layer}"))
    gen = HeatmapGenerator(specs=specs, params=params, U=U, name_map=cfg.lrp_name_map,
                           sample_class=sample_class, num_concepts=K, layer_idx=layer,
                           case=cfg.case, device="cuda")
    return gen, torch.as_tensor(batch[:max_sonify], device="cuda")


def generator_conditioning(gen, x) -> dict:
    """lrp_conditioning of a HeatmapGenerator chunk: the kernels' walk and
    the plain walk on ``x``, and the plain walk on x times (1 + 1e-7 *
    seeded noise), all through subspace_heatmaps on the generator's
    specs_proj."""
    import torch
    from drsa_audio_tpu_torch.xai.explain import subspace_heatmaps
    onehot = torch.zeros(gen.num_classes, device="cuda")
    onehot[gen.class_idx] = 1.0
    g = torch.Generator(device="cuda").manual_seed(0)

    def walk(mels, fused):
        return subspace_heatmaps(gen.specs_proj, gen.params, mels, gen.composite,
                                 gen.num_concepts, output_mask=lambda lg: lg * onehot,
                                 fused=fused)[0]
    with torch.inference_mode():
        moved = x * (1 + 1e-7 * torch.randn(x.shape, generator=g, device="cuda"))
        return conditioning(walk(x, None), walk(x, False), walk(moved, False))


def workflow(card: str) -> dict:
    """Phase 14: the research workflow through the port's CLIs, each
    stage's ``main([...])`` called in this process on the card with every
    launch counter set to 0 just before and read just after, timed with the
    device synchronised; the counts must equal those derived from the
    stage's HeatmapGenerator chunks. Returns {stage: launch counts}.

    Toy (the toy config at full width, K=4, layer 10, d=16): generate_toydata
    (50 clips a class), scripts.train (8 epochs), extract_drsa_data (20
    locations), optimize_subspaces (K=4, 500 steps x 3 runs),
    run_concept_eval (DRSA and random, interclass at 10), sonify_prototypes
    (class1), concept_recovery_experiment (64 clips a class, 4 epochs, 300
    steps x 3 runs). The prototype chunk's maps on the trained weights
    against the plain walk at the chain tolerance. demo_toy_workflow is not
    run: its plots need matplotlib, which this host lacks (the CPU tests
    run it).

    GTZAN-6s (the flagship at full width with BatchNorm): generate_gtzan_synth
    --multi-concept (10 songs a genre: fold 1 holds 2, which fill
    --samples-per-class 2), scripts.train --case gtzan_6s (1 epoch), then
    run_gtzan_synth_workflow at layer 33 (40 clips a class, 200 steps x 1
    run), one call a stage with --skip for the others. The prototype
    chunk's maps on the trained weights against the plain walk as phase 13
    holds the trained 6s model (conditioning: within 10x the plain walk's
    own spread).

    Cut in depth only, never in width: clips a class (toy 50, reference
    2,000; recovery 64, reference 512), epochs (toy 8 and recovery 4,
    reference 40-80; 6s 1, reference 500), DRSA steps and runs (toy 500 x 3
    and recovery 300 x 3, reference 2,000-5,000 x 3; 6s 200 x 1), the 6s
    corpus (10 songs a genre, 40 clips a class extracted, reference 300), its
    evaluation (2 songs a genre x 3 chunks, reference 20) and DRSA layers
    (33 of 19/26/33)."""
    import tempfile

    import torch
    from drsa_audio_tpu_torch.data.datasets import (
        get_songs_drsa, get_songs_toy, get_toy_samplelist)
    from drsa_audio_tpu_torch.scripts import (
        concept_recovery_experiment, extract_drsa_data, generate_gtzan_synth, generate_toydata,
        optimize_subspaces, run_concept_eval, run_gtzan_synth_workflow, sonify_prototypes,
        train)
    from drsa_audio_tpu_torch.scripts.common import experiment_config
    from drsa_audio_tpu_torch.utils.evaluation import get_train_stats

    launches = {}
    dev = ["--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        # ------------------------------------------------------------ toy
        d = {k: os.path.join(tmp, k) for k in ("toy", "model", "drsa", "sub", "eval", "son")}
        launches["toy_generate"] = workflow_stage(
            "workflow_toy_generate", card, lambda: generate_toydata.main(
                ["--out", d["toy"], "--per-class", str(WF_TOY_PER_CLASS), "--seed", "0", *dev]),
            {}, clips_per_class=WF_TOY_PER_CLASS)
        launches["toy_train"] = workflow_stage(
            "workflow_toy_train", card, lambda: train.main(
                ["--case", "toy", "--data", d["toy"], "--out", d["model"],
                 "--epochs", str(WF_TOY_EPOCHS), *dev]), {}, epochs=WF_TOY_EPOCHS)
        stats = get_train_stats(d["model"])
        if not (f"ckpt_{WF_TOY_EPOCHS}.pt" in os.listdir(d["model"])
                and np.isfinite(stats["train_loss"]).all()):
            raise AssertionError(f"toy train CLI: {os.listdir(d['model'])}, {stats}")
        model = ["--case", "toy", "--data", d["toy"], "--checkpoint", d["model"], *dev]
        launches["toy_extract"] = workflow_stage(
            "workflow_toy_extract", card, lambda: extract_drsa_data.main(
                [*model, "--out", d["drsa"], "--layers", "10", "--num-locations", "20"]), {})
        for cls in ("class1", "class2"):
            arr = np.load(os.path.join(d["drsa"], cls, "dataset_layer10.npz"))
            if arr["activations"].shape != (WF_TOY_PER_CLASS * 20, 16) or not np.isfinite(
                    arr["contexts"]).all():
                raise AssertionError(f"toy extraction {cls}: {arr['activations'].shape}")
        sub4 = os.path.join(d["sub"], f"{K}_concepts")
        launches["toy_optimize"] = workflow_stage(
            "workflow_toy_optimize", card, lambda: optimize_subspaces.main(
                ["--data", d["drsa"], "--out", sub4, "--num-concepts", str(K),
                 "--steps", str(WF_TOY_STEPS), "--runs", str(WF_TOY_RUNS), *dev]), {},
            steps=WF_TOY_STEPS, runs=WF_TOY_RUNS)
        emit({"phase": "workflow_toy_runs", "card": card, **check_runs(sub4, "toy runs")})
        per_class = min(len(get_toy_samplelist(d["toy"], "class1", "test")),
                        experiment_config(None, "toy").eval.samples_per_class)
        chunks = eval_chunks(per_class, 2)
        launches["toy_eval"] = workflow_stage(
            "workflow_toy_eval", card, lambda: run_concept_eval.main(
                [*model, "--subspaces", d["sub"], "--out", d["eval"], "--num-concepts", str(K),
                 "--layers", "10", "--algorithms", "drsa", "random",
                 "--interclass-layer", "10"]),
            chain_counts("toy", chunks), clips_per_class=per_class, generator_chunks=chunks)
        emit({"phase": "workflow_toy_eval_files", "card": card,
              **check_eval(d["eval"], "toy eval")})
        launches["toy_sonify"] = workflow_stage(
            "workflow_toy_sonify", card, lambda: sonify_prototypes.main(
                [*model, "--subspaces", sub4, "--out", d["son"], "--sample-class", "class1",
                 "--layer", "10", "--num-concepts", str(K)]), chain_counts("toy", 1))
        emit({"phase": "workflow_toy_sonify_files", "card": card,
              **check_sonified(d["son"], "toy sonify", 240 * 63)})
        # the prototype chunk on the trained toy weights against the plain walk
        subset = json.load(open(os.path.join(d["son"], "prototypes.json")))["subset_index"]
        batch, _ = get_songs_toy(d["toy"], "class1", device="cuda")
        gen, x = prototype_generator(experiment_config(None, "toy"), d["model"], sub4,
                                     batch[subset * 10:], "class1", 10)
        line, _ = generator_checks(gen, x, 2, chain_counts("toy", 1),
                                   "workflow_toy_prototype_chunk_vs_plain")
        emit({**line, "card": card})
        report = os.path.join(tmp, "recovery.json")
        rec_chunks = 2 * (1 + 3)           # per class: the fitted U and 3 random Us
        launches["toy_recovery"] = workflow_stage(
            "workflow_toy_recovery", card, lambda: concept_recovery_experiment.main(
                ["--out", report, "--per-class", str(WF_REC_PER_CLASS),
                 "--epochs", str(WF_REC_EPOCHS), "--steps", str(WF_REC_STEPS), *dev]),
            chain_counts("toy", rec_chunks), per_class=WF_REC_PER_CLASS,
            epochs=WF_REC_EPOCHS, steps=WF_REC_STEPS)
        rec = json.load(open(report))
        if not all(np.isfinite([v for k, v in e.items() if k != "assignment"]).all()
                   for e in rec["classes"].values()):
            raise AssertionError(f"recovery report not finite: {rec}")
        emit({"phase": "workflow_toy_recovery_report", "card": card, **rec})
        del gen, x
        torch.cuda.empty_cache()

        # ------------------------------------------------------------ 6s
        corpus, rd = os.path.join(tmp, "corpus"), os.path.join(tmp, "gtzan_synth")
        launches["6s_generate"] = workflow_stage(
            "workflow_6s_generate", card, lambda: generate_gtzan_synth.main(
                ["--out", corpus, "--songs-per-genre", str(WF_SONGS), "--multi-concept",
                 "--seed", "0", *dev]), {}, songs_per_genre=WF_SONGS)
        launches["6s_train"] = workflow_stage(
            "workflow_6s_train", card, lambda: train.main(
                ["--case", "gtzan_6s", "--data", corpus, "--out", os.path.join(rd, "model"),
                 "--epochs", "1", *dev]), {}, epochs=1)
        stages = ("extract", "optimize", "eval", "prototypes")
        wf = ["--data", corpus, "--run-dir", rd, "--layers", "33", "--num-clips", str(WF_CLIPS),
              "--steps", str(WF_6S_STEPS), "--runs", "1", "--samples-per-class", str(WF_6S_SPC),
              *dev]
        cfg6 = experiment_config(None, "gtzan_6s")
        chunks6 = eval_chunks(WF_6S_SPC * cfg6.eval.num_chunks, 10)
        expected = {"extract": {}, "optimize": {}, "eval": chain_counts("gtzan_6s", chunks6),
                    "prototypes": chain_counts("gtzan_6s", 1)}
        for st in stages:
            launches[f"6s_{st}"] = workflow_stage(
                f"workflow_6s_{st}", card, lambda st=st: run_gtzan_synth_workflow.main(
                    [*wf, "--skip", *(s for s in stages if s != st)]), expected[st])
        for cls in ("blues", "pop"):
            arr = np.load(os.path.join(rd, "drsa_data", cls, "dataset_layer33.npz"))
            if arr["activations"].shape != (WF_CLIPS * 20, cfg6.model.n_filters[-1]):
                raise AssertionError(f"6s extraction {cls}: {arr['activations'].shape}")
        sub6 = os.path.join(rd, "subspaces", f"{K}_concepts")
        emit({"phase": "workflow_6s_runs", "card": card, **check_runs(sub6, "6s runs")})
        emit({"phase": "workflow_6s_eval_files", "card": card,
              **check_eval(os.path.join(rd, "eval"), "6s eval"), "generator_chunks": chunks6})
        son6 = os.path.join(rd, "sonified")
        emit({"phase": "workflow_6s_sonify_files", "card": card,
              **check_sonified(son6, "6s sonify", 360 * 255)})
        # the prototype chunk on the trained 6s weights: the walk is
        # ill-conditioned after training (phase 13), so held as there
        subset = json.load(open(os.path.join(son6, "prototypes.json")))["subset_index"]
        batch, _, _ = get_songs_drsa(corpus, "pop", excluded_folds=[cfg6.train.validation_fold],
                                     num_chunks=cfg6.drsa.chunks_per_song, case="gtzan_6s",
                                     device="cuda")
        gen, x = prototype_generator(cfg6, os.path.join(rd, "model"), sub6, batch[subset * 10:],
                                     "pop", 33)
        emit({"phase": "workflow_6s_prototype_chunk_vs_plain", "card": card, "batch": len(x),
              "conditioning": generator_conditioning(gen, x)})
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from drsa_audio_tpu_torch.models.projection import insert_projection
    from drsa_audio_tpu_torch.models.vgg import (
        build_layer_specs, fold_batchnorm, gtzan_3s_config, gtzan_6s_config, init_params,
        toy_config)
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig, logmel, peak_normalize
    from drsa_audio_tpu_torch.runtime import native
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils import nvcc
    from drsa_audio_tpu_torch.utils.constants import (
        LRP_NAME_MAP_GTZAN, LRP_NAME_MAP_GTZAN_6S, LRP_NAME_MAP_TOY)
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    from drsa_audio_tpu_torch.xai.explain import subspace_heatmaps
    from drsa_audio_tpu_torch.xai.lrp import chain

    # the merged-tail switch is this script's own: the module flag below
    os.environ.pop("DRSA_CHAIN_MERGED", None)
    chain.CHAIN_MERGED = False

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:             # g++ beside the six nvcc
        native_lib = pool.submit(native.build)
        libs = nvcc.build(list(SOURCES))
        native_lib = native_lib.result()
    logs = {n: p.with_suffix(".log").read_text().splitlines() for n, p in libs.items()}
    emit({"phase": "build", "seconds": time.time() - t0,
          "native": {"source": "csrc/audio_runtime.cpp", "library": native_lib.name,
                     "flags": native.FLAGS},
          "ptxas": {n: [ln.strip() for ln in lines if "registers" in ln or "smem" in ln]
                    for n, lines in logs.items()},
          "spill_store_bytes": {n: sum(int(ln.split("bytes spill stores")[0].split()[-1])
                                       for ln in lines if "bytes spill stores" in ln)
                                for n, lines in logs.items()}})
    emit({"phase": "sass", "hmma": hmma_counts(libs)})

    # ---------------------------------------------------------------- 3s
    specs = build_layer_specs(gtzan_3s_config())
    params = init_params(specs, seed=0, device="cuda")
    classes = ["blues", "jazz", "rock"]
    Us = {c: random_orthogonal(i + 1, 64) for i, c in enumerate(classes)}
    svc = ExplainerService(specs, params, LRP_NAME_MAP_GTZAN, Us, K, 10, case="gtzan")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(0)
    wavs = [(rng.standard_normal((B_SERVE, 48000)) * 0.3).astype(np.float32)
            for _ in classes]

    # the main path: three requests, counters read around them only
    svc.explain(wavs[0], classes[0])            # first call: kernels load
    serve = serve_checks(svc, wavs, classes, (B_SERVE, 128, 128),
                         {"chain_block": 3, "first_layer": 1}, "serve")
    launches = {"3s": serve["launches"]}
    emit(serve)

    # the card against the CPU path (held against the JAX package by the
    # tests) on a small input. The log-mel is compared first, at the log-mel
    # tolerance (the CPU's DFT matmul sums in an order set by its threads,
    # and the log amplifies that at the quietest bins); the network and
    # LRP then run on the same (CPU) mels on both: a max-pool window whose
    # two largest entries, or a pre-activation, lie within the front-end's
    # round-off flips a discrete LRP decision (route, gate, rule mask). U is
    # a signed permutation, so U U^T is exact. The CPU side is a
    # host_reference: two runs must give the same bits.
    cfg = FrontendConfig.for_case("gtzan")
    perm = np.zeros((64, 64), np.float32)
    perm[np.arange(64), rng.permutation(64)] = rng.choice([-1.0, 1.0], 64)
    small = torch.as_tensor(wavs[1][:4])
    with torch.inference_mode():
        mel_cpu, mel_runs = host_reference(
            "CPU log-mel", lambda: logmel(peak_normalize(small), cfg)[:, None])
        mel_gpu = logmel(peak_normalize(small.cuda()), cfg)[:, None]
    mel_f64 = logmel_f64(small, cfg)[:, None]
    emit({"phase": "card_vs_cpu_logmel_vs_f64", "cpu_runs": mel_runs,
          "card": (mel_gpu.cpu().double() - mel_f64).abs().max().item(),
          "cpu": (mel_cpu.double() - mel_f64).abs().max().item()})

    def heatmaps(dev):
        p = {n: {k: v.to(dev) for k, v in d.items()} for n, d in params.items()}
        sp = insert_projection(specs, 10, torch.as_tensor(perm, device=dev), K,
                               input_size=(128, 128))
        onehot = torch.zeros(10, device=dev)
        onehot[3] = 1.0
        with torch.inference_mode():
            heat, logits = subspace_heatmaps(sp, p, mel_cpu.to(dev), svc.composite, K,
                                             output_mask=lambda lg: lg * onehot[None, :])
        return heat.cpu(), logits.cpu()

    ref = {"cuda": heatmaps("cuda")}
    ref["cpu"], heat_runs = host_reference("CPU heatmaps", lambda: heatmaps("cpu"))
    emit({"phase": "card_vs_cpu", "batch": len(small),
          "logmel_max_abs_err": check_close("card vs CPU log-mel", mel_gpu.cpu(), mel_cpu,
                                            atol=1e-4),
          "max_abs_err": check_close("card vs CPU heatmaps", ref["cuda"][0], ref["cpu"][0]),
          "logits_max_abs_err": check_close("card vs CPU logits", ref["cuda"][1], ref["cpu"][1]),
          "cpu_reference_runs": {"logmel": mel_runs, "heatmaps": heat_runs}})
    del ref

    big = (rng.standard_normal((B_KERNEL, 48000)) * 0.3).astype(np.float32)
    rows = {"3s": kernel_rows(svc, big, classes[0], ["chain_block"] * 3 + ["first_layer"],
                              B_KERNEL, "3s")}
    peak_3s = request_phases(svc, big, classes[1], "3s")

    # ------------------------------------------------- 3s and toy, merged tail
    chain.CHAIN_MERGED = True
    merged_counts = {"chain_block": 1, "merged_tail": 1}
    serve_m = serve_checks(svc, wavs, classes, (B_SERVE, 128, 128), merged_counts,
                           "serve_merged", vs_default=True)
    launches["3s_merged"] = serve_m["launches"]
    emit(serve_m)
    specs_t = build_layer_specs(toy_config())
    svc_t = ExplainerService(specs_t, init_params(specs_t, seed=0, device="cuda"),
                             LRP_NAME_MAP_TOY, {"class2": random_orthogonal(30, 16)}, K, 10,
                             case="toy")
    wav_t = (rng.standard_normal((B_SERVE, 16000)) * 0.3).astype(np.float32)
    emit(serve_checks(svc_t, [wav_t], ["class2"], (B_SERVE, 64, 64), merged_counts,
                      "serve_toy_merged", vs_default=True))
    del svc_t
    rows["3s_merged"] = kernel_rows(svc, big, classes[0], ["chain_block", "merged_tail"],
                                    B_KERNEL, "3s_merged")
    torch.cuda.empty_cache()
    request_phases(svc, big, classes[1], "3s_merged", peak_mem_gb_default=peak_3s)
    chain.CHAIN_MERGED = False

    # ---------------------------------------- 3s, shared-denominator path
    U_sh = signed_permutation(rng, 64)
    shared_dispatch(svc, wavs[0][:2], classes[0], U_sh)      # first call: kernel loads
    serve_sh = serve_shared(svc, wavs, classes, U_sh, 3, "serve_3s_shared")
    launches["3s_shared"] = serve_sh["launches"]
    emit(serve_sh)
    torch.cuda.empty_cache()
    rows["3s_shared"] = shared_kernel_rows(svc, big, classes[0], U_sh, 3, "3s_shared")
    lower_segment_memory(svc, big, classes[0], U_sh, "3s_shared")
    del svc, params
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6s
    specs6 = build_layer_specs(gtzan_6s_config())
    specs6, params6 = fold_batchnorm(specs6, random_bn_stats(
        init_params(specs6, seed=0, device="cuda"), seed=1))
    classes6 = ["metal", "disco", "classical"]
    rng6 = np.random.default_rng(6)
    wavs6 = [(rng6.standard_normal((B_SERVE, 96000)) * 0.3).astype(np.float32)
             for _ in classes6]
    svc6 = ExplainerService(specs6, params6, LRP_NAME_MAP_GTZAN_6S,
                            {c: random_orthogonal(10 + i, 128) for i, c in enumerate(classes6)},
                            K, 33, case="gtzan_6s")
    svc6.explain(wavs6[0][:2], classes6[0])     # first call: kernels load
    serve6 = serve_checks(svc6, wavs6, classes6, (B_SERVE, 128, 256),
                          {"chain_block": 4, "first_block_deep": 1}, "serve_6s_layer33")
    launches["6s"] = serve6["launches"]
    emit(serve6)
    chain.CHAIN_MERGED = True                   # the 6s model does not merge
    emit(serve_checks(svc6, wavs6[:1], classes6[:1], (B_SERVE, 128, 256),
                      {"chain_block": 4, "first_block_deep": 1}, "serve_6s_layer33_switch_on"))
    chain.CHAIN_MERGED = False
    for layer, d, n_blocks in ((26, 128, 3), (19, 100, 2)):
        svc_l = ExplainerService(specs6, params6, LRP_NAME_MAP_GTZAN_6S,
                                 {"rock": random_orthogonal(20 + layer, d)}, K, layer,
                                 case="gtzan_6s")
        emit(serve_checks(svc_l, wavs6[:1], ["rock"], (B_SERVE, 128, 256),
                          {"chain_block": n_blocks, "first_block_deep": 1},
                          f"serve_6s_layer{layer}"))
        del svc_l

    big6 = (rng6.standard_normal((B_KERNEL_6S, 96000)) * 0.3).astype(np.float32)
    rows["6s"] = kernel_rows(svc6, big6, classes6[0], ["chain_block"] * 4 + ["first_block_deep"],
                             B_KERNEL_6S, "6s")
    torch.cuda.empty_cache()
    request_phases(svc6, big6, classes6[1], "6s")

    # ---------------------------------------- 6s, shared-denominator path
    U6 = signed_permutation(rng6, 128)
    serve_sh6 = serve_shared(svc6, wavs6[:1], classes6[:1], U6, 9, "serve_6s_shared",
                             strict_clips=2)
    launches["6s_shared"] = serve_sh6["launches"]
    emit(serve_sh6)
    torch.cuda.empty_cache()
    rows["6s_shared"] = shared_kernel_rows(svc6, wavs6[0], classes6[0], U6, 9, "6s_shared")
    lower_segment_memory(svc6, wavs6[0], classes6[0], U6, "6s_shared")
    del svc6, params6
    torch.cuda.empty_cache()

    # --------------------------------------------------- log-mel kernel
    for path, case, w in (("frontend_3s", "gtzan", big), ("frontend_6s", "gtzan_6s", big6),
                          ("frontend_toy", "toy", wav_t)):
        rows[path] = logmel_rows(w, FrontendConfig.for_case(case), path)
        launches[path] = {"logmel": rows[path][0]["launches"]}

    # --------------------------------------------------- fit then serve
    counts_3s, state_3s = fit_then_serve_3s(card)
    fitted = {"fit_then_serve_3s": counts_3s}
    torch.cuda.empty_cache()
    fitted["fit_then_serve_6s"] = fit_then_serve_6s(card)
    torch.cuda.empty_cache()

    # --------------------------------------------------- evaluate and sonify
    t0 = time.time()
    evaluated = {"evaluate_3s": evaluate_3s(card, *state_3s)}
    emit({"phase": "evaluate_3s_total", "card": card, "seconds": time.time() - t0})
    del state_3s
    torch.cuda.empty_cache()

    # --------------------------------------------------- train then explain
    t0 = time.time()
    trained = train_then_explain(card)
    emit({"phase": "train_then_explain_total", "card": card, "seconds": time.time() - t0})
    torch.cuda.empty_cache()

    # --------------------------------------------------- the workflow CLIs
    t0 = time.time()
    workflowed = workflow(card)
    emit({"phase": "workflow_total", "card": card, "seconds": time.time() - t0})
    torch.cuda.empty_cache()

    kernels = []
    for name in SOURCES:
        paths = {}
        for path, path_rows in rows.items():
            mine = [r for r in path_rows if r["name"] == name]
            if not mine:
                continue
            paths[path] = {
                "launches": launches[path][name],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
                "bound_ms": sum(r["bound_ms"] for r in mine),
                "bound_by": max(mine, key=lambda r: r["bound_ms"])["bound_by"],
                "bound_tc_ms": sum(r["bound_tc_ms"] for r in mine),
                "bound_fma_ms": sum(r["bound_fma_ms"] for r in mine)}
            if name == "logmel":
                paths[path]["matmul_dft_logmel_ms"] = mine[0]["matmul_dft_logmel_ms"]
                paths[path]["library_ms"] = mine[0]["library_ms"]
        top = max(paths.values(), key=lambda v: v["bound_ms"])
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": sum(v["launches"] for v in paths.values()),
            "max_abs_err": max(v["max_abs_err"] for v in paths.values()),
            "ms": sum(v["ms"] for v in paths.values()),
            "plain_ms": sum(v["plain_ms"] for v in paths.values()),
            "bound_ms": sum(v["bound_ms"] for v in paths.values()),
            "bound_by": top["bound_by"],
            "bound_tc_ms": sum(v["bound_tc_ms"] for v in paths.values()),
            "bound_fma_ms": sum(v["bound_fma_ms"] for v in paths.values()),
            "library_ms": None, "paths": paths}
        # phase 11 serves through the kernels of 2 and 6 at their shapes;
        # its counted launches join the sum, its kernels are timed above
        row["fit_then_serve_launches"] = {p: c[name] for p, c in fitted.items()}
        row["evaluate_launches"] = {p: c[name] for p, c in evaluated.items()}
        row["train_then_explain_launches"] = {p: c[name] for p, c in trained.items()}
        row["workflow_launches"] = {p: c[name] for p, c in workflowed.items()}
        row["launches"] += sum(c[name] for c in (*fitted.values(), *evaluated.values(),
                                                 *trained.values(), *workflowed.values()))
        if name == "logmel":
            row["matmul_dft_logmel_ms"] = sum(v["matmul_dft_logmel_ms"] for v in paths.values())
            row["library_ms"] = sum(v["library_ms"] for v in paths.values())
        kernels.append(row)

    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
