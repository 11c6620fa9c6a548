#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (drsa_audio_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the six CUDA kernels
   (csrc/*.cu, one nvcc each, in parallel) and beside them the native
   runtime (csrc/audio_runtime.cpp with g++: WAV decode, Telea), and counts
   the tensor-core instructions in the SASS of chain_block,
   first_block_deep, merged_tail and gamma_nonneg (cuobjdump): it fails
   where any of the four holds no HGMMA (wgmma) or any HMMA (mma.sync), or
   where one of chain_block's wide-route instances (WIDE_INSTANCES: the
   8 x 16 prep, the 128-column per-slice applies) is missing or does. The
   build line carries each library's registers, spills and serialised
   wgmma groups.
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
   chain_block is also timed launch by launch (chain_block_split: each
   conv's chain_gamma_prep and chain_gamma_apply beside its own bound, with
   the tap widths its layouts chose and the shared memory a block).
5. Times one 256-clip request end to end, then the service's own stages of
   the same request (upload, front-end, forward + upper LRP, lower segment,
   readback, sort; medians of STAGE_REPS), and traces one request with
   torch.profiler for the device time of each kernel and the idle share.
5m. The merged-tail path (the switch chain.CHAIN_MERGED set here): three
   32-clip 3s requests
   with the counters set to 0 just before and read just after (chain_block
   and merged_tail once each, first_layer never, per request), the checks
   of 2 and one request against the default multi-kernel path; one 32-clip
   toy request (8/16 channels, 64x64 mels) the same; then the two launches
   of one 256-clip request held against their plain versions and timed
   (merged_tail also by launch: its chain_gamma_prep launches and the main
   kernel, each beside its own bound, the main kernel's shared memory and
   the rest of the wrapper's call on one line, merged_tail_split_*), and
   that request end to end, by stages and traced,
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
   holds and times each against its plain version, as 4, with the splits
   (chain_block_split_6s; first_block_deep_split_6s: its chain_gamma_prep
   and its main launch with the rim pass).
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
   prep and the apply, each beside its own bound with its tap width and
   shared memory, the rest of the wrapper's call and the host's time to
   build the layer's taps anew on one line, gamma_nonneg_split_*), that
   request's lower segment and peak memory
   beside the default path's, and the request traced. Then one 32-clip 6s
   layer-33 request (gamma_nonneg 9 times), its checks, its nine
   launches held and timed the same way, and its lower segment and peak
   memory beside the default path's.
9v. VGGish at its published widths (vggish_config; the rules, DRSA layer
   14 and K of portbench/configs/vggish.json; seeded weights and U): three
   requests of 32 examples of 0.96 s with the counters set to 0 just before
   and read just after (chain_block 3, first_layer 1 a request) and each
   request's chain.wide_launches 8 in the request log, checked as 2 but for
   the match with the plain walk; then the four launches of one 256-example
   request held and timed as 4, the two wide chain_block calls against the
   plain version in float64 that takes the kernel's G where a sign lies
   within round-off (aligned_reference), the kernel's G against the float64
   G everywhere else.
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
15. Scale-out (drsa_audio_tpu_torch.parallel), one JSON line a stage
   (scaleout_*: host clock with the device synchronised, launch counts).
   15a, in this process: an NCCL group of one (distributed_init with a
   file:// store under build/scaleout/, destroyed after), cuDNN held to
   deterministic algorithms; each call through the mesh with every launch
   counter set to 0 just before and read just after, then the same call
   without a mesh, which must give the same bits (timed on the first call
   and on a second): sharded_explain_pipeline on 3s waveforms, b=256
   (chain_block 3, first_layer 1), and on 6s with BatchNorm folded, b=64,
   layer 33 (chain_block 4, first_block_deep 1); ExplainerService(mesh=),
   b=32 (3, 1); make_sharded_train_step, 3s, b=128 mels, one step (loss,
   gradients and params); sharded_drsa_extraction, 3s layer 10, 64 clips x
   20 locations (against preprocess_data with the same clip_seeds). 15b:
   two ranks spawned on the one card (parallel.launch, gloo on CUDA
   tensors: NCCL takes one rank a card), each loading the kernels from the
   build cache (none rebuilt), params replicated from rank 0: the 3s
   pipeline on 64 waveforms, each rank's launches read around its call
   (chain_block 3, first_layer 1 each), its 32 rows against the
   single-process program on those rows (rtol 1e-4, atol 1e-5 * max) and
   the gathered standard maps against the single-process b=64 run (rtol
   1e-3, atol 1e-4 * max); one sharded train step of 3s at b=32 against
   the single-process step on the whole batch (phase 13's card tolerance,
   step_card_vs_cpu's, on the updated params: 2e-3 of max|grad|); the 6s
   step with BatchNorm at b=16 in float64 against the single-process
   float64 step (every gradient, param and running statistic to 1e-9 of
   its max), and in float32 within 4x (F32_SPREAD) the single-process
   float32 step's own distance from the float64 step (the float32 step
   from these clips is ill-conditioned: another rounding moves its
   gradients by about 1e-2 of their max), its loss at rtol 1e-5; 3 DRSA
   restarts (100 steps, phase 15a's extracted vectors) split 2 + 1 over the
   ranks against drsa_fit_batched alone (U orthogonal to 1e-4, objectives
   at rtol 2e-2). Each rank's train steps: the second from the same init is
   timed, the first pays the process's one-time work. A failing rank fails
   the phase.

The kernels line gives, for each kernel, its numbers per path under
"paths" (3s, 3s_merged, 3s_shared and vggish at batch 256, 6s at batch
64, 6s_shared at batch 32, per request: the launches of one request summed;
frontend_3s, frontend_6s and frontend_toy for the log-mel kernel at the
batches of 10) and at its top level their sums over the paths (launches:
the counts of the served requests of 2, 5m, 6, 9 and 9v, the calls of 10 and
the counted runs of 11, 12, 13, 14 and 15, also apart under
fit_then_serve_launches, evaluate_launches, train_then_explain_launches,
workflow_launches (by CLI stage) and scaleout_launches (phase 15's counted
calls, 15b by rank);
max_abs_err: the largest). The log-mel row also carries the matmul-DFT
logmel's time, and as library_ms the port's logmel(use_matmul_dft=False)
(cuFFT through torch.fft.rfft), which the port never calls on a path.
bound_ms is the least time for the work: the larger of bytes at 3.35 TB/s
and flops at three TF32 products each at 495 TFLOP/s (3xTF32 on the tensor
cores, the least time for f32-accurate products on this card); bound_tc_ms is the same number under its tensor-core name, and
bound_fma_ms the same with the flops at f32's 67 TFLOP/s on the FMA units.

Tolerance for every comparison: rtol 1e-4, atol 1e-5 * max|plain| (the JAX
package's own fused-vs-tiled bound), for a wide chain_block call against
aligned_reference; for the log-mel, rtol 1e-4, atol 1e-4
in log10 units (the JAX package's Pallas log-mel test). Prints JSON lines; the line before the
last is nvidia-smi's name and power limit, the last is the status line.
Exits non-zero, printing no result, where CUDA is unavailable.
"""

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

B_SERVE, B_KERNEL, B_KERNEL_6S, K = 32, 256, 64, 4
SIGN_DELTA = 1e-6         # gamma_reference: a sign decided within round-off
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


def gamma_reference(x, cv, delta: float = SIGN_DELTA):
    """chain_gamma_prep's G for one conv (x [b, H, W, Ci], cv a GammaConv)
    in float64, [b, H, W, Co], and where either of its two signs was decided
    within round-off: the gate z_true > 0 and the side of 0 the stabilised
    denominator z1 + b2 lies on, each where the sum lies within ``delta`` of
    the sum of its terms' magnitudes. There two correct float32 computations
    may split the decision, and G differ by its whole value. SIGN_DELTA:
    on the card the largest error of such a float32 sum, over the sum of its
    terms' magnitudes, was 4e-7 for chain_gamma_prep and 7.4e-7 for cuDNN
    (VGGish's wide convs on Gaussian data, 400k sums each)."""
    import torch
    from drsa_audio_tpu_torch.models.vgg import conv2d_same_nhwc

    x = x.double()
    w1, w3 = cv.wz1.double(), cv.wz3.double()
    b1, b0, b2 = cv.biases.double()
    a1, a3 = conv2d_same_nhwc(x, w1, None), conv2d_same_nhwc(x, w3, None)
    m1, m3 = conv2d_same_nhwc(x.abs(), w1.abs(), None), conv2d_same_nhwc(x.abs(), w3.abs(), None)
    den, den_mag = a1 + b1 + b2, m1 + b1.abs() + b2.abs()
    zt, zt_mag = (a1 + a3) * cv.inv + b0, (m1 + m3 + 2 * b1.abs()) * cv.inv + b0.abs()
    G = (zt > 0).double() / (den + torch.where(den >= 0, cv.stab, -cv.stab))
    near = (den.abs() <= delta * den_mag) | (zt.abs() <= delta * zt_mag)
    return G.contiguous(), near


def sign_mask(xs, convs, pool=None, delta: float = SIGN_DELTA):
    """[b, 1, H', W', 1] bool: the outputs of a chain block (chain_block's
    contract: xs and convs top-down, the pool below or None) that hang on a
    sign decided within round-off (gamma_reference). A split sign at a
    pixel changes that pixel's G at one channel; the apply's 3 x 3
    transposed conv spreads it to the neighbours over every channel, each
    conv below again, and the pool's backward to its windows."""
    import torch.nn.functional as F

    pix = None
    for x, cv in zip(xs, convs):
        near = gamma_reference(x, cv, delta)[1].any(-1)
        pix = near if pix is None else pix | near
        pix = F.max_pool2d(pix[:, None].double(), 3, 1, 1)[:, 0] > 0
    if pool is not None:
        pix = pix.repeat_interleave(pool[0], 1).repeat_interleave(pool[1], 2)
    return pix[:, None, :, :, None]


def chain_block_close(name: str, got, want, xs, convs, pool=None, delta: float = SIGN_DELTA,
                      most: float = 0.5) -> dict:
    """``got`` against ``want`` (chain_block's output and the plain
    version's) as check_close holds them, outside ``sign_mask(xs, convs,
    pool, delta)``, with atol 1e-5 * max|want| outside it; fails where the
    mask covers more than ``most`` of the output. Returns the largest error
    outside, the share masked and the elements that differ inside it."""
    import torch
    mask = sign_mask(xs, convs, pool, delta).expand_as(want)
    share = mask.double().mean().item()
    if share > most:
        raise AssertionError(f"{name}: the sign mask covers {share:.3g} of the output")
    keep = ~mask
    err = check_close(name + " outside the sign mask", torch.where(keep, got, 0.0),
                      torch.where(keep, want, 0.0))
    inside = ((got - want).abs() > 1e-5 * want.abs().max() + 1e-4 * want.abs()) & mask
    return {"max_abs_err": err, "masked_share": share, "differ_in_mask": int(inside.sum())}


def aligned_reference(name: str, R, xs, convs, apre=None, pool=None) -> tuple:
    """chain_block_plain in float64 on chain_block's inputs, but where a
    conv's G hangs on a sign decided within round-off (gamma_reference) the
    kernel's own G (chain_gamma_prep on the same input) stands in for it, so
    that both sides take every decision alike. Holds the kernel's G against
    the float64 G everywhere else (check_close). Returns the reference and
    the share of G taken from the kernel."""
    import ctypes

    import torch
    from drsa_audio_tpu_torch.xai.lrp import chain

    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    b, K = R.shape[:2]
    R, taken, total = R.double(), 0, 0
    for j, (x, cv) in enumerate(zip(xs, convs)):
        G64, near = gamma_reference(x, cv)
        Gk = chain._gamma_prep(x, cv, stream).double()
        check_close(f"{name} conv {j} G", torch.where(near, 0.0, Gk), torch.where(near, 0.0, G64))
        G = torch.where(near, Gk, G64)
        taken, total = taken + int(near.sum()), total + near.numel()
        H, W = x.shape[1:3]
        c = chain._conv_t_nhwc((R * G[:, None]).reshape(b * K, H, W, cv.co), cv.wz1.double())
        R = x.double()[:, None] * c.reshape(b, K, H, W, cv.ci)
    if apre is not None:
        mask = chain.route_mask(torch.clamp(apre.double(), min=0.0), pool)
        R = chain.pool_backward(R, mask[:, None], pool)
    return R, taken / total


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


# The tensor-core instruction each library's SASS must hold: wgmma (HGMMA),
# and no mma.sync (HMMA), in all four tensor-core kernels.
SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
SASS_EXPECTED = {"chain_block": "HGMMA", "first_block_deep": "HGMMA",
                 "merged_tail": "HGMMA", "gamma_nonneg": "HGMMA"}


def sass_counts(libs: dict) -> dict:
    """The HMMA (mma.sync) and HGMMA (wgmma) instructions in the SASS of the
    four tensor-core kernels' libraries, by cuobjdump; fails where a library
    holds none of its expected instruction (SASS_EXPECTED), or where an
    HGMMA library still holds an HMMA."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for name, want in SASS_EXPECTED.items():
        sass = subprocess.run([tool, "-sass", str(libs[name])], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        ops = [m.group(1) for m in SASS_OP.finditer(sass)]
        counts[name] = {"HMMA": ops.count("HMMA"), "HGMMA": ops.count("HGMMA")}
        if not counts[name][want]:
            raise AssertionError(f"{name}: no {want} instruction in {libs[name].name}")
        if want == "HGMMA" and counts[name]["HMMA"]:
            raise AssertionError(f"{name}: {counts[name]['HMMA']} HMMA left in "
                                 f"{libs[name].name}")
    return counts


# The chain_block instances that only the wide route (a conv over 128
# channels, VGGish's) launches, by their mangled template arguments: the
# 8 x 16 prep of the 8-row levels and the 128-column applies that sum each
# slice apart (PER_SLICE), on 8 x 16 and 16 x 8 tiles.
WIDE_INSTANCES = ("gamma_prep_wgILi32ELi1ELi16E", "gamma_apply_wgILi128ELi1ELi16ELb1E",
                  "gamma_apply_wgILi128ELi1ELi8ELb1E")


def wide_sass_counts(lib) -> dict:
    """{instance: {"HMMA", "HGMMA"}} of the wide route's chain_block kernels
    (WIDE_INSTANCES) in the library's SASS, function by function; fails
    where one is missing, holds no HGMMA or holds an HMMA."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        ops = [m.group(1) for m in SASS_OP.finditer(body)]
        funcs[name.strip()] = {"HMMA": ops.count("HMMA"), "HGMMA": ops.count("HGMMA")}
    counts = {}
    for inst in WIDE_INSTANCES:
        found = [c for name, c in funcs.items() if inst in name]
        if not found:
            raise AssertionError(f"chain_block: no {inst} in {lib.name}")
        counts[inst] = found[0]
        if not found[0]["HGMMA"] or found[0]["HMMA"]:
            raise AssertionError(f"chain_block: {inst} holds {found[0]}")
    return counts


def kernel_registers(lines: list) -> dict:
    """{kernel: registers a thread} from a library's ptxas report, the
    kernels' names demangled with the toolkit's cu++filt where it has one
    (template arguments kept: the tile widths and m64 tiles a warpgroup)."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cu++filt")
    out, name = {}, None
    for ln in lines:
        if "Function properties for " in ln:
            name = ln.split("Function properties for ")[1].strip()
        elif "Used " in ln and " registers" in ln and name is not None:
            out[name] = int(ln.split("Used ")[1].split()[0])
    if not out or not os.path.exists(tool):
        return out
    names = subprocess.run([tool], input="\n".join(out), capture_output=True, text=True,
                           timeout=60, check=True).stdout.splitlines()
    if len(names) != len(out):
        return out
    short = (re.sub(r"\((?:unsigned )?(?:int|bool|long)\)", "", d).split("(")[0]
             .replace("void ", "").replace("<unnamed>::", "") for d in names)
    return dict(zip(short, out.values()))


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
    (CUDA events, 5 calls each): the prep and the apply, each beside its own
    bound (the forward pair; the transposed conv over Co channels, as
    gamma_nonneg_work), with the tap widths the layouts chose and the shared
    memory a block; the rest of the wrapper's call (the cached taps' lookup,
    the allocations, the host's time where the device waits for it) as the
    whole call less both; and the host's time to build the layer's taps
    anew (taps.build_gamma_conv with the pair's apply layout, which the
    cache saves on every call after a layer's first)."""
    import ctypes
    import time

    import torch
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma, taps

    n, ci, H, W = x.shape
    co = w.shape[0]
    cv = taps.gamma_conv(w, b, gamma, stabilizer)
    x, R = x.contiguous(), R.contiguous()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    M = fused_gamma._prep(x, cv, stream)
    prep = bounds(2.0 * n * H * W * 9 * ci * 2 * co,
                  4.0 * (x.numel() + 2 * w.numel() + 3 * co + M.numel()))
    apply = bounds(2.0 * K * n * H * W * 9 * co * ci,
                   4.0 * (R.numel() + M.numel() + x.numel() + 2 * w.numel() + K * n * ci * H * W))
    whole = cuda_ms(lambda: fused_gamma.gamma_nonneg_folded(x, R, w, b, K, gamma, stabilizer), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    taps.build_gamma_conv(w, b, gamma, stabilizer).w_apply_pair_wg
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    out = {"level": [H, W], "ci": ci, "co": co, "prep_cols": cv.prep_cols,
           "apply_cols": cv.apply_pair_cols,
           "prep_ms": cuda_ms(lambda: fused_gamma._prep(x, cv, stream), 5),
           "prep_bound_ms": prep["bound_ms"],
           "apply_ms": cuda_ms(lambda: fused_gamma._apply(R, M, x, cv, K, stream), 5),
           "apply_bound_ms": apply["bound_ms"], "ms": whole, "taps_build_host_ms": build_ms,
           **dict(zip(("prep_smem_bytes", "apply_smem_bytes"), fused_gamma.gamma_smem(cv, H)))}
    out["rest_ms"] = whole - out["prep_ms"] - out["apply_ms"]
    return out


def merged_tail_split_ms(R, xs, convs, apres, a1, fl) -> dict:
    """merged_tail's launches timed apart on its own inputs (CUDA events, 5
    calls each): the chain_gamma_prep launches together (one or two), the
    main kernel on their output, each beside its own bound (the preps'
    forward pairs; the K transposed convs and the tail, as
    merged_tail_work), with the main kernel's shared memory a block; and the
    rest of the wrapper's call (checks, allocations, the host's time where
    the device waits for it) as the whole call less both."""
    from drsa_audio_tpu_torch.xai.lrp import chain

    b, k = R.shape[:2]
    H, W, C = a1.shape[1:]
    preps = chain._merged_preps(xs, convs, apres)
    flops, nbytes = merged_tail_work(R, xs, convs, apres, a1, fl)
    prep_flops = sum(4.0 * b * x.shape[1] * x.shape[2] * cv.ci * cv.co * 9
                     for x, cv in zip(xs, convs))
    prep_bytes = 4.0 * (sum(x.numel() + 2 * cv.wz1.numel() + 3 * cv.co for x, cv in zip(xs, convs))
                        + sum(a.numel() for a in apres) + sum(p.numel() for p in preps
                                                              if p is not None))
    main_bytes = 4.0 * (R.numel() + a1.numel() + fl.z0.numel() + fl.taps.numel() + b * k * H * W
                        + sum(x.numel() + cv.wz1.numel() for x, cv in zip(xs, convs))
                        + sum(p.numel() for p in preps if p is not None))
    whole = cuda_ms(lambda: chain.merged_tail(R, xs, convs, apres, a1, fl), 5)
    out = {"prep_ms": cuda_ms(lambda: chain._merged_preps(xs, convs, apres), 5),
           "prep_bound_ms": bounds(prep_flops, prep_bytes)["bound_ms"],
           "main_ms": cuda_ms(lambda: chain._merged_main(R, xs, convs, a1, fl, preps), 5),
           "main_bound_ms": bounds(flops - prep_flops, main_bytes)["bound_ms"],
           "main_smem_bytes": chain.merged_smem(convs), "ms": whole}
    out["rest_ms"] = whole - out["prep_ms"] - out["main_ms"]
    return out


def chain_block_split_ms(R, xs, convs, apre=None, pool=None) -> dict:
    """chain_block's launches timed apart on its own inputs (CUDA events, 5
    calls each): per conv, top-down, chain_gamma_prep and chain_gamma_apply
    (on the prep's G and the relevance the conv above passes down), each
    beside its own bound (the flops and bytes of chain_block_work for that
    launch alone); the rest of the wrapper's call (checks, allocations, the
    host's time where the device waits for it) as the whole call less all
    of them."""
    import ctypes

    import torch
    from drsa_audio_tpu_torch.xai.lrp import chain

    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    whole = cuda_ms(lambda: chain.chain_block(R, xs, convs, apre, pool), 5)
    k, convs_out, total = R.shape[1], [], 0.0
    for j, (x, cv) in enumerate(zip(xs, convs)):
        n, H, W, _ = x.shape
        a = apre if apre is not None and j == len(convs) - 1 else None
        G = chain._gamma_prep(x, cv, stream)
        out = chain._gamma_apply(R, G, x, cv, stream, a, pool)
        prep = bounds(2.0 * n * H * W * 9 * cv.ci * 2 * cv.co,
                      4.0 * (x.numel() + 2 * cv.wz1.numel() + 3 * cv.co + G.numel()))
        apply = bounds(2.0 * k * n * H * W * 9 * cv.co * cv.ci,
                       4.0 * (R.numel() + G.numel() + x.numel() + cv.wz1.numel() + out.numel()
                              + (a.numel() if a is not None else 0)))
        row = {"level": [H, W], "ci": cv.ci, "co": cv.co, "prep_cols": cv.prep_cols,
               "apply_cols": cv.apply_cols,
               "prep_ms": cuda_ms(lambda: chain._gamma_prep(x, cv, stream), 5),
               "prep_bound_ms": prep["bound_ms"],
               "apply_ms": cuda_ms(lambda: chain._gamma_apply(R, G, x, cv, stream, a, pool), 5),
               "apply_bound_ms": apply["bound_ms"],
               **dict(zip(("prep_smem_bytes", "apply_smem_bytes"), chain.gamma_smem(cv, H)))}
        total += row["prep_ms"] + row["apply_ms"]
        convs_out.append(row)
        R = out
    return {"convs": convs_out, "ms": whole, "rest_ms": whole - total}


def first_block_deep_split_ms(R, a1, apre, gconv, fl, pool) -> dict:
    """first_block_deep's launches timed apart on its own inputs (CUDA
    events, 5 calls each): its chain_gamma_prep (M from relu(a1) and the
    pool route of relu(apre)), the main kernel with its rim pass on that M,
    each beside its own bound (as first_block_deep_work, split), and the
    rest of the wrapper's call as the whole call less both."""
    import ctypes

    import torch
    from drsa_audio_tpu_torch.xai.lrp import chain

    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    b, k = R.shape[:2]
    H, W, C0 = a1.shape[1:]
    C = apre.shape[-1]
    M = chain._gamma_prep(a1, gconv, stream, apre=apre, pool=pool)
    prep = bounds(2.0 * 2 * b * H * W * C0 * C * 9,
                  4.0 * (a1.numel() + apre.numel() + 2 * gconv.wz1.numel() + 3 * C + M.numel()))
    main = bounds(2.0 * k * b * H * W * C0 * C * 9 + 2.0 * k * b * H * W * C0 * 9,
                  4.0 * (R.numel() + M.numel() + a1.numel() + gconv.wz1.numel()
                         + fl.z0.numel() + fl.taps.numel() + b * k * H * W))
    whole = cuda_ms(lambda: chain.first_block_deep(R, a1, apre, gconv, fl, pool), 5)
    out = {"prep_ms": cuda_ms(lambda: chain._gamma_prep(a1, gconv, stream, apre=apre,
                                                        pool=pool), 5),
           "prep_bound_ms": prep["bound_ms"],
           "main_ms": cuda_ms(lambda: chain._deep_main(R, M, a1, gconv, fl, pool, stream), 5),
           "main_bound_ms": main["bound_ms"], "ms": whole,
           "prep_smem_bytes": chain.gamma_smem(gconv, H)[0],
           "main_smem_bytes": chain.deep_smem(gconv)}
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
    and the host clock times the readback and the sort's enqueue.
    ``other_host`` is what the request took beyond all of these."""
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
               host_stage(serving, "sort_concepts", "sort")]
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
    out["readback"] = host["readback"]          # the sort is enqueued in _dispatch
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


def unsorted_heatmaps(svc, wavs, class_name: str, **kw):
    """One request's heatmaps [b, K+1, h, w] on the card, in the concepts'
    own order: ``_dispatch`` returns them sorted, with the order it used,
    and the sort is undone."""
    from drsa_audio_tpu_torch.xai.explain import unsort_concepts
    heat, _, _, order = svc._dispatch(wavs, class_name, **kw)
    return unsort_concepts(heat, order)


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
    got = unsorted_heatmaps(svc, wavs[0], class_names[0])
    want = unsorted_heatmaps(svc, wavs[0], class_names[0], fused=False)
    torch.cuda.synchronize()
    out.update(max_abs_err_vs_plain=check_close(f"{name} request vs plain path", got, want),
               max_abs_plain=want.abs().max().item())
    if vs_default:
        merged, chain.CHAIN_MERGED = chain.CHAIN_MERGED, False
        try:
            default = unsorted_heatmaps(svc, wavs[0], class_names[0])
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
        heat = svc._dispatch(wavs, class_name)[0]
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
            taken = {}
            if name == "chain_block" and any(max(cv.ci, cv.co) > 128 for cv in args[2]):
                # a wide block against the plain version in float64 with the
                # kernel's own decisions where a sign lies within round-off:
                # at 256 clips cuDNN's float32 sums split signs of their own
                del want
                want, share = aligned_reference(f"{path} {name} launch {i}", *args)
                taken = {"g_taken_share": share}
                err = check_close(f"{path} {name} launch {i}", got, want)
            else:
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
               "plain_ms": min(ms_plain, ms_plain2), **bounds(flops, nbytes), **taken}
        rows.append(row)
        emit({"phase": "kernel_vs_plain" + phase_tag(path), "batch": batch, "K": K, **row})
        splits = {"merged_tail": merged_tail_split_ms, "chain_block": chain_block_split_ms,
                  "first_block_deep": first_block_deep_split_ms}
        if name in splits:
            with torch.inference_mode():
                emit({"phase": f"{name}_split" + phase_tag(path), "launch": i,
                      **splits[name](*args)})
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


def _as_cpu(a):
    import torch
    return a.detach().cpu() if torch.is_tensor(a) else torch.as_tensor(a)


def cancelled_biases(specs) -> set:
    """The biases that a BatchNorm follows: it cancels them, so their
    gradient is zero but for round-off."""
    return {f"{a.name}.bias" for a, b in zip(specs, specs[1:])
            if a.kind in ("conv", "linear") and b.kind.startswith("batchnorm")}


def step_atols(specs, grads: dict, factor: float, other: float | None = None) -> dict:
    """Per tensor, the atol of a train step's gradient against a reference
    step's ``grads``: ``factor`` * max|g| for the conv and BatchNorm
    tensors (summed over many positions), ``other`` (``factor`` where None)
    * max|g| for the rest, and ``factor`` * the model's largest |gradient|
    for a bias that BatchNorm follows (``cancelled_biases``)."""
    scale = {k: _as_cpu(g).abs().max().item() for k, g in grads.items()}
    top = max(scale.values())
    cancelled = cancelled_biases(specs)
    summed = {f"{s.name}.{k}" for s in specs if s.kind in ("conv", "batchnorm")
              for k in ("weight", "bias")}
    return {k: factor * top if k in cancelled
            else (factor if other is None or k in summed else other) * m
            for k, m in scale.items()}


def hold_step(name: str, got: dict, want: dict, atols: dict, lr: float,
              hold_grads: bool) -> dict:
    """A train step ``got`` ({"loss", "grads", "after"}, tensors or numpy)
    against a reference step ``want``: the loss at rtol 1e-5; with
    ``hold_grads`` each gradient at rtol 1e-4 and its ``atols`` entry
    (``step_atols``); each tensor after the step (params and BatchNorm
    statistics) at rtol 1e-4, atol 1e-5 * its max|ref| plus, for a param,
    ``lr`` times its gradient's atol (an update moves a param by lr * its
    gradient). Returns the largest errors."""
    loss, ref = float(got["loss"]), float(want["loss"])
    rel = abs(loss - ref) / abs(ref)
    if not rel <= 1e-5:
        raise AssertionError(f"{name}: loss {loss}, reference {ref} (rel err {rel})")
    out = {"loss_rel_err": rel}
    if hold_grads:
        out["grad_max_abs_err"] = max(
            check_close(f"{name} gradient {k}", _as_cpu(got["grads"][k]), _as_cpu(g),
                        atol=atols[k]) for k, g in want["grads"].items())
    out["param_max_abs_err_after_step"] = max(
        check_close(f"{name} {k} after the step", _as_cpu(got["after"][k]), _as_cpu(v),
                    atol=1e-5 * _as_cpu(v).abs().max().item() + lr * atols.get(k, 0.0))
        for k, v in want["after"].items())
    return out


def step_distance(got: dict, want: dict, specs) -> dict:
    """How far a train step ``got`` lies from ``want`` (``hold_step``'s
    dicts): the loss's relative error, and the largest difference of a
    gradient and of a tensor after the step, each as a share of that
    tensor's max|want| (the biases that BatchNorm follows apart, as a share
    of the model's largest |gradient|: theirs is zero but for round-off)."""
    def f64(a):
        return _as_cpu(a).double()

    def worst(part, keys, scale):
        return max(((f64(got[part][k]) - f64(want[part][k])).abs().max().item()
                    / max(scale(k), 1e-30), k) for k in keys) if keys else (0.0, None)

    grads = want["grads"]
    cancelled = cancelled_biases(specs)
    top = max(f64(g).abs().max().item() for g in grads.values())
    loss, ref = float(got["loss"]), float(want["loss"])
    return {"loss_rel_err": abs(loss - ref) / abs(ref),
            "grad": worst("grads", [k for k in grads if k not in cancelled],
                          lambda k: f64(grads[k]).abs().max().item()),
            "cancelled_bias_grad": worst("grads", [k for k in grads if k in cancelled],
                                         lambda k: top),
            "after": worst("after", list(want["after"]),
                           lambda k: f64(want["after"][k]).abs().max().item())}


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
    want = {"loss": flat[0], "grads": dict(zip(grads, flat[1:1 + len(grads)])),
            "after": dict(zip(after, flat[1 + len(grads):]))}
    atols = step_atols(specs, want["grads"], *((1e-2, 1e-4) if has_bn else (2e-3, 1e-5)))
    held = hold_step(name, {"loss": loss, "grads": grads, "after": after}, want, atols, LR,
                     hold_grads=True)
    return {"loss_card": loss.item(), "loss_cpu": want["loss"].item(), **held,
            "grad_max_abs": max(g.abs().max().item() for g in want["grads"].values()),
            "cpu_reference_runs": runs}


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
    got = unsorted_heatmaps(svc, wavs, class_name)
    want = unsorted_heatmaps(svc, wavs, class_name, fused=False)
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


# ------------------------------------------------------------ phase 15

B_SCALE_3S, B_SCALE_6S, B_SCALE_SERVE, B_SCALE_TRAIN, B_SCALE_EXTRACT = 256, 64, 32, 128, 64
B_RANKS_3S, B_RANKS_TRAIN_3S, B_RANKS_TRAIN_6S, RESTART_STEPS = 64, 32, 16, 100
SCALE_LR = 1e-2
# how far a rank's float32 6s BatchNorm step may lie from the float64 step,
# in units of the single-process float32 step's own distance from it
F32_SPREAD = 4


def synced(run):
    """(what ``run()`` returned, its seconds on the host clock with the
    device synchronised before and after)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_bits(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return bool(np.array_equal(a, b))


def world1_stage(name: str, card: str, sharded_run, plain_run, expected: dict,
                 counts: dict, **beside) -> None:
    """Phase 15a, one stage: ``sharded_run()`` (the mesh's call) with every
    launch counter set to 0 just before and read just after (they must be
    ``expected``); then ``plain_run()``, the same call without a mesh,
    whose result must be the same bits. Each is timed on that first call and
    on a second."""
    (got, first), counts[name] = counted(name, lambda: synced(sharded_run), expected)
    want, plain_first = synced(plain_run)
    if not same_bits(got, want):
        raise AssertionError(f"{name}: the mesh's result is not the unsharded call's bits")
    del got, want
    seconds, plain_seconds = synced(sharded_run)[1], synced(plain_run)[1]
    emit({"phase": name, "card": card, "world": 1, "backend": "nccl", "seconds": seconds,
          "unsharded_seconds": plain_seconds, "first_call_seconds": first,
          "unsharded_first_call_seconds": plain_first, "launches": counts[name],
          "bit_equal": True, **beside})


def train_state(specs, has_bn: bool, device):
    """init_params (seed 0), with seeded BatchNorm statistics where the
    model has BatchNorm."""
    from drsa_audio_tpu_torch.models.vgg import init_params
    params = init_params(specs, seed=0, device=device)
    return random_bn_stats(params, seed=1) if has_bn else params


def one_step(specs, params, mels, labels, dropout, has_bn: bool, mesh=None, dtype=None):
    """One train step (SGD at SCALE_LR), sharded over ``mesh`` where given,
    in ``dtype`` where given (params and mels converted): {"loss", "acc",
    "grads": {tensor: gradient}, "after": {tensor: value after}}."""
    import torch
    from drsa_audio_tpu_torch.models.train import (
        make_optimizer, make_train_step, split_trainable)
    from drsa_audio_tpu_torch.parallel.sharding import make_sharded_train_step
    if dtype is not None:
        params = {n: {k: v.to(dtype) for k, v in p.items()} for n, p in params.items()}
        mels = torch.as_tensor(mels).to(dtype)
    trainable, _ = split_trainable(params)
    opt = make_optimizer(trainable, SCALE_LR)
    device = next(iter(trainable.values()))["weight"].device
    draws = {"dropout": {k: torch.as_tensor(v, device=device) for k, v in dropout.items()}}
    step = (make_train_step(specs, opt, None, has_bn) if mesh is None
            else make_sharded_train_step(specs, opt, mesh, has_bn=has_bn))
    if mesh is None:
        mels = torch.as_tensor(mels, device=device)
        labels = torch.as_tensor(labels, device=device)
    loss, acc = step(params, mels, labels, draws)
    return {"loss": loss, "acc": acc,
            "grads": {f"{n}.{k}": v.grad for n, p in trainable.items() for k, v in p.items()},
            "after": {f"{n}.{k}": v.detach() for n, p in params.items() for k, v in p.items()}}


def scaleout_rank(mesh, data: dict) -> dict:
    """Phase 15b, one of two ranks spawned on the one card
    (parallel.launch, gloo on CUDA tensors): the 3s explain pipeline on
    B_RANKS_3S waveforms (its rows also through the single-process program
    here), one sharded train step of 3s and of 6s with BatchNorm, and the
    DRSA restarts split over the ranks. Returns numpy."""
    import torch
    import torch.distributed as dist
    from drsa_audio_tpu_torch.models.projection import insert_projection
    from drsa_audio_tpu_torch.models.vgg import (
        build_layer_specs, gtzan_3s_config, gtzan_6s_config, init_params)
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig, logmel, peak_normalize
    from drsa_audio_tpu_torch.parallel import sharding as tsh
    from drsa_audio_tpu_torch.utils import nvcc
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN
    from drsa_audio_tpu_torch.xai.explain import class_composite, subspace_heatmaps

    prebuilt = {n: nvcc.library_path(n).exists() for n in ("chain_block", "first_layer")}
    device = tsh.mesh_device(mesh)
    out = {"rank": mesh.get_local_rank(), "backend": dist.get_backend(), "device": str(device),
           "kernels_prebuilt": prebuilt}

    specs = build_layer_specs(gtzan_3s_config())
    params = tsh.replicate(init_params(specs, seed=0, device=device), mesh)
    sp = insert_projection(specs, 10, torch.as_tensor(data["U"], device=device), K,
                           input_size=(128, 128))
    composite = class_composite(LRP_NAME_MAP_GTZAN, K)
    cfg = FrontendConfig.for_case("gtzan")
    explain = tsh.sharded_explain_pipeline(sp, params, composite, mesh, K, class_idx=0,
                                           frontend_config=cfg)
    explain(data["wavs"][:4])                   # first call: the kernels load
    reset_counts()
    heat, seconds = synced(lambda: explain(data["wavs"]))
    launches = launch_counts()
    local = tsh.shard_batch(data["wavs"], mesh)
    with torch.inference_mode():
        mine = subspace_heatmaps(sp, params, logmel(peak_normalize(local.rows), cfg)[:, None],
                                 composite, K, class_idx=0)[0]
    rows = slice(local.start, local.start + len(local.rows))
    out["pipeline"] = {"seconds": seconds, "launches": launches, "rows": len(local.rows),
                       "own_rows_max_abs_err": check_close(
                           "rank's rows against the single-process program", heat[rows], mine),
                       "standard": heat[:, 0].cpu().numpy()}

    for name, cfg_fn, has_bn, dtype in (("train_3s", gtzan_3s_config, False, None),
                                        ("train_6s_bn", gtzan_6s_config, True, None),
                                        ("train_6s_bn_f64", gtzan_6s_config, True,
                                         torch.float64)):
        specs_t = build_layer_specs(cfg_fn())
        d = data[name.removesuffix("_f64")]

        # the process's first step pays for one-time work (its first
        # optimizer imports torch._dynamo, cuDNN's first backward): the
        # second, from the same init, is the one timed and compared
        for _ in range(2):
            params_t = tsh.replicate(train_state(specs_t, has_bn, device), mesh)
            step, seconds = synced(lambda: one_step(specs_t, params_t, d["mels"], d["labels"],
                                                    d["dropout"], has_bn, mesh, dtype))
        out[name] = {"seconds": seconds, "loss": step["loss"].item(), "acc": step["acc"].item(),
                     "grads": {k: v.cpu().numpy() for k, v in step["grads"].items()},
                     "after": {k: v.cpu().numpy() for k, v in step["after"].items()}}
        del step, params_t

    res, seconds = synced(lambda: tsh.sharded_drsa_restarts(
        data["U0"], data["act"], data["ctx"], K, mesh, steps=RESTART_STEPS))
    out["drsa"] = {"seconds": seconds, "U": res.U.cpu().numpy(),
                   "objectives": res.objectives.cpu().numpy()}
    return out


def scaleout(card: str) -> dict:
    """Phase 15: the parallel module. 15a in this process, an NCCL group
    of one (file store under build/): each sharded call bit-equal to the
    same call without a mesh, cuDNN held to deterministic algorithms. 15b:
    two ranks spawned on the one card (gloo, CUDA tensors), each against the
    single-process programs. Returns {stage: launch counts}."""
    import torch
    import torch.distributed as dist
    from drsa_audio_tpu_torch.models.projection import insert_projection
    from drsa_audio_tpu_torch.models.vgg import (
        build_layer_specs, draw_keep_masks, fold_batchnorm, gtzan_3s_config, gtzan_6s_config,
        init_params)
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig, logmel, peak_normalize
    from drsa_audio_tpu_torch.parallel import sharding as tsh
    from drsa_audio_tpu_torch.parallel.launch import launch
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils import nvcc
    from drsa_audio_tpu_torch.utils.constants import (
        LRP_NAME_MAP_GTZAN, LRP_NAME_MAP_GTZAN_6S)
    from drsa_audio_tpu_torch.xai.drsa.optimizer import drsa_fit_batched, init_runs
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import (
        draw_clip_seeds, normalize_vectors, preprocess_data)
    from drsa_audio_tpu_torch.xai.explain import class_composite, subspace_heatmaps
    from drsa_audio_tpu_torch.xai.lrp.engine import Composite

    counts = {}
    rng = np.random.default_rng(15)
    cfg3, cfg6 = FrontendConfig.for_case("gtzan"), FrontendConfig.for_case("gtzan_6s")
    specs3 = build_layer_specs(gtzan_3s_config())
    params3 = init_params(specs3, seed=0, device="cuda")
    U3 = signed_permutation(rng, 64)
    sp3 = insert_projection(specs3, 10, U3, K, input_size=(128, 128))
    comp3 = class_composite(LRP_NAME_MAP_GTZAN, K)
    specs6_bn = build_layer_specs(gtzan_6s_config())
    specs6, params6 = fold_batchnorm(specs6_bn, train_state(specs6_bn, True, "cuda"))
    sp6 = insert_projection(specs6, 33, signed_permutation(rng, 128), K, input_size=(128, 256))
    comp6 = class_composite(LRP_NAME_MAP_GTZAN_6S, K)

    def unsharded(sp, params, comp, cfg, wavs):
        with torch.inference_mode():
            mels = logmel(peak_normalize(torch.as_tensor(wavs, device="cuda")), cfg)[:, None]
            return subspace_heatmaps(sp, params, mels, comp, K, class_idx=0)[0]

    store = os.path.join(os.path.dirname(nvcc.BUILD_DIR), "scaleout", f"store-{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t_phase = time.perf_counter()
    tsh.distributed_init(f"file://{store}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"15a: backend {dist.get_backend()}, not nccl")
        mesh = tsh.get_mesh(1)
        _, first = synced(lambda: dist.all_reduce(torch.ones(1, device="cuda")))
        emit({"phase": "scaleout_w1_init", "card": card, "world": 1, "backend": "nccl",
              "seconds": time.perf_counter() - t_phase, "first_all_reduce_seconds": first})
        w3 = (rng.standard_normal((B_SCALE_3S, 48000)) * 0.3).astype(np.float32)
        world1_stage("scaleout_w1_3s_pipeline", card,
                     lambda: tsh.sharded_explain_pipeline(sp3, params3, comp3, mesh, K, 0,
                                                          frontend_config=cfg3)(w3),
                     lambda: unsharded(sp3, params3, comp3, cfg3, w3),
                     {"chain_block": 3, "first_layer": 1}, counts, batch=B_SCALE_3S)
        w6 = (rng.standard_normal((B_SCALE_6S, 96000)) * 0.3).astype(np.float32)
        world1_stage("scaleout_w1_6s_pipeline", card,
                     lambda: tsh.sharded_explain_pipeline(sp6, params6, comp6, mesh, K, 0,
                                                          frontend_config=cfg6)(w6),
                     lambda: unsharded(sp6, params6, comp6, cfg6, w6),
                     {"chain_block": 4, "first_block_deep": 1}, counts, batch=B_SCALE_6S,
                     layer=33)
        kw = dict(Us={"blues": U3.cpu().numpy()}, num_concepts=K, layer_idx=10, case="gtzan")
        svc_mesh = ExplainerService(specs3, params3, LRP_NAME_MAP_GTZAN, mesh=mesh, **kw)
        svc = ExplainerService(specs3, params3, LRP_NAME_MAP_GTZAN, **kw)
        ws = w3[:B_SCALE_SERVE]
        world1_stage("scaleout_w1_service", card, lambda: svc_mesh.explain(ws, "blues"),
                     lambda: svc.explain(ws, "blues"), {"chain_block": 3, "first_layer": 1},
                     counts, batch=B_SCALE_SERVE)
        del svc, svc_mesh
        mels = seeded_mels(21, B_SCALE_TRAIN, cfg3)
        labels = torch.arange(B_SCALE_TRAIN, device="cuda") % 10
        masks = draw_keep_masks(specs3, B_SCALE_TRAIN, torch.Generator().manual_seed(6))
        replicas = [train_state(specs3, False, "cuda") for _ in range(2)]
        world1_stage("scaleout_w1_train_3s", card,
                     lambda: one_step(specs3, replicas[0], mels, labels, masks, False, mesh),
                     lambda: one_step(specs3, replicas[1], mels, labels, masks, False), {},
                     counts, batch=B_SCALE_TRAIN)
        del replicas
        mels_x = seeded_mels(22, B_SCALE_EXTRACT, cfg3)
        comp = Composite.from_list(LRP_NAME_MAP_GTZAN)
        world1_stage("scaleout_w1_extract_3s", card,
                     lambda: tsh.sharded_drsa_extraction(specs3, params3, comp, mesh, 10, 0,
                                                         N_LOCATIONS)(mels_x, 7),
                     lambda: preprocess_data(specs3, params3, mels_x, comp, 10, 0, N_LOCATIONS,
                                             clip_seeds=draw_clip_seeds(7, B_SCALE_EXTRACT)),
                     {}, counts, batch=B_SCALE_EXTRACT, locations=N_LOCATIONS)
        act, ctx = (normalize_vectors(v) for v in tsh.sharded_drsa_extraction(
            specs3, params3, comp, mesh, 10, 0, N_LOCATIONS)(mels_x, 7))
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "scaleout_w1_total", "card": card, "seconds": time.perf_counter() - t_phase})

    # ---------------------------------------------- 15b: two ranks, one card
    data = {"U": U3.cpu().numpy(),
            "wavs": (rng.standard_normal((B_RANKS_3S, 48000)) * 0.3).astype(np.float32),
            "U0": init_runs(42, 64, 3), "act": act.cpu().numpy(), "ctx": ctx.cpu().numpy()}
    for name, specs_t, cfg, b, seed in (("train_3s", specs3, cfg3, B_RANKS_TRAIN_3S, 23),
                                        ("train_6s_bn", specs6_bn, cfg6, B_RANKS_TRAIN_6S, 24)):
        masks = draw_keep_masks(specs_t, b, torch.Generator().manual_seed(seed))
        data[name] = {"mels": seeded_mels(seed, b, cfg).cpu().numpy(),
                      "labels": np.arange(b) % 10,
                      "dropout": {k: v.numpy() for k, v in masks.items()}}
    ranks, seconds = synced(lambda: launch(2, scaleout_rank, (data,), device="cuda",
                                           backend="gloo", timeout_s=600))
    emit({"phase": "scaleout_w2_launch", "card": card, "world": 2, "backend": "gloo",
          "seconds": seconds, "ranks": [{k: r[k] for k in ("rank", "backend", "device",
                                                             "kernels_prebuilt")}
                                        for r in ranks]})
    for r in ranks:
        if r["backend"] != "gloo" or not all(r["kernels_prebuilt"].values()):
            raise AssertionError(f"15b rank {r['rank']}: {r['backend']}, "
                                 f"kernels prebuilt {r['kernels_prebuilt']}")

    want = unsharded(sp3, params3, comp3, cfg3, data["wavs"])[:, 0].cpu()
    expected = {k: {"chain_block": 3, "first_layer": 1}.get(k, 0) for k in SOURCES}
    for r in ranks:
        p = r["pipeline"]
        if p["launches"] != expected or p["rows"] != B_RANKS_3S // 2:
            raise AssertionError(f"15b rank {r['rank']}: launches {p['launches']}, "
                                 f"rows {p['rows']}")
        counts[f"scaleout_w2_3s_pipeline_rank{r['rank']}"] = p["launches"]
    std = torch.as_tensor(ranks[0]["pipeline"]["standard"])
    if not same_bits(ranks[1]["pipeline"]["standard"], ranks[0]["pipeline"]["standard"]):
        raise AssertionError("15b: the ranks' gathered maps differ")
    err = (std - want).abs()
    bad = (err > 1e-4 * want.abs().max() + 1e-3 * want.abs()).sum().item()
    if bad:
        raise AssertionError(f"15b: {bad} standard-map elements off the single-process b=64 run")
    emit({"phase": "scaleout_w2_3s_pipeline", "card": card, "world": 2, "batch": B_RANKS_3S,
          "seconds": [r["pipeline"]["seconds"] for r in ranks],
          "launches": [r["pipeline"]["launches"] for r in ranks],
          "own_rows_max_abs_err": [r["pipeline"]["own_rows_max_abs_err"] for r in ranks],
          "standard_max_abs_err_vs_b64": err.max().item()})

    def single(name, specs_t, has_bn, dtype=None):
        d = data[name]
        return one_step(specs_t, train_state(specs_t, has_bn, "cuda"), d["mels"], d["labels"],
                        d["dropout"], has_bn, dtype=dtype)

    def train_line(name, **beside):
        emit({"phase": f"scaleout_w2_{name}", "card": card, "world": 2,
              "batch": len(data[name.removesuffix("_f64")]["labels"]),
              "seconds": [r[name]["seconds"] for r in ranks],
              "loss": [r[name]["loss"] for r in ranks], **beside})

    want = single("train_3s", specs3, False)
    atols = step_atols(specs3, want["grads"], 2e-3)
    train_line("train_3s", loss_single=want["loss"].item(), tolerance_factor=2e-3,
               vs_single=[{**hold_step(f"15b train_3s rank {r['rank']}", r["train_3s"], want,
                                       atols, SCALE_LR, hold_grads=False),
                           **step_distance(r["train_3s"], want, specs3)} for r in ranks])
    # The 6s step with BatchNorm from these clips is ill-conditioned in
    # float32: a change of rounding (another split of the batch, F.batch_norm's
    # fused backward or group_batch_norm's) moves its gradients by about a
    # percent of their max (PERF.md §6). Its algebra is held in float64,
    # where the sharded step must give the single-process step to 1e-9 of
    # each tensor. In float32 both steps are roundings of the float64 one:
    # each rank's step must lie within F32_SPREAD x the single float32
    # step's own distance from float64 (the largest share over gradients,
    # cancelled biases and tensors after the step), its loss at rtol 1e-5.
    exact = single("train_6s_bn", specs6_bn, True, torch.float64)
    for r in ranks:
        d = step_distance(r["train_6s_bn_f64"], exact, specs6_bn)
        if not (d["loss_rel_err"] <= 1e-12 and max(d["grad"][0], d["cancelled_bias_grad"][0],
                                                   d["after"][0]) <= 1e-9):
            raise AssertionError(f"15b train_6s_bn in float64, rank {r['rank']}: {d}")
    train_line("train_6s_bn_f64", vs_single=[step_distance(r["train_6s_bn_f64"], exact,
                                                           specs6_bn) for r in ranks])
    want = single("train_6s_bn", specs6_bn, True)

    def spread(d):
        return max(d["grad"][0], d["cancelled_bias_grad"][0], d["after"][0])
    own = step_distance(want, exact, specs6_bn)
    vs_f64 = [step_distance(r["train_6s_bn"], exact, specs6_bn) for r in ranks]
    for r, d in zip(ranks, vs_f64):
        rel = abs(r["train_6s_bn"]["loss"] - want["loss"].item()) / abs(want["loss"].item())
        if not (rel <= 1e-5 and spread(d) <= F32_SPREAD * spread(own)):
            raise AssertionError(f"15b train_6s_bn in float32, rank {r['rank']}: loss rel "
                                 f"err {rel} from the single step; from float64 {d}, the "
                                 f"single float32 step {own}")
    train_line("train_6s_bn", loss_single=want["loss"].item(), spread_factor=F32_SPREAD,
               vs_single=[step_distance(r["train_6s_bn"], want, specs6_bn) for r in ranks],
               vs_float64=vs_f64, single_vs_float64=own)
    del want, exact

    single = drsa_fit_batched(data["U0"][None], data["act"][None], data["ctx"][None],
                              np.ones((1, len(data["act"])), np.float32), K, RESTART_STEPS)
    want = single.objectives[0].cpu()
    ortho, rel = [], []
    for r in ranks:
        U = torch.as_tensor(r["drsa"]["U"])
        ortho.append((U.transpose(-2, -1) @ U - torch.eye(U.shape[-1])).abs().max().item())
        rel.append(((torch.as_tensor(r["drsa"]["objectives"]) - want).abs()
                    / want.abs()).max().item())
        if not (ortho[-1] <= 1e-4 and rel[-1] <= 2e-2):
            raise AssertionError(f"15b DRSA rank {r['rank']}: max|U^T U - I| {ortho[-1]}, "
                                 f"objective rel err {rel[-1]}")
    emit({"phase": "scaleout_w2_drsa", "card": card, "world": 2, "runs": 3,
          "steps": RESTART_STEPS, "vectors": len(data["act"]),
          "seconds": [r["drsa"]["seconds"] for r in ranks], "orthogonality_max_err": ortho,
          "objective_max_rel_err": rel})
    return counts


def vggish_phase(rng) -> tuple:
    """Phase 9v: VGGish at its published widths through ExplainerService,
    with the rules, DRSA layer and K of portbench/configs/vggish.json and
    seeded weights and U. Three 32-example requests with every launch
    counter set to 0 just before and read just after (chain_block 3 and
    first_layer 1 a request), and each request's ``chain.wide_launches``
    in the request log 8 (two wide blocks of two convs, two launches a
    conv); the checks of 2 but the match with the plain walk, which a sign
    split (gamma_reference) may move at any pixel of the maps. Then the
    four launches of one 256-example request, as served, each held against
    its plain version and timed as 4: the two wide chain_block calls
    (128 -> 256 -> 256 at 16 x 24, 256 -> 512 -> 512 at 8 x 12, each with
    a pool below) against aligned_reference. Returns the request's launch
    counts and the kernel rows."""
    import torch
    from drsa_audio_tpu_torch.models.vgg import build_layer_specs, init_params, vggish_config
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils import profiling
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "configs",
                           "vggish.json")) as f:
        cfg = json.load(f)
    specs = build_layer_specs(vggish_config())
    params = init_params(specs, seed=0, device="cuda")
    name_map = [(n, (r, dict(kw))) for n, r, kw in cfg["rules"]]
    classes = ["blues", "jazz", "rock"]
    Us = {c: random_orthogonal(40 + i, cfg["subspace_dim"]) for i, c in enumerate(classes)}
    svc = ExplainerService(specs, params, name_map, Us, cfg["num_concepts"], cfg["drsa_layer"],
                           case="vggish")
    wavs = [(rng.standard_normal((B_SERVE, cfg["clip_samples"])) * 0.3).astype(np.float32)
            for _ in classes]
    svc.explain(wavs[0][:2], classes[0])        # first call: kernels load
    serve = serve_checks(svc, wavs, classes, (B_SERVE, cfg["n_mels"], cfg["mel_width"]),
                         {"chain_block": 3, "first_layer": 1}, "serve_vggish", vs_plain=False)
    wide = [r.counters["chain.wide_launches"] for r in profiling.requests()[-len(classes):]]
    if wide != [8] * len(classes):
        raise AssertionError(f"serve_vggish: chain.wide_launches {wide}, expected 8 a request")
    emit({**serve, "wide_launches": wide})
    big = (rng.standard_normal((B_KERNEL, cfg["clip_samples"])) * 0.3).astype(np.float32)
    rows = kernel_rows(svc, big, classes[0], ["chain_block"] * 3 + ["first_layer"], B_KERNEL,
                       "vggish")
    del svc, params
    torch.cuda.empty_cache()
    return serve["launches"], rows


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
          "registers": {n: kernel_registers(lines) for n, lines in logs.items()},
          "native": {"source": "csrc/audio_runtime.cpp", "library": native_lib.name,
                     "flags": native.FLAGS},
          "ptxas": {n: [ln.strip() for ln in lines if "registers" in ln or "smem" in ln]
                    for n, lines in logs.items()},
          "spill_store_bytes": {n: sum(int(ln.split("bytes spill stores")[0].split()[-1])
                                       for ln in lines if "bytes spill stores" in ln)
                                for n, lines in logs.items()},
          # ptxas's C7520: wgmma groups it had to serialise (a performance loss)
          "wgmma_serialized": {n: sum("C7520" in ln for ln in lines)
                               for n, lines in logs.items()}})
    emit({"phase": "sass", "counts": sass_counts(libs),
          "chain_block_wide": wide_sass_counts(libs["chain_block"])})

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

    # ------------------------------------------------------------ VGGish
    launches["vggish"], rows["vggish"] = vggish_phase(rng)
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

    # --------------------------------------------------- scale-out
    t0 = time.time()
    scaled = scaleout(card)
    emit({"phase": "scaleout_total", "card": card, "seconds": time.time() - t0})
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
        row["scaleout_launches"] = {p: c[name] for p, c in scaled.items()}
        row["launches"] += sum(c[name] for c in (*fitted.values(), *evaluated.values(),
                                                 *trained.values(), *workflowed.values(),
                                                 *scaled.values()))
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
