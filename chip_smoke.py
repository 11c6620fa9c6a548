#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (drsa_audio_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the six CUDA kernels
   (csrc/*.cu, one nvcc each, in parallel), and counts the HMMA
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
   heatmaps and logits computed from the same mels.
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

The kernels line gives, for each kernel, its numbers per path under
"paths" (3s, 3s_merged and 3s_shared at batch 256, 6s at batch 64,
6s_shared at batch 32, per request: the launches of one request summed;
frontend_3s, frontend_6s and frontend_toy for the log-mel kernel at the
batches of 10) and at its top level their sums over the paths (launches:
the counts of the served requests of 2, 5m, 6 and 9 and the calls of 10;
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


def serve_checks(svc, wavs, class_names, shape, counts, name, vs_default=False) -> dict:
    """Serve one request per class with every launch counter set to 0 just
    before and read just after; check the launch counts, the heatmaps'
    shape, finiteness and standard = sum of the subspace maps, then one
    request's unsorted heatmaps against the plain tiled walk and, with
    ``vs_default``, against the default multi-kernel chain (the merged-tail
    switch off for that request)."""
    import torch
    from drsa_audio_tpu_torch.xai.lrp import chain

    reset_counts()
    t0 = time.time()
    outs = [svc.explain(w, c) for w, c in zip(wavs, class_names)]
    seconds = time.time() - t0
    launches = launch_counts()
    want_counts = {k: counts.get(k, 0) * len(class_names) for k in SOURCES}
    if launches != want_counts:
        raise AssertionError(f"{name}: launch counts {launches}, expected {want_counts}")
    b, h, w = shape
    for out in outs:
        std, sub = out["standard_heatmaps"], out["subspace_heatmaps"]
        assert std.shape == (b, 1, h, w) and sub.shape == (b, K, h, w), (std.shape, sub.shape)
        assert np.isfinite(std).all() and np.isfinite(sub).all()
        np.testing.assert_allclose(std[:, 0], sub.sum(axis=1), rtol=1e-5,
                                   atol=1e-6 * np.abs(std).max())
    got, _ = svc._dispatch(wavs[0], class_names[0])
    want, _ = svc._dispatch(wavs[0], class_names[0], fused=False)
    torch.cuda.synchronize()
    out = {"phase": name, "requests": len(class_names), "batch": b, "seconds": seconds,
           "launches": launches,
           "max_abs_err_vs_plain": check_close(f"{name} request vs plain path", got, want),
           "max_abs_plain": want.abs().max().item()}
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
        reset_counts()
        heat, mels, sp, mask = shared_dispatch(svc, w, c, U)
        torch.cuda.synchronize()
        got = launch_counts()
        want = {k: (n_gamma if k == "gamma_nonneg" else 0) for k in SOURCES}
        if got != want:
            raise AssertionError(f"{name}: launch counts {got}, expected {want}")
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
        reset_counts()
        got = fused_frontend.fused_logmel(x, cfg)
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != {k: int(k == "logmel") for k in SOURCES}:
            raise AssertionError(f"{path}: launch counts {counts}")
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
    libs = nvcc.build(list(SOURCES))
    logs = {n: p.with_suffix(".log").read_text().splitlines() for n, p in libs.items()}
    emit({"phase": "build", "seconds": time.time() - t0,
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
    # a signed permutation, so U U^T is exact.
    cfg = FrontendConfig.for_case("gtzan")
    perm = np.zeros((64, 64), np.float32)
    perm[np.arange(64), rng.permutation(64)] = rng.choice([-1.0, 1.0], 64)
    small = torch.as_tensor(wavs[1][:4])
    with torch.inference_mode():
        mel_cpu = logmel(peak_normalize(small), cfg)[:, None]
        mel_gpu = logmel(peak_normalize(small.cuda()), cfg)[:, None]
    ref = {}
    for dev in ("cpu", "cuda"):
        p = {n: {k: v.to(dev) for k, v in d.items()} for n, d in params.items()}
        sp = insert_projection(specs, 10, torch.as_tensor(perm, device=dev), K,
                               input_size=(128, 128))
        onehot = torch.zeros(10, device=dev)
        onehot[3] = 1.0
        with torch.inference_mode():
            heat, logits = subspace_heatmaps(sp, p, mel_cpu.to(dev), svc.composite, K,
                                             output_mask=lambda lg: lg * onehot[None, :])
        ref[dev] = (heat.cpu(), logits.cpu())
    emit({"phase": "card_vs_cpu", "batch": len(small),
          "logmel_max_abs_err": check_close("card vs CPU log-mel", mel_gpu.cpu(), mel_cpu,
                                            atol=1e-4),
          "max_abs_err": check_close("card vs CPU heatmaps", ref["cuda"][0], ref["cpu"][0]),
          "logits_max_abs_err": check_close("card vs CPU logits", ref["cuda"][1], ref["cpu"][1])})
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
