#!/usr/bin/env python3
"""What holds the two wgmma chain kernels back, by ablation, on one GPU.

    python3 ablate_chain.py

Builds csrc/chain_block.cu and csrc/first_block_deep.cu of this checkout as
they are and in variants that each leave one part of one kernel out, by a
named text substitution in a copy of the source under build/ablation/:

  no_split     the per-slice split of the staged region into hi and lo
  taps_2       the taps' bulk copies after the first two slices (the
               products read the taps left in the stage)
  no_products  the wgmma groups
  no_epilogue  everything after the slices: the kernel returns

Each library is timed (CUDA events, the mean of 5 calls after one) through
the port's own launch wrappers (xai/lrp/chain.py _gamma_prep, _gamma_apply,
_deep_main) at the main path's shapes, on seeded random inputs. A variant
computes wrong values: only its time means something, and its distance from
the shipped kernel's time is what that part costs where nothing else hides
it. A substitution that no longer matches its source fails by name.

Prints the card's name and power limit, then one JSON object a line:
{"launch", "shape", "ms": {"base": ms, variant: ms, ...}}. The bounds
beside these times are chip_smoke.py's split rows at the same shapes.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ablation"
K = 4

_PREP_SLICE = "        if (nt > 0)\n          wg::slice<BN, true,"
_APPLY_SLICE = "        if (nt > 0)\n          wg::slice<BN, false,"
_WAIT = "        wg::bar_wait(&bars[s & 1], (s >> 1) & 1);\n        __syncthreads();\n"
# {(source, launch): {variant: [(text, replacement), ...]}}
VARIANTS = {
    ("chain_block", "chain_gamma_prep"): {
        "no_split": [("        tc::split_region(hi, hi + A, NQ, [&](int q, int c4) {\n"
                      "          return tc::relu4(",
                      "        if (false) tc::split_region(hi, hi + A, NQ, [&](int q, int c4) {\n"
                      "          return tc::relu4(")],
        "taps_2": [("if (threadIdx.x == 0) wg::bulk_load(buf, wb + ",
                    "if (threadIdx.x == 0 && s < 2) wg::bulk_load(buf, wb + "),
                   (_WAIT + _PREP_SLICE, "        if (s < 2)" + _WAIT[7:] + _PREP_SLICE)],
        "no_products": [(_PREP_SLICE, _PREP_SLICE.replace("nt > 0", "false"))],
        "no_epilogue": [("  // G of the chunk's channels through shared memory",
                         "  return;\n  // G of the chunk's channels through shared memory")],
    },
    ("chain_block", "chain_gamma_apply"): {
        "no_split": [("        tc::split_region(hi, hi + A, NQ, [&](int q, int c4) {\n"
                      "          return tc::mul4(",
                      "        if (false) tc::split_region(hi, hi + A, NQ, [&](int q, int c4) {\n"
                      "          return tc::mul4(")],
        "taps_2": [("if (threadIdx.x == 0) wg::bulk_load(buf, wt + ",
                    "if (threadIdx.x == 0 && s < 2) wg::bulk_load(buf, wt + "),
                   (_WAIT + _APPLY_SLICE, "        if (s < 2)" + _WAIT[7:] + _APPLY_SLICE)],
        "no_products": [(_APPLY_SLICE, _APPLY_SLICE.replace("nt > 0", "false"))],
        "no_epilogue": [("  // the sums through shared memory (the stages are free after the",
                         "  return;\n  // the sums through shared memory (the stages are free "
                         "after the")],
    },
    ("first_block_deep", "first_block_deep"): {
        "no_split": [("        tc::split_region(mh, lo, NS,",
                      "        if (false) tc::split_region(mh, lo, NS,")],
        "taps_2": [("if (threadIdx.x == 0) wg::bulk_load(",
                    "if (threadIdx.x == 0 && s < 2) wg::bulk_load("),
                   ("        wg::bar_wait(&bars[s & 1], (s >> 1) & 1);",
                    "        if (s < 2) wg::bar_wait(&bars[s & 1], (s >> 1) & 1);")],
        "no_products": [("        if (live)\n          wg::slice<",
                         "        if (false)\n          wg::slice<")],
        "no_epilogue": [("  // the pipeline ends with a barrier",
                         "  return;\n  // the pipeline ends with a barrier")],
    },
}

# the main path's chain convs: (label, b, level, Ci, Co, pool below the conv)
CONVS = [("3s b=256 16^2 64->64 pool", 256, 16, 64, 64, True),
         ("3s b=256 32^2 32->64 pool", 256, 32, 32, 64, True),
         ("3s b=256 64^2 32->32", 256, 64, 32, 32, False),
         ("6s b=64 8^2 128->128", 64, 8, 128, 128, False),
         ("6s b=64 16^2 100->128 pool", 64, 16, 100, 128, True),
         ("6s b=64 32^2 100->100", 64, 32, 100, 100, False),
         ("6s b=64 64^2 64->64", 64, 64, 64, 64, False)]


def build() -> dict:
    """{(source, variant): library path}: every variant and each source as
    it is ("base"), one nvcc each, all at once."""
    from drsa_audio_tpu_torch.utils import nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {}
    for (src, launch), variants in VARIANTS.items():
        text = (nvcc.CSRC / f"{src}.cu").read_text()
        texts[(src, "base")] = text
        for name, subs in variants.items():
            v = text
            for old, new in subs:
                if v.count(old) != 1:
                    raise AssertionError(f"{launch} {name}: the source no longer holds "
                                         f"{old.strip()[:60]!r} once")
                v = v.replace(old, new)
            texts[(src, f"{launch}.{name}")] = v
    procs = {}
    for (src, name), text in texts.items():
        cu = OUT / f"{src}.{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[(src, name)] = (so, subprocess.Popen(
            [nvcc._nvcc(), *nvcc.FLAGS, "-I", str(nvcc.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out[-3000:]}")
    return {key: so for key, (so, _) in procs.items()}


def timed(libs: dict, src: str, launch: str, fn) -> dict:
    """{variant: ms} of fn() with src's library swapped for each of launch's
    variants in turn (the wrappers load through nvcc's cache)."""
    import chip_smoke
    from drsa_audio_tpu_torch.utils import nvcc
    out = {}
    for name in ["base", *(f"{launch}.{v}" for v in VARIANTS[(src, launch)])]:
        nvcc._LIBS[src] = ctypes.CDLL(str(libs[(src, name)]))
        out[name.split(".")[-1]] = chip_smoke.cuda_ms(fn, 5)
    del nvcc._LIBS[src]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_chain: no CUDA device", file=sys.stderr)
        return 2
    from drsa_audio_tpu_torch.models import vgg
    from drsa_audio_tpu_torch.xai.lrp import chain

    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    libs = build()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)   # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def conv(ci, co):
        w = t(rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
        return chain.prep_inner_weights(
            {"g": {"weight": w, "bias": t(rng.standard_normal(co) * 0.05)}},
            vgg.LayerSpec("conv", "g", {}), {"gamma": 0.25, "stabilizer": 1e-7}), w

    for label, b, H, ci, co, pool in CONVS:
        cv, _ = conv(ci, co)
        x = t(np.maximum(rng.standard_normal((b, H, H, ci)), 0))
        R = t(rng.standard_normal((b, K, H, H, co)))
        apre = t(rng.standard_normal((b, 2 * H, 2 * H, ci))) if pool else None
        G = chain._gamma_prep(x, cv, stream)
        print(json.dumps({"launch": "chain_gamma_prep", "shape": label, "ms": timed(
            libs, "chain_block", "chain_gamma_prep", lambda: chain._gamma_prep(x, cv, stream))}),
            flush=True)
        print(json.dumps({"launch": "chain_gamma_apply", "shape": label, "ms": timed(
            libs, "chain_block", "chain_gamma_apply",
            lambda: chain._gamma_apply(R, G, x, cv, stream, apre, (2, 2)))}), flush=True)
        del x, R, apre, G
    # first_block_deep at the 6s widths: conv 3 at 128x256, 64 -> 64, a (2,4) pool
    b, H, W, C0, C, kw = 64, 128, 256, 64, 64, 4
    gconv, w3 = conv(C0, C)
    w0 = t(rng.standard_normal((C0, 1, 3, 3)) * 0.5)
    b0 = t(rng.standard_normal(C0) * 0.1)
    fl = chain.prep_first_weights({"c0": {"weight": w0, "bias": b0}},
                                  vgg.LayerSpec("conv", "c0", {}),
                                  ("wsquare", {"stabilizer": 1e-7}), (H, W))
    a1 = torch.nn.functional.conv2d(t(rng.standard_normal((b, 1, H, W))), w0, b0,
                                    padding=1).permute(0, 2, 3, 1).contiguous()
    apre = vgg.conv2d_same_nhwc(torch.clamp(a1, min=0.0), w3, gconv.biases[1]).contiguous()
    R = t(rng.standard_normal((b, K, H // 2, W // kw, C)))
    label = "6s b=64 128x256 64->64 (2,4)"
    print(json.dumps({"launch": "chain_gamma_prep (deep)", "shape": label, "ms": timed(
        libs, "chain_block", "chain_gamma_prep",
        lambda: chain._gamma_prep(a1, gconv, stream, apre=apre, pool=(2, kw)))}), flush=True)
    M = chain._gamma_prep(a1, gconv, stream, apre=apre, pool=(2, kw))
    print(json.dumps({"launch": "first_block_deep", "shape": label, "ms": timed(
        libs, "first_block_deep", "first_block_deep",
        lambda: chain._deep_main(R, M, a1, gconv, fl, (2, kw), stream))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
