"""The lower conv-section LRP backward as a chain of per-block kernels (the
port of drsa_audio_tpu.xai.lrp.pallas_chain).

The chain takes the relevance at the head conv's output ([b, K, h, w, d],
NHWC, all K concept clones of each instance) down to the input heatmaps
[b, K, H, W]. It runs one ``chain_block`` per block above the first, each
covering the block's gamma convs and the max-pool below it, then the first
block: ``first_layer`` (pool route, relu gate and wsquare/flat rule) when it
holds only the first conv (3s, toy), or ``first_block_deep`` (pool route,
the gamma rule of its second conv, then the same tail) when it holds two
(the 6s model). With the merged-tail switch on (``CHAIN_MERGED``, off by
default) the 3s and toy models instead run blocks nb-2 .. 0 and the
first-layer tail as one ``merged_tail``.

Each of the four functions has a plain PyTorch version beside it
(``*_plain``). The wrapper runs the plain version for tensors on the CPU and
the CUDA kernel (``csrc/chain_block.cu``, ``csrc/first_layer.cu``,
``csrc/first_block_deep.cu``, ``csrc/merged_tail.cu``) for CUDA tensors; it
never falls back from one to the other. ``LAUNCHES`` counts the wrapper
calls that launched a kernel.

Layout is plain NHWC: the TPU kernels' column packing [H, W/P, P*C] existed
only to fill 128-wide vector lanes and is not part of the math.

``plan_chain`` admits a conv section only where each conv passes its
kernel's predicate (``chain_takes``, ``first_layer_takes``,
``first_block_deep_takes``, the .cu files' refusals written in Python), so
a model the kernels would refuse takes the plain tiled walk instead. A
``chain_block`` call with a conv over 128 channels (VGGish's 256 and 512)
is the request log's device span ``chain.wide``, and its kernel launches
the counter ``chain.wide_launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from drsa_audio_tpu_torch.models.vgg import conv2d_same_nhwc
from drsa_audio_tpu_torch.utils import profiling
from drsa_audio_tpu_torch.utils.nvcc import check_cuda, load, raise_on
from drsa_audio_tpu_torch.xai.lrp.rules import stabilize
from drsa_audio_tpu_torch.xai.lrp.taps import (
    FirstLayer, GammaConv, build_gamma_conv, prep_first_weights)

LAUNCHES = {"chain_block": 0, "first_layer": 0, "first_block_deep": 0, "merged_tail": 0}

# Merged-tail switch: run blocks nb-2 .. 0 and the first-layer tail in one
# kernel (merged_tail), so that the per-clone relevances between them never
# reach device memory. Off by default, as in the JAX package.
CHAIN_MERGED = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ shared pieces

def relu_gate(a: torch.Tensor) -> torch.Tensor:
    """The vjp of max(a, 0) as JAX takes it: 1 where a > 0, 0.5 at exact
    zeros, 0 below. torch.relu's backward gives 0 at zero, so the gate is
    written out. Tie semantics shared with route_mask: change one, change
    both."""
    return torch.where(a > 0, 1.0, torch.where(a == 0, 0.5, 0.0)).to(a.dtype)


def route_mask(a: torch.Tensor, kernel: tuple, nhwc: bool = True) -> torch.Tensor:
    """First-argmax routing mask of a stride == kernel max-pool, shape of
    ``a``: each window's whole cotangent goes to its FIRST maximum in
    row-major order (jax's reduce_window vjp, ties included)."""
    kh, kw = kernel
    if not nhwc:
        a = a.movedim(1, -1)
    *lead, H, W, C = a.shape
    win = a.reshape(*lead, H // kh, kh, W // kw, kw, C)
    eq = win == win.amax(dim=(-4, -2), keepdim=True)
    pos = (torch.arange(kh, device=a.device)[:, None] * kw
           + torch.arange(kw, device=a.device)[None, :]).view(kh, 1, kw, 1)
    cand = torch.where(eq, pos, kh * kw)
    mask = (eq & (cand == cand.amin(dim=(-4, -2), keepdim=True))).to(a.dtype)
    mask = mask.reshape(*lead, H, W, C)
    return mask if nhwc else mask.movedim(-1, 1)


def pool_backward(R: torch.Tensor, mask: torch.Tensor, kernel: tuple,
                  nhwc: bool = True) -> torch.Tensor:
    """Route coarse relevance through the pool: upsample, times the mask."""
    kh, kw = kernel
    hd, wd = (-3, -2) if nhwc else (-2, -1)
    return R.repeat_interleave(kh, dim=hd).repeat_interleave(kw, dim=wd) * mask


def _conv_t_nhwc(g, w):
    return F.conv_transpose2d(g.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def prep_inner_weights(params: dict, spec, kwargs: dict) -> GammaConv:
    """The plan's adapter: the GammaConv of ``spec``'s weights under its
    gamma rule's arguments, built anew."""
    p = params[spec.name]
    return build_gamma_conv(p["weight"], p["bias"], float(kwargs.get("gamma", 0.25)),
                            float(kwargs.get("stabilizer", 1e-6)))


# ------------------------------------------------------- the kernels' predicates
#
# Each mirrors the refusals of its kernel (or, where stricter, its wrapper),
# so that plan_chain admits only a conv section the kernels run.

def chain_takes(c: int) -> bool:
    """A channel count chain_gamma_prep and chain_gamma_apply take
    (csrc/chain_block.cu ``takes``): a multiple of 8 or of 20 up to 128, or
    a multiple of 64 from 192 to 512."""
    return (0 < c <= 128 and (c % 8 == 0 or c % 20 == 0)) or (192 <= c <= 512 and c % 64 == 0)


def first_layer_takes(C: int, hw: tuple | None = None) -> bool:
    """The first conv's output channels C, and its level's (H, W) where
    given, as ``first_layer`` takes them: C % 8 == 0, H % 8 == 0 and W even
    and at most 512 (the wrapper's; csrc/first_layer.cu itself takes W up
    to 1024 and even H)."""
    if C <= 0 or C % 8:
        return False
    return hw is None or (hw[0] > 0 and hw[0] % 8 == 0 and 0 < hw[1] <= 512 and hw[1] % 2 == 0)


def first_block_deep_takes(C0: int, C: int) -> bool:
    """The deep first block's channels, C0 out of its first conv and C out
    of its gamma conv (csrc/first_block_deep.cu): C0 % 8 == 0, C0 <= 64,
    C % 4 == 0, C <= 128, and both counts the prep (chain_gamma_prep,
    Ci = C0, Co = C) takes."""
    return (0 < C0 <= 64 and C0 % 8 == 0 and 0 < C <= 128 and C % 4 == 0
            and chain_takes(C0) and chain_takes(C))


# ------------------------------------------------------------ chain_block

def chain_block_plain(R: torch.Tensor, xs: Sequence[torch.Tensor],
                      convs: Sequence[GammaConv], apre: torch.Tensor | None = None,
                      pool: tuple | None = None) -> torch.Tensor:
    """Plain version of chain_block. R [b, K, H, W, Co] at the top conv's
    output; xs the convs' recorded inputs [b, H, W, Ci], top-down; apre the
    pre-relu input of the pool below [b, H*kh, W*kw, Ci] and pool its
    kernel, or None. Returns R at the block's input level (fine level if a
    pool is below)."""
    b, K = R.shape[:2]
    for x, cv in zip(xs, convs):
        b1, b0, b2 = (v.view(1, 1, 1, -1) for v in cv.biases)
        z1 = conv2d_same_nhwc(x, cv.wz1, None) + b1
        z3 = conv2d_same_nhwc(x, cv.wz3, None)
        z_true = (z1 + z3 - b1) * cv.inv + b0
        m1 = (z_true > 0).to(R.dtype) / stabilize(z1 + b2, cv.stab)
        m3 = (z_true < 0).to(R.dtype) / stabilize(z3, cv.stab)
        Rg = R * relu_gate(z_true)[:, None]
        H, W = x.shape[1:3]
        c = (_conv_t_nhwc((Rg * m1[:, None]).reshape(b * K, H, W, cv.co), cv.wz1)
             + _conv_t_nhwc((Rg * m3[:, None]).reshape(b * K, H, W, cv.co), cv.wz3))
        R = x[:, None] * c.reshape(b, K, H, W, cv.ci)
    if apre is not None:
        mask = route_mask(torch.clamp(apre, min=0.0), pool)
        R = pool_backward(R, mask[:, None], pool)
    return R


def _lib(name: str):
    lib = load(name)
    if not getattr(lib, "_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "chain_block":
            lib.chain_gamma_prep.argtypes = [P] * 5 + [I] * 8 + [Fl, Fl, P]
            lib.chain_gamma_apply.argtypes = [P] * 6 + [I] * 9 + [P]
            lib.chain_gamma_prep.restype = lib.chain_gamma_apply.restype = I
            lib.chain_gamma_smem.argtypes = [I] * 3
            lib.chain_gamma_smem.restype = ctypes.c_size_t
        elif name == "first_layer":
            lib.first_layer.argtypes = [P, P, P, P, P, I, I, I, I, I, Fl, P]
            lib.first_layer.restype = I
        elif name == "first_block_deep":
            lib.first_block_deep.argtypes = [P] * 8 + [I] * 9 + [Fl, P]
            lib.first_block_deep.restype = I
            lib.first_block_deep_smem.argtypes = [I]
            lib.first_block_deep_smem.restype = ctypes.c_size_t
        else:
            lib.merged_tail.argtypes = [P] * 13 + [I] * 10 + [Fl, P]
            lib.merged_tail.restype = I
            lib.merged_tail_smem.argtypes = [I] * 2
            lib.merged_tail_smem.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _gamma_prep(x: torch.Tensor, cv: GammaConv, stream,
                apre: torch.Tensor | None = None, pool: tuple = (1, 1)) -> torch.Tensor:
    """One chain_gamma_prep launch: G [b, H, W, Co] from relu(x), where x is
    the conv's input (a relu output in a chain block, the pre-relu a1 in
    the deep first block); with ``apre``, G is zeroed off the route of the
    ``pool`` above the conv."""
    b, H, W, _ = x.shape
    G = torch.empty((b, H, W, cv.co), device=x.device)
    raise_on(_lib("chain_block").chain_gamma_prep(
        x.data_ptr(), cv.w_prep_wg.data_ptr(), cv.biases.data_ptr(),
        apre.data_ptr() if apre is not None else None, G.data_ptr(),
        b, H, W, cv.ci, cv.co, cv.prep_cols, pool[0], pool[1], cv.inv, cv.stab, stream),
        "chain_gamma_prep")
    return G


def chain_block(R: torch.Tensor, xs: Sequence[torch.Tensor],
                convs: Sequence[GammaConv], apre: torch.Tensor | None = None,
                pool: tuple | None = None) -> torch.Tensor:
    """One block of the chain. Same contract as chain_block_plain; CPU
    tensors take the plain version, CUDA tensors the kernel
    (csrc/chain_block.cu, two launches per conv; one count per call).

    Replaces drsa_audio_tpu/xai/lrp/pallas_chain.py:624 _chain_block_kernel.
    Bound on an H100: operations (two forward convs per instance and one
    transposed conv per clone): 1.23 ms per 3s request (b=256) on the
    tensor cores in 3xTF32, the least time for f32-accurate products (3.03
    ms on the FMA units). Design: the
    clone-shared masks are computed once per instance into a scratch G, the
    convT(R * m3) term of the gamma rule is skipped because the relu gate
    zeroes it, and both launches are 3xTF32 implicit GEMMs on Hopper's
    wgmma (csrc/conv3x3_wgmma.cuh): the forward pair as one GEMM over 2*Co
    interleaved columns, the transposed conv over R * G formed and split
    once per staged 8-channel slice, A from registers, the taps pre-split
    on the host (``w_prep_wg``, ``w_apply_wg``) and staged by bulk copy
    (asynchronous, double-buffered). Past 128 channels (VGGish's 256 and
    512) the apply runs a grid column per chunk of 128 input channels and
    adds its 8-channel slices' sums in f32, and 8-row levels take 8 x 16
    tiles; such a call is the request log's device span ``chain.wide`` and
    adds its launches to ``chain.wide_launches``."""
    if R.device.type == "cpu":
        return chain_block_plain(R, xs, convs, apre, pool)
    b, K = R.shape[:2]
    check_cuda("chain_block", R, *xs, *(apre,) if apre is not None else (),
               *(t for cv in convs for t in (cv.w_prep_wg, cv.w_apply_wg, cv.biases)))
    if (pool is not None and pool[0] != 2) or b > 65535:
        raise ValueError("chain_block: pools must be (2, kw); batch at most 65535")
    stream = ctypes.c_void_p(torch.cuda.current_stream(R.device).cuda_stream)
    wide = any(max(cv.ci, cv.co) > 128 for cv in convs)
    with profiling.span("chain.wide", device=True) if wide else contextlib.nullcontext():
        for j, (x, cv) in enumerate(zip(xs, convs)):
            _, H, W, _ = x.shape
            if tuple(R.shape) != (b, K, H, W, cv.co) or x.shape[-1] != cv.ci:
                raise ValueError("chain_block: relevance / activation shapes disagree")
            last_pool = apre is not None and j == len(convs) - 1
            if last_pool and tuple(apre.shape) != (b, H * pool[0], W * pool[1], cv.ci):
                raise ValueError("chain_block: pool input shape disagrees")
            G = _gamma_prep(x, cv, stream)
            R = _gamma_apply(R, G, x, cv, stream, apre if last_pool else None, pool)
    if wide:
        profiling.count("chain.wide_launches", 2 * len(convs))
    LAUNCHES["chain_block"] += 1
    return R


def _gamma_apply(R: torch.Tensor, G: torch.Tensor, x: torch.Tensor, cv: GammaConv, stream,
                 apre: torch.Tensor | None = None, pool: tuple | None = None) -> torch.Tensor:
    """One chain_gamma_apply launch: x * convT(R * G) for every clone, routed
    through the ``pool`` backward to [b, K, H*kh, W*kw, Ci] when ``apre`` is
    given, else [b, K, H, W, Ci]; past 128 input channels, one grid column
    a chunk of ``cv.apply_cols`` of them."""
    b, K, H, W, _ = R.shape
    kh, kw = pool if apre is not None else (1, 1)
    out = torch.empty((b, K, H * kh, W * kw, cv.ci), device=R.device)
    raise_on(_lib("chain_block").chain_gamma_apply(
        R.data_ptr(), G.data_ptr(), x.data_ptr(), cv.w_apply_wg.data_ptr(),
        apre.data_ptr() if apre is not None else None, out.data_ptr(),
        b, K, H, W, cv.ci, cv.co, cv.apply_cols, kh, kw, stream), "chain_gamma_apply")
    return out


def gamma_smem(cv: GammaConv, H: int) -> tuple:
    """The dynamic shared memory, bytes, a block of chain_gamma_prep and of
    chain_gamma_apply takes for cv's layouts at a level of H rows."""
    lib = _lib("chain_block")
    return lib.chain_gamma_smem(1, cv.prep_cols, H), lib.chain_gamma_smem(0, cv.apply_cols, H)


# ------------------------------------------------------------ first_layer

def first_layer_plain(R: torch.Tensor, a1: torch.Tensor, fl: FirstLayer) -> torch.Tensor:
    """Plain version of first_layer. R [b, K, H/2, W/2, C] at the output of
    the first block's pool; a1 [b, H, W, C] the first conv's pre-relu
    output. Returns heatmaps [b, K, H, W]."""
    b, K = R.shape[:2]
    H, W, C = a1.shape[1:]
    Fm = (route_mask(torch.clamp(a1, min=0.0), (2, 2)) * relu_gate(a1)
          / stabilize(fl.z0, fl.stab0))
    s0 = pool_backward(R, Fm[:, None], (2, 2))
    heat = F.conv_transpose2d(s0.reshape(b * K, H, W, C).permute(0, 3, 1, 2),
                              fl.wm, padding=1)
    return heat.reshape(b, K, H, W)


def first_layer(R: torch.Tensor, a1: torch.Tensor, fl: FirstLayer) -> torch.Tensor:
    """Pool route + relu gate + first-layer rule. CPU tensors take the
    plain version, CUDA tensors the kernel (csrc/first_layer.cu, one launch
    and one count per call).

    Replaces drsa_audio_tpu/xai/lrp/pallas_chain.py:709 _first_layer_kernel
    (and its mm_taps / recompute flag variants, the same function). Bound
    on an H100: bytes (R and a1 read once, K maps written). Design: one
    block per (16-row coarse band, instance) holds all K clones; per coarse
    row it forms the one-hot F compactly (the winner and gate / stab(z0)
    there) once for every clone, and each thread scatters one coarse pixel
    of one clone onto a 4x4 heatmap patch in registers; patches overlap-add
    in a fixed order (the carry down the band, shared memory across)."""
    if R.device.type == "cpu":
        return first_layer_plain(R, a1, fl)
    check_cuda("first_layer", R, a1, fl.z0, fl.taps)
    b, K, Hc, Wc, C = R.shape
    H, W = a1.shape[1:3]
    if (tuple(a1.shape) != (b, 2 * Hc, 2 * Wc, C) or tuple(fl.z0.shape) != (H, W, C)
            or not first_layer_takes(C, (H, W)) or b > 65535):
        raise ValueError("first_layer: unsupported shapes")
    heat = torch.empty((b, K, H, W), device=R.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(R.device).cuda_stream)
    raise_on(_lib("first_layer").first_layer(
        R.data_ptr(), a1.data_ptr(), fl.z0.data_ptr(), fl.taps.data_ptr(),
        heat.data_ptr(), b, K, H, W, C, fl.stab0, stream), "first_layer")
    LAUNCHES["first_layer"] += 1
    return heat


# ------------------------------------------------------- first_block_deep

def first_block_deep_plain(R: torch.Tensor, a1: torch.Tensor, apre: torch.Tensor,
                           gconv: GammaConv, fl: FirstLayer, pool: tuple) -> torch.Tensor:
    """Plain version of first_block_deep. R [b, K, H/kh, W/kw, C] at the
    output of the first block's pool; a1 [b, H, W, C0] the first conv's
    pre-relu output (the gamma conv's input is relu(a1)); apre [b, H, W, C]
    the gamma conv's pre-relu output (the pool's input is relu(apre)).
    Returns heatmaps [b, K, H, W]."""
    b, K = R.shape[:2]
    H, W, C0 = a1.shape[1:]
    mask = route_mask(torch.clamp(apre, min=0.0), pool)
    s = pool_backward(R, mask[:, None], pool)
    Rn = chain_block_plain(s, [torch.clamp(a1, min=0.0)], [gconv])
    s0 = Rn * (relu_gate(a1) / stabilize(fl.z0, fl.stab0))[:, None]
    heat = F.conv_transpose2d(s0.reshape(b * K, H, W, C0).permute(0, 3, 1, 2),
                              fl.wm, padding=1)
    return heat.reshape(b, K, H, W)


def first_block_deep(R: torch.Tensor, a1: torch.Tensor, apre: torch.Tensor,
                     gconv: GammaConv, fl: FirstLayer, pool: tuple) -> torch.Tensor:
    """The deep first block: pool route, relu gate and gamma rule of the
    block's second conv, then the first conv's wsquare/flat tail. Same
    contract as first_block_deep_plain; CPU tensors take the plain version,
    CUDA tensors the kernel (one count per call).

    Replaces drsa_audio_tpu/xai/lrp/pallas_chain.py:668
    _first_block_deep_kernel (launched :1237). Bound on an H100: operations
    (the gamma conv's two forward convs per instance and one transposed conv
    per clone at the fine level). Design: two launches. chain_gamma_prep
    (csrc/chain_block.cu) writes the clone-shared M = G * route once per
    instance (G = [z_true > 0] / stab(z1 + b2) from relu(a1), route the
    pool's first-argmax mask of relu(apre)); then csrc/first_block_deep.cu
    runs one block per (16x8 tile, clone, instance), stages R (at its
    coarse level) and M over the tile plus a 1-pixel halo, takes the
    transposed conv of R * M over the tile on wgmma in 3xTF32
    (csrc/conv3x3_wgmma.cuh), applies relu(a1) and the tail multiplier to the
    accumulator fragments and reduces the 3x3 tail taps over the channels;
    it writes the heatmap pixels whose neighbourhood lies in the tile, and a
    second launch adds the tiles' shares of the others in a fixed order, so
    the heatmaps are the same from run to run. The fine relevance never
    reaches device memory.
    Bound: 5.63 ms per 6s request (b=64) on the tensor cores in 3xTF32, the
    least time for f32-accurate products (13.99 ms on the FMA units)."""
    if R.device.type == "cpu":
        return first_block_deep_plain(R, a1, apre, gconv, fl, pool)
    check_cuda("first_block_deep", R, a1, apre, fl.z0, fl.taps,
               gconv.w_prep_wg, gconv.w_apply_wg, gconv.biases)
    b, K, Hc, Wc, C = R.shape
    H, W, C0 = a1.shape[1:]
    kh, kw = pool
    if (tuple(apre.shape) != (b, H, W, C) or (H, W) != (kh * Hc, kw * Wc)
            or (gconv.ci, gconv.co) != (C0, C) or tuple(fl.z0.shape) != (H, W, C0)):
        raise ValueError("first_block_deep: shapes disagree")
    if b > 65535 or K > 65535:
        raise ValueError("first_block_deep: batch and clones at most 65535")
    stream = ctypes.c_void_p(torch.cuda.current_stream(R.device).cuda_stream)
    M = _gamma_prep(a1, gconv, stream, apre=apre, pool=pool)
    heat = _deep_main(R, M, a1, gconv, fl, pool, stream)
    LAUNCHES["first_block_deep"] += 1
    return heat


def _deep_main(R: torch.Tensor, M: torch.Tensor, a1: torch.Tensor, gconv: GammaConv,
               fl: FirstLayer, pool: tuple, stream) -> torch.Tensor:
    """first_block_deep's own two launches (csrc/first_block_deep.cu: the
    tiles, then the rim pass) on the prep's M. Returns heatmaps [b, K, H, W]."""
    b, K = R.shape[:2]
    H, W, C0 = a1.shape[1:]
    heat = torch.empty((b, K, H, W), device=R.device)
    # the tiles' rim shares: 96 floats a 16x8 tile and clone (csrc/first_block_deep.cu)
    rim = torch.empty((b * K * -(-H // 16) * -(-W // 8) * 96,), device=R.device)
    raise_on(_lib("first_block_deep").first_block_deep(
        R.data_ptr(), M.data_ptr(), a1.data_ptr(), gconv.w_apply_wg.data_ptr(),
        fl.z0.data_ptr(), fl.taps.data_ptr(), heat.data_ptr(), rim.data_ptr(),
        b, K, H, W, C0, R.shape[-1], gconv.apply_cols, pool[0], pool[1], fl.stab0, stream),
        "first_block_deep")
    return heat


def deep_smem(gconv: GammaConv) -> int:
    """The dynamic shared memory, bytes, a block of first_block_deep's tiles
    takes for gconv's transposed layout."""
    return _lib("first_block_deep").first_block_deep_smem(gconv.apply_cols)


# ------------------------------------------------------------ merged_tail

def merged_tail_plain(R: torch.Tensor, xs: Sequence[torch.Tensor],
                      convs: Sequence[GammaConv], apres: Sequence[torch.Tensor],
                      a1: torch.Tensor, fl: FirstLayer) -> torch.Tensor:
    """Plain version of merged_tail. R [b, K, h, w, Co] at the top merged
    conv's output; xs the merged convs' recorded inputs and convs their
    weights, top-down; apres the pre-relu inputs of the (2,2) pools between
    them, top-down (one fewer than the convs); a1 [b, H, W, C] the first
    conv's pre-relu output. Returns heatmaps [b, K, H, W]."""
    for j, (x, cv) in enumerate(zip(xs, convs)):
        if j < len(apres):
            R = chain_block_plain(R, [x], [cv], apres[j], (2, 2))
        else:
            R = chain_block_plain(R, [x], [cv])
    return first_layer_plain(R, a1, fl)


def merged_tail(R: torch.Tensor, xs: Sequence[torch.Tensor],
                convs: Sequence[GammaConv], apres: Sequence[torch.Tensor],
                a1: torch.Tensor, fl: FirstLayer) -> torch.Tensor:
    """Blocks nb-2 .. 0 of the chain and the first-layer tail. Same contract
    as merged_tail_plain; CPU tensors take the plain version, CUDA tensors
    the kernel (csrc/merged_tail.cu, one count per call). The kernel takes
    one or two merged convs (3s and toy at DRSA layer 7 or 10) at the 3s
    (32, 64) or toy (8, 16) channel counts, and raises for others.

    Replaces drsa_audio_tpu/xai/lrp/pallas_chain.py:746 _merged_tail_kernel
    (launched :1155). Bound on an H100: operations (per merged conv two
    forward convs per instance and one transposed conv per clone; the 3x3
    tail per clone). Design: chain_gamma_prep writes the clone-shared
    multipliers once per instance, and a short pass the tail's factor F
    (the pool route times relu_gate(a1) / stab(z0)), then one block per
    (32x32 heatmap tile, clone, instance) walks the merged convs with a
    halo that grows one pixel per level on the way up and recomputes the
    overlap, each transposed
    conv a 3xTF32 implicit GEMM on Hopper's wgmma (csrc/conv3x3_wgmma.cuh,
    the pre-split taps ``w_apply_wg`` staged by bulk copy) into shared
    memory, then scatters each coarse pixel onto its 4x4 heatmap patch and
    adds the patches in a fixed order (see the source).

    Allocates, on the device: G [b, h, w, Co] of the top conv (two merged
    convs only), M [b, 2h, 2w, C] of the bottom conv with the pool route
    between the two folded in (G alone for one conv), the first-layer
    tail's factor once per instance (F [b, H/2, W/2, C] and its winners, a
    byte a channel) and the heatmaps [b, K, H, W]. No per-clone relevance between the merged levels is
    written to device memory."""
    if R.device.type == "cpu":
        return merged_tail_plain(R, xs, convs, apres, a1, fl)
    check_cuda("merged_tail", R, a1, fl.z0, fl.taps, *xs, *apres,
               *(t for cv in convs for t in (cv.w_prep_wg, cv.w_apply_wg, cv.biases)))
    m = len(convs)
    if m not in (1, 2) or len(xs) != m or len(apres) != m - 1:
        raise ValueError("merged_tail: the kernel takes one or two merged convs")
    b, K = R.shape[:2]
    H, W, C = a1.shape[1:]
    top, bottom = convs[0], convs[-1]
    ok = (H % (2 * m) == 0 and W % (2 * m) == 0 and tuple(fl.z0.shape) == (H, W, C)
          and bottom.ci == C and tuple(xs[-1].shape) == (b, H // 2, W // 2, C)
          and tuple(R.shape) == (b, K, H // (2 * m), W // (2 * m), top.co))
    if m == 2:
        ok = ok and (top.ci == bottom.co and tuple(xs[0].shape) == (b, H // 4, W // 4, top.ci)
                     and tuple(apres[0].shape) == (b, H // 2, W // 2, bottom.co))
    if not ok:
        raise ValueError("merged_tail: relevance / activation shapes disagree")
    if b > 65535 or K > 65535:
        raise ValueError("merged_tail: batch and clones at most 65535")
    heat = _merged_main(R, xs, convs, a1, fl, _merged_preps(xs, convs, apres))
    LAUNCHES["merged_tail"] += 1
    return heat


def _merged_preps(xs, convs, apres) -> tuple:
    """merged_tail's chain_gamma_prep launches: (G of the top conv or None,
    M of the bottom conv, the pool route between them folded in)."""
    stream = ctypes.c_void_p(torch.cuda.current_stream(xs[0].device).cuda_stream)
    if len(convs) == 2:
        return (_gamma_prep(xs[0], convs[0], stream),
                _gamma_prep(xs[1], convs[1], stream, apres[0], (2, 2)))
    return None, _gamma_prep(xs[0], convs[0], stream)


def _merged_main(R, xs, convs, a1, fl, preps) -> torch.Tensor:
    """merged_tail's own two launches (csrc/merged_tail.cu: the tail's
    factor, then the main kernel) on the preps' G and M."""
    (G, M), m = preps, len(convs)
    b, K = R.shape[:2]
    H, W, C = a1.shape[1:]
    top, bottom = convs[0], convs[-1]
    top_ptrs = ((G.data_ptr(), xs[0].data_ptr(), top.w_apply_wg.data_ptr()) if m == 2
                else (None, None, None))        # not read with one merged conv
    heat = torch.empty((b, K, H, W), device=R.device)
    # the tail's factor once per instance: f, and the four winners of four
    # channels packed in an int32 (csrc/merged_tail.cu merged_tail_factor)
    fq = torch.empty((b, H // 2, W // 2, C), device=R.device)
    wins = torch.empty((b, H // 2, W // 2, C // 4), dtype=torch.int32, device=R.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(R.device).cuda_stream)
    raise_on(_lib("merged_tail").merged_tail(
        R.data_ptr(), *top_ptrs, M.data_ptr(), xs[-1].data_ptr(), bottom.w_apply_wg.data_ptr(),
        a1.data_ptr(), fl.z0.data_ptr(), fl.taps.data_ptr(), heat.data_ptr(), fq.data_ptr(),
        wins.data_ptr(), b, K, H, W, C, bottom.co, top.co, m, top.apply_cols, bottom.apply_cols,
        fl.stab0, stream), "merged_tail")
    return heat


def merged_smem(convs) -> int:
    """The dynamic shared memory, bytes, a block of merged_tail's main
    kernel takes for these merged convs."""
    return _lib("merged_tail").merged_tail_smem(convs[-1].ci, int(len(convs) == 2))


# ------------------------------------------------------------- host plan

def plan_chain(conv_section: Sequence, params: dict, composite,
               fine_hw: tuple | None = None):
    """Check the conv section against the chain's topology and collect
    per-block metadata; None when it does not fit (the caller then takes
    the plain tiled path, as the JAX package takes its XLA path).

    Topology, bottom-up: conv(wsquare/flat, Cin=1) relu [conv(gamma) relu]
    maxpool(2,2|2,4), then [conv(gamma) relu]+ maxpool(2,2) blocks, then a
    [conv(gamma) relu]+ head. 3x3 convs with bias; block 0 holds at most
    one gamma conv above the first conv; a (2,4) pool only above block 0.
    Each conv's channels pass its kernel's predicate: ``chain_takes`` in
    the blocks above the first (up to 512 channels), ``first_layer_takes``
    or ``first_block_deep_takes`` in the first. ``fine_hw`` also checks
    that every pool divides its level, and the first layer's level. The
    TPU plan's lane-packing conditions do not apply."""
    specs = list(conv_section)
    if len(specs) < 2 or specs[0].kind != "conv" or specs[-1].kind != "relu":
        return None
    blocks = []
    cur: list = []
    i, n = 0, len(specs)
    while i < n:
        if specs[i].kind != "conv":
            return None
        cur.append(i)
        if i + 1 >= n or specs[i + 1].kind != "relu":
            return None
        i += 2
        if i == n:
            blocks.append({"convs": cur, "pool_above": None})
            break
        if specs[i].kind == "maxpool":
            kh, kw = specs[i].config["kernel"]
            if kh != 2 or kw not in (2, 4):
                return None
            blocks.append({"convs": cur, "pool_above": (i, kh, kw)})
            cur = []
            i += 1
    if len(blocks) < 2 or blocks[-1]["pool_above"] is not None:
        return None
    first_rule = composite.rule_for(specs[0].name)
    if first_rule is None or first_rule[0] not in ("wsquare", "flat"):
        return None
    if params[specs[0].name]["weight"].shape[1] != 1:
        return None
    for blk in blocks:
        for ci in blk["convs"]:
            if tuple(params[specs[ci].name]["weight"].shape[2:]) != (3, 3):
                return None
    if len(blocks[0]["convs"]) > 2:
        return None
    for bi, blk in enumerate(blocks):
        blk["rules"] = {}
        for ci in blk["convs"]:
            if ci == 0:
                continue
            rule = composite.rule_for(specs[ci].name)
            if rule is None or rule[0] not in ("gamma", "gamma_nonneg"):
                return None
            p = params[specs[ci].name]
            if p.get("bias") is None:
                return None
            co_, ci_ = p["weight"].shape[:2]
            if bi > 0 and not (chain_takes(ci_) and chain_takes(co_)):
                return None
            blk["rules"][ci] = rule[1]
    first = [params[specs[ci].name]["weight"].shape[0] for ci in blocks[0]["convs"]]
    if len(first) == 2 and not first_block_deep_takes(*first):
        return None
    if len(first) == 1 and not first_layer_takes(first[0], fine_hw):
        return None
    for bi in range(len(blocks) - 1):
        if blocks[bi]["pool_above"][2] == 4 and bi != 0:
            return None
    if len(blocks[0]["convs"]) == 1 and blocks[0]["pool_above"][2] != 2:
        return None
    if fine_hw is not None:
        H, W = int(fine_hw[0]), int(fine_hw[1])
        for blk in blocks[:-1]:
            _, kh, kw = blk["pool_above"]
            if H % kh or W % kw:
                return None
            H, W = H // kh, W // kw
    return {"specs": specs, "blocks": blocks, "first_rule": first_rule}


def _lane_pack(params: dict, specs, blk) -> int:
    """The JAX plan's packing factor of a block, pow2_floor(128 // the
    widest map it operates on): the conv inputs, or the first conv's output
    for block 0."""
    widest = max(params[specs[ci].name]["weight"].shape[0 if ci == 0 else 1]
                 for ci in blk["convs"])
    p = 1
    while p * 2 <= 128 // widest:
        p *= 2
    return p


def mergeable(plan, params: dict) -> bool:
    """Whether the merged tail can take blocks nb-2 .. 0 (the JAX package's
    predicate, pallas_chain.py:1066-1072): at least three blocks, one conv
    in each of blocks 0 .. nb-2, and (2,2) pools between them. The JAX
    predicate also asks every merged block to pack its lanes at block 0's
    factor, a TPU layout condition; it is kept as the same test on channel
    counts so that the port merges exactly the models the JAX package
    merges (3s and toy at layers 7 and 10, not 6s). The JAX condition on its
    first-layer recompute flag has no counterpart: the port has no such
    variant."""
    specs, blocks = plan["specs"], plan["blocks"]
    M = len(blocks) - 2
    p0 = _lane_pack(params, specs, blocks[0])
    return (M >= 1
            and all(len(blocks[i]["convs"]) == 1 for i in range(M + 1))
            and all(_lane_pack(params, specs, blocks[i]) == p0 for i in range(1, M + 1))
            and all(blocks[i]["pool_above"][2] == 2 for i in range(M)))


def _prep(prep, *args):
    """A weight prep of the chain, as the span ``lower.prep`` of the
    request log."""
    with profiling.span("lower.prep"):
        return prep(*args)


def fused_lower_conv_backward(plan, params: dict, acts_nhwc, R_nhwc: torch.Tensor,
                              K: int) -> torch.Tensor:
    """Run the chain. acts_nhwc: the recorded NHWC input of every
    conv-section layer (explain_forward_upper); R_nhwc [b, K, h, w, d] at the
    head conv's output. Returns heatmaps [b, K, H, W]. With the merged-tail
    switch on and a mergeable plan, the block walk stops above block
    M = nb - 2 and merged_tail takes the rest."""
    specs, blocks = plan["specs"], plan["blocks"]
    M = len(blocks) - 2
    merged = CHAIN_MERGED and mergeable(plan, params)
    R = R_nhwc
    for i in range(len(blocks) - 1, M if merged else 0, -1):
        blk = blocks[i]
        convs_td = list(reversed(blk["convs"]))
        cws = [_prep(prep_inner_weights, params, specs[ci], blk["rules"][ci])
               for ci in convs_td]
        xs = [acts_nhwc[ci] for ci in convs_td]
        if i >= 2:
            pi, kh, kw = blocks[i - 1]["pool_above"]
            R = chain_block(R, xs, cws, acts_nhwc[pi - 1], (kh, kw))
        else:
            R = chain_block(R, xs, cws)
    a1 = acts_nhwc[1]
    fl = _prep(prep_first_weights, params, specs[0], plan["first_rule"], a1.shape[1:3])
    if merged:
        # the merged convs top-down, and below each but the last the pool
        # above the next block down, its route from that block's pre-relu
        # conv output
        convs_td = [(bi, blocks[bi]["convs"][0]) for bi in range(M, 0, -1)]
        cws = [_prep(prep_inner_weights, params, specs[ci], blocks[bi]["rules"][ci])
               for bi, ci in convs_td]
        apres = [acts_nhwc[blocks[bi]["pool_above"][0] - 1] for bi in range(M - 1, 0, -1)]
        return merged_tail(R, [acts_nhwc[ci] for _, ci in convs_td], cws, apres, a1, fl)
    if len(blocks[0]["convs"]) == 1:
        return first_layer(R, a1, fl)
    pi, kh, kw = blocks[0]["pool_above"]
    ci = blocks[0]["convs"][1]
    gconv = _prep(prep_inner_weights, params, specs[ci], blocks[0]["rules"][ci])
    return first_block_deep(R, a1, acts_nhwc[pi - 1], gconv, fl, (kh, kw))
