"""The lower chain's prepared weights and the wgmma tap layout that the
kernels read them in: one home for both wrappers that run a gamma conv
(xai.lrp.chain and xai.lrp.fused_gamma) and for the .cu files' B tiles
(csrc/conv3x3_wgmma.cuh).

A gamma conv is prepared once, by ``build_gamma_conv``, into one record,
``GammaConv``. The chain builds it anew on every request (through
``chain.prep_inner_weights``); the shared-denominator walk reaches it
through ``gamma_conv``, which caches it per layer. ``FirstLayer`` holds the
first conv's wsquare/flat pieces.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F

SLICE = 8     # the wgmma kernels' reduction slice (csrc/conv3x3_tc.cuh CC)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32 values: the significand rounded to 10 bits,
    ties away from zero (add 0x1000 to the bit pattern, clear the low 13
    bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def wg_cols(n: int) -> int:
    """The width of a wgmma B tile for n columns: the next of 8, 16, 32, 64,
    104, 128 (the widths the kernels are built for), past 128 the next
    multiple of 64. The layout's width is the one decision: the wrappers
    pass it to the kernels, which refuse a width they lack."""
    for c in (8, 16, 32, 64, 104, 128):
        if n <= c:
            return c
    return -(-n // 64) * 64


def apply_chunk(ci: int, co: int) -> int:
    """chain_gamma_apply's column width for a conv of Ci -> Co channels:
    one tile of ``wg_cols(Ci)`` up to 128 channels in and out; for a conv
    over 128 channels, chunks of 128 columns, one a grid column of the
    launch (csrc/chain_block.cu)."""
    return wg_cols(ci) if max(ci, co) <= 128 else 128


def prep_chunk(n: int) -> int:
    """chain_gamma_prep's column chunk for N = 2*Co columns: the tile width,
    at most 32, so that the prep's FRESH scratch fragments fit beside its
    accumulators (csrc/chain_block.cu)."""
    return min(wg_cols(n), 32)


def wgmma_taps(taps: torch.Tensor, chunk: int) -> torch.Tensor:
    """Taps [9, Kr, N] (tap, reduction channel, output column), split once
    into hi = tf32(w) and lo = tf32(w - hi) and laid out K-major for the
    wgmma kernels as [ceil(N/chunk), ceil(Kr/8), 2 (hi, lo), 9, 2, chunk, 4]:
    per column chunk and 8-channel slice one contiguous block, in which a
    (part, tap) tile holds the slice's two 4-channel halves (kc), each
    [chunk][4] (column n, channel 8s + 4kc + i at [kc][n][i]). Zeros past Kr
    and N."""
    _, kr, n = taps.shape
    nsl, ncb = -(-kr // SLICE), -(-n // chunk)
    t = taps.new_zeros((9, nsl * SLICE, ncb * chunk))
    t[:, :kr, :n] = taps
    hi = tf32(t)
    parts = torch.stack([hi, tf32(t - hi)])                  # [2, 9, nsl*8, ncb*chunk]
    parts = parts.reshape(2, 9, nsl, 2, 4, ncb, chunk)       # part, tap, s, kc, i, cb, n
    return parts.permute(5, 2, 0, 1, 3, 6, 4).contiguous()


@dataclasses.dataclass
class GammaConv:
    """One gamma conv, prepared (port of _prep_inner_weights, in plain
    NHWC). wz1 = w + g*w+, wz3 = w + g*w- (OIHW); biases = (b + g*b+, b,
    b + g*b-); inv = f32(1/(2+g)). The kernels' tap layouts: ``w_prep_wg``
    the forward pair interleaved (column 2j wz1's output channel j, 2j + 1
    wz3's), pre-split by ``wgmma_taps`` in column chunks of
    ``prep_chunk(2*Co)`` (chain_gamma_prep, gamma_nonneg_prep);
    ``w_apply_wg`` the transposed wz1, pre-split in column chunks of
    ``apply_chunk(Ci, Co)``: one chunk up to 128 channels
    (chain_gamma_apply, first_block_deep, merged_tail), chunks of 128 for a
    conv over 128 channels (chain_gamma_apply); ``w_apply_pair_wg``, built
    at its first read, the pair flipped and transposed, reduction row 2o + s
    wz1's (s = 0) or wz3's (s = 1) output channel o, the order of the prep's
    (m1, m3), in one chunk of ``wg_cols(Ci)`` (gamma_nonneg_apply)."""
    wz1: torch.Tensor
    wz3: torch.Tensor
    biases: torch.Tensor
    inv: float
    stab: float
    w_prep_wg: torch.Tensor
    w_apply_wg: torch.Tensor

    @functools.cached_property
    def w_apply_pair_wg(self) -> torch.Tensor:
        pair = torch.stack([self.wz1, self.wz3], dim=1).reshape(2 * self.co, self.ci, 3, 3)
        return wgmma_taps(pair.flip(2, 3).permute(2, 3, 0, 1).reshape(9, 2 * self.co, self.ci),
                          wg_cols(self.ci))

    @property
    def prep_cols(self) -> int:
        """The column chunk ``w_prep_wg`` is laid out in."""
        return self.w_prep_wg.shape[-2]

    @property
    def apply_cols(self) -> int:
        """The column chunk ``w_apply_wg`` is laid out in."""
        return self.w_apply_wg.shape[-2]

    @property
    def apply_pair_cols(self) -> int:
        """The column width ``w_apply_pair_wg`` is laid out in."""
        return self.w_apply_pair_wg.shape[-2]

    @property
    def ci(self) -> int:
        return self.wz1.shape[1]

    @property
    def co(self) -> int:
        return self.wz1.shape[0]


BUILDS = {"gamma_conv": 0}


def build_gamma_conv(w: torch.Tensor, b: torch.Tensor | None, gamma: float,
                     stabilizer: float) -> GammaConv:
    """The GammaConv of a conv's weight w [Co, Ci, 3, 3] and bias b (None:
    zeros) at gamma, built anew (``BUILDS`` counts the builds)."""
    g = float(gamma)
    co, ci = w.shape[:2]
    if b is None:
        b = torch.zeros(co, dtype=w.dtype, device=w.device)
    wz1 = w + g * torch.clamp(w, min=0.0)
    wz3 = w + g * torch.clamp(w, max=0.0)
    biases = torch.stack([b + g * torch.clamp(b, min=0.0), b,
                          b + g * torch.clamp(b, max=0.0)])
    pair = torch.stack([wz1, wz3], dim=1).reshape(2 * co, ci, 3, 3)
    pair = pair.permute(2, 3, 1, 0).reshape(9, ci, 2 * co)
    w_apply = wz1.flip(2, 3).permute(2, 3, 0, 1).reshape(9, co, ci).contiguous()
    BUILDS["gamma_conv"] += 1
    return GammaConv(
        wz1=wz1, wz3=wz3, biases=biases.contiguous(),
        inv=float(np.float32(1.0 / (2.0 + g))), stab=float(stabilizer),
        w_prep_wg=wgmma_taps(pair, prep_chunk(2 * co)),
        w_apply_wg=wgmma_taps(w_apply, apply_chunk(ci, co)))


# {(id(w), id(b), gamma, stabilizer): (weakref to w, weakref to b, stamp,
# GammaConv)}: the record of each layer met, built once and served while
# the weight and bias are the same tensors at the same version (an in-place
# update bumps it) and storage.
_CACHE: dict = {}


def _stamp(t: torch.Tensor | None):
    return None if t is None else (t._version, t.data_ptr(), t.device)


def gamma_conv(w: torch.Tensor, b: torch.Tensor | None, gamma: float,
               stabilizer: float) -> GammaConv:
    """The GammaConv of a layer's weight w and bias b at gamma and
    stabilizer: built at the first call and cached per layer, keyed on the
    tensors themselves, gamma and stabilizer. A weight or bias changed in
    place, or another tensor, is built again: a changed weight is never
    served stale. An entry goes with its weight. An inference tensor keeps
    no version, so a record of one is built anew on every call and never
    cached."""
    if w.is_inference() or (b is not None and b.is_inference()):
        return build_gamma_conv(w, b, gamma, stabilizer)
    key = (id(w), None if b is None else id(b), float(gamma), float(stabilizer))
    hit = _CACHE.get(key)
    stamp = (_stamp(w), _stamp(b))
    if (hit is not None and hit[0]() is w and (b is None or hit[1]() is b)
            and hit[2] == stamp):
        return hit[3]
    cv = build_gamma_conv(w, b, gamma, stabilizer)
    _CACHE[key] = (weakref.ref(w, lambda _, k=key: _CACHE.pop(k, None)),
                   None if b is None else weakref.ref(b), stamp, cv)
    return cv


@dataclasses.dataclass
class FirstLayer:
    """The first conv's wsquare/flat pieces (port of _prep_first_weights):
    rule weights ``wm`` [C, 1, 3, 3], the input-independent denominator
    ``z0`` [H, W, C] and the kernel's transposed-conv taps [9, C]."""
    wm: torch.Tensor
    z0: torch.Tensor
    taps: torch.Tensor
    stab0: float


def prep_first_weights(params: dict, spec, rule, fine_hw) -> FirstLayer:
    p = params[spec.name]
    w, b = p["weight"], p.get("bias")
    name, kwargs = rule
    if w.shape[1] != 1:
        raise ValueError("the first-layer tail needs a single input channel")
    if name == "wsquare":
        wm, bm = w * w, (b * b if b is not None else None)
    else:                                   # flat
        wm, bm = torch.ones_like(w), None
    ones = torch.ones((1, 1) + tuple(fine_hw), dtype=w.dtype, device=w.device)
    z0 = F.conv2d(ones, wm, bm, padding=1)[0].permute(1, 2, 0).contiguous()
    taps = wm[:, 0].flip(1, 2).permute(1, 2, 0).reshape(9, -1).contiguous()
    return FirstLayer(wm=wm, z0=z0, taps=taps,
                      stab0=float(kwargs.get("stabilizer", 1e-6)))
