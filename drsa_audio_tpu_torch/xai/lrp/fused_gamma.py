"""The gamma rule on non-negative input for one 3x3 SAME conv, with the K
relevance clones folded into the batch (the port of
drsa_audio_tpu.xai.lrp.pallas_gamma).

``gamma_nonneg_folded`` runs the plain version for tensors on the CPU and
the CUDA kernel (``csrc/gamma_nonneg.cu``) for CUDA tensors; it never falls
back from one to the other. ``LAUNCHES`` counts the calls that launched the
kernel. The shared-denominator walk reaches it through
``rules.shared_gamma_nonneg`` for every 3x3 conv (``takes``). The kernel
reads the layer's GammaConv (xai.lrp.taps), built once per layer
(``taps.gamma_conv``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from drsa_audio_tpu_torch.utils.nvcc import check_cuda, load, raise_on
from drsa_audio_tpu_torch.xai.lrp.rules import _gmods, _mul_small, stabilize
from drsa_audio_tpu_torch.xai.lrp.taps import GammaConv, gamma_conv

LAUNCHES = {"gamma_nonneg": 0}


def reset_launches() -> None:
    LAUNCHES["gamma_nonneg"] = 0


def takes(layer) -> bool:
    """Whether shared_gamma_nonneg sends this layer (an engine.LayerOp) to
    the kernel on a GPU: an NCHW conv with 3x3 taps (every conv of the
    models is stride 1, SAME) whose channels the kernel takes
    (csrc/gamma_nonneg.cu ``takes``: Co a multiple of 8 or of 20 up to 128,
    Ci a multiple of 4 up to 128). Others take the plain rule."""
    if layer.kind != "conv" or layer.nhwc or tuple(layer.w.shape[2:]) != (3, 3):
        return False
    co, ci = layer.w.shape[:2]
    return 0 < co <= 128 and (co % 8 == 0 or co % 20 == 0) and 0 < ci <= 128 and ci % 4 == 0


def gamma_nonneg_folded_plain(x: torch.Tensor, R: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor | None, num_concepts: int,
                              gamma: float = 0.25, stabilizer: float = 1e-6) -> torch.Tensor:
    """Plain version of gamma_nonneg_folded, with the kernel's arithmetic:
    z_true = (z1 + z3 - b1) * f32(1/(2+gamma)) + b0, as the TPU kernel
    derives it (the rules divide by 2+gamma instead)."""
    K, Co = num_concepts, w.shape[0]
    gp, gn = _gmods(gamma)
    b0 = torch.zeros(Co, dtype=w.dtype, device=w.device) if b is None else b
    b1, b2 = gp(b0), gn(b0)
    wpn = torch.cat([gp(w), gn(w)])
    z = F.conv2d(x, wpn, padding=1)
    z1 = z[:, :Co] + b1[:, None, None]
    z3 = z[:, Co:]
    inv = float(np.float32(1.0 / (2.0 + gamma)))
    z_true = (z1 + z3 - b1[:, None, None]) * inv + b0[:, None, None]
    m1 = (z_true > 0).to(x.dtype) / stabilize(z1 + b2[:, None, None], stabilizer)
    m3 = (z_true < 0).to(x.dtype) / stabilize(z3, stabilizer)
    s = torch.cat([_mul_small(R, m1, K), _mul_small(R, m3, K)], dim=1)
    return _mul_small(F.conv_transpose2d(s, wpn, padding=1), x, K)


def _lib():
    lib = load("gamma_nonneg")
    if not getattr(lib, "_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gamma_nonneg_prep.argtypes = [P] * 4 + [I] * 6 + [Fl, Fl, P]
        lib.gamma_nonneg_apply.argtypes = [P] * 5 + [I] * 7 + [P]
        lib.gamma_nonneg_prep.restype = lib.gamma_nonneg_apply.restype = I
        lib.gamma_nonneg_smem.argtypes = [I] * 3
        lib.gamma_nonneg_smem.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _prep(x: torch.Tensor, cv: GammaConv, stream) -> torch.Tensor:
    """One gamma_nonneg_prep launch: M = (m1, m3) interleaved [b, H, W,
    2*Co] from x [b, Ci, H, W]."""
    n, ci, H, W = x.shape
    M = torch.empty((n, H, W, 2 * cv.co), device=x.device)
    raise_on(_lib().gamma_nonneg_prep(
        x.data_ptr(), cv.w_prep_wg.data_ptr(), cv.biases.data_ptr(), M.data_ptr(),
        n, H, W, ci, cv.co, cv.prep_cols, cv.inv, cv.stab, stream), "gamma_nonneg")
    return M


def _apply(R: torch.Tensor, M: torch.Tensor, x: torch.Tensor, cv: GammaConv, K: int,
           stream) -> torch.Tensor:
    """One gamma_nonneg_apply launch: x * convT(R * M) for every clone,
    [K*b, Ci, H, W]."""
    n, ci, H, W = x.shape
    out = torch.empty((K * n, ci, H, W), device=x.device)
    raise_on(_lib().gamma_nonneg_apply(
        R.data_ptr(), M.data_ptr(), x.data_ptr(), cv.w_apply_pair_wg.data_ptr(), out.data_ptr(),
        n, K, H, W, ci, cv.co, cv.apply_pair_cols, stream), "gamma_nonneg")
    return out


def gamma_smem(cv: GammaConv, H: int) -> tuple:
    """The dynamic shared memory, bytes, a block of the prep and of the
    apply takes for cv's layouts at a level of H rows."""
    lib = _lib()
    return (lib.gamma_nonneg_smem(1, cv.prep_cols, H),
            lib.gamma_nonneg_smem(0, cv.apply_pair_cols, H))


def gamma_nonneg_folded(x: torch.Tensor, R: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor | None, num_concepts: int,
                        gamma: float = 0.25, stabilizer: float = 1e-6) -> torch.Tensor:
    """The gamma rule on non-negative x for a 3x3 SAME conv w [Co, Ci, 3, 3]
    with bias b, the K clones folded clone-major into R's batch: x
    [b, Ci, H, W], R [K*b, Co, H, W] -> [K*b, Ci, H, W]. The same contract as
    the JAX package's pallas_gamma_nonneg. CPU tensors take the plain
    version, CUDA tensors the kernel (two launches, one count per call).

    Replaces drsa_audio_tpu/xai/lrp/pallas_gamma.py:49 _gamma_nonneg_kernel
    (launched :135). Bound on an H100: operations (the forward pair once per
    instance, one transposed conv over Co channels per clone: m1 and m3 are
    disjoint, so each relevance entry meets one weight set). Design: a prep
    launch writes the clone-shared (m1, m3) once per instance, and the apply
    launch takes the transposed conv over the 2*Co channels R * (m1, m3)
    against the stacked flipped taps of the pair; both are 3xTF32 implicit
    GEMMs on Hopper's wgmma (csrc/conv3x3_wgmma.cuh) with the taps
    pre-split once per layer (``gamma_conv``) and staged by bulk copy, and
    they stage x and R from NCHW in whole 16-byte pieces of rows and write
    the result NCHW, so nothing is transposed. Takes 0 < Ci, Co <= 128 with
    Ci % 4 == 0 and Co a multiple of 8 or 20; raises ValueError, before any
    launch, for other counts."""
    if x.device.type == "cpu":
        return gamma_nonneg_folded_plain(x, R, w, b, num_concepts, gamma, stabilizer)
    x, R = x.contiguous(), R.contiguous()
    check_cuda("gamma_nonneg", x, R, w, *(() if b is None else (b,)))
    K = num_concepts
    n, Ci, H, W = x.shape
    Co = w.shape[0]
    if (tuple(w.shape) != (Co, Ci, 3, 3) or tuple(R.shape) != (K * n, Co, H, W)
            or (b is not None and tuple(b.shape) != (Co,))):
        raise ValueError("gamma_nonneg: relevance / activation / weight shapes disagree")
    cv = gamma_conv(w, b, gamma, stabilizer)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    out = _apply(R, _prep(x, cv, stream), x, cv, K, stream)
    LAUNCHES["gamma_nonneg"] += 1
    return out
