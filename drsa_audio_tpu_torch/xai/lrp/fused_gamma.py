"""The gamma rule on non-negative input for one 3x3 SAME conv, with the K
relevance clones folded into the batch (the port of
drsa_audio_tpu.xai.lrp.pallas_gamma).

``gamma_nonneg_folded`` runs the plain version for tensors on the CPU and
the CUDA kernel (``csrc/gamma_nonneg.cu``) for CUDA tensors; it never falls
back from one to the other. ``LAUNCHES`` counts the calls that launched the
kernel. The shared-denominator walk reaches it through
``rules.shared_gamma_nonneg`` for every 3x3 conv (``takes``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from drsa_audio_tpu_torch.utils.nvcc import check_cuda, load, raise_on
from drsa_audio_tpu_torch.xai.lrp.rules import _gmods, _mul_small, stabilize

LAUNCHES = {"gamma_nonneg": 0}


def reset_launches() -> None:
    LAUNCHES["gamma_nonneg"] = 0


def takes(layer) -> bool:
    """Whether shared_gamma_nonneg sends this layer (an engine.LayerOp) to
    the kernel on a GPU: an NCHW conv with 3x3 taps (every conv of the
    models is stride 1, SAME)."""
    return layer.kind == "conv" and not layer.nhwc and tuple(layer.w.shape[2:]) == (3, 3)


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
        lib.gamma_nonneg.argtypes = [P] * 7 + [I] * 6 + [Fl, Fl, P]
        lib.gamma_nonneg.restype = I
        lib._typed = True
    return lib


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
    disjoint, so each relevance entry meets one weight set). Design: a
    prep launch writes the clone-shared [m1 | m3] once per instance; the
    apply launch stages R * [m1 | m3] per (16x16 tile, clone) and keeps 4
    pixels x 8 channels a thread in registers. NCHW throughout, so no
    transposes. Takes 0 < Ci, Co <= 128 with Ci % 4 == 0 and Co a multiple
    of 8 or 20; raises ValueError for other counts."""
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
    gp, gn = _gmods(gamma)
    b0 = torch.zeros(Co, device=x.device) if b is None else b
    wpn = torch.cat([gp(w), gn(w)])                                 # [2Co, Ci, 3, 3]
    wf = wpn.permute(2, 3, 1, 0).reshape(9, Ci, 2 * Co).contiguous()
    ci8 = -(-Ci // 8) * 8
    wt = F.pad(wpn.flip(2, 3).permute(2, 3, 0, 1).reshape(9, 2 * Co, Ci),
               (0, ci8 - Ci)).contiguous()
    bias3 = torch.stack([gp(b0), gn(b0), b0]).contiguous()
    M = torch.empty((n, 2 * Co, H, W), device=x.device)
    out = torch.empty((K * n, Ci, H, W), device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(_lib().gamma_nonneg(
        x.data_ptr(), R.data_ptr(), wf.data_ptr(), wt.data_ptr(),
        bias3.data_ptr(), M.data_ptr(), out.data_ptr(), n, K, H, W, Ci, Co,
        float(np.float32(1.0 / (2.0 + gamma))), float(stabilizer), stream), "gamma_nonneg")
    LAUNCHES["gamma_nonneg"] += 1
    return out
