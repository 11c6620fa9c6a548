"""Fused log-mel (the port of drsa_audio_tpu.ops.pallas_frontend).

``fused_logmel(wav, config)`` is a drop-in for ops.frontend.logmel,
[..., time] -> [..., n_mels, width], the [1 : width + 1] crop included. It
runs the plain version for tensors on the CPU and the CUDA kernel
(``csrc/logmel.cu``) for CUDA tensors, and never falls back from one to the
other. ``LAUNCHES`` counts the calls that launched the kernel. As in the JAX
package, the explain service keeps the matmul-DFT ``logmel``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
from drsa_audio_tpu_torch.ops.mel import mel_filterbank
from drsa_audio_tpu_torch.ops.stft import _frame_signal, dft_basis, hann_window
from drsa_audio_tpu_torch.utils.nvcc import check_cuda, load, raise_on

LAUNCHES = {"logmel": 0}

INV_LN10 = float(np.float32(1.0 / np.log(10.0)))
MAX_FACTOR = 32     # the longest small DFT of the kernel (csrc/logmel.cu MAXF)


def reset_launches() -> None:
    LAUNCHES["logmel"] = 0


def fused_logmel_plain(wav: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """Plain version of fused_logmel, with the TPU kernel's arithmetic: the
    kept frames times the window, the cos and sin products, the magnitude,
    the mel product, then ln(x + 1e-7) * f32(1/ln 10) clamped at -4."""
    frames = _frame_signal(wav, config.n_fft, config.hop_length)[..., 1:config.width + 1, :]
    frames = frames * hann_window(config.n_fft, frames.dtype, frames.device)
    cos_b, sin_b = (torch.as_tensor(m, device=wav.device) for m in dft_basis(config.n_fft))
    re, im = frames @ cos_b, frames @ sin_b
    mag = torch.sqrt(re * re + im * im)
    fb = torch.as_tensor(mel_filterbank(config.n_fft // 2 + 1, config.n_mels,
                                        config.sample_rate), device=wav.device)
    out = torch.clamp(torch.log(mag @ fb + 1e-7) * INV_LN10, min=-4.0)
    return out.transpose(-1, -2)


def fft_factors(half: int) -> tuple[int, int]:
    """(n1, n2) with n1 * n2 = half, both at most MAX_FACTOR, n1 the largest
    divisor not above sqrt(half) (the fewest products, half * (n1 + n2));
    (0, 0), which the kernel refuses, where there is none."""
    for n1 in range(int(np.sqrt(half)), 0, -1):
        if half % n1 == 0 and half // n1 <= MAX_FACTOR:
            return n1, half // n1
    return 0, 0


def _unit(k: np.ndarray, n: int) -> np.ndarray:
    """exp(-2 pi i k / n) as [..., 2] (re, im), float64."""
    ang = -2.0 * np.pi * (np.asarray(k, np.float64) % n) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def fft_tables(n_fft: int) -> dict:
    """The kernel's FFT tables, built in float64 and cast to float32. The
    real frame x of length N = n_fft is taken as z[m] = x[2m] + i x[2m+1],
    m < N/2 = n1 * n2, whose DFT Z is the four-step product
      Y[m1, k2] = tw[m1, k2] * sum_m2 z[m1 + n1 m2] * t2[m2, k2]
      Z[k2 + n2 k1] = sum_m1 Y[m1, k2] * t1[m1, k1],
    t2 = W_n2^(m2 k2), t1 = W_n1^(m1 k1), tw = W_(N/2)^(m1 k2) (W_n =
    exp(-2 pi i / n)); then X[k] = (Z[k] + conj Z[N/2 - k]) / 2 + post[k] *
    (Z[k] - conj Z[N/2 - k]) / (2i) for k <= N/2 (Z periodic), post =
    W_N^k. Also the window. Each [..., 2] as (re, im)."""
    half = n_fft // 2
    n1, n2 = fft_factors(half)
    m1, m2 = np.arange(max(n1, 1)), np.arange(max(n2, 1))
    f32 = lambda a: a.astype(np.float32)                                 # noqa: E731
    return {"n1": n1, "n2": n2,
            "t2": f32(_unit(np.outer(m2, m2), max(n2, 1))),
            "t1": f32(_unit(np.outer(m1, m1), max(n1, 1))),
            "tw": f32(_unit(np.outer(m1, m2), half)),
            "post": f32(_unit(np.arange(half + 1), n_fft)),
            "win": hann_window(n_fft).numpy()}


def mel_bands(n_freq: int, n_mels: int, sample_rate: int):
    """The filterbank as bands: per mel its first bin, its count of bins and
    the offset of its weights in ``weights`` (the mel's nonzero column
    entries, ascending bins). The HTK triangles are contiguous, so a band
    holds exactly the column's nonzeros."""
    fb = mel_filterbank(n_freq, n_mels, sample_rate)
    bands, weights = np.zeros((n_mels, 3), np.int32), []
    for j in range(n_mels):
        nz = np.nonzero(fb[:, j])[0]
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if len(nz) else (0, 0)
        bands[j] = first, count, sum(len(w) for w in weights)
        weights.append(fb[first:first + count, j])
    return bands, np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_constants(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    """(n1, n2, the FFT tables and the window packed as the kernel stages
    them [t2 | t1 | tw | post | win], the mel bands, their weights) on
    ``device``, built once per config (outside inference mode)."""
    tb = fft_tables(n_fft)
    packed = np.concatenate([tb[k].ravel() for k in ("t2", "t1", "tw", "post", "win")])
    bands, weights = mel_bands(n_fft // 2 + 1, n_mels, sample_rate)
    with torch.inference_mode(False):
        return (tb["n1"], tb["n2"],
                *(torch.as_tensor(a, device=device) for a in (packed, bands, weights)))


def _lib():
    lib = load("logmel")
    if not getattr(lib, "_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.logmel.argtypes = [P] * 5 + [I] * 9 + [Fl, P]
        lib.logmel.restype = I
        lib._typed = True
    return lib


def fused_logmel(wav: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """[..., time] waveform -> [..., n_mels, width] log-mel. CPU tensors take
    the plain version, CUDA tensors the kernel (one launch and one count per
    call). Takes n_mels <= 128 and an n_fft whose half is n1 * n2 with both
    at most 32 (fft_factors); raises ValueError for sizes the kernel does not
    take.

    Replaces drsa_audio_tpu/ops/pallas_frontend.py:34 _logmel_kernel
    (launched :83). Bound on an H100: bytes (the waveform read, the
    log-mels written). Design: one block per 16 output frames of a clip
    stages the frames' span of the waveform once (reflect pad), takes each
    windowed frame's real FFT as a complex four-step FFT of half its length
    with the real-FFT post-twiddle (small dense DFTs from host tables,
    float64 cast to f32), and sums each mel over its band of bins only
    (mel_bands); frames outside the crop are never computed. Both take the
    GTZAN framing only (FrontendConfig's defaults) and raise ValueError for
    a case that states its own (VGGish's)."""
    defaults = FrontendConfig(*config[:7])._replace(
        win_length=config.n_fft, f_max=config.sample_rate / 2.0,
        clip_samples=config.clip_samples)
    if config != defaults:
        raise ValueError("fused_logmel: the GTZAN framing only (centred n_fft frames, the "
                         "Hz-linear bank, log10 clamped, frames 1 .. width)")
    if wav.device.type == "cpu":
        return fused_logmel_plain(wav, config)
    lead, L = wav.shape[:-1], wav.shape[-1]
    x = wav.reshape(-1, L).contiguous()
    check_cuda("logmel", x)
    n1, n2, tables, bands, weights = _device_constants(
        config.n_fft, config.n_mels, config.sample_rate, x.device)
    out = torch.empty((x.shape[0], config.n_mels, config.width), device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(_lib().logmel(
        x.data_ptr(), tables.data_ptr(), bands.data_ptr(), weights.data_ptr(), out.data_ptr(),
        x.shape[0], L, config.n_fft, config.hop_length, n1, n2, config.n_mels,
        weights.numel(), config.width, INV_LN10, stream), "logmel")
    LAUNCHES["logmel"] += 1
    return out.reshape(*lead, config.n_mels, config.width)
