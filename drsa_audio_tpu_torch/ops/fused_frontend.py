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
# the kernel's tiles (csrc/logmel.cu): basis rows a multiple of KC, columns
# a multiple of FC, 128 mel columns
_KC, _FC, _MP = 32, 64, 128


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


@functools.lru_cache(maxsize=None)
def _device_constants(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    """The window and the zero-padded cos, sin and filterbank tables of the
    kernel, on ``device``, built once per config (outside inference mode)."""
    n_freq = n_fft // 2 + 1
    nk, nfp = -(-n_fft // _KC) * _KC, -(-n_freq // _FC) * _FC
    cos_p, sin_p = np.zeros((nk, nfp), np.float32), np.zeros((nk, nfp), np.float32)
    cos_b, sin_b = dft_basis(n_fft)
    cos_p[:n_fft, :n_freq], sin_p[:n_fft, :n_freq] = cos_b, sin_b
    fb_p = np.zeros((nfp, _MP), np.float32)
    fb_p[:n_freq, :n_mels] = mel_filterbank(n_freq, n_mels, sample_rate)
    with torch.inference_mode(False):
        return (hann_window(n_fft, torch.float32, device),
                *(torch.as_tensor(a, device=device) for a in (cos_p, sin_p, fb_p)))


def _lib():
    lib = load("logmel")
    if not getattr(lib, "_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.logmel.argtypes = [P] * 6 + [I] * 8 + [Fl, P]
        lib.logmel.restype = I
        lib._typed = True
    return lib


def fused_logmel(wav: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """[..., time] waveform -> [..., n_mels, width] log-mel. CPU tensors take
    the plain version, CUDA tensors the kernel (one launch and one count per
    call). Takes n_mels <= 128; raises ValueError for sizes the kernel does
    not take.

    Replaces drsa_audio_tpu/ops/pallas_frontend.py:34 _logmel_kernel
    (launched :83). Bound on an H100: bytes (the waveform read, the
    log-mels written; an FFT and the filterbank's nonzeros per kept frame
    take less time), while the kernel does the dense cos/sin products on
    the FMA units, about 65 times an FFT's operations. Design: one block
    per 64 output frames of a clip builds its frames from the waveform on
    the fly (reflect pad, window), accumulates re and im per 64-frequency
    chunk in registers against the cos/sin tables in L2, and adds the
    chunk's magnitudes times its filterbank rows into a register
    accumulator; frames outside the crop are never computed."""
    if wav.device.type == "cpu":
        return fused_logmel_plain(wav, config)
    lead, L = wav.shape[:-1], wav.shape[-1]
    x = wav.reshape(-1, L).contiguous()
    check_cuda("logmel", x)
    win, cos_p, sin_p, fb_p = _device_constants(config.n_fft, config.n_mels,
                                                config.sample_rate, x.device)
    out = torch.empty((x.shape[0], config.n_mels, config.width), device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(_lib().logmel(
        x.data_ptr(), win.data_ptr(), cos_p.data_ptr(), sin_p.data_ptr(), fb_p.data_ptr(),
        out.data_ptr(), x.shape[0], L, config.n_fft, config.hop_length, cos_p.shape[0],
        cos_p.shape[1], config.n_mels, config.width, INV_LN10, stream), "logmel")
    LAUNCHES["logmel"] += 1
    return out.reshape(*lead, config.n_mels, config.width)
