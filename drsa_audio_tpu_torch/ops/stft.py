"""STFT primitives (the port of drsa_audio_tpu.ops.stft).

Semantics match torchaudio.transforms.Spectrogram(power=None): periodic Hann
window of length n_fft, center=True with reflect padding, one-sided, no
normalisation. ``stft`` is the FFT path (torch.fft.rfft); the magnitude is
also two plain matmuls against a DFT basis built in float64 and cast
(``stft_mag_matmul``), which agrees with the FFT path to float32 round-off.
``stft_mag_matmul`` also takes a window shorter than the DFT (``win_length``
samples a frame, zero-padded at its end to n_fft, as VGGish frames 400
samples into a 512-point FFT) and uncentred framing.
``istft`` inverts a centred spectrum by overlap-add.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window(periodic=True)), built in
    float64 numpy then cast, as the JAX package builds it."""
    n = np.arange(n_fft)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    return torch.as_tensor(w, dtype=dtype, device=device)


def _frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                  center: bool = True) -> torch.Tensor:
    """Reflect-pad by n_fft//2 on both sides (``center``) and cut
    overlapping frames of n_fft samples. [..., time] -> [..., n_frames,
    n_fft]."""
    lead = x.shape[:-1]
    if center:
        pad = n_fft // 2
        xp = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                                     mode="reflect")[:, 0]
    else:
        xp = x.reshape(-1, x.shape[-1])
    frames = xp.unfold(-1, n_fft, hop_length)
    return frames.reshape(*lead, frames.shape[-2], n_fft)


def stft(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Complex one-sided STFT: [..., time] -> [..., n_fft//2 + 1, n_frames]."""
    frames = _frame_signal(x, n_fft, hop_length)
    frames = frames * hann_window(n_fft, frames.dtype, frames.device)
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def stft_magnitude(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """|STFT| through the FFT: [..., n_freq, n_frames]."""
    return stft(x, n_fft, hop_length).abs()


def dft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag one-sided DFT basis, each [n_fft, n_fft//2+1], float64 ->
    float32."""
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_basis(n_fft: int, dtype: torch.dtype, device: torch.device,
                  win_length: int | None = None):
    """(window, cos basis, sin basis) on ``device``, built once: they are
    constants of the config. The window is a periodic Hann of
    ``win_length`` (default n_fft) samples, and the bases are the n_fft-point
    DFT's first ``win_length`` rows: a frame zero-padded to n_fft meets the
    other rows with its zeros. Built outside inference mode so that later
    callers in any mode may use them."""
    win = n_fft if win_length is None else win_length
    with torch.inference_mode(False):
        cos_b, sin_b = (torch.as_tensor(m[:win], device=device) for m in dft_basis(n_fft))
        return hann_window(win, dtype, device), cos_b, sin_b


def stft_mag_matmul(x: torch.Tensor, n_fft: int, hop_length: int,
                    win_length: int | None = None, center: bool = True) -> torch.Tensor:
    """|STFT| as two matmuls: [..., time] -> [..., n_freq, n_frames]. Frames
    of ``win_length`` samples (default n_fft), centred by reflect padding
    where ``center``, each windowed and zero-padded to n_fft."""
    win = n_fft if win_length is None else win_length
    frames = _frame_signal(x, win, hop_length, center)
    window, cos_b, sin_b = _device_basis(n_fft, frames.dtype, frames.device,
                                         None if win == n_fft else win)
    frames = frames * window
    re = frames @ cos_b
    im = frames @ sin_b
    return torch.sqrt(re * re + im * im).transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[n, n_frames, n_fft] -> [n, n_fft + hop * (n_frames - 1)]: each frame
    added in at its hop (F.fold, which gathers per output sample: no
    atomics, so the same bits on every run)."""
    n, n_frames, n_fft = frames.shape
    out_len = n_fft + hop_length * (n_frames - 1)
    return F.fold(frames.transpose(1, 2), output_size=(1, out_len), kernel_size=(1, n_fft),
                  stride=(1, hop_length))[:, 0, 0]


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          length: int | None = None) -> torch.Tensor:
    """Inverse of ``stft``: complex [..., n_freq, n_frames] -> [..., time].
    Each frame's irfft is windowed (periodic Hann) and overlap-added, the sum
    divided by the overlap-added squared window where that exceeds 1e-11,
    and n_fft//2 samples cropped at each end (then ``length`` kept, if
    given). Written out, not torch.istft, whose centring and window checks
    are not this function's."""
    n_frames = spec.shape[-1]
    lead = spec.shape[:-2]
    window = hann_window(n_fft, torch.float32, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    sig = _overlap_add(frames.reshape(-1, n_frames, n_fft), hop_length)
    win_sq = _overlap_add((window * window).expand(1, n_frames, n_fft), hop_length)
    sig = sig / torch.where(win_sq > 1e-11, win_sq, torch.ones_like(win_sq))
    pad = n_fft // 2
    sig = sig[:, pad:]
    sig = sig[:, :length] if length is not None else sig[:, :sig.shape[-1] - pad]
    return sig.reshape(*lead, sig.shape[-1])
