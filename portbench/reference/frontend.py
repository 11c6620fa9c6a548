"""Waveform -> log-mel, as the configuration states it: peak normalise,
|STFT| (periodic Hann window of n_fft, centred with reflect padding,
one-sided), an HTK mel filterbank (f_min 0, f_max sample_rate / 2, no
norm), log10(mel + 1e-7) clamped at -4, time bins 1 .. width kept."""

from __future__ import annotations

import numpy as np
import torch


def peak_normalize(wav: torch.Tensor) -> torch.Tensor:
    """Scale each clip to max |x| = 1; a silent clip stays as it is."""
    peak = wav.abs().amax(dim=-1, keepdim=True)
    return wav / torch.where(peak > 0, peak, torch.ones_like(peak))


def htk_filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """Triangular filters [n_freqs, n_mels] on the HTK mel scale, computed
    in float64."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    edges = to_hz(np.linspace(to_mel(0.0), to_mel(sample_rate / 2.0), n_mels + 2))
    lower, centre, upper = edges[:-2], edges[1:-1], edges[2:]
    rise = (freqs[:, None] - lower[None, :]) / (centre - lower)[None, :]
    fall = (upper[None, :] - freqs[:, None]) / (upper - centre)[None, :]
    return np.clip(np.minimum(rise, fall), 0.0, None)


def logmel(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[b, samples] peak-normalised waveform -> [b, n_mels, width]."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    x = torch.nn.functional.pad(wav[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)                                   # [b, frames, n_fft]
    n = torch.arange(n_fft, dtype=torch.float64, device=wav.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / n_fft)).to(torch.float32)
    mag = torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs()        # [b, frames, freqs]
    fb = torch.as_tensor(htk_filterbank(n_fft // 2 + 1, cfg["n_mels"], cfg["sample_rate"]),
                         dtype=torch.float32, device=wav.device)
    mel = (mag @ fb).transpose(-1, -2)                                  # [b, mels, frames]
    out = torch.clamp(torch.log10(mel + 1e-7), min=-4.0)
    return out[..., 1:cfg["mel_width"] + 1]
