"""HTK mel filterbank and mel projection (the port of drsa_audio_tpu.ops.mel).

Matches torchaudio.transforms.MelScale defaults: f_min=0,
f_max=sample_rate/2, norm=None, mel_scale='htk'. ``triangles="mel"`` gives
VGGish's bank instead (mel_features.spectrogram_to_mel_matrix): each
triangle linear on the mel scale between its edges, the DC bin left out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float | None = None,
                   triangles: str = "hz") -> np.ndarray:
    """Triangular HTK filterbank [n_freqs, n_mels], float64 then cast:
    triangles linear in Hz ("hz", torchaudio's) or on the mel scale with the
    DC bin's row zero ("mel", VGGish's)."""
    f_max = float(sample_rate) / 2 if f_max is None else f_max
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    if triangles == "mel":
        bins = hz_to_mel(all_freqs)
        lower, centre, upper = m_pts[:-2], m_pts[1:-1], m_pts[2:]
        rise = (bins[:, None] - lower[None, :]) / (centre - lower)[None, :]
        fall = (upper[None, :] - bins[:, None]) / (upper - centre)[None, :]
        fb = np.maximum(0.0, np.minimum(rise, fall))
        fb[0] = 0.0
        return fb.astype(np.float32)
    if triangles != "hz":
        raise ValueError(f"mel_filterbank: triangles {triangles!r} is not 'hz' or 'mel'")
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                       device: torch.device, f_min: float = 0.0, f_max: float | None = None,
                       triangles: str = "hz") -> torch.Tensor:
    """mel_filterbank on ``device``, built once per config (outside inference
    mode, so that later callers in any mode may use it)."""
    with torch.inference_mode(False):
        return torch.as_tensor(mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max,
                                              triangles), device=device)


def mel_scale(spec_mag: torch.Tensor, n_mels: int, sample_rate: int, f_min: float = 0.0,
              f_max: float | None = None, triangles: str = "hz") -> torch.Tensor:
    """[..., n_freq, time] magnitude -> [..., n_mels, time] (the bank's
    edges and triangles as ``mel_filterbank`` takes them)."""
    fb = _device_filterbank(spec_mag.shape[-2], n_mels, sample_rate, spec_mag.device,
                            f_min, f_max, triangles)
    fb = fb.to(spec_mag.dtype)                   # float64 for a float64 reference
    return (spec_mag.transpose(-1, -2) @ fb).transpose(-1, -2)
