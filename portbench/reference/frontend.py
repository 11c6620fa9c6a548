"""Waveform -> log-mel, as the configuration states it. Each step has a key
with a default (``settings``); the defaults are the GTZAN models' front-end:

  peak_normalize  true: scale each clip to max |x| = 1
  clip_samples    slice_length * sample_rate: the samples of a clip
  center          true: reflect-pad win_length // 2 samples at each end
  win_length      n_fft: frame i is win_length samples from i * hop_length,
                  times a periodic Hann window of win_length, zero-padded at
                  its end to n_fft for the one-sided |FFT|
  f_min, f_max    0 and sample_rate / 2: the mel bands' outer edges, HTK
                  scale, no norm
  triangles       "hz": each band's triangle linear in Hz between its edges
                  (torchaudio's HTK bank); "mel": linear on the mel scale, the
                  DC bin left out (VGGish's mel_features)
  log             "log10_clamp": log10(mel + 1e-7) clamped at -4;
                  "ln_offset": ln(mel + log_offset)
  first_frame     1: frames first_frame .. first_frame + mel_width - 1 kept
"""

from __future__ import annotations

import numpy as np
import torch


def settings(cfg: dict) -> dict:
    """The front-end's keys of ``cfg``, each missing one at its default."""
    defaults = {"peak_normalize": True, "center": True, "win_length": cfg["n_fft"],
                "f_min": 0.0, "f_max": cfg["sample_rate"] / 2.0, "triangles": "hz",
                "log": "log10_clamp", "log_offset": None, "first_frame": 1,
                "clip_samples": int(round(cfg["slice_length"] * cfg["sample_rate"]))}
    return {k: cfg.get(k, v) for k, v in defaults.items()}


def n_frames(cfg: dict) -> int:
    """The frames the STFT computes of one clip."""
    s = settings(cfg)
    win = s["win_length"]
    padded = s["clip_samples"] + (2 * (win // 2) if s["center"] else 0)
    return (padded - win) // cfg["hop_length"] + 1


def peak_normalize(wav: torch.Tensor) -> torch.Tensor:
    """Scale each clip to max |x| = 1; a silent clip stays as it is."""
    peak = wav.abs().amax(dim=-1, keepdim=True)
    return wav / torch.where(peak > 0, peak, torch.ones_like(peak))


def htk_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: float | None = None, triangles: str = "hz") -> np.ndarray:
    """Triangular filters [n_freqs, n_mels] on the HTK mel scale between
    ``f_min`` and ``f_max`` (default sample_rate / 2), computed in float64."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    f_max = sample_rate / 2.0 if f_max is None else f_max
    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    edges = np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2)
    if triangles == "hz":
        edges = to_hz(edges)
    elif triangles == "mel":
        freqs = to_mel(freqs)
    else:
        raise ValueError(f"triangles {triangles!r}: 'hz' or 'mel'")
    lower, centre, upper = edges[:-2], edges[1:-1], edges[2:]
    rise = (freqs[:, None] - lower[None, :]) / (centre - lower)[None, :]
    fall = (upper[None, :] - freqs[:, None]) / (upper - centre)[None, :]
    fb = np.clip(np.minimum(rise, fall), 0.0, None)
    if triangles == "mel":
        fb[0] = 0.0
    return fb


def filterbank(cfg: dict) -> np.ndarray:
    """The configuration's mel filterbank [n_fft // 2 + 1, n_mels]."""
    s = settings(cfg)
    return htk_filterbank(cfg["n_fft"] // 2 + 1, cfg["n_mels"], cfg["sample_rate"],
                          s["f_min"], s["f_max"], s["triangles"])


def logmel(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[b, samples] waveform, already peak-normalised where the
    configuration says so -> [b, n_mels, mel_width]."""
    s = settings(cfg)
    n_fft, hop, win = cfg["n_fft"], cfg["hop_length"], s["win_length"]
    x = wav
    if s["center"]:
        x = torch.nn.functional.pad(wav[:, None, :], (win // 2, win // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, win, hop)                                     # [b, frames, win]
    n = torch.arange(win, dtype=torch.float64, device=wav.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win)).to(torch.float32)
    mag = torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs()        # [b, frames, freqs]
    fb = torch.as_tensor(filterbank(cfg), dtype=torch.float32, device=wav.device)
    mel = (mag @ fb).transpose(-1, -2)                                  # [b, mels, frames]
    if s["log"] == "log10_clamp":
        out = torch.clamp(torch.log10(mel + 1e-7), min=-4.0)
    elif s["log"] == "ln_offset":
        out = torch.log(mel + s["log_offset"])
    else:
        raise ValueError(f"log {s['log']!r}: 'log10_clamp' or 'ln_offset'")
    first = s["first_frame"]
    return out[..., first:first + cfg["mel_width"]]


def features(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[b, samples] waveform -> [b, n_mels, mel_width]: peak-normalised
    where the configuration says so, then ``logmel``."""
    if settings(cfg)["peak_normalize"]:
        wav = peak_normalize(wav)
    return logmel(wav, cfg)
