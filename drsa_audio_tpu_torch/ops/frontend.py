"""Waveform -> log-mel front-end and waveform utilities (the port of
drsa_audio_tpu.ops.frontend).

Pipeline: slice -> peak normalise -> |STFT| (matmul DFT by default) -> mel
-> log10(x + 1e-7) -> clamp at -4 -> crop time bins [1 : width + 1]: the
GTZAN and toy cases. A case of ``FRONTEND_PARAMS`` may state each step
otherwise (VGGish: no peak normalisation, 400-sample windows in a 512-point
DFT, uncentred frames, mel-linear bands from 125 to 7,500 Hz,
ln(mel + 0.01), frames [0 : 96]); ``FrontendConfig`` carries the keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from drsa_audio_tpu_torch.ops.mel import mel_scale
from drsa_audio_tpu_torch.ops.stft import stft, stft_mag_matmul, stft_magnitude
from drsa_audio_tpu_torch.utils.constants import FRONTEND_PARAMS


def round_down(value: float, decimals: int = 1) -> float:
    """Floor to ``decimals`` decimals."""
    factor = 10 ** decimals
    return math.floor(value * factor) / factor


def slice_hop_samples(slice_length: int, num_chunks: int, sample_rate: int) -> int:
    """Hop between evenly spaced slices of the first 29 s."""
    return int(round_down((29 - slice_length) / (num_chunks - 1), 1) * sample_rate)


def chunk_startpoints(slice_length: int, num_chunks: int, sample_rate: int) -> np.ndarray:
    """Startpoint (seconds) of each chunk that ``get_slices`` extracts."""
    if num_chunks == 1:
        return np.zeros(1)
    hop = slice_hop_samples(slice_length, num_chunks, sample_rate)
    return np.arange(num_chunks) * hop / sample_rate


def get_slices(wav: torch.Tensor, slice_length: int, num_chunks: int,
               sample_rate: int) -> torch.Tensor:
    """``num_chunks`` evenly spaced windows of the first 29 s of a
    [channels, time] waveform (its first channel): [num_chunks, 1, window]."""
    window = int(slice_length * sample_rate)
    if num_chunks == 1:
        return wav[None, :, :window]
    hop = slice_hop_samples(slice_length, num_chunks, sample_rate)
    idx = torch.as_tensor(np.arange(num_chunks)[:, None] * hop + np.arange(window)[None, :],
                          device=wav.device)
    return wav[:, :29 * sample_rate][0][idx][:, None, :]


def get_slice_at(wav: torch.Tensor, slice_length: int, start_point: float,
                 sample_rate: int) -> torch.Tensor:
    """One window at ``start_point`` seconds, over the last axis."""
    window = int(slice_length * sample_rate)
    start = int(start_point * sample_rate)
    # clamped as jax.lax.dynamic_slice clamps a window that runs past the end
    start = max(0, min(start, wav.shape[-1] - window))
    return wav[..., start:start + window]


def peak_normalize(wav: torch.Tensor) -> torch.Tensor:
    """Scale to [-1, 1] by max |amplitude| over the last dim. A silent clip
    passes through unchanged instead of becoming 0/0."""
    peak = wav.abs().amax(dim=-1, keepdim=True)
    return wav / torch.where(peak > 0, peak, torch.ones_like(peak))


def rms_normalize(wav: torch.Tensor, rms_db: float = 0.0) -> torch.Tensor:
    """Scale each slice to a target RMS in dB."""
    rms = 10.0 ** (rms_db / 20.0)
    n = wav.shape[-1]
    return wav * torch.sqrt((n * rms ** 2) / torch.sum(wav ** 2, dim=-1, keepdim=True))


def adjust_vol(reference_audio: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """Match the RMS loudness of ``audio`` to ``reference_audio``."""
    def rms(sig):
        return torch.sqrt(torch.mean(sig ** 2))
    return audio * torch.abs(rms(reference_audio) / rms(audio))


def minmax_normalize(mel: torch.Tensor, epsilon: float = 1e-7) -> torch.Tensor:
    """Per-spectrogram min/max scaling to [-1, 1]."""
    mel_min = mel.amin(dim=(-2, -1), keepdim=True)
    mel_max = mel.amax(dim=(-2, -1), keepdim=True)
    return 2.0 * ((mel - mel_min) / (mel_max - mel_min + epsilon)) - 1.0


class FrontendConfig(NamedTuple):
    """Static DSP parameters for one case (FRONTEND_PARAMS). The keys after
    ``num_chunks`` are the front-end's steps, each at the GTZAN path's
    default where the case leaves it out (``for_case`` fills the defaults
    that depend on the others): ``win_length`` samples a frame (n_fft),
    ``center`` (reflect padding), the mel bands' edges ``f_min`` (0) and
    ``f_max`` (sample_rate / 2) and ``triangles`` ("hz"), ``log``
    ("log10_clamp": log10(mel + 1e-7) clamped at -4; "ln_offset":
    ln(mel + ``log_offset``)), ``first_frame`` (1: frames first_frame ..
    first_frame + width - 1 kept), ``peak_normalize`` (true) and
    ``clip_samples`` (slice_length * sample_rate)."""
    sample_rate: int
    n_fft: int
    hop_length: int
    n_mels: int
    width: int
    slice_length: float
    num_chunks: int
    win_length: int | None = None
    center: bool = True
    f_min: float = 0.0
    f_max: float | None = None
    triangles: str = "hz"
    log: str = "log10_clamp"
    log_offset: float | None = None
    first_frame: int = 1
    peak_normalize: bool = True
    clip_samples: int | None = None

    @classmethod
    def for_case(cls, case: str) -> "FrontendConfig":
        p = FRONTEND_PARAMS[case]
        sr = p["sample_rate"]
        return cls(sample_rate=sr, n_fft=p["n_fft"],
                   hop_length=p["hop_length"], n_mels=p["n_mels"],
                   width=p["mel_width"], slice_length=p["slice_length"],
                   num_chunks=p["num_chunks"], win_length=p.get("win_length", p["n_fft"]),
                   center=p.get("center", True), f_min=p.get("f_min", 0.0),
                   f_max=p.get("f_max", sr / 2.0), triangles=p.get("triangles", "hz"),
                   log=p.get("log", "log10_clamp"), log_offset=p.get("log_offset"),
                   first_frame=p.get("first_frame", 1),
                   peak_normalize=p.get("peak_normalize", True),
                   clip_samples=p.get("clip_samples",
                                      int(round(p["slice_length"] * sr))))


def logmel(wav: torch.Tensor, config: FrontendConfig,
           use_matmul_dft: bool = True) -> torch.Tensor:
    """[..., time] waveform -> [..., n_mels, width] log-mel spectrogram. The
    matmul DFT is the default; ``use_matmul_dft=False`` takes the FFT (the
    default framing only)."""
    if use_matmul_dft:
        mag = stft_mag_matmul(wav, config.n_fft, config.hop_length, config.win_length,
                              config.center)
    elif config.win_length in (None, config.n_fft) and config.center:
        mag = stft_magnitude(wav, config.n_fft, config.hop_length)
    else:
        raise ValueError("logmel: the FFT path takes only centred frames of n_fft samples")
    mel = mel_scale(mag, config.n_mels, config.sample_rate, config.f_min, config.f_max,
                    config.triangles)
    if config.log == "log10_clamp":
        out = torch.clamp(torch.log10(mel + 1e-7), min=-4.0)
    elif config.log == "ln_offset":
        out = torch.log(mel + config.log_offset)
    else:
        raise ValueError(f"logmel: log {config.log!r} is not 'log10_clamp' or 'ln_offset'")
    return out[..., config.first_frame:config.first_frame + config.width]


def logmel_full(wav: torch.Tensor, config: FrontendConfig):
    """(magnitude, phase, mel) with time cropped to [:width], for
    sonification round trips; phase is complex, spec / max(|spec|, 1e-16)."""
    spec = stft(wav, config.n_fft, config.hop_length)
    mag = spec.abs()
    phase = spec / torch.clamp(mag, min=1e-16)
    mel = mel_scale(mag, config.n_mels, config.sample_rate)
    w = config.width
    return mag[..., :w], phase[..., :w], mel[..., :w]


def load_clip_to_mels(wav: torch.Tensor, config: FrontendConfig, startpoint: float = 0.0,
                      num_chunks: int | None = None) -> torch.Tensor:
    """Slice -> peak normalise -> log-mel of one decoded clip [channels,
    time]: [num_chunks, 1, n_mels, width]."""
    num_chunks = config.num_chunks if num_chunks is None else num_chunks
    if config.slice_length != 0:
        if num_chunks > 1:
            sl = get_slices(wav, config.slice_length, num_chunks, config.sample_rate)
        else:
            sl = get_slice_at(wav, config.slice_length, startpoint, config.sample_rate)[None]
    else:
        sl = wav[None]
    mels = logmel(peak_normalize(sl) if config.peak_normalize else sl, config)
    return mels.reshape(-1, 1, config.n_mels, config.width)
