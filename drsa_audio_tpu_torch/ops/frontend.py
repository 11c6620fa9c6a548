"""Waveform -> log-mel front-end (the port of drsa_audio_tpu.ops.frontend).

Pipeline: peak normalise -> |STFT| (matmul DFT) -> mel -> log10(x + 1e-7)
-> clamp at -4 -> crop time bins [1 : width + 1].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from drsa_audio_tpu_torch.ops.mel import mel_scale
from drsa_audio_tpu_torch.ops.stft import stft_mag_matmul
from drsa_audio_tpu_torch.utils.constants import AUDIO_PARAMS


def peak_normalize(wav: torch.Tensor) -> torch.Tensor:
    """Scale to [-1, 1] by max |amplitude| over the last dim. A silent clip
    passes through unchanged instead of becoming 0/0."""
    peak = wav.abs().amax(dim=-1, keepdim=True)
    return wav / torch.where(peak > 0, peak, torch.ones_like(peak))


class FrontendConfig(NamedTuple):
    """Static DSP parameters for one case (AUDIO_PARAMS)."""
    sample_rate: int
    n_fft: int
    hop_length: int
    n_mels: int
    width: int
    slice_length: int
    num_chunks: int

    @classmethod
    def for_case(cls, case: str) -> "FrontendConfig":
        p = AUDIO_PARAMS[case]
        return cls(sample_rate=p["sample_rate"], n_fft=p["n_fft"],
                   hop_length=p["hop_length"], n_mels=p["n_mels"],
                   width=p["mel_width"], slice_length=p["slice_length"],
                   num_chunks=p["num_chunks"])


def logmel(wav: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """[..., time] waveform -> [..., n_mels, width] log-mel spectrogram."""
    mag = stft_mag_matmul(wav, config.n_fft, config.hop_length)
    mel = mel_scale(mag, config.n_mels, config.sample_rate)
    out = torch.clamp(torch.log10(mel + 1e-7), min=-4.0)
    return out[..., 1:config.width + 1]
