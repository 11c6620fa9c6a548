"""Heatmap sonification (the port of drsa_audio_tpu.xai.sonify.mel2audio):
mask the mel with the blurred, thresholded heatmap, invert the mel to a
magnitude STFT by projected-gradient NNLS, apply the original phase, and
inverse-STFT.

Plain torch on the caller's device (``Mel2Audio(device=...)``: CUDA unless
named, raising where there is none): the blur is one F.conv2d, the NNLS 80
small matmul steps, the iSTFT irfft and an overlap-add (ops.stft.istft).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from drsa_audio_tpu_torch.ops.frontend import (
    FrontendConfig, adjust_vol, get_slice_at, logmel_full, peak_normalize)
from drsa_audio_tpu_torch.ops.mel import mel_filterbank
from drsa_audio_tpu_torch.ops.stft import istft
from drsa_audio_tpu_torch.utils.device import resolve_device


def gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """2D Gaussian blur of the last two axes with reflect padding
    (torchvision.transforms.GaussianBlur semantics, reference
    audiogen.py:49)."""
    k1 = gaussian_kernel1d(size, sigma)
    k2 = torch.as_tensor(np.outer(k1, k1), device=img.device)
    pad = size // 2
    x = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(x, k2[None, None]).reshape(img.shape)


def generate_mask(heatmap: torch.Tensor, percentile: float | None = 50,
                  blur_size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """ReLU -> zero at or below the ``percentile``-th percentile (linear
    interpolation, as jnp.percentile) -> Gaussian blur (reference
    audiogen.py:172-192)."""
    pos = torch.clamp(heatmap, min=0.0)
    if percentile:
        thresh = torch.quantile(pos, percentile / 100.0)
        pos = pos * (pos > thresh)
    return gaussian_blur(pos, blur_size, sigma)


def mel_to_stft_nnls(mel: torch.Tensor, fb: torch.Tensor, iters: int = 80,
                     power: float = 1.0) -> torch.Tensor:
    """Find S >= 0 with fb^T S ~= mel: mel [n_mels, t], fb [n_freq, n_mels]
    -> magnitude [n_freq, t]. Projected gradient from the clamped transpose
    solution, step 1/L with L the largest absolute row sum of A^T A (a bound
    on its largest eigenvalue); replaces librosa's mel_to_stft (reference
    audiogen.py:136-143)."""
    A = fb.T                                   # [n_mels, n_freq]
    S = torch.clamp(A.T @ mel, min=0.0)
    step = 1.0 / (A.T @ A).abs().sum(dim=1).max()
    for _ in range(iters):
        S = torch.clamp(S - step * (A.T @ (A @ S - mel)), min=0.0)
    if power != 1.0:
        S = S ** (1.0 / power)
    return S


class Mel2Audio:
    """Waveforms from (masked) mel spectrograms (reference Mel2Audio,
    audiogen.py:15-206); Mel2AudioToy is the same class with case='toy'.
    Inputs may be numpy arrays or tensors; results are tensors on
    ``device``, and make_audios returns numpy arrays."""

    def __init__(self, case: str = "gtzan", blur_kernel: int = 5, sigma: float = 1.0,
                 nnls_iters: int = 80, device=None):
        self.device = resolve_device(device, "Mel2Audio")
        self.config = FrontendConfig.for_case(case)
        self.blur_kernel = blur_kernel
        self.sigma = sigma
        self.nnls_iters = nnls_iters
        self.fb = torch.as_tensor(mel_filterbank(
            self.config.n_fft // 2 + 1, self.config.n_mels, self.config.sample_rate),
            device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def transform_audio(self, wav):
        """wav -> (mel, complex phase) of the clip (audiogen.py:148-158)."""
        _, phase, mel = logmel_full(self._tensor(wav).float(), self.config)
        return mel.squeeze(), phase.squeeze()

    def _invert(self, mel: torch.Tensor, phase) -> torch.Tensor:
        mag = mel_to_stft_nnls(mel, self.fb, self.nnls_iters)
        spec = mag * self._tensor(phase)
        return istft(spec[None], self.config.n_fft, self.config.hop_length)[0]

    def transform(self, heatmap, orig_mel, phase, percentile=50) -> torch.Tensor:
        """Mask the mel with the blurred thresholded heatmap -> NNLS ->
        phase -> iSTFT (audiogen.py:114-146)."""
        mask = generate_mask(self._tensor(heatmap).squeeze(), percentile, self.blur_kernel,
                             self.sigma)
        return self._invert(self._tensor(orig_mel) * mask, phase)

    def transform_audio_from_file(self, path_to_sample: str, startpoint: float | None = None):
        """Decode a clip (runtime.loader, the native decoder), slice it at
        ``startpoint`` seconds, and return (mel, phase) (audiogen.py:160-170).
        The file must be at the case's sample rate."""
        from drsa_audio_tpu_torch.runtime.loader import load_audio
        wav, sr = load_audio(path_to_sample)
        if sr != self.config.sample_rate:
            raise ValueError(f"{path_to_sample}: {sr} Hz, the {self.config.sample_rate} Hz "
                             "of this case expected")
        wav = self._tensor(wav[0])
        if startpoint is not None and self.config.slice_length:
            wav = get_slice_at(wav, self.config.slice_length, startpoint,
                               self.config.sample_rate)
        return self.transform_audio(wav)

    def transform_mel(self, mel, phase) -> torch.Tensor:
        """Invert an unmasked mel, the round-trip check (audiogen.py:194-206)."""
        return self._invert(self._tensor(mel), phase)

    def make_audios(self, sample_info, original_audio, num_concepts: int = 4,
                    percentile: float = 50, sample_idx: int = 0) -> list:
        """The standard and K subspace explanation audios of one clip,
        peak-normalised and loudness-matched to the original
        (audiogen.py:53-112); the standard map is thresholded at the 50th
        percentile whatever ``percentile`` is, as in the reference."""
        original = peak_normalize(self._tensor(original_audio).float().reshape(-1))
        mel, phase = self.transform_audio(original)
        std_map = sample_info["standard_heatmaps"][sample_idx]
        wavs = [self.transform(std_map, mel, phase, percentile=50)]
        for k in range(num_concepts):
            wavs.append(self.transform(sample_info["subspace_heatmaps"][sample_idx][k], mel,
                                       phase, percentile=percentile))
        return [adjust_vol(original, peak_normalize(w)).cpu().numpy() for w in wavs]


Mel2AudioToy = functools.partial(Mel2Audio, case="toy")
