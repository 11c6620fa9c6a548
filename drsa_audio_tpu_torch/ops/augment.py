"""Waveform and spectrogram augmentations over a batch, with static shapes
(the port of drsa_audio_tpu.ops.augment).

Every function takes a batch [..., time] (or [..., freq, time]) and its
parameters per example, as tensors of the batch's leading shape (or Python
scalars for all). Randomness is not drawn here: ``add_noise`` takes its
standard-normal noise and ``reverb`` its impulse response's noise, and the
masks and ``adjust_size`` their positions; the samplers of models.train
draw them from a ``torch.Generator``.

Static shapes as in the JAX package: the phase vocoder returns a fixed
``out_frames`` and a valid-frame count per example; ``pitch_shift`` keeps
the input's length (2 * frames + 2 stretched frames, then resampled back);
the reverb's FFT length is the next power of two of time + impulse length.
The biquads apply their transfer function in the FFT domain (circular),
the reverb is a synthetic exponential-decay noise response, and the pitch
shift a phase-vocoder stretch plus linear resample, as there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from drsa_audio_tpu_torch.ops.stft import istft, stft


def _per_example(v, like: torch.Tensor, lead: tuple, dtype=None) -> torch.Tensor:
    """``v`` (a scalar or a tensor of shape ``lead``) as a tensor on
    ``like``'s device, broadcastable over ``lead``."""
    dtype = like.dtype if dtype is None else dtype
    return torch.as_tensor(v, dtype=dtype, device=like.device).expand(lead)


# ---------------------------------------------------------------- waveform

def gain_db(wav: torch.Tensor, db) -> torch.Tensor:
    """Gain in dB."""
    db = _per_example(db, wav, wav.shape[:-1])
    return wav * torch.pow(10.0, db / 20.0)[..., None]


def add_noise(wav: torch.Tensor, noise: torch.Tensor, noise_std_ratio) -> torch.Tensor:
    """wav + noise * (ratio * std(wav)), ``noise`` standard normal of wav's
    shape; the population std over time."""
    std = torch.std(wav, dim=-1, correction=0, keepdim=True)
    ratio = _per_example(noise_std_ratio, wav, wav.shape[:-1])[..., None]
    return wav + noise * (ratio * std)


def delay(wav: torch.Tensor, delay_ms, sample_rate: int, volume_factor: float = 0.5):
    """wav plus a copy delayed by ``delay_ms`` (integer ms) and scaled by
    ``volume_factor``."""
    n = wav.shape[-1]
    ms = _per_example(delay_ms, wav, wav.shape[:-1], torch.int64)
    shift = (ms * sample_rate) // 1000
    t = torch.arange(n, device=wav.device)
    src = torch.remainder(t - shift[..., None], n)
    delayed = torch.gather(wav, -1, src)
    mask = (t >= shift[..., None]).to(wav.dtype)
    return wav + volume_factor * delayed * mask


def reverb_length(sample_rate: int, decay_s: float = 0.3) -> int:
    """Samples of ``reverb``'s impulse response."""
    return int(decay_s * sample_rate)


def reverb(wav: torch.Tensor, ir_noise: torch.Tensor, sample_rate: int, decay_s: float = 0.3,
           wet: float = 0.3) -> torch.Tensor:
    """Synthetic reverb: the impulse response is ``ir_noise`` (standard
    normal, [..., reverb_length]) under an exponential decay, normalised to
    unit energy, convolved through the FFT."""
    ir_len = reverb_length(sample_rate, decay_s)
    t = torch.arange(ir_len, dtype=wav.dtype, device=wav.device) / sample_rate
    ir = ir_noise * torch.exp(-6.0 * t / decay_s)
    ir = ir / torch.sqrt(torch.sum(ir ** 2, dim=-1, keepdim=True) + 1e-9)
    n = wav.shape[-1]
    fft_len = int(2 ** np.ceil(np.log2(n + ir_len)))
    W = torch.fft.rfft(wav, fft_len)
    H = torch.fft.rfft(ir, fft_len)
    wet_sig = torch.fft.irfft(W * H, fft_len)[..., :n]
    return (1 - wet) * wav + wet * wet_sig


def _biquad_coeffs_lowpass(cutoff, sample_rate, Q=0.707):
    w0 = 2 * math.pi * cutoff / sample_rate
    alpha = torch.sin(w0) / (2 * Q)
    cos_w0 = torch.cos(w0)
    b0 = (1 - cos_w0) / 2
    b1 = 1 - cos_w0
    b2 = (1 - cos_w0) / 2
    a0 = 1 + alpha
    a1 = -2 * cos_w0
    a2 = 1 - alpha
    return (b0, b1, b2), (a0, a1, a2)


def _biquad_coeffs_highpass(cutoff, sample_rate, Q=0.707):
    w0 = 2 * math.pi * cutoff / sample_rate
    alpha = torch.sin(w0) / (2 * Q)
    cos_w0 = torch.cos(w0)
    b0 = (1 + cos_w0) / 2
    b1 = -(1 + cos_w0)
    b2 = (1 + cos_w0) / 2
    a0 = 1 + alpha
    a1 = -2 * cos_w0
    a2 = 1 - alpha
    return (b0, b1, b2), (a0, a1, a2)


def _apply_biquad_fft(wav: torch.Tensor, coeffs) -> torch.Tensor:
    """A biquad's transfer function applied in the frequency domain; each
    coefficient a tensor of wav's leading shape."""
    (b0, b1, b2), (a0, a1, a2) = ([c[..., None] for c in cs] for cs in coeffs)
    n = wav.shape[-1]
    W = torch.fft.rfft(wav, n)
    w = 2 * math.pi * (torch.arange(n // 2 + 1, dtype=wav.dtype, device=wav.device) / n)
    z1 = torch.exp(-1j * w)
    z2 = z1 * z1
    H = (b0 + b1 * z1 + b2 * z2) / (a0 + a1 * z1 + a2 * z2)
    return torch.fft.irfft(W * H, n)


def _cutoff(cutoff, wav):
    return _per_example(cutoff, wav, wav.shape[:-1])


def lowpass(wav: torch.Tensor, cutoff, sample_rate: int) -> torch.Tensor:
    return _apply_biquad_fft(wav, _biquad_coeffs_lowpass(_cutoff(cutoff, wav), sample_rate))


def highpass(wav: torch.Tensor, cutoff, sample_rate: int) -> torch.Tensor:
    return _apply_biquad_fft(wav, _biquad_coeffs_highpass(_cutoff(cutoff, wav), sample_rate))


def low_or_highpass(wav: torch.Tensor, use_low, low_cutoff, high_cutoff,
                    sample_rate: int) -> torch.Tensor:
    """``lowpass`` where ``use_low``, else ``highpass``, per example: the
    chosen filter's coefficients through one FFT."""
    use_low = _per_example(use_low, wav, wav.shape[:-1], torch.bool)
    low = _biquad_coeffs_lowpass(_cutoff(low_cutoff, wav), sample_rate)
    high = _biquad_coeffs_highpass(_cutoff(high_cutoff, wav), sample_rate)
    coeffs = tuple(tuple(torch.where(use_low, lc, hc) for lc, hc in zip(ls, hs))
                   for ls, hs in zip(low, high))
    return _apply_biquad_fft(wav, coeffs)


# ---------------------------------------------------------- phase vocoder

def _stretch_frames(n_time: int, rate: torch.Tensor, out_frames: int):
    """Per example, the frames that a stretch by ``rate`` reads: (valid
    [..., out], alphas, idx0, idx1) for out = ``out_frames``; idx1 may point
    at the first of two zero frames past the end."""
    steps = torch.arange(out_frames, dtype=rate.dtype, device=rate.device) * rate[..., None]
    valid = steps < n_time
    alphas = torch.remainder(steps, 1.0)
    idx0 = torch.clamp(steps.to(torch.int32), 0, n_time - 1).long()
    idx1 = torch.clamp(idx0 + 1, 0, n_time)
    return valid, alphas, idx0, idx1


def _take_frames(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., freq, time], idx [..., out] -> [..., freq, out]."""
    return torch.gather(x, -1, idx[..., None, :].expand(*x.shape[:-1], idx.shape[-1]))


def _pad_frames(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype, device=x.device)], -1)


def _phase_advance(n_freq: int, hop_length: int, device) -> torch.Tensor:
    """linspace(0, pi * hop, n_freq), [n_freq, 1], with the JAX package's
    float32 bits: XLA computes jnp.linspace's entries as (stop * (1 /
    (n - 1))) * i, the last one stop."""
    stop = np.float32(np.pi * hop_length)
    adv = (stop * (np.float32(1) / np.float32(n_freq - 1))) * np.arange(n_freq, dtype=np.float32)
    adv[-1] = stop
    return torch.as_tensor(adv, device=device)[:, None]


def phase_vocoder(spec: torch.Tensor, rate, hop_length: int, out_frames: int):
    """Complex time stretch (torchaudio's phase_vocoder) to a static
    ``out_frames``: spec [..., freq, time] complex, ``rate`` per example
    (> 1 speeds up). Frames past ceil(time / rate) carry zero magnitude.
    Returns (stretched [..., freq, out_frames], valid frames int32 [...])."""
    n_freq, n_time = spec.shape[-2], spec.shape[-1]
    rate = _per_example(rate, spec.real, spec.shape[:-2])
    valid, alphas, idx0, idx1 = _stretch_frames(n_time, rate, out_frames)
    specp = _pad_frames(spec)
    norm, angle = specp.abs(), specp.angle()
    norm_0, norm_1 = _take_frames(norm, idx0), _take_frames(norm, idx1)
    angle_0, angle_1 = _take_frames(angle, idx0), _take_frames(angle, idx1)

    # The phase arithmetic runs in float64 and the sum is reduced mod 2 pi
    # before it is rounded to float32: the sum runs to ~3e5 rad, where a
    # float32 step is 0.03 rad and its bits would follow the summation
    # order, which differs between the CPU, the card and XLA. The JAX
    # package sums in float32 (up to 0.05 rad off at the top bins).
    advance = _phase_advance(n_freq, hop_length, spec.device).double()
    phase = angle_1.double() - angle_0.double() - advance
    phase = phase - 2 * math.pi * torch.round(phase / (2 * math.pi))
    phase = phase + advance
    phase = torch.cat([angle[..., :1].double(), phase[..., :-1]], dim=-1)
    phase_acc = torch.remainder(torch.cumsum(phase, dim=-1), 2 * math.pi).to(spec.real.dtype)

    a = alphas[..., None, :]
    mag = a * norm_1 + (1 - a) * norm_0
    mag = mag * valid[..., None, :].to(mag.dtype)
    return torch.polar(mag, phase_acc), valid.sum(-1, dtype=torch.int32)


def stretch_magnitude(mag: torch.Tensor, rate, out_frames: int):
    """|phase_vocoder(spec, rate, ...)| from mag = |spec| [..., freq, time]
    alone: the stretch's magnitude does not depend on the phases. Returns
    (stretched magnitude [..., freq, out_frames], valid frames int32)."""
    n_time = mag.shape[-1]
    rate = _per_example(rate, mag, mag.shape[:-2])
    valid, alphas, idx0, idx1 = _stretch_frames(n_time, rate, out_frames)
    magp = _pad_frames(mag)
    a = alphas[..., None, :]
    out = a * _take_frames(magp, idx1) + (1 - a) * _take_frames(magp, idx0)
    return out * valid[..., None, :].to(out.dtype), valid.sum(-1, dtype=torch.int32)


def linear_resample(wav: torch.Tensor, factor, out_len: int):
    """Resample by linear interpolation to a static ``out_len``, zero past
    the valid region; ``factor`` > 1 reads faster. Returns (out, valid
    samples int32)."""
    n = wav.shape[-1]
    factor = _per_example(factor, wav, wav.shape[:-1])
    pos = torch.arange(out_len, dtype=wav.dtype, device=wav.device) * factor[..., None]
    valid = pos < (n - 1)
    i0 = torch.clamp(pos.to(torch.int32), 0, n - 2).long()
    frac = pos - i0
    lo = torch.gather(wav, -1, i0)
    hi = torch.gather(wav, -1, i0 + 1)
    out = lo * (1 - frac) + hi * frac
    return out * valid.to(out.dtype), valid.sum(-1, dtype=torch.int32)


def pitch_shift(wav: torch.Tensor, semitones, n_fft: int, hop_length: int) -> torch.Tensor:
    """Pitch shift by ``semitones`` (per example, in [-12, 12]): a
    phase-vocoder stretch by 2^(-semitones/12), then a resample back to the
    input's length."""
    n = wav.shape[-1]
    # the rate in float64, rounded once: the stretch reads frame floor(k *
    # rate), so a rate an ulp apart (float32 pow differs by device) would
    # pair other frames
    semis = _per_example(semitones, wav, wav.shape[:-1], torch.float64)
    rate = torch.pow(2.0, -semis / 12.0).to(wav.dtype)
    spec = stft(wav, n_fft, hop_length)
    out_frames = int(2 * spec.shape[-1]) + 2      # rate 0.5 at +12: twice the frames
    stretched, _ = phase_vocoder(spec, rate, hop_length, out_frames)
    stretched_wav = istft(stretched, n_fft, hop_length)
    out, _ = linear_resample(stretched_wav, 1.0 / rate, n)
    return out


# --------------------------------------------------------------- mel masks

def _band(n: int, start, count, like: torch.Tensor) -> torch.Tensor:
    """[..., n] float: 0 inside [start, start + count), 1 outside."""
    i = torch.arange(n, device=like.device)
    start, count = start[..., None], count[..., None]
    return (~((i >= start) & (i < start + count))).to(like.dtype)


def time_freq_mask(mel: torch.Tensor, n_rows, row0, n_cols, col0) -> torch.Tensor:
    """SpecAugment: one band of rows and one of columns zeroed, at each
    example's positions. mel [..., h, w]; positions of mel's leading shape."""
    h, w = mel.shape[-2], mel.shape[-1]
    lead = mel.shape[:-2]
    n_rows, row0, n_cols, col0 = (_per_example(v, mel, lead, torch.int64)
                                  for v in (n_rows, row0, n_cols, col0))
    return mel * _band(h, row0, n_rows, mel)[..., :, None] * _band(w, col0, n_cols, mel)[..., None, :]


def single_mask(mel: torch.Tensor, choose_rows, n_r, r0, n_c, c0) -> torch.Tensor:
    """The toy augmentation: one band zeroed, of rows where ``choose_rows``,
    else of columns."""
    h, w = mel.shape[-2], mel.shape[-1]
    lead = mel.shape[:-2]
    n_r, r0, n_c, c0 = (_per_example(v, mel, lead, torch.int64) for v in (n_r, r0, n_c, c0))
    choose_rows = _per_example(choose_rows, mel, lead, torch.bool)
    masked_rows = mel * _band(h, r0, n_r, mel)[..., :, None]
    masked_cols = mel * _band(w, c0, n_c, mel)[..., None, :]
    return torch.where(choose_rows[..., None, None], masked_rows, masked_cols)


def adjust_size(mel: torch.Tensor, target_width: int, valid_width, insert_draw) -> torch.Tensor:
    """Pad or crop the time axis to ``target_width``, the valid columns
    placed at insert = insert_draw % (room + 1), room = max(target - valid,
    0); zeros around them. mel [..., h, w_max], zero from ``valid_width`` on;
    ``insert_draw`` a non-negative integer per example."""
    w_max = mel.shape[-1]
    lead = mel.shape[:-2]
    valid_width = _per_example(valid_width, mel, lead, torch.int64)
    insert_draw = _per_example(insert_draw, mel, lead, torch.int64)
    pad_room = torch.clamp(target_width - valid_width, min=0)
    insert = torch.remainder(insert_draw, pad_room + 1)
    cols = torch.arange(target_width, device=mel.device)
    src = cols - insert[..., None]
    take = (src >= 0) & (src < torch.clamp(valid_width, max=w_max)[..., None])
    src = torch.clamp(src, 0, w_max - 1)
    out = torch.gather(mel, -1, src[..., None, :].expand(*mel.shape[:-1], target_width))
    return out * take[..., None, :].to(mel.dtype)
