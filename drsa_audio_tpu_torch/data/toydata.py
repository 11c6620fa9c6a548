"""Synthetic 2-class toy dataset with known ground-truth concepts (the
port's copy of drsa_audio_tpu.data.toydata, numpy only; a test holds the two
bit-equal).

Deterministic, seeded re-implementation of the reference generator notebook
(dataprep/toydata/generate_toydata.ipynb, cells 2/5/15/27-28). Each 1 s
@16 kHz sample is a random superposition of 1-4 class-specific concepts
(p = [.5, .2, .2, .1]):

  concept 1  amplitude-modulated low band 100-150 Hz ("drum" rhythm; class 1
             additionally gates the modulation with a slow square mask)
  concept 2  sawtooth-enveloped 500-600 Hz tone, envelope ramp direction
             opposite between classes
  concept 3  class 1: harmonic tone 800-1000 Hz with slow modulation;
             class 2: frequency-alternating melody
  concept 4  high band: class 1 3500-4000 Hz, class 2 4000-4500 Hz pulses

plus 3-5 exponentially-distributed distractor sinusoids avoiding the concept
bands, and Gaussian noise (strength 0.01). These known concepts are the
ground truth DRSA is expected to recover — the framework's primary
end-to-end fixture (SURVEY.md §4).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

N = 16000
SAMPLE_RATE = 16000
_n = np.arange(N)

CLASS_PARAMS = {
    "class1": {
        "concept1": {"f_range": [100, 150], "f_amp": [16]},
        "concept2": {"f_range": [500, 600], "f_saw": [2], "direction": 1},
        "concept3": {"f_range": [800, 1000], "f_amp": [3, 6]},
        "concept4": {"f_range": [3500, 4000], "f_amp": [20]},
    },
    "class2": {
        "concept1": {"f_range": [100, 150], "f_amp": [4, 5]},
        "concept2": {"f_range": [500, 600], "f_saw": [2], "direction": -1},
        "concept3": {"f_range": [800, 1000], "f_amp": [16]},
        "concept4": {"f_range": [4000, 4500], "f_amp": [10]},
    },
}

RANDOM_CONCEPTS = {"f_amp": [40, 100]}
EXP_SCALE = 2000.0  # mean distractor frequency (Hz)


def _relu(x):
    return x * (x > 0)


def _norm(sig):
    return sig / np.abs(sig).max()


class _Rand:
    """Seeded sampling helpers mirroring the notebook's random draws."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def phase(self, lo=0.0, hi=2 * np.pi):
        return self.rng.uniform(lo, hi)

    def amp(self, lo=0.6, hi=1.0):
        return self.rng.uniform(lo, hi)

    def pick(self, range_):
        if len(range_) > 1:
            return int(self.rng.integers(range_[0], range_[1] + 2))
        return int(range_[0])


def _sinusoid(r: _Rand, freq):
    return r.amp() * np.sin(2 * np.pi * _n * freq / N + r.phase())


def _modulating_amp(r: _Rand, f_amp, phase_amp, shift=0.0):
    return _relu(np.sin(2 * np.pi * _n * f_amp / N + phase_amp) + shift) / (shift + 1)


def _harmonic(r: _Rand, freq, harmonics=2):
    amp = r.amp()
    sig = amp * np.sin(2 * np.pi * _n * freq / N + r.phase())
    for h in range(1, harmonics + 1):
        sig += amp / (2 * h) * np.sin(2 * np.pi * _n * (freq * h) / N + r.phase())
    return sig


def _alternating(r: _Rand, freq, f_amp, phase_amp, mod_amp):
    sig = np.zeros(N)
    T = N // f_amp
    step = 200
    freqs = freq + np.concatenate([np.arange(0, 4) * step, np.arange(1, 3)[::-1] * step])
    s = int(r.rng.integers(0, max(f_amp // 2, 1)))
    for i in range(s, f_amp + 1):
        if i == s + 12:
            break
        bump = mod_amp * _sinusoid(r, freqs[i % 6])
        start = int((2 * i * np.pi - phase_amp) * T / (2 * np.pi))
        if start < 0 or start >= N:
            continue
        sig[start:start + T] = bump[start:start + T]
    return sig


def _sawtooth(t, width=1.0):
    """scipy.signal.sawtooth equivalent (rises -1..1 over each period)."""
    tmod = np.mod(t, 2 * np.pi) / (2 * np.pi)
    return np.where(tmod < width, 2 * tmod / width - 1,
                    1 - 2 * (tmod - width) / (1 - width + 1e-12))


def _smooth_attack(saw, direction, f_saw, phase, kernel=160):
    mask = np.arange(kernel) / kernel
    T = N / f_saw
    s1 = int((2 * np.pi - phase) * T / (2 * np.pi))
    if direction == -1:
        for i in range(f_saw):
            t0 = int(s1 + i * T)
            seg = saw[t0:t0 + kernel]
            saw[t0:t0 + kernel] = seg * mask[: len(seg)]
    else:
        for i in range(f_saw):
            t0 = int(s1 + i * T)
            lo = max(t0 - kernel + 3, 0)
            seg = saw[lo:t0 + 3]
            saw[lo:t0 + 3] = seg * mask[::-1][-len(seg):]
    return saw


def _sawtooth_amp(r: _Rand, f_saw_range, direction):
    f_saw = r.pick(f_saw_range)
    phase = r.phase(0.5, 2 * np.pi - 0.5)
    saw = (direction * _sawtooth(2 * np.pi * f_saw * _n / N + phase) + 1) / 2
    return _smooth_attack(saw, direction, f_saw, phase)


def _mask_modulating(r: _Rand, f_amp, phase_amp, f_mask=2):
    hi = max((f_amp // 2) - 1, 2)
    start_phase = (phase_amp + 2 * np.pi * r.rng.integers(1, hi)) / (f_amp / f_mask)
    return (np.sin(2 * np.pi * _n * f_mask / N + start_phase) >= 0) * 1.0


def generate_concept(r: _Rand, class_name: str, concept_idx: int) -> np.ndarray:
    """One isolated concept signal (for ground-truth fixtures)."""
    params = CLASS_PARAMS[class_name]
    if concept_idx == 1:
        p = params["concept1"]
        f_amp = r.pick(p["f_amp"])
        phase_amp = r.phase()
        mod = _modulating_amp(r, f_amp, phase_amp) * _sinusoid(r, r.pick(p["f_range"]))
        if class_name == "class1":
            return mod * _mask_modulating(r, f_amp, phase_amp)
        return mod
    if concept_idx == 2:
        p = params["concept2"]
        return _sawtooth_amp(r, p["f_saw"], p["direction"]) * _sinusoid(r, r.pick(p["f_range"]))
    if concept_idx == 3:
        p = params["concept3"]
        if class_name == "class1":
            mod = _modulating_amp(r, r.pick(p["f_amp"]), r.phase(), shift=3 / 4)
            return mod * _harmonic(r, r.pick(p["f_range"]))
        f_amp = r.pick(p["f_amp"])
        phase_amp = r.phase()
        mod = _modulating_amp(r, f_amp, phase_amp)
        return _alternating(r, r.pick(p["f_range"]), f_amp, phase_amp, mod)
    p = params["concept4"]
    return _sinusoid(r, r.pick(p["f_range"])) * _modulating_amp(
        r, r.pick(p["f_amp"]), r.phase(), shift=1.0)


def _exp_freq(r: _Rand, exclude_ranges, tolerance=50):
    while True:
        f = max(1, int(r.rng.exponential(EXP_SCALE)))
        if not any(lo - tolerance <= f <= hi + tolerance for lo, hi in exclude_ranges):
            return f


def add_random_distractors(r: _Rand, class_name: str, ns: int) -> np.ndarray:
    """3-5 distractor sinusoids from an exponential frequency distribution,
    avoiding the concept bands (notebook cell 15)."""
    params = CLASS_PARAMS[class_name]
    excludes = [tuple(params[f"concept{i}"]["f_range"]) for i in range(1, 5)]
    signal = np.zeros(N)
    for _ in range(ns):
        f = _exp_freq(r, excludes)
        s = r.rng.uniform(0.1, 1.0) * np.sin(2 * np.pi * _n * f / N + r.phase())
        if r.rng.integers(0, 3) == 1:
            s = s * _modulating_amp(r, r.pick(RANDOM_CONCEPTS["f_amp"]), r.phase(), shift=2.0)
        signal += s
    return signal


def generate_sample(rng: np.random.Generator, class_name: str,
                    concept_idcs: Sequence[int] | None = None,
                    noise_strength: float = 0.01):
    """One normalized toy sample. Returns (signal float32[16000], concepts)."""
    r = _Rand(rng)
    if concept_idcs is None:
        n_c = rng.choice(np.arange(1, 5), p=[0.5, 0.2, 0.2, 0.1])
        concept_idcs = rng.choice(np.arange(1, 5), size=n_c, replace=False)
    signal = np.zeros(N)
    for ci in concept_idcs:
        signal += generate_concept(r, class_name, int(ci))
    signal += add_random_distractors(r, class_name, ns=int(rng.integers(3, 6)))
    signal += noise_strength * rng.standard_normal(N)
    return _norm(signal).astype(np.float32), tuple(int(c) for c in concept_idcs)


def generate_dataset(
    out_dir: str,
    datapoints_per_class: int = 2000,
    seed: int = 42,
    noise_strength: float = 0.01,
    splits=(0.7, 0.1, 0.2),
):
    """Generate the full dataset on disk: WAV files + train/valid/test split
    lists + all4.txt (notebook cell 28). Returns the split dict."""
    from drsa_audio_tpu_torch.runtime.wavio import write_wav

    rng = np.random.default_rng(seed)
    names = {"class1": [], "class2": []}
    all4 = []
    for i in range(datapoints_per_class):
        for class_name in ("class1", "class2"):
            signal, concepts = generate_sample(rng, class_name,
                                               noise_strength=noise_strength)
            fname = f"{class_name}/{i + 1:05d}.wav"
            path = os.path.join(out_dir, fname)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_wav(path, signal, SAMPLE_RATE)
            names[class_name].append(fname)
            if len(concepts) == 4:
                all4.append(fname)

    split_lists = {"train": [], "valid": [], "test": []}
    for class_name in ("class1", "class2"):
        files = list(names[class_name])
        rng.shuffle(files)
        n = len(files)
        n_train = int(splits[0] * n)
        n_valid = int((splits[0] + splits[1]) * n)
        split_lists["train"].extend(files[:n_train])
        split_lists["valid"].extend(files[n_train:n_valid])
        split_lists["test"].extend(files[n_valid:])

    for split, items in split_lists.items():
        with open(os.path.join(out_dir, f"{split}_split.txt"), "w") as f:
            f.write("\n".join(items) + "\n")
    with open(os.path.join(out_dir, "all4.txt"), "w") as f:
        f.write("\n".join(all4) + "\n")
    return split_lists


def generate_batch(rng_or_seed, class_name: str, batch: int,
                   concept_idcs=None, noise_strength: float = 0.01):
    """In-memory batch of toy waveforms [batch, 16000] — the fast path for
    tests and benchmarks (no disk round trip)."""
    rng = (np.random.default_rng(rng_or_seed)
           if isinstance(rng_or_seed, (int, np.integer)) else rng_or_seed)
    sigs = [generate_sample(rng, class_name, concept_idcs, noise_strength)[0]
            for _ in range(batch)]
    return np.stack(sigs)
