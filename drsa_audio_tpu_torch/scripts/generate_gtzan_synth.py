"""Generate a GTZAN-shaped synthetic corpus for full-scale rehearsal, with
the port:

    python -m drsa_audio_tpu_torch.scripts.generate_gtzan_synth --out DIR [--multi-concept]

The real GTZAN audio is not distributable; this writes a corpus with the
exact GTZAN layout the data pipeline expects (reference dataloading.py:208-274:
``genres_original/{genre}/*.wav`` + ``5folds/fold_k.txt``) — 10 classes of
29.5 s 16 kHz clips with class-distinct spectral structure (per-genre
fundamental, harmonic decay, rhythm rate, noise band) plus shared distractors,
so a trained classifier and DRSA have real class evidence to find.

The flags of the JAX package's scripts/generate_gtzan_synth.py, plus
``--device``. Both recipes are that script's numpy code, drawn in the same
order, written by the port's ``write_wav``: the same seed writes the same
WAV bytes and fold lists. The device is resolved as every CLI of the port
resolves it (CUDA unless named, raising without a card); no work runs
there.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from drsa_audio_tpu_torch.runtime.wavio import write_wav
from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER

SR = 16000
DUR_S = 29.5


def genre_signature(g: int):
    """Deterministic per-genre spectral recipe."""
    return {
        # fundamentals spread over ~3 octaves, avoiding collisions
        "f0": 90.0 * 2.0 ** (g * 0.37),
        # harmonic amplitude decay (bright vs dark timbre)
        "decay": 0.5 + 0.09 * (g % 5),
        "n_harm": 3 + (g % 4),
        # amplitude-modulation rhythm rate in Hz
        "rhythm": 1.5 + 0.7 * g,
        "duty": 0.3 + 0.05 * (g % 3),
        # genre noise band (Hz)
        "band": (2000.0 + 450.0 * g, 2600.0 + 450.0 * g),
        # vibrato for odd genres
        "vibrato": 4.0 + g if g % 2 else 0.0,
    }


def synth_clip(g: int, rng: np.random.Generator) -> np.ndarray:
    sig = genre_signature(g)
    n = int(DUR_S * SR)
    t = np.arange(n) / SR

    # harmonic stack with per-song detune and slow amplitude wander
    f0 = sig["f0"] * (1.0 + rng.uniform(-0.03, 0.03))
    phase = rng.uniform(0, 2 * np.pi)
    vib = (np.sin(2 * np.pi * sig["vibrato"] * t) * 0.004 * f0
           if sig["vibrato"] else 0.0)
    tone = np.zeros(n)
    for h in range(1, sig["n_harm"] + 1):
        amp = sig["decay"] ** (h - 1)
        tone += amp * np.sin(2 * np.pi * (f0 * h + vib) * t
                             + phase * h + rng.uniform(0, 0.3))
    # rhythmic gating (the genre's "beat")
    rate = sig["rhythm"] * (1.0 + rng.uniform(-0.08, 0.08))
    beat = (np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi)) >
            (1.0 - 2 * sig["duty"]))
    gate = 0.25 + 0.75 * beat.astype(np.float64)
    tone *= gate

    # genre noise band via FFT masking
    lo, hi = sig["band"]
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1 / SR)
    spec[(freqs < lo) | (freqs > hi)] = 0.0
    band_noise = np.fft.irfft(spec, n)
    band_noise *= 0.35 / (np.abs(band_noise).max() + 1e-9)
    # band noise pulses on the off-beat
    band_noise *= (1.2 - gate)

    # shared distractors: 2-4 random sinusoids anywhere + noise floor
    distract = np.zeros(n)
    for _ in range(rng.integers(2, 5)):
        fd = rng.uniform(100, 6000)
        distract += rng.uniform(0.05, 0.15) * np.sin(
            2 * np.pi * fd * t + rng.uniform(0, 2 * np.pi))
    floor = 0.01 * rng.standard_normal(n)

    clip = tone / (np.abs(tone).max() + 1e-9) + band_noise + distract + floor
    clip = clip / (np.abs(clip).max() + 1e-9) * 0.9
    return clip.astype(np.float32)


# --------------------------------------------------- multi-concept recipe
#
# The v1 recipe gives each genre ONE dominant harmonic stack, so relevance
# concentrates in a single blob and subspace splitting cannot beat the
# standard map (runs/gtzan_synth/RESULTS.md). The multi-concept recipe mirrors the toy generator's design (reference
# dataprep/toydata/generate_toydata.ipynb cells 2/5): each genre owns FOUR
# spectrally and rhythmically disjoint concepts, each individually
# genre-discriminative, present stochastically per clip in random time
# segments — the ground-truth structure DRSA exists to recover.

def concept_bank(g: int):
    """Four disjoint concepts for genre g, parameters interleaved across
    genres so every concept band is genre-unique."""
    return [
        # 1) low harmonic stack (85-330 Hz fundamentals)
        {"kind": "harm", "f0": 85.0 * 2.0 ** (g * 0.21),
         "n_harm": 3 + g % 3, "decay": 0.55 + 0.04 * (g % 5)},
        # 2) mid-band melody: stepped tone sequence, genre rate + intervals
        {"kind": "melody", "base": 560.0 * 2.0 ** (g * 0.10),
         "rate": 1.8 + 0.45 * g, "steps": [0, 3, 7, 5, 10, 7][g % 4:][:4]},
        # 3) pulsed noise band (2-4.2 kHz, genre-unique band + pulse rate)
        {"kind": "noiseband", "band": (2050.0 + 210.0 * g, 2400.0 + 210.0 * g),
         "pulse": 1.3 + 0.5 * g},
        # 4) high pulse train / chirp (4.6-6.8 kHz)
        {"kind": "chirp", "f_lo": 4600.0 + 190.0 * g,
         "f_hi": 4900.0 + 190.0 * g, "rate": 2.5 + 0.9 * g},
    ]


def _segments_mask(n: int, rng, coverage=(0.5, 0.9)) -> np.ndarray:
    """Random on/off envelope: 2-4 smooth on-intervals covering 50-90%."""
    target = rng.uniform(*coverage)
    n_seg = rng.integers(2, 5)
    mask = np.zeros(n)
    seg_len = int(target * n / n_seg)
    for s in range(n_seg):
        start = rng.integers(0, max(1, n - seg_len))
        mask[start:start + seg_len] = 1.0
    # smooth edges (20 ms ramp) to avoid clicks
    ramp = int(0.02 * SR)
    kernel = np.ones(ramp) / ramp
    return np.convolve(mask, kernel, mode="same")


def render_concept(c: dict, t: np.ndarray, rng) -> np.ndarray:
    n = len(t)
    if c["kind"] == "harm":
        f0 = c["f0"] * (1.0 + rng.uniform(-0.02, 0.02))
        out = np.zeros(n)
        for h in range(1, c["n_harm"] + 1):
            out += c["decay"] ** (h - 1) * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    elif c["kind"] == "melody":
        rate = c["rate"] * (1.0 + rng.uniform(-0.06, 0.06))
        step_idx = (t * rate).astype(int) % len(c["steps"])
        semis = np.asarray(c["steps"])[step_idx]
        f = c["base"] * 2.0 ** (semis / 12.0)
        phase = 2 * np.pi * np.cumsum(f) / SR
        out = np.sin(phase + rng.uniform(0, 2 * np.pi))
    elif c["kind"] == "noiseband":
        lo, hi = c["band"]
        spec = np.fft.rfft(rng.standard_normal(n))
        freqs = np.fft.rfftfreq(n, 1 / SR)
        spec[(freqs < lo) | (freqs > hi)] = 0.0
        out = np.fft.irfft(spec, n)
        out /= np.abs(out).max() + 1e-9
        pulse = (np.sin(2 * np.pi * c["pulse"] * t
                        + rng.uniform(0, 2 * np.pi)) > 0.2).astype(float)
        out *= 0.3 + 0.7 * pulse
    else:                                   # chirp / high pulse train
        rate = c["rate"] * (1.0 + rng.uniform(-0.06, 0.06))
        frac = (t * rate) % 1.0
        f = c["f_lo"] + (c["f_hi"] - c["f_lo"]) * frac
        phase = 2 * np.pi * np.cumsum(f) / SR
        gate = (frac < 0.55).astype(float)
        out = np.sin(phase) * gate
    return out / (np.abs(out).max() + 1e-9)


def synth_clip_multi(g: int, rng: np.random.Generator) -> np.ndarray:
    """One clip = a random subset (>= 2) of the genre's four concepts, each
    active in random time segments, plus shared distractors."""
    n = int(DUR_S * SR)
    t = np.arange(n) / SR
    bank = concept_bank(g)
    active = rng.random(len(bank)) < 0.75
    while active.sum() < 2:
        active = rng.random(len(bank)) < 0.75
    clip = np.zeros(n)
    for c, on in zip(bank, active):
        if not on:
            continue
        level = rng.uniform(0.6, 1.0)
        clip += level * render_concept(c, t, rng) * _segments_mask(n, rng)
    # shared distractors: sinusoids + noise floor (genre-uninformative)
    for _ in range(rng.integers(2, 5)):
        fd = rng.uniform(100, 7000)
        clip += rng.uniform(0.04, 0.1) * np.sin(
            2 * np.pi * fd * t + rng.uniform(0, 2 * np.pi))
    clip += 0.01 * rng.standard_normal(n)
    clip = clip / (np.abs(clip).max() + 1e-9) * 0.9
    return clip.astype(np.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--songs-per-genre", type=int, default=15)
    ap.add_argument("--num-folds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--multi-concept", action="store_true",
                    help="4 stochastic disjoint concepts per genre "
                         "(toy-generator style) instead of the v1 "
                         "single-signature recipe")
    ap.add_argument("--device", help="torch device (default: CUDA, raising without a card)")
    args = ap.parse_args(argv)

    from drsa_audio_tpu_torch.utils.device import resolve_device
    resolve_device(args.device, "generate_gtzan_synth")

    synth = synth_clip_multi if args.multi_concept else synth_clip
    rng = np.random.default_rng(args.seed)
    folds = [[] for _ in range(args.num_folds)]
    for genre, g in CLASS_IDX_MAPPER.items():
        gdir = os.path.join(args.out, "genres_original", genre)
        os.makedirs(gdir, exist_ok=True)
        for i in range(args.songs_per_genre):
            clip = synth(g, rng)
            rel = f"{genre}/{genre}.{i:05d}.wav"
            write_wav(os.path.join(args.out, "genres_original", rel),
                      clip[None], SR)
            folds[i % args.num_folds].append(rel)
        print(f"{genre}: {args.songs_per_genre} clips")

    fold_dir = os.path.join(args.out, "5folds")
    os.makedirs(fold_dir, exist_ok=True)
    for k, lines in enumerate(folds, start=1):
        with open(os.path.join(fold_dir, f"fold_{k}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    print(f"corpus at {args.out}: {args.songs_per_genre * 10} clips, "
          f"{args.num_folds} folds")


if __name__ == "__main__":
    main()
