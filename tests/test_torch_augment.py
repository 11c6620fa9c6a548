"""The port's augmentations and augment + log-mel pipelines
(drsa_audio_tpu_torch.ops.augment, models.train) against the JAX package's,
on the CPU. JAX's keys cannot be reproduced by a torch.Generator, so each
test draws with JAX's keys in the JAX package's order and passes the draws
to the port (tests/test_torch_util.py jax_*_draws).

Tolerances, each stated at its test: float32 round-off of the same
arithmetic (rtol 1e-5 or 1e-6); the log-mel at the JAX package's own
tolerance (rtol 1e-4, atol 1e-4 in log10 units). Two measured exceptions:
the phase vocoder's phase sums, which the JAX package runs in float32
(0.03 rad a step at the ~3e5 rad they reach; the port sums in float64), and
a low/high-pass filter's stopband, whose bins sit 60-100 dB under the clip's
peak, where both packages' float32 FFT round-off (~1e-6 of the peak's
energy) is the whole value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.models import train as jtrain
from drsa_audio_tpu.ops import augment as jaug
from drsa_audio_tpu.ops.frontend import FrontendConfig as JFC
from drsa_audio_tpu.ops.stft import stft as jstft
from drsa_audio_tpu_torch.models import train as ttrain
from drsa_audio_tpu_torch.ops import augment as taug
from drsa_audio_tpu_torch.ops.frontend import FrontendConfig as TFC
from drsa_audio_tpu_torch.ops.stft import stft as tstft

from test_torch_util import jax_gtzan_draws, jax_toy_draws, torch_draws

SR = 16000


def _wavs(b=3, n=48000, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, n)) * 0.3).astype(np.float32)


def _keys(seed, b):
    return jax.random.split(jax.random.PRNGKey(seed), b)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    """rtol, atol atol_rel * max|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def test_gain_noise_delay_match_jax():
    """Gain (per-example dB), noise (JAX's normal draw passed in; the
    population std) and delay (integer shift): float32 round-off, rtol 1e-6,
    atol 1e-6 * max."""
    x = _wavs()
    keys = _keys(1, 3)
    db = np.asarray([jax.random.uniform(k, (), minval=-12.0, maxval=3.0) for k in keys])
    ratio = np.float32([1e-3, 3e-2, 1e-1])
    noise = np.stack([np.asarray(jax.random.normal(k, (x.shape[1],))) for k in keys])
    ms = np.int32([50, 123, 299])
    want_gain = jax.vmap(jaug.gain_db)(jnp.asarray(x), jnp.asarray(db))
    want_noise = jnp.stack([jaug.add_noise(jnp.asarray(x[i]), keys[i], ratio[i]) for i in range(3)])
    want_delay = jax.vmap(lambda w, m: jaug.delay(w, m, SR))(jnp.asarray(x), jnp.asarray(ms))
    _close(taug.gain_db(_t(x), _t(db)), want_gain, rtol=1e-6)
    _close(taug.add_noise(_t(x), _t(noise), _t(ratio)), want_noise, rtol=1e-6)
    _close(taug.delay(_t(x), _t(ms), SR), want_delay, rtol=1e-6)


def test_reverb_and_filters_match_jax():
    """The reverb's impulse response from JAX's normal draw, the low- and
    high-pass biquads at per-example cutoffs, and the per-example choice
    between them (one FFT): float32 FFT round-off, rtol 1e-5, atol 1e-6 *
    max."""
    x = _wavs()
    keys = _keys(2, 3)
    ir = np.stack([np.asarray(jax.random.normal(k, (taug.reverb_length(SR),))) for k in keys])
    want = jnp.stack([jaug.reverb(jnp.asarray(x[i]), keys[i], SR) for i in range(3)])
    _close(taug.reverb(_t(x), _t(ir), SR), want)
    low, high = np.float32([1400.0, 2500.0, 3999.0]), np.float32([200.0, 800.0, 1399.0])
    jl = jax.vmap(lambda w, c: jaug.lowpass(w, c, SR))(jnp.asarray(x), jnp.asarray(low))
    jh = jax.vmap(lambda w, c: jaug.highpass(w, c, SR))(jnp.asarray(x), jnp.asarray(high))
    _close(taug.lowpass(_t(x), _t(low), SR), jl)
    _close(taug.highpass(_t(x), _t(high), SR), jh)
    use_low = np.array([True, False, True])
    want = np.where(use_low[:, None], np.asarray(jl), np.asarray(jh))
    _close(taug.low_or_highpass(_t(x), _t(use_low), _t(low), _t(high), SR), want)


def _vocoder_f64(spec, rate, hop, out_frames):
    """torchaudio's phase vocoder in float64 numpy: the yardstick of the
    phase comparisons."""
    spec = spec.astype(np.complex128)
    n_freq, n_time = spec.shape
    advance = np.linspace(0, np.pi * hop, n_freq)[:, None]
    steps = np.arange(out_frames) * rate
    valid = steps < n_time
    alphas = np.mod(steps, 1.0)
    i0 = np.clip(steps.astype(int), 0, n_time - 1)
    i1 = np.clip(i0 + 1, 0, n_time)
    sp = np.concatenate([spec, np.zeros((n_freq, 2))], -1)
    phase = np.angle(sp[:, i1]) - np.angle(sp[:, i0]) - advance
    phase = phase - 2 * np.pi * np.round(phase / (2 * np.pi)) + advance
    phase = np.cumsum(np.concatenate([np.angle(spec[:, :1]), phase[:, :-1]], -1), -1)
    mag = (alphas * np.abs(sp[:, i1]) + (1 - alphas) * np.abs(sp[:, i0])) * valid
    return mag * np.exp(1j * phase)


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.2])
def test_phase_vocoder_matches_jax(rate):
    """Valid frame count equal; magnitudes rtol 1e-5, atol 1e-6 * max. The
    phase where |spec| >= 1e-2 max: the JAX package's float32 phase sums run
    to ~3e5 rad (0.03 rad a float32 step) and sit up to 0.048 rad from a
    float64 vocoder (measured), the port's float64 sums within 1e-3 rad of
    it; so the port within 0.1 rad of JAX and 1e-3 of float64."""
    x = _wavs(1)[0]
    spec = np.asarray(jstft(jnp.asarray(x), 800, 360))
    out_frames = int(spec.shape[-1] / 0.8) + 2
    jo, jv = jaug.phase_vocoder(jnp.asarray(spec), jnp.float32(rate), 360, out_frames)
    to, tv = taug.phase_vocoder(_t(spec)[None], torch.tensor([rate]), 360, out_frames)
    jo, to = np.asarray(jo), to[0].numpy()
    assert int(tv[0]) == int(jv)
    _close(np.abs(to), np.abs(jo))
    ref = _vocoder_f64(spec, np.float32(rate), 360, out_frames)
    big = np.abs(ref) >= 1e-2 * np.abs(ref).max()

    def phase_err(a, b):
        return np.abs(np.angle(a[big] / b[big])).max()
    assert phase_err(to, jo) <= 0.1
    assert phase_err(to, ref) <= 1e-3
    # the magnitude-only stretch of the GTZAN pipeline is |phase_vocoder|
    sm, sv = taug.stretch_magnitude(_t(np.abs(spec))[None], torch.tensor([rate]), out_frames)
    assert int(sv[0]) == int(jv)
    _close(sm[0], np.abs(jo))


def test_linear_resample_matches_jax():
    """Per-example factors; positions and weights in float32 as the JAX
    package's: rtol 1e-6, atol 1e-6 * max."""
    x = _wavs(3, 4000)
    f = np.float32([0.5, 1.0, 1.7])
    for i in range(3):
        jo, jv = jaug.linear_resample(jnp.asarray(x[i]), f[i], 3000)
        to, tv = taug.linear_resample(_t(x[i:i + 1]), _t(f[i:i + 1]), 3000)
        assert int(tv[0]) == int(jv)
        _close(to[0], jo, rtol=1e-6)


@pytest.mark.parametrize("semitones", [-12.0, 0.0, 7.0])
def test_pitch_shift_matches_jax(semitones):
    """Pitch shift of 3 s of noise. The JAX package's float32 phase sums
    put its output up to 7.3e-3 of the peak from a float64 run (measured),
    so the port against JAX at atol 1e-2 * max. Where the stretch rate and
    the resample factor are exact in float32 (-12 and 0 semitones), the
    port against its own float64 run at atol 1e-5 * max (3.3e-6 measured):
    the float64 phase sums leave only float32 round-off."""
    x = _wavs(2)
    s = np.float32([semitones, semitones])
    jo = jax.vmap(lambda w, v: jaug.pitch_shift(w, v, 800, 360))(jnp.asarray(x), jnp.asarray(s))
    to = taug.pitch_shift(_t(x), _t(s), 800, 360)
    assert to.shape == x.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-2 * np.abs(np.asarray(jo)).max())
    if semitones in (-12.0, 0.0):
        ref = taug.pitch_shift(_t(x).double(), _t(s).double(), 800, 360).numpy()
        np.testing.assert_allclose(to.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_masks_and_adjust_size_match_jax():
    """Both masks and adjust_size (pad and crop) at JAX's drawn positions:
    equal."""
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((4, 128, 170)).astype(np.float32)
    keys = _keys(4, 4)
    r = jax.random
    for i, k in enumerate(keys):
        k1, k2, k3, k4 = r.split(k, 4)
        pos = [r.randint(k1, (), 1, 21), r.randint(k2, (), 0, 128 - 20),
               r.randint(k3, (), 1, 41), r.randint(k4, (), 0, 170 - 40)]
        want = jaug.time_freq_mask(jnp.asarray(mel[i]), k, 40, 40)
        got = taug.time_freq_mask(_t(mel[i:i + 1]), *[_t([int(p)]) for p in pos])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
        kc, k1, k2 = r.split(k, 3)
        k3, k4 = r.split(kc)
        pos = [r.bernoulli(kc, 0.5), r.randint(k1, (), 1, 7), r.randint(k2, (), 0, 128 - 5),
               r.randint(k3, (), 1, 12), r.randint(k4, (), 0, 170 - 10)]
        want = jaug.single_mask(jnp.asarray(mel[i]), k, 10)
        got = taug.single_mask(_t(mel[i:i + 1]), *[_t([np.asarray(p).item()]) for p in pos])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    for valid in (90, 128, 170):              # pad, exact, crop
        m = mel.copy()
        m[..., valid:] = 0.0
        for k in keys:
            want = jaug.adjust_size(jnp.asarray(m[0]), 128, valid, k)
            draw = int(jax.random.randint(k, (), 0, 1 << 20))
            got = taug.adjust_size(_t(m[:1]), 128, torch.tensor([valid]), torch.tensor([draw]))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("augment", [True, False])
def test_toy_pipeline_matches_jax(augment):
    """toy_augment_and_mel over 4 clips (gain, delay, reverb and noise all
    drawn on for some) with JAX's draws: the log-mel tolerance, rtol 1e-4,
    atol 1e-4 in log10 units (no clamp here)."""
    fe, tfe = JFC.for_case("toy"), TFC.for_case("toy")
    x = _wavs(4, 16000, seed=5)
    keys = _keys(1, 4)
    want = jax.jit(jax.vmap(lambda w, k: jtrain.toy_augment_and_mel(w, k, fe, augment, augment)))(
        jnp.asarray(x), keys)
    d = jax_toy_draws(keys, 16000, fe, augment, augment)
    if augment:
        assert all(d[g].any() for g in ("gain_on", "delay_on", "reverb_on", "noise_on"))
    got = ttrain.toy_augment_and_mel(_t(x), torch_draws(d), tfe, augment, augment)
    assert got.shape == (4, 1, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _mel_power(m):
    return 10.0 ** np.asarray(m, np.float64)


@pytest.mark.parametrize("augment", [True, False])
def test_gtzan_pipeline_matches_jax(augment):
    """gtzan_augment_and_mel over 4 clips of 29 s with JAX's draws (seed 2:
    with augmentation on, clip 0 is pitch-shifted and filtered, 1 neither, 2
    filtered, 3 pitch-shifted). Per clip:
      - neither: the log-mel tolerance, rtol 1e-4, atol 1e-4 in log10 units;
      - filtered: on the mel power, rtol 1e-4, atol 1e-5 * the clip's peak
        (the stopband's bins are float32 FFT round-off in both packages,
        up to 6e-6 of the peak from float64, measured);
      - pitch-shifted: on the mel power, atol 1e-2 * the clip's peak (the
        JAX package's float32 phase sums, up to 5e-3 of the peak from
        float64, measured)."""
    fe, tfe = JFC.for_case("gtzan"), TFC.for_case("gtzan")
    x = _wavs(4, 29 * SR, seed=0)
    keys = _keys(2, 4)
    want = np.asarray(jax.jit(jax.vmap(
        lambda w, k: jtrain.gtzan_augment_and_mel(w, k, fe, augment, augment)))(jnp.asarray(x), keys))
    d = jax_gtzan_draws(keys, x.shape[1], fe, augment, augment)
    got = ttrain.gtzan_augment_and_mel(_t(x), torch_draws(d), tfe, augment, augment).numpy()
    assert got.shape == want.shape == (4, 1, 128, 128)
    if augment:
        assert [bool(v) for v in d["pitch_on"]] == [True, False, False, True]
        assert [bool(v) for v in d["filter_on"]] == [True, False, True, False]
    for i in range(4):
        pitched = augment and d["pitch_on"][i]
        filtered = augment and d["filter_on"][i]
        if not (pitched or filtered):
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4)
            continue
        g, w = _mel_power(got[i]), _mel_power(want[i])
        peak = w.max()
        if pitched:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * peak)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * peak)


def test_port_samplers_draw_what_the_pipelines_take():
    """The port's samplers give the keys, shapes and ranges of JAX's draws,
    and the pipelines run on them."""
    g = torch.Generator().manual_seed(0)
    for case, sample, jdraws, apply, n in (
            ("gtzan", ttrain.sample_gtzan_draws, jax_gtzan_draws, ttrain.gtzan_augment_and_mel,
             29 * SR),
            ("toy", ttrain.sample_toy_draws, jax_toy_draws, ttrain.toy_augment_and_mel, SR)):
        fe, tfe = JFC.for_case(case), TFC.for_case(case)
        d = sample(64, n, tfe, True, True, generator=g)
        ref = jdraws(_keys(0, 2), n, fe, True, True)
        assert set(d) == set(ref)
        for k, v in d.items():
            assert tuple(v.shape[1:]) == ref[k].shape[1:] and v.shape[0] == 64, k
            assert (v.dtype == torch.bool) == (ref[k].dtype == bool), k
        out = apply(_t(_wavs(64, n, seed=1)[:2]), {k: v[:2] for k, v in d.items()}, tfe, True, True)
        assert torch.isfinite(out).all()
    d = ttrain.sample_gtzan_draws(4096, 29 * SR, TFC.for_case("gtzan"), True, True, generator=g)
    assert 0.25 < d["pitch_on"].float().mean() < 0.35 and 0.35 < d["filter_on"].float().mean() < 0.45
    assert d["rate"].min() >= 0.8 and d["rate"].max() < 1.2
    assert d["start"].max() < 26 * SR and d["n_cols"].min() >= 1 and d["n_cols"].max() <= 40


def test_valid_chunks_to_mels_matches_jax():
    """Eight chunks of each of 2 clips through the log-mel: rtol 1e-4, atol
    1e-4 in log10 units."""
    fe, tfe = JFC.for_case("gtzan"), TFC.for_case("gtzan")
    x = _wavs(2, 29 * SR + 100, seed=7)
    want = jtrain.valid_chunks_to_mels(jnp.asarray(x), fe)
    got = ttrain.valid_chunks_to_mels(_t(x), tfe)
    assert got.shape == (16, 1, 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
