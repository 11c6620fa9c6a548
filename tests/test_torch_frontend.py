"""The port's log-mel front-end against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.ops import frontend as jfe
from drsa_audio_tpu.ops import mel as jmel
from drsa_audio_tpu.ops import stft as jstft
from drsa_audio_tpu_torch.ops import frontend as tfe
from drsa_audio_tpu_torch.ops import mel as tmel
from drsa_audio_tpu_torch.ops import stft as tstft

# The log-mel parity tolerance, in log10 units: the JAX package's Pallas
# log-mel test's (tests/test_pallas_frontend.py). The two frameworks sum the
# DFT in different orders, which the log amplifies at the quietest mel bins,
# and the order depends on the host's BLAS threads. Over numpy seeds 0-29 the
# worst error was 0.17 of this tolerance for the matmul DFT (gtzan), 0.15 for
# the FFT path (gtzan_6s) and 0.27 for load_clip_to_mels (gtzan, 10 chunks);
# at rtol 1e-5, atol 1e-5 the same errors reached 1.71x, 1.49x and 2.67x.
LOGMEL_TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.mark.parametrize("case", ["gtzan", "toy", "gtzan_6s"])
def test_logmel_matches_jax(case, rng):
    jcfg = jfe.FrontendConfig.for_case(case)
    tcfg = tfe.FrontendConfig.for_case(case)
    # the JAX package's fields, then the port's front-end steps at their
    # defaults (the GTZAN and toy framing)
    assert tuple(tcfg)[:len(jcfg)] == tuple(jcfg)
    assert tuple(tcfg)[len(jcfg):] == (jcfg.n_fft, True, 0.0, jcfg.sample_rate / 2, "hz",
                                       "log10_clamp", None, 1, True,
                                       jcfg.sample_rate * jcfg.slice_length)
    n = jcfg.sample_rate * jcfg.slice_length
    wav = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    want = np.asarray(jfe.logmel(jfe.peak_normalize(jnp.asarray(wav)), jcfg))
    got = tfe.logmel(tfe.peak_normalize(torch.as_tensor(wav)), tcfg).numpy()
    assert got.shape == (2, jcfg.n_mels, jcfg.width)
    np.testing.assert_allclose(got, want, **LOGMEL_TOL)


@pytest.mark.parametrize("n_fft,n_mels", [(800, 128), (480, 64)])
def test_filterbank_and_basis_equal(n_fft, n_mels):
    np.testing.assert_array_equal(tmel.mel_filterbank(n_fft // 2 + 1, n_mels, 16000),
                                  jmel.mel_filterbank(n_fft // 2 + 1, n_mels, 16000))
    for a, b in zip(tstft.dft_basis(n_fft), jstft.dft_basis(n_fft)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tstft.hann_window(n_fft).numpy(),
                                  np.asarray(jstft.hann_window(n_fft)))


def test_frames_match_jax(rng):
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    want = np.asarray(jstft._frame_signal(jnp.asarray(x), 800, 360))
    got = tstft._frame_signal(torch.as_tensor(x), 800, 360).numpy()
    np.testing.assert_array_equal(got, want)


def test_peak_normalize_passes_silence():
    x = np.zeros((2, 100), np.float32)
    x[1, 3] = -4.0
    got = tfe.peak_normalize(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfe.peak_normalize(jnp.asarray(x))))
    assert np.isfinite(got).all() and got[1, 3] == -1.0


CASES = ["gtzan", "toy", "gtzan_6s"]


def _wav(case, rng, b=2):
    cfg = jfe.FrontendConfig.for_case(case)
    n = cfg.sample_rate * cfg.slice_length
    return cfg, tfe.FrontendConfig.for_case(case), (rng.standard_normal((b, n)) * 0.3).astype(
        np.float32)


@pytest.mark.parametrize("case", CASES)
def test_stft_and_magnitude_match_jax(case, rng):
    """tests/test_frontend.py's stft tolerance (rtol 1e-4, atol 2e-3)."""
    jcfg, _, wav = _wav(case, rng)
    want = np.asarray(jstft.stft(jnp.asarray(wav), jcfg.n_fft, jcfg.hop_length))
    got = tstft.stft(torch.as_tensor(wav), jcfg.n_fft, jcfg.hop_length).numpy()
    assert got.shape == want.shape and np.iscomplexobj(got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
    mag = tstft.stft_magnitude(torch.as_tensor(wav), jcfg.n_fft, jcfg.hop_length).numpy()
    np.testing.assert_allclose(
        mag, np.asarray(jstft.stft_magnitude(jnp.asarray(wav), jcfg.n_fft, jcfg.hop_length)),
        rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("case", CASES)
def test_fft_logmel_matches_jax(case, rng):
    jcfg, tcfg, wav = _wav(case, rng)
    want = np.asarray(jfe.logmel(jnp.asarray(wav), jcfg, use_matmul_dft=False))
    got = tfe.logmel(torch.as_tensor(wav), tcfg, use_matmul_dft=False).numpy()
    assert got.shape == (2, jcfg.n_mels, jcfg.width)
    np.testing.assert_allclose(got, want, **LOGMEL_TOL)


@pytest.mark.parametrize("case", CASES)
def test_logmel_full_matches_jax(case, rng):
    jcfg, tcfg, wav = _wav(case, rng, b=1)
    want = [np.asarray(a) for a in jfe.logmel_full(jnp.asarray(wav), jcfg)]
    got = [a.numpy() for a in tfe.logmel_full(torch.as_tensor(wav), tcfg)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=2e-3)
    # the phase of a bin is exact where the bin is far from zero
    big = want[0] > 1e-2
    np.testing.assert_allclose(got[1][big], want[1][big], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=2e-3)


def test_slicing_matches_jax(rng):
    sr = 16000
    wav = rng.standard_normal((1, 30 * sr)).astype(np.float32)
    for sl, chunks in ((3, 8), (3, 10), (6, 1)):
        assert tfe.slice_hop_samples(sl, max(chunks, 2), sr) == jfe.slice_hop_samples(
            sl, max(chunks, 2), sr)
        np.testing.assert_array_equal(tfe.chunk_startpoints(sl, chunks, sr),
                                      jfe.chunk_startpoints(sl, chunks, sr))
        np.testing.assert_array_equal(
            tfe.get_slices(torch.as_tensor(wav), sl, chunks, sr).numpy(),
            np.asarray(jfe.get_slices(jnp.asarray(wav), sl, chunks, sr)))
    for start in (0.0, 2.5, 29.0):
        np.testing.assert_array_equal(
            tfe.get_slice_at(torch.as_tensor(wav), 3, start, sr).numpy(),
            np.asarray(jfe.get_slice_at(jnp.asarray(wav), 3, start, sr)))
    assert tfe.round_down(3.79, 1) == jfe.round_down(3.79, 1) == 3.7


def test_normalisers_and_adjust_vol_match_jax(rng):
    """tests/test_frontend.py's normaliser tolerances (rtol 1e-5)."""
    wav = (rng.standard_normal((4, 1000)) * 3).astype(np.float32)
    for fn in ("rms_normalize", "minmax_normalize"):
        arg = wav if fn == "rms_normalize" else wav.reshape(2, 2, 1000)
        np.testing.assert_allclose(getattr(tfe, fn)(torch.as_tensor(arg)).numpy(),
                                   np.asarray(getattr(jfe, fn)(jnp.asarray(arg))),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfe.rms_normalize(torch.as_tensor(wav), rms_db=-6.0).numpy(),
                               np.asarray(jfe.rms_normalize(jnp.asarray(wav), rms_db=-6.0)),
                               rtol=1e-5)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (rng.standard_normal(1000) * 0.1).astype(np.float32)
    np.testing.assert_allclose(tfe.adjust_vol(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(jfe.adjust_vol(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case,chunks", [("gtzan", 10), ("gtzan", 1), ("toy", None)])
def test_load_clip_to_mels_matches_jax(case, chunks, rng):
    """The cases of tests/test_datasets.py: a 30 s clip sliced into chunks
    (or one slice at a startpoint) through peak normalisation and log-mel."""
    jcfg, tcfg = jfe.FrontendConfig.for_case(case), tfe.FrontendConfig.for_case(case)
    wav = (rng.standard_normal((1, 30 * jcfg.sample_rate)) * 0.3).astype(np.float32)
    want = np.asarray(jfe.load_clip_to_mels(jnp.asarray(wav), jcfg, 1.5, chunks))
    got = tfe.load_clip_to_mels(torch.as_tensor(wav), tcfg, 1.5, chunks).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOGMEL_TOL)
