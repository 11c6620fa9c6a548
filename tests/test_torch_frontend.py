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


@pytest.mark.parametrize("case", ["gtzan", "toy", "gtzan_6s"])
def test_logmel_matches_jax(case, rng):
    jcfg = jfe.FrontendConfig.for_case(case)
    tcfg = tfe.FrontendConfig.for_case(case)
    assert tuple(tcfg) == tuple(jcfg)
    n = jcfg.sample_rate * jcfg.slice_length
    wav = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    want = np.asarray(jfe.logmel(jfe.peak_normalize(jnp.asarray(wav)), jcfg))
    got = tfe.logmel(tfe.peak_normalize(torch.as_tensor(wav)), tcfg).numpy()
    assert got.shape == (2, jcfg.n_mels, jcfg.width)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


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
