"""The port's sonification (drsa_audio_tpu_torch.xai.sonify.mel2audio) and
its iSTFT (ops.stft.istft) against the JAX package's, mirroring
tests/test_sonify.py, on the CPU.

Tolerances: the Gaussian kernel bit-equal; the blur and the mask rtol 1e-5
(the blur sums 25 non-negative products in another order); the NNLS, the
iSTFT, the mels and every waveform atol 1e-5 * max|ref| (rtol 1e-4). The
phase spec/|spec| is compared at the same tolerance where |spec| is at
least 1e-2 of its maximum: below that, the two STFTs' round-off turns the
angle of a near-zero bin freely. The waveforms built with the phase hold
it everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.data.toydata import generate_sample
from drsa_audio_tpu.ops import frontend as jfe
from drsa_audio_tpu.ops import stft as jstft
from drsa_audio_tpu.ops.mel import mel_filterbank
from drsa_audio_tpu.runtime.wavio import write_wav
from drsa_audio_tpu.xai.sonify import mel2audio as jm
from drsa_audio_tpu_torch.ops import stft as tstft
from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
from drsa_audio_tpu_torch.xai.sonify import mel2audio as tm


def _close(got, want):
    """atol 1e-5 * max|ref|, rtol 1e-4."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _close_phase(phase, jphase, wav, case):
    """The phase where the JAX STFT's magnitude is at least 1e-2 of its
    maximum."""
    mag = np.asarray(jfe.logmel_full(jnp.asarray(wav), jfe.FrontendConfig.for_case(case))[0])
    live = mag >= 1e-2 * mag.max()
    jphase = np.asarray(jphase)
    _close(torch.view_as_real(phase).numpy()[live], np.stack([jphase.real, jphase.imag], -1)[live])


@pytest.fixture(scope="module")
def clip():
    """A 1 s toy waveform (all four concepts) and maps [1, 1+K, 64, 64]."""
    wav, _ = generate_sample(np.random.default_rng(1), "class2", concept_idcs=(1, 2, 3, 4))
    rng = np.random.default_rng(2)
    info = {"standard_heatmaps": rng.standard_normal((1, 1, 64, 64)).astype(np.float32),
            "subspace_heatmaps": rng.standard_normal((1, 2, 64, 64)).astype(np.float32)}
    return wav, info


def test_gaussian_kernel_matches_jax():
    for size, sigma in ((5, 1.0), (7, 2.5), (3, 0.5)):
        np.testing.assert_array_equal(tm.gaussian_kernel1d(size, sigma),
                                      jm.gaussian_kernel1d(size, sigma))


@pytest.mark.parametrize("shape,size,sigma", [((16, 16), 5, 1.0), ((2, 3, 20, 12), 7, 2.0)])
def test_gaussian_blur_matches_jax(shape, size, sigma):
    img = np.abs(np.random.default_rng(3).standard_normal(shape)).astype(np.float32)
    got = tm.gaussian_blur(torch.as_tensor(img), size, sigma)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.gaussian_blur(jnp.asarray(img), size,
                                                                        sigma)), rtol=1e-5)


@pytest.mark.parametrize("percentile", [None, 50, 90])
def test_generate_mask_matches_jax(percentile):
    hm = np.random.default_rng(4).standard_normal((64, 48)).astype(np.float32)
    hm[16:32, 16:32] += 5.0
    got = tm.generate_mask(torch.as_tensor(hm), percentile)
    want = np.asarray(jm.generate_mask(jnp.asarray(hm), percentile))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert got.min().item() >= 0


@pytest.mark.parametrize("case,iters", [("toy", 80), ("gtzan", 30)])
def test_nnls_matches_jax(case, iters):
    cfg = FrontendConfig.for_case(case)
    fb = mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate)
    S_true = np.abs(np.random.default_rng(5).standard_normal((fb.shape[0], 30))).astype(np.float32)
    mel = fb.T @ S_true
    got = tm.mel_to_stft_nnls(torch.as_tensor(mel), torch.as_tensor(fb), iters)
    _close(got, jm.mel_to_stft_nnls(jnp.asarray(mel), jnp.asarray(fb), iters))
    assert got.min().item() >= 0
    rel = np.abs(fb.T @ got.numpy() - mel).mean() / np.abs(mel).mean()
    assert rel < 0.05, rel


@pytest.mark.parametrize("lead,length", [((), None), ((2,), None), ((2, 3), 1000)])
def test_istft_matches_jax(lead, length):
    """The inverse of a centred STFT, with and without ``length``; it
    recovers the waveform away from the ends."""
    x = np.random.default_rng(6).standard_normal(lead + (16000,)).astype(np.float32)
    spec = np.asarray(jstft.stft(jnp.asarray(x), 480, 240))
    got = tstft.istft(torch.as_tensor(spec), 480, 240, length)
    _close(got, jstft.istft(jnp.asarray(spec), 480, 240, length))
    n = got.shape[-1]
    np.testing.assert_allclose(got.numpy()[..., 240:n - 240], x[..., 240:n - 240], atol=1e-5)


def test_mel2audio_transforms_match_jax(clip):
    wav, info = clip
    jobj, tobj = jm.Mel2Audio(case="toy"), tm.Mel2Audio(case="toy", device="cpu")
    mel, phase = tobj.transform_audio(wav)
    jmel, jphase = jobj.transform_audio(wav)
    _close(mel, jmel)
    _close_phase(phase, jphase, wav, "toy")
    jmel, jphase = np.asarray(jmel), np.asarray(jphase)
    _close(tobj.transform_mel(jmel, jphase), jobj.transform_mel(jmel, jphase))
    for p in (50, 80):
        hm = info["subspace_heatmaps"][0, 1]
        _close(tobj.transform(hm, jmel, jphase, percentile=p),
               jobj.transform(hm, jmel, jphase, percentile=p))


@pytest.mark.parametrize("percentile", [50, 70])
def test_make_audios_matches_jax(clip, percentile):
    wav, info = clip
    got = tm.Mel2AudioToy(device="cpu").make_audios(info, wav, num_concepts=2,
                                                    percentile=percentile)
    want = jm.Mel2AudioToy().make_audios(info, wav, num_concepts=2, percentile=percentile)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.ndim == 1
        _close(g, w)


def test_transform_audio_from_file_matches_jax(tmp_path):
    """Decoded natively, sliced at a startpoint; a file at another rate is
    refused."""
    wav = np.random.default_rng(7).uniform(-0.5, 0.5, 16000 * 4).astype(np.float32)
    path = str(tmp_path / "clip.wav")
    write_wav(path, wav, 16000)
    tobj, jobj = tm.Mel2Audio(device="cpu"), jm.Mel2Audio()
    for start in (None, 0.5):
        mel, phase = tobj.transform_audio_from_file(path, start)
        jmel, jphase = jobj.transform_audio_from_file(path, start)
        assert mel.shape == (128, 128)
        _close(mel, jmel)
        cut = wav if start is None else wav[8000:8000 + 48000]
        _close_phase(phase, jphase, np.round(np.clip(cut, -1, 1) * 32767) / 32768, "gtzan")
    other = str(tmp_path / "22k.wav")
    write_wav(other, wav[:22050], 22050)
    with pytest.raises(ValueError, match="22050 Hz"):
        tobj.transform_audio_from_file(other)


def test_mel2audio_needs_cuda_unless_named(monkeypatch):
    """No device named and no CUDA: refused, not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.Mel2Audio()
