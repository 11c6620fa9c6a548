"""The port's fused_logmel (its plain version, as the CPU runs it) against
the JAX package's pallas_logmel in interpret mode and its XLA logmel, at
tests/test_pallas_frontend.py's tolerance: rtol 1e-4, atol 1e-4 (log10
units)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drsa_audio_tpu.ops import frontend as jfe
from drsa_audio_tpu.ops.pallas_frontend import pallas_logmel
from drsa_audio_tpu_torch.ops import frontend as tfe
from drsa_audio_tpu_torch.ops import fused_frontend


@pytest.mark.parametrize("case,b", [("toy", 2), ("gtzan", 1), ("gtzan_6s", 1)])
def test_fused_logmel_plain_matches_jax(case, b, rng):
    jcfg, tcfg = jfe.FrontendConfig.for_case(case), tfe.FrontendConfig.for_case(case)
    n = jcfg.sample_rate * jcfg.slice_length
    wav = jfe.peak_normalize(jnp.asarray(rng.standard_normal((b, n)).astype(np.float32)))
    got = fused_frontend.fused_logmel(torch.as_tensor(np.array(wav)), tcfg).numpy()
    assert got.shape == (b, jcfg.n_mels, jcfg.width)
    kernel = np.asarray(pallas_logmel(wav, jcfg, True))
    np.testing.assert_allclose(got, kernel, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jfe.logmel(wav, jcfg)), rtol=1e-4, atol=1e-4)


def test_fused_logmel_leading_axes_and_silence():
    """[..., time] in, [..., n_mels, width] out; a silent clip gives -4
    everywhere, as the JAX logmel does."""
    cfg = tfe.FrontendConfig.for_case("toy")
    wav = torch.zeros((2, 1, 16000))
    wav[1, 0] = torch.linspace(-1.0, 1.0, 16000)
    got = fused_frontend.fused_logmel(wav, cfg)
    assert got.shape == (2, 1, 64, 64)
    assert (got[0] == -4.0).all()
    np.testing.assert_allclose(got[1, 0].numpy(), fused_frontend.fused_logmel(wav[1], cfg)[0])
    np.testing.assert_allclose(
        got[0].numpy(), np.asarray(jfe.logmel(jnp.zeros((1, 16000)),
                                              jfe.FrontendConfig.for_case("toy"))))


def _fft_as_kernel(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """csrc/logmel.cu's FFT of windowed frames [F, n_fft] in f32, from the
    host tables and in the kernel's stage order: z[m] = x[2m] + i x[2m+1];
    per m1 a length-n2 DFT over m2 and the twiddle; per k2 a length-n1 DFT
    over m1 into Z[k2 + n2 k1]; the real-FFT post-twiddle. Returns |X|
    [F, n_fft/2 + 1]."""
    tb = fused_frontend.fft_tables(n_fft)
    n1, n2, half = tb["n1"], tb["n2"], n_fft // 2
    c = lambda a: torch.complex(*torch.as_tensor(a).unbind(-1))         # noqa: E731
    t2, t1, tw, post = (c(tb[k]) for k in ("t2", "t1", "tw", "post"))
    x = frames * torch.as_tensor(tb["win"])
    z = torch.complex(x[:, 0::2], x[:, 1::2]).reshape(-1, n2, n1)      # [F, m2, m1]
    Y = torch.einsum("fqp,qk->fpk", z, t2) * tw                         # [F, m1, k2]
    Z = torch.einsum("fpk,pj->fjk", Y, t1).reshape(-1, half)            # k = k2 + n2 k1
    a = torch.cat([Z, Z[:, :1]], dim=1)                                 # Z[k], k <= half
    b = torch.flip(a, dims=[1]).conj()                                  # conj Z[half - k]
    X = (a + b) / 2 + post * (a - b) / 2j
    return X.abs()


@pytest.mark.parametrize("case", ["gtzan", "toy"])
def test_fft_tables_emulated_match_rfft_and_plain(case, rng):
    """The kernel's factorisation with its f32 tables: |X| against
    torch.fft.rfft in float64 (to f32 round-off of the largest bin), and
    the log-mel from it through the mel bands against fused_logmel_plain
    (rtol 1e-4, atol 1e-4 in log10 units)."""
    cfg = tfe.FrontendConfig.for_case(case)
    n = cfg.sample_rate * cfg.slice_length
    wav = tfe.peak_normalize(torch.as_tensor(rng.standard_normal((2, n)).astype(np.float32)))
    frames = fused_frontend._frame_signal(wav, cfg.n_fft, cfg.hop_length)[:, 1:cfg.width + 1]
    frames = frames.reshape(-1, cfg.n_fft)
    mag = _fft_as_kernel(frames, cfg.n_fft)
    ref = torch.fft.rfft(frames.double() * fused_frontend.hann_window(cfg.n_fft, torch.float64),
                         dim=-1).abs()
    np.testing.assert_allclose(mag.numpy(), ref.numpy(), rtol=0, atol=1e-6 * ref.max().item())
    bands, weights = fused_frontend.mel_bands(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate)
    mel = torch.stack([mag[:, f:f + c] @ torch.as_tensor(weights[o:o + c])
                       for f, c, o in bands], dim=-1)
    got = torch.clamp(torch.log(mel + 1e-7) * fused_frontend.INV_LN10, min=-4.0)
    got = got.reshape(2, cfg.width, cfg.n_mels).transpose(-1, -2)
    want = fused_frontend.fused_logmel_plain(wav, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft,factors", [(800, (20, 20)), (480, (15, 16)), (64, (4, 8)),
                                           (2048, (32, 32)), (74, (0, 0)), (4096, (0, 0))])
def test_fft_factors(n_fft, factors):
    """n_fft / 2 = n1 * n2 with both at most 32, n1 the largest divisor not
    above the square root; (0, 0), which the kernel refuses, otherwise."""
    assert fused_frontend.fft_factors(n_fft // 2) == factors
    tb = fused_frontend.fft_tables(n_fft)
    if factors != (0, 0):
        assert (tb["t2"].shape, tb["t1"].shape, tb["tw"].shape, tb["post"].shape) == (
            (factors[1],) * 2 + (2,), (factors[0],) * 2 + (2,), factors + (2,),
            (n_fft // 2 + 1, 2))


@pytest.mark.parametrize("n_fft,n_mels", [(800, 128), (480, 64)])
def test_mel_bands_cover_the_filterbank(n_fft, n_mels):
    """The band table against the dense filterbank by index: every nonzero
    in its mel's band with its weight, nothing else, and no bin in more
    than 2 bands."""
    fb = fused_frontend.mel_filterbank(n_fft // 2 + 1, n_mels, 16000)
    bands, weights = fused_frontend.mel_bands(n_fft // 2 + 1, n_mels, 16000)
    dense = np.zeros_like(fb)
    for j, (first, count, off) in enumerate(bands):
        assert count > 0 and (weights[off:off + count] != 0).all()
        dense[first:first + count, j] = weights[off:off + count]
    np.testing.assert_array_equal(dense, fb)
    assert len(weights) == np.count_nonzero(fb) == bands[-1, 1] + bands[-1, 2]
    assert (np.count_nonzero(fb, axis=1) <= 2).all()
