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
