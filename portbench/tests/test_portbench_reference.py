"""The plain reference against the program's plain CPU path at a tiny width,
3s-shaped and 6s-shaped (BatchNorm folded: the program by its
fold_batchnorm, the reference by its own)."""

import numpy as np
import pytest
import torch

from tests import tiny
from pb import check, model, program
from reference import frontend, lrp


def _run(name, U_kind, seed=3, b=3):
    cfg = tiny.config(name)
    cfg.update(n_filters=[8, 8, 16, 16, 16], subspace_dim=16, n_dense=16)
    params, U = model.draw(cfg, seed, "cpu")
    if U_kind == "permutation":
        g = torch.Generator().manual_seed(seed)
        d = cfg["subspace_dim"]
        P = torch.zeros(d, d)
        P[torch.arange(d), torch.randperm(d, generator=g)] = torch.where(
            torch.rand(d, generator=g) < 0.5, -1.0, 1.0)
        U = P.expand_as(U).contiguous()
    svc = program.service(cfg, {n: {k: v.clone() for k, v in p.items()} for n, p in params.items()},
                          U, "cpu")
    g = torch.Generator().manual_seed(seed + 100)
    wavs = (torch.randn(b, cfg["slice_length"] * cfg["sample_rate"], generator=g) * 0.3).clamp(-1, 1)
    cls = cfg["classes"][seed % 10]
    out = svc.explain(wavs.numpy(), cls)
    k = cfg["classes"].index(cls)
    mel, heat, logits = check.reference_outputs(lrp.Model(cfg, params), cfg, wavs, U[k], k, 2)
    return out, mel, heat, logits


# The 6s model's max-pools hold near-ties on most inputs (ROADMAP Queue 3
# items 4-5): a window routed otherwise moves the relevance of one clip, so
# 6s is held on the median clip
MAP_TOL = {"gtzan3s": ("std_p98", 1e-4, 1e-4), "gtzan6s": ("std_p50", 5e-3, 5e-3)}


def test_reference_matches_the_program_with_an_exact_projection_3s():
    """A signed-permutation U makes U U^T exact, so that nothing rests on
    its round-off: every map, the relevances and the order agree."""
    out, _, heat, logits = _run("gtzan3s", "permutation")
    nums = check.pooled([check.numbers(out, heat, logits)])
    assert nums["logits"] < 1e-5
    assert nums["std_p98"] < 1e-4 and nums["subsum_p98"] < 1e-4
    assert nums["sub_max"] < 1e-3 and nums["rel_max"] < 1e-4
    assert nums["relsum_max"] < 1e-5 and nums["relmap_max"] < 1e-6 and nums["unsorted"] == 0


def test_reference_matches_the_program_with_an_exact_projection_6s():
    out, _, heat, logits = _run("gtzan6s", "permutation", b=4)
    nums = check.pooled([check.numbers(out, heat, logits)])
    assert nums["logits"] < 1e-5
    assert nums["std_p50"] < 5e-3 and nums["sub_p50"] < 5e-3
    assert nums["relsum_max"] < 5e-3 and nums["unsorted"] == 0


@pytest.mark.parametrize("name", ["gtzan3s", "gtzan6s"])
def test_reference_matches_the_program_with_a_generic_projection(name):
    """A generic U: the standard maps, their sums of concept maps, the
    logits and the total relevance agree; the concept split rests on the
    round-off of U U^T (ROADMAP Queue 3 item 3) and is not held here."""
    out, mel, heat, logits = _run(name, "generic", b=4)
    nums = check.pooled([check.numbers(out, heat, logits)])
    key, tol, rel_tol = MAP_TOL[name]
    assert nums["logits"] < 1e-5
    assert nums[key] < tol
    assert nums["relsum_max"] < rel_tol and nums["unsorted"] == 0


def test_reference_logmel_matches_the_program_frontend():
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig, logmel, peak_normalize
    cfg = tiny.config("gtzan6s")
    g = torch.Generator().manual_seed(5)
    wavs = (torch.randn(2, 96000, generator=g) * 0.3).clamp(-1, 1)
    want = logmel(peak_normalize(wavs), FrontendConfig.for_case("gtzan_6s"))
    got = frontend.logmel(frontend.peak_normalize(wavs), cfg)
    assert got.shape == want.shape == (2, 128, 256)
    assert (got - want).abs().max().item() < 1e-3
    assert ((got - want) ** 2).mean().sqrt().item() < 1e-5


def test_reference_filterbank_is_the_htk_one():
    from drsa_audio_tpu_torch.ops.mel import mel_filterbank
    np.testing.assert_allclose(frontend.htk_filterbank(401, 128, 16000),
                               mel_filterbank(401, 128, 16000), atol=1e-7)

