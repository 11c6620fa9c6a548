"""The port's ExplainerService on the CPU against the JAX service, with the
weights bridged from the JAX model.

U in the strict comparisons is a random signed permutation. With a generic
orthogonal U, the inverse projection rebuilds exact relu zeros as float32
round-off (~1e-8), the epsilon rule (eps 1e-6) on that layer divides by it,
and how the filter relevance splits over the concepts then depends on each
framework's matmul summation order: the subspace maps of the two packages
differ by a few percent of their maximum while the standard map (their sum)
and the logits still agree (test_generic_u_standard_map_matches_jax)."""

import jax
import numpy as np
import pytest
import torch

from drsa_audio_tpu.serving import ExplainerService as JService
from drsa_audio_tpu.xai.drsa.optimizer import random_orthogonal as j_ortho
from drsa_audio_tpu_torch.serving import ExplainerService, ExplainRequest
from test_torch_util import (
    MODELS, POOL_MARGIN, assert_close_lrp, both_models, service_margins, signed_permutation)

# The request of each strict service test is drawn from a numpy seed whose
# input holds no max-pool near-tie in the JAX forward (tie_margins): 3s
# seed 1 had a pool margin of 7.0e-8, seed 30 has 1.7e-6 (1.7x POOL_MARGIN,
# 7x the largest gap at which a 3s window flipped in the scan); toy seed 1
# has 5.0e-6 (10x POOL_MARGIN, 40x the largest flip).
SERVICE_SEEDS = {"toy": 1, "gtzan3s": 30}


def _services(name, Us, margin_of=None):
    """The JAX and port services; with ``margin_of`` (wavs, class), also
    the tie margins of that request in the JAX forward."""
    jspecs, jparams, tspecs, tparams, nm, layer, d, hw, case = both_models(name)
    js = JService(jspecs, jparams, nm, Us(d), 4, layer, case=case)
    ts = ExplainerService(tspecs, tparams, nm, Us(d), 4, layer, case=case, device="cpu")
    if margin_of is None:
        return js, ts, case
    wavs, cls = margin_of
    return js, ts, case, service_margins(jspecs, jparams, layer, Us(d)[cls], wavs, case)


def _wavs(case, b, seed):
    n = 16000 if case == "toy" else 48000
    return (np.random.default_rng(seed).standard_normal((b, n)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name,b,cls", [("toy", 2, "class2"), ("gtzan3s", 1, "jazz")])
def test_explain_matches_jax_service(name, b, cls):
    case = MODELS[name][5]
    wavs = _wavs(case, b, SERVICE_SEEDS[name])
    js, ts, _, margins = _services(
        name, lambda d: {cls: signed_permutation(11, d)}, (wavs, cls))
    assert margins[0] >= POOL_MARGIN[name], margins
    want = js.explain(wavs, cls)
    got = ts.explain(wavs, cls)
    for key in ("standard_heatmaps", "subspace_heatmaps", "subspace_relevances",
                "standard_relevance", "logits"):
        assert_close_lrp(got[key], want[key])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    # standard = sum of the subspace maps
    np.testing.assert_allclose(got["standard_heatmaps"][:, 0],
                               got["subspace_heatmaps"].sum(axis=1), rtol=1e-5,
                               atol=1e-6 * np.abs(got["standard_heatmaps"]).max())
    # the chain and the plain tiled walk agree inside the port
    plain = ts.explain(wavs, cls, fused=False)
    assert_close_lrp(got["subspace_heatmaps"], plain["subspace_heatmaps"])


def test_generic_u_standard_map_matches_jax():
    """Generic orthogonal U (see module note): standard maps and logits agree
    at the LRP bound; the subspace maps agree to correlation 0.99."""
    U = lambda d: {"class1": np.asarray(j_ortho(jax.random.PRNGKey(7), d))}
    js, ts, case = _services("toy", U)
    wavs = _wavs(case, 2, 2)
    want, got = js.explain(wavs, "class1"), ts.explain(wavs, "class1")
    assert_close_lrp(got["logits"], want["logits"])
    np.testing.assert_allclose(got["standard_heatmaps"], want["standard_heatmaps"],
                               rtol=1e-4, atol=1e-4 * np.abs(want["standard_heatmaps"]).max())
    corr = np.corrcoef(got["subspace_heatmaps"].ravel(), want["subspace_heatmaps"].ravel())
    assert corr[0, 1] > 0.99


def test_explain_stream_matches_explain():
    _, ts, case = _services("toy", lambda d: {"class1": signed_permutation(1, d),
                                              "class2": signed_permutation(2, d)})
    reqs = [ExplainRequest(_wavs(case, 2, s), s % 2) for s in range(3)]
    outs = list(ts.explain_stream(iter(reqs)))
    assert len(outs) == 3
    for req, out in zip(reqs, outs):
        ref = ts.explain(req.wavs, "class1" if req.class_idx == 0 else "class2")
        np.testing.assert_array_equal(out["subspace_heatmaps"], ref["subspace_heatmaps"])


def test_service_without_device_needs_cuda(monkeypatch):
    """No device and no CUDA: the service refuses rather than running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tspecs, tparams, nm, layer, d, _, case = both_models("toy")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExplainerService(tspecs, tparams, nm, {"class1": signed_permutation(0, d)},
                         4, layer, case=case)


def test_finalize_on_cpu_returns_views_of_the_outputs(monkeypatch):
    """On a CPU service the readback copies nothing: every array of the
    result dict views the storage of ``_dispatch``'s own outputs, no
    page-locked memory is asked for, and the request log counts no bytes
    moved."""
    from drsa_audio_tpu_torch.utils import profiling
    _, ts, case = _services("toy", lambda d: {"class1": signed_permutation(1, d)})
    out = ts._dispatch(_wavs(case, 2, 3), "class1")
    empty = torch.empty

    def no_pinned(*args, **kwargs):
        assert not kwargs.get("pin_memory"), "page-locked memory asked for on the CPU"
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_pinned)
    with profiling.request(ts.device) as req:
        got = ts._finalize(out)
    heat, logits, rel, order = out
    for key, t in (("standard_heatmaps", heat), ("subspace_heatmaps", heat),
                   ("subspace_relevances", rel), ("standard_relevance", rel),
                   ("mask", order), ("logits", logits)):
        assert np.shares_memory(got[key], t.numpy()), key
    np.testing.assert_array_equal(got["subspace_heatmaps"], heat.numpy()[:, 1:])
    np.testing.assert_array_equal(got["standard_relevance"], rel.numpy()[:, 0])
    assert req.counters["d2h_bytes.pinned"] == req.counters["d2h_bytes.pageable"] == 0
