"""The port's subspace sort (``xai.explain.sort_concepts``, on the device
where the maps live) against the JAX package's numpy ``sort_subspaces``:
the order wherever the relevances differ, exact ties broken larger index
first, the maps permuted bit for bit, each relevance its map's sum; and
``unsort_concepts`` undoing it. ``check_device_sort`` is shared with the
card's test (test_torch_gpu.py), which passes the reference's order
computed without jax."""

import numpy as np
import pytest
import torch

from drsa_audio_tpu_torch.xai.explain import sort_concepts, unsort_concepts

# float32 round-off of a sum, as a share of the absolute sum it runs over
SUM_RTOL = 1e-6


def check_device_sort(heat: torch.Tensor, got, want: np.ndarray) -> None:
    """``got`` is ``sort_concepts(heat)`` of the tensor ``heat``
    [b, 1 + K, h, w]; holds it to ``want``, the reference's order [b, K]
    of ``heat``'s last K maps, and to ``unsort_concepts``."""
    maps, rel, order = got
    assert {t.device for t in got} == {heat.device}
    assert (maps.dtype, rel.dtype, order.dtype) == (torch.float32, torch.float32, torch.int64)
    assert maps.is_contiguous()
    assert torch.equal(unsort_concepts(maps, order), heat)
    h, maps, rel, order = (t.cpu().numpy() for t in (heat, maps, rel, order))
    b, K = h.shape[0], h.shape[1] - 1
    assert maps.shape == h.shape and rel.shape == (b, 1 + K) and order.shape == (b, K)
    assert (np.sort(order, axis=1) == np.arange(K)).all()           # a permutation
    rows = np.arange(b)[:, None]
    np.testing.assert_array_equal(maps[:, :1], h[:, :1])
    np.testing.assert_array_equal(maps[:, 1:], h[:, 1:][rows, order])
    # each relevance is its map's sum, within float32 round-off
    exact = maps.astype(np.float64).sum(axis=(-2, -1))
    scale = np.abs(maps).astype(np.float64).sum(axis=(-2, -1))
    assert (np.abs(rel - exact) <= SUM_RTOL * scale).all()
    sub_rel = rel[:, 1:]
    assert (np.diff(sub_rel, axis=1) <= 0).all()                    # they do not rise
    for i in range(b):
        for j in range(K):
            tied = (sub_rel[i] == sub_rel[i, j]).sum() > 1
            if not tied:
                assert order[i, j] == want[i, j], (i, order[i], want[i])
            elif j + 1 < K and sub_rel[i, j + 1] == sub_rel[i, j]:
                assert order[i, j] > order[i, j + 1]                # larger index first


def _maps_with_ties(b: int, K: int, seed: int) -> torch.Tensor:
    """Random maps [b, 1 + K, 16, 16]; among the concepts, row 1 repeats a
    map, row 2 holds an all-zero map, row 3 two, row 4 is one map K times."""
    g = torch.Generator().manual_seed(seed)
    heat = torch.randn(b, 1 + K, 16, 16, generator=g)
    sub = heat[:, 1:]
    sub[1, K - 1] = sub[1, 0]
    sub[2, K // 2] = 0.0
    sub[3, :2] = 0.0
    sub[4] = sub[4, 0]
    return heat


@pytest.mark.parametrize("K", [2, 3, 4])
def test_device_sort_matches_numpy(K):
    from drsa_audio_tpu.xai.explain import sort_subspaces
    heat = _maps_with_ties(6, K, seed=K)
    _, _, want = sort_subspaces(heat[:, 1:].numpy())
    check_device_sort(heat, sort_concepts(heat), want)


@pytest.fixture(scope="module")
def toy_service():
    from drsa_audio_tpu_torch.models.vgg import build_layer_specs, init_params, toy_config
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_TOY
    specs = build_layer_specs(toy_config())
    params = init_params(specs, 0, device="cpu")
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((16, 16)))
    Us = {"class1": q.astype(np.float32), "class2": q[:, ::-1].astype(np.float32)}
    return ExplainerService(specs, params, LRP_NAME_MAP_TOY, Us, 4, 10, case="toy",
                            device="cpu")


@pytest.mark.parametrize("entry", ["explain", "explain_stream"])
def test_service_results_keep_their_form_and_sums(toy_service, entry):
    """The service's dicts after the sort moved onto the device: the keys,
    shapes and dtypes they had, each relevance its returned map's sum, the
    relevances not rising along ``mask``, and the request log's count of the
    clips sorted on the device."""
    import time
    from drsa_audio_tpu_torch.serving import ExplainRequest
    from drsa_audio_tpu_torch.utils import profiling
    svc, b, K = toy_service, 3, 4
    wavs = (np.random.default_rng(5).standard_normal((b, 16000)) * 0.3).astype(np.float32)
    t0 = time.perf_counter()
    if entry == "explain":
        out = svc.explain(wavs, "class2")
    else:
        (out,) = svc.explain_stream(iter([ExplainRequest(wavs, 1)]))
    (req,) = profiling.requests(t0, time.perf_counter())
    assert req.counters["sort.device_clips"] == b
    h, w = svc.config.n_mels, svc.config.width
    form = {"standard_heatmaps": ((b, 1, h, w), np.float32),
            "subspace_heatmaps": ((b, K, h, w), np.float32),
            "subspace_relevances": ((b, K), np.float32), "mask": ((b, K), np.int64),
            "logits": ((b, svc.n_classes), np.float32)}
    if entry == "explain":
        form["standard_relevance"] = ((b,), np.float32)
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == form
    sums = out["subspace_heatmaps"].astype(np.float64).sum(axis=(-2, -1))
    np.testing.assert_allclose(out["subspace_relevances"], sums, rtol=1e-5,
                               atol=1e-6 * np.abs(sums).max())
    assert (np.diff(out["subspace_relevances"], axis=1) <= 0).all()
    assert (np.sort(out["mask"], axis=1) == np.arange(K)).all()
    if entry == "explain":
        std = out["standard_heatmaps"].astype(np.float64).sum(axis=(-3, -2, -1))
        np.testing.assert_allclose(out["standard_relevance"], std, rtol=1e-5,
                                   atol=1e-6 * np.abs(std).max())
