"""Each CUDA kernel of the port against its plain PyTorch version, on the
card (TF32 off), at small shapes and the 3s and 6s models' widths. Run on a GPU
host with ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``; without a
card every test here skips.

Tolerance: rtol 1e-4, atol 1e-5 * max|plain| (summation order differs).
This file imports no jax: the GPU machine has none (hence --noconftest)."""

import numpy as np
import pytest
import torch

from drsa_audio_tpu_torch.models import vgg
from drsa_audio_tpu_torch.xai.lrp import chain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    atol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


def _conv(rng, ci, co, dev):
    spec = vgg.LayerSpec("conv", f"c{ci}_{co}_{rng.integers(1 << 30)}", {})
    w = torch.as_tensor((rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
                        .astype(np.float32), device=dev)
    b = torch.as_tensor((rng.standard_normal(co) * 0.05).astype(np.float32), device=dev)
    return chain.prep_inner_weights({spec.name: {"weight": w, "bias": b}}, spec,
                                    {"gamma": 0.4, "stabilizer": 1e-7})


@pytest.mark.parametrize("chans,H,pool", [
    ([(64, 64)], 16, (2, 2)),          # 3s block 3
    ([(32, 64)], 32, (2, 2)),          # 3s block 2
    ([(32, 32)], 64, None),            # 3s block 1
    ([(8, 16)], 8, (2, 2)),            # toy widths
    ([(16, 16), (16, 32)], 8, (2, 4)),  # two convs, a (2,4) pool
    ([(128, 128)], 6, None),           # widest, ragged tile
    ([(64, 100)], 16, (2, 2)),         # 6s block 2, bottom conv
    ([(64, 100), (100, 100)], 8, (2, 2)),    # 6s block 2, both convs
    ([(100, 128), (128, 128)], 8, (2, 2)),   # 6s block 3
    ([(100, 128)], 6, None),           # 6s block 3, bottom conv, ragged tile
    ([(128, 128)], 8, (2, 2)),         # 6s block 4
    ([(100, 100)], 32, None),          # the 6s layer-19 head level
])
def test_chain_block_kernel_matches_plain(cuda, chans, H, pool):
    rng = np.random.default_rng(0)
    b, K = 3, 4
    convs = [_conv(rng, ci, co, cuda) for ci, co in chans][::-1]     # top-down
    W = H
    xs = [torch.as_tensor(np.maximum(rng.standard_normal((b, H, W, cv.ci)), 0)
                          .astype(np.float32), device=cuda) for cv in convs]
    R = torch.as_tensor(rng.standard_normal((b, K, H, W, convs[0].co)).astype(np.float32),
                        device=cuda)
    apre = None
    if pool:
        apre = rng.standard_normal((b, H * pool[0], W * pool[1], convs[-1].ci)).astype(np.float32)
        apre[0, :2, :pool[1]] = -1.0      # an all-tied (zero after relu) window
        apre = torch.as_tensor(apre, device=cuda)
    n0 = chain.LAUNCHES["chain_block"]
    got = chain.chain_block(R, xs, convs, apre, pool)
    assert chain.LAUNCHES["chain_block"] == n0 + 1
    _close(got, chain.chain_block_plain(R, xs, convs, apre, pool))


@pytest.mark.parametrize("ci,co", [(12, 16), (16, 12), (136, 136)])
def test_chain_block_kernel_refuses_unsupported_counts(cuda, ci, co):
    rng = np.random.default_rng(0)
    cv = _conv(rng, ci, co, cuda)
    x = torch.zeros((1, 8, 8, ci), device=cuda)
    R = torch.zeros((1, 2, 8, 8, co), device=cuda)
    n0 = chain.LAUNCHES["chain_block"]
    with pytest.raises(ValueError, match="channel counts"):
        chain.chain_block(R, [x], [cv])
    assert chain.LAUNCHES["chain_block"] == n0


@pytest.mark.parametrize("rule,H,C", [("wsquare", 128, 32), ("flat", 64, 8), ("wsquare", 16, 16)])
def test_first_layer_kernel_matches_plain(cuda, rule, H, C):
    rng = np.random.default_rng(1)
    b, K = 3, 4
    spec = vgg.LayerSpec("conv", "features.0", {})
    w = torch.as_tensor((rng.standard_normal((C, 1, 3, 3)) * 0.5).astype(np.float32), device=cuda)
    bias = torch.as_tensor((rng.standard_normal(C) * 0.1).astype(np.float32), device=cuda)
    fl = chain.prep_first_weights({"features.0": {"weight": w, "bias": bias}}, spec,
                                  (rule, {"stabilizer": 1e-7}), (H, H))
    a1 = rng.standard_normal((b, H, H, C)).astype(np.float32)
    a1[0, :2, :4] = 0.0                   # relu ties and an all-tied window
    a1 = torch.as_tensor(a1, device=cuda)
    R = torch.as_tensor(rng.standard_normal((b, K, H // 2, H // 2, C)).astype(np.float32),
                        device=cuda)
    n0 = chain.LAUNCHES["first_layer"]
    got = chain.first_layer(R, a1, fl)
    assert chain.LAUNCHES["first_layer"] == n0 + 1
    _close(got, chain.first_layer_plain(R, a1, fl))


def _deep_inputs(rng, dev, b, K, H, W, C0, C, kw, rule):
    spec, spec0 = vgg.LayerSpec("conv", "g", {}), vgg.LayerSpec("conv", "c0", {})
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    w3 = t(rng.standard_normal((C, C0, 3, 3)) * np.sqrt(2 / (9 * C0)))
    b3 = t(rng.standard_normal(C) * 0.05)
    b3[0] = -50.0                         # all-tied (zero after relu) pool windows
    gconv = chain.prep_inner_weights({"g": {"weight": w3, "bias": b3}}, spec,
                                     {"gamma": 0.3, "stabilizer": 1e-7})
    w0, b0 = t(rng.standard_normal((C0, 1, 3, 3)) * 0.5), t(rng.standard_normal(C0) * 0.1)
    fl = chain.prep_first_weights({"c0": {"weight": w0, "bias": b0}}, spec0,
                                  (rule, {"stabilizer": 1e-7}), (H, W))
    mel = t(rng.standard_normal((b, 1, H, W)))
    a1 = torch.nn.functional.conv2d(mel, w0, b0, padding=1).permute(0, 2, 3, 1).contiguous()
    a1[0, :2, :3] = 0.0                   # relu ties
    apre = vgg.conv2d_same_nhwc(torch.clamp(a1, min=0.0), w3, b3).contiguous()
    R = t(rng.standard_normal((b, K, H // 2, W // kw, C)))
    return R, a1, apre, gconv, fl, (2, kw)


@pytest.mark.parametrize("H,W,C0,C,kw,rule", [
    (16, 32, 8, 16, 4, "wsquare"),     # small
    (18, 20, 16, 8, 2, "flat"),        # ragged tiles, (2,2) pool
    (32, 64, 32, 64, 4, "wsquare"),
    (128, 256, 64, 64, 4, "wsquare"),  # the 6s widths
])
def test_first_block_deep_kernel_matches_plain(cuda, H, W, C0, C, kw, rule):
    args = _deep_inputs(np.random.default_rng(2), cuda, 2, 4, H, W, C0, C, kw, rule)
    n0 = chain.LAUNCHES["first_block_deep"]
    got = chain.first_block_deep(*args)
    assert chain.LAUNCHES["first_block_deep"] == n0 + 1
    _close(got, chain.first_block_deep_plain(*args))


def test_service_on_card_matches_plain_path(cuda):
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    specs = vgg.build_layer_specs(vgg.gtzan_3s_config())
    params = vgg.init_params(specs, 0, device="cuda")
    svc = ExplainerService(specs, params, LRP_NAME_MAP_GTZAN,
                           {"pop": random_orthogonal(0, 64)}, 4, 10)
    wavs = (np.random.default_rng(2).standard_normal((4, 48000)) * 0.3).astype(np.float32)
    chain.reset_launches()
    got, _ = svc._dispatch(wavs, "pop")
    counts = {"chain_block": 3, "first_layer": 1, "first_block_deep": 0, "merged_tail": 0}
    assert chain.LAUNCHES == counts
    want, _ = svc._dispatch(wavs, "pop", fused=False)
    assert chain.LAUNCHES == counts
    _close(got, want)


@pytest.mark.parametrize("layer,d,n_blocks", [(33, 128, 4), (19, 100, 2)])
def test_6s_service_on_card_matches_plain_path(cuda, layer, d, n_blocks):
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN_6S
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    specs, params = vgg.fold_batchnorm(*_6s_model())
    svc = ExplainerService(specs, params, LRP_NAME_MAP_GTZAN_6S,
                           {"jazz": random_orthogonal(0, d)}, 4, layer, case="gtzan_6s")
    wavs = (np.random.default_rng(2).standard_normal((2, 96000)) * 0.3).astype(np.float32)
    chain.reset_launches()
    got, _ = svc._dispatch(wavs, "jazz")
    counts = {"chain_block": n_blocks, "first_layer": 0, "first_block_deep": 1,
              "merged_tail": 0}
    assert chain.LAUNCHES == counts
    want, _ = svc._dispatch(wavs, "jazz", fused=False)
    assert chain.LAUNCHES == counts
    assert got.shape == (2, 5, 128, 256)
    _close(got, want)


def _merged_inputs(rng, dev, b, K, H, W, C, C6, m, rule):
    """merged_tail's arguments: m merged convs (conv 6 C -> C6 above conv 3
    C -> C), pools with all-tied windows, a1 with relu ties."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    convs = [_conv(rng, C, C6, dev), _conv(rng, C, C, dev)][2 - m:]
    xs = [t(np.maximum(rng.standard_normal((b, H // 4, W // 4, C)), 0)),
          t(np.maximum(rng.standard_normal((b, H // 2, W // 2, C)), 0))][2 - m:]
    apre = rng.standard_normal((b, H // 2, W // 2, C))
    apre[0, :2, :2] = -1.0                # an all-tied (zero after relu) window
    apres = [t(apre)][:m - 1]
    spec = vgg.LayerSpec("conv", "c0", {})
    w0, b0 = t(rng.standard_normal((C, 1, 3, 3)) * 0.5), t(rng.standard_normal(C) * 0.1)
    fl = chain.prep_first_weights({"c0": {"weight": w0, "bias": b0}}, spec,
                                  (rule, {"stabilizer": 1e-7}), (H, W))
    a1 = rng.standard_normal((b, H, W, C))
    a1[0, :2, :4] = 0.0                   # relu ties and an all-tied window
    R = rng.standard_normal((b, K, H // (2 * m), W // (2 * m), convs[0].co))
    return t(R), xs, convs, apres, t(a1), fl


@pytest.mark.parametrize("H,W,C,C6,m,rule", [
    (128, 128, 32, 64, 2, "wsquare"),   # the 3s widths, DRSA layer 10
    (64, 64, 8, 16, 2, "flat"),         # the toy widths
    (40, 72, 32, 64, 2, "flat"),        # ragged tiles
    (128, 128, 32, 64, 1, "wsquare"),   # one merged conv (layer 7)
    (36, 20, 8, 16, 1, "flat"),         # one merged conv, ragged
])
def test_merged_tail_kernel_matches_plain(cuda, H, W, C, C6, m, rule):
    args = _merged_inputs(np.random.default_rng(3), cuda, 2, 4, H, W, C, C6, m, rule)
    n0 = chain.LAUNCHES["merged_tail"]
    got = chain.merged_tail(*args)
    assert chain.LAUNCHES["merged_tail"] == n0 + 1
    _close(got, chain.merged_tail_plain(*args))


def test_merged_tail_kernel_refuses_unsupported_counts(cuda):
    args = _merged_inputs(np.random.default_rng(3), cuda, 1, 2, 32, 32, 16, 32, 2, "flat")
    n0 = chain.LAUNCHES["merged_tail"]
    with pytest.raises(ValueError, match="channel counts"):
        chain.merged_tail(*args)
    assert chain.LAUNCHES["merged_tail"] == n0


@pytest.mark.parametrize("layer", [10, 7])
def test_service_merged_on_card_matches_default_path(cuda, monkeypatch, layer):
    """The 3s service with the merged-tail switch on: one chain_block and one
    merged_tail launch per request (two merged convs at layer 10, one at
    layer 7), heatmaps equal to the default multi-kernel path and to the
    plain walk."""
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    monkeypatch.delenv("DRSA_CHAIN_MERGED", raising=False)
    specs = vgg.build_layer_specs(vgg.gtzan_3s_config())
    params = vgg.init_params(specs, 0, device="cuda")
    svc = ExplainerService(specs, params, LRP_NAME_MAP_GTZAN,
                           {"pop": random_orthogonal(0, 64)}, 4, layer)
    wavs = (np.random.default_rng(2).standard_normal((4, 48000)) * 0.3).astype(np.float32)
    want, _ = svc._dispatch(wavs, "pop")
    monkeypatch.setattr(chain, "CHAIN_MERGED", True)
    chain.reset_launches()
    got, _ = svc._dispatch(wavs, "pop")
    assert chain.LAUNCHES == {"chain_block": 1, "first_layer": 0, "first_block_deep": 0,
                              "merged_tail": 1}
    _close(got, want)
    _close(got, svc._dispatch(wavs, "pop", fused=False)[0])


def _6s_model():
    """The 6s layer list and seeded random weights with random BN
    statistics (so the fold is not the identity), as chip_smoke.py draws
    them."""
    from chip_smoke import random_bn_stats
    specs = vgg.build_layer_specs(vgg.gtzan_6s_config())
    return specs, random_bn_stats(vgg.init_params(specs, 0, device="cuda"), seed=1)


# ------------------------------------------------------------ gamma_nonneg

def _gamma_inputs(rng, b, K, ci, co, H, W, dev):
    x = np.maximum(rng.standard_normal((b, ci, H, W)), 0).astype(np.float32)
    x[0, 0, :2] = 0.0
    R = rng.standard_normal((K * b, co, H, W)).astype(np.float32)
    w = (rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci))).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.05).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (x, R, w, bias)]


@pytest.mark.parametrize("ci,co,H,W", [
    (64, 64, 16, 16), (32, 64, 32, 32), (32, 32, 64, 64),   # 3s convs 9, 6, 3
    (8, 16, 8, 8), (16, 16, 8, 16),                          # the JAX test's shapes
    (8, 8, 9, 13), (16, 32, 7, 5),                           # toy widths, ragged
    (64, 100, 16, 16), (100, 100, 11, 6), (100, 128, 8, 8),  # 6s widths
    (128, 128, 17, 9), (64, 64, 128, 256),                   # widest; 6s block 0
])
@pytest.mark.parametrize("K", [1, 2])
def test_gamma_nonneg_kernel_matches_plain(cuda, ci, co, H, W, K):
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    rng = np.random.default_rng(ci * 1000 + co)
    b = 1 if H * W > 10000 else 3
    x, R, w, bias = _gamma_inputs(rng, b, K, ci, co, H, W, cuda)
    n0 = fused_gamma.LAUNCHES["gamma_nonneg"]
    got = fused_gamma.gamma_nonneg_folded(x, R, w, bias, K, gamma=0.3, stabilizer=1e-7)
    assert fused_gamma.LAUNCHES["gamma_nonneg"] == n0 + 1
    _close(got, fused_gamma.gamma_nonneg_folded_plain(x, R, w, bias, K, 0.3, 1e-7))


@pytest.mark.parametrize("ci,co", [(8, 12), (6, 16), (136, 128), (64, 136)])
def test_gamma_nonneg_kernel_refuses_unsupported_counts(cuda, ci, co):
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    x, R, w, bias = _gamma_inputs(np.random.default_rng(0), 1, 2, ci, co, 8, 8, cuda)
    n0 = fused_gamma.LAUNCHES["gamma_nonneg"]
    with pytest.raises(ValueError, match="cudaErrorInvalidValue"):
        fused_gamma.gamma_nonneg_folded(x, R, w, bias, 2)
    assert fused_gamma.LAUNCHES["gamma_nonneg"] == n0


# ------------------------------------------------------------------ logmel

@pytest.mark.parametrize("case,b", [("toy", 32), ("gtzan", 7), ("gtzan_6s", 3)])
def test_logmel_kernel_matches_plain(cuda, case, b):
    """rtol 1e-4, atol 1e-4 in log10 units; an odd batch, and a silent clip
    among the clips (all -4)."""
    from drsa_audio_tpu_torch.ops import frontend, fused_frontend
    cfg = frontend.FrontendConfig.for_case(case)
    rng = np.random.default_rng(b)
    wav = (rng.standard_normal((b, cfg.sample_rate * cfg.slice_length)) * 0.3).astype(np.float32)
    wav[1] = 0.0
    wav = frontend.peak_normalize(torch.as_tensor(wav, device=cuda))
    n0 = fused_frontend.LAUNCHES["logmel"]
    got = fused_frontend.fused_logmel(wav, cfg)
    assert fused_frontend.LAUNCHES["logmel"] == n0 + 1
    assert got.shape == (b, cfg.n_mels, cfg.width) and bool((got[1] == -4.0).all())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_frontend.fused_logmel_plain(wav, cfg),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, frontend.logmel(wav, cfg), rtol=1e-4, atol=1e-4)


def test_logmel_kernel_refuses_unsupported_sizes(cuda):
    from drsa_audio_tpu_torch.ops import frontend, fused_frontend
    cfg = frontend.FrontendConfig.for_case("toy")
    with pytest.raises(ValueError, match="cudaErrorInvalidValue"):
        fused_frontend.fused_logmel(torch.zeros((2, 1000), device=cuda), cfg)
