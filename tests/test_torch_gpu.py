"""Each CUDA kernel of the port against its plain PyTorch version, on the
card (TF32 off), at small shapes and the 3s model's widths. Run on a GPU
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
    assert chain.LAUNCHES == {"chain_block": 3, "first_layer": 1}
    want, _ = svc._dispatch(wavs, "pop", fused=False)
    assert chain.LAUNCHES == {"chain_block": 3, "first_layer": 1}
    _close(got, want)
