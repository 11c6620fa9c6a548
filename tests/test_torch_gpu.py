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


@pytest.mark.parametrize("chans,H,W,pool,b,K", [
    ([(64, 64)], 16, 16, (2, 2), 3, 4),           # 3s block 3
    ([(32, 64)], 32, 32, (2, 2), 3, 4),           # 3s block 2
    ([(32, 32)], 64, 64, None, 3, 4),             # 3s block 1
    ([(8, 16)], 8, 8, (2, 2), 3, 4),              # toy widths
    ([(16, 16), (16, 32)], 8, 8, (2, 4), 3, 4),   # two convs, a (2,4) pool
    ([(128, 128)], 6, 6, None, 3, 4),             # widest, ragged tile
    ([(64, 100)], 16, 16, (2, 2), 3, 4),          # 6s block 2, bottom conv
    ([(64, 100), (100, 100)], 8, 8, (2, 2), 3, 4),     # 6s block 2, both convs
    ([(100, 128), (128, 128)], 8, 8, (2, 2), 3, 4),    # 6s block 3
    ([(100, 128)], 6, 6, None, 3, 4),             # 6s block 3, bottom conv, ragged tile
    ([(128, 128)], 8, 8, (2, 2), 3, 4),           # 6s block 4
    ([(100, 100)], 32, 32, None, 3, 4),           # the 6s layer-19 head level
    # every channel level through both tensor-core launches, Ci != Co, ragged
    # sizes, one and several clones and instances
    ([(8, 8)], 9, 13, (2, 2), 1, 1),              # toy level, ragged 8x8 tiles
    ([(8, 16)], 12, 20, (2, 4), 3, 4),            # toy widths, a (2,4) pool
    ([(16, 16)], 17, 11, None, 3, 1),
    ([(32, 32)], 40, 24, None, 1, 4),             # 3s block 1 level, ragged 32x8 tiles
    ([(32, 64)], 20, 12, (2, 2), 3, 1),           # 3s block 2 level
    ([(64, 64)], 33, 17, (2, 4), 1, 1),           # ragged 32x8 apply tiles
    ([(64, 100)], 18, 10, (2, 2), 1, 4),          # the apply's N = 64
    ([(100, 100)], 9, 9, None, 3, 1),             # the 100-channel level both ways
    ([(100, 128)], 10, 14, (2, 4), 3, 4),         # the apply's N = 104
    ([(128, 64)], 8, 8, (2, 2), 1, 4),
    ([(128, 128)], 12, 8, (2, 2), 1, 4),          # the prep's two column blocks
    # the main path's levels as the 6s layer-33 request walks them (b=64
    # there): the apply's N = 128, 104, 64 and the prep's 4 column chunks
    ([(128, 128), (128, 128)], 8, 8, (2, 2), 2, 4),    # 6s block 4
    ([(100, 128), (128, 128)], 16, 16, (2, 2), 2, 4),  # 6s block 3
    ([(64, 100), (100, 100)], 32, 32, (2, 2), 2, 4),   # 6s block 2, C=100
    ([(64, 64), (64, 64)], 64, 64, None, 2, 4),        # 6s block 1
])
def test_chain_block_kernel_matches_plain(cuda, chans, H, W, pool, b, K):
    """Pools hold an all-tied (zero after relu) window."""
    rng = np.random.default_rng(0)
    convs = [_conv(rng, ci, co, cuda) for ci, co in chans][::-1]     # top-down
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


def _relaid(cv, prep_chunk, apply_cols):
    """cv with its wgmma taps laid out again in other widths."""
    import dataclasses
    pair = (torch.stack([cv.wz1, cv.wz3], dim=1).reshape(2 * cv.co, cv.ci, 3, 3)
            .permute(2, 3, 1, 0).reshape(9, cv.ci, 2 * cv.co))
    w_apply = cv.wz1.flip(2, 3).permute(2, 3, 0, 1).reshape(9, cv.co, cv.ci)
    return dataclasses.replace(cv, w_prep_wg=chain.wgmma_taps(pair, prep_chunk),
                               w_apply_wg=chain.wgmma_taps(w_apply, apply_cols))


@pytest.mark.parametrize("prep_chunk,apply_cols,takes", [
    (16, 128, True),       # other widths than the layout's own: still the plain result
    (24, 64, False),       # a prep chunk without an instance
    (32, 32, False),       # an apply tile narrower than Ci
])
def test_chain_block_kernel_takes_the_layouts_width(cuda, prep_chunk, apply_cols, takes):
    """The kernels multiply in the widths the host laid the taps out in
    (GammaConv.prep_cols, apply_cols) and refuse, before any launch, a width
    they have no instance for."""
    rng = np.random.default_rng(5)
    cv = _relaid(_conv(rng, 64, 64, cuda), prep_chunk, apply_cols)
    assert (cv.prep_cols, cv.apply_cols) == (prep_chunk, apply_cols)
    x = torch.as_tensor(np.maximum(rng.standard_normal((2, 16, 16, 64)), 0).astype(np.float32),
                        device=cuda)
    R = torch.as_tensor(rng.standard_normal((2, 4, 16, 16, 64)).astype(np.float32), device=cuda)
    apre = torch.as_tensor(rng.standard_normal((2, 32, 32, 64)).astype(np.float32), device=cuda)
    n0 = chain.LAUNCHES["chain_block"]
    if not takes:
        with pytest.raises(ValueError, match="channel counts or shapes"):
            chain.chain_block(R, [x], [cv], apre, (2, 2))
        assert chain.LAUNCHES["chain_block"] == n0
        return
    got = chain.chain_block(R, [x], [cv], apre, (2, 2))
    _close(got, chain.chain_block_plain(R, [x], [cv], apre, (2, 2)))


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


def _first_inputs(rng, dev, rule, b, K, H, W, C):
    spec = vgg.LayerSpec("conv", "features.0", {})
    w = torch.as_tensor((rng.standard_normal((C, 1, 3, 3)) * 0.5).astype(np.float32), device=dev)
    bias = torch.as_tensor((rng.standard_normal(C) * 0.1).astype(np.float32), device=dev)
    fl = chain.prep_first_weights({"features.0": {"weight": w, "bias": bias}}, spec,
                                  (rule, {"stabilizer": 1e-7}), (H, W))
    a1 = rng.standard_normal((b, H, W, C)).astype(np.float32)
    a1[0, :2, :4] = 0.0                   # relu ties and an all-tied window
    a1[-1, -2:, -4:] = -1.0               # an all-negative window (gate 0)
    R = rng.standard_normal((b, K, H // 2, W // 2, C)).astype(np.float32)
    return torch.as_tensor(R, device=dev), torch.as_tensor(a1, device=dev), fl


@pytest.mark.parametrize("rule,b,K,H,W,C", [
    ("wsquare", 3, 4, 128, 128, 32),      # the 3s service's shape (b=256 there)
    ("flat", 3, 4, 64, 64, 8),            # the toy service's shape
    ("wsquare", 2, 1, 40, 72, 16),        # one clone; a band cut short (20 coarse rows)
    ("flat", 1, 6, 8, 24, 8),             # more clones than 4; one short band
    ("wsquare", 1, 4, 16, 512, 8),        # 1024 column-clone pairs: two clone groups
])
def test_first_layer_kernel_matches_plain_at_band_edges(cuda, rule, b, K, H, W, C):
    """The banded kernel where bands, clone groups and the image's edges
    fall: every heatmap pixel sums its four patches, across band and
    column borders."""
    R, a1, fl = _first_inputs(np.random.default_rng(5), cuda, rule, b, K, H, W, C)
    n0 = chain.LAUNCHES["first_layer"]
    got = chain.first_layer(R, a1, fl)
    assert chain.LAUNCHES["first_layer"] == n0 + 1
    _close(got, chain.first_layer_plain(R, a1, fl))


@pytest.mark.parametrize("H,W,C", [(128, 128, 32), (40, 72, 16)])
def test_first_layer_kernel_is_deterministic(cuda, H, W, C):
    R, a1, fl = _first_inputs(np.random.default_rng(6), cuda, "wsquare", 2, 4, H, W, C)
    first = chain.first_layer(R, a1, fl)
    for _ in range(3):
        assert torch.equal(first, chain.first_layer(R, a1, fl))


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


@pytest.mark.parametrize("H,W,C0,C,kw,rule,b,K", [
    (16, 32, 8, 16, 4, "wsquare", 2, 4),     # small
    (18, 20, 16, 8, 2, "flat", 2, 4),        # ragged tiles, (2,2) pool
    (32, 64, 32, 64, 4, "wsquare", 2, 4),
    (128, 256, 64, 64, 4, "wsquare", 2, 4),  # the 6s widths
    (16, 40, 64, 64, 4, "wsquare", 1, 1),    # W not a multiple of the tile
    (34, 36, 32, 100, 2, "flat", 3, 1),      # the 100-channel level as C
    (20, 24, 8, 8, 2, "wsquare", 1, 4),      # the narrowest C0 and C
    (50, 68, 16, 128, 4, "flat", 3, 4),      # ragged in both directions, C = 128
    (128, 256, 64, 64, 4, "flat", 1, 4),     # the 6s widths, the flat rule
    (36, 44, 24, 100, 2, "wsquare", 2, 4),   # C0 = 24 (a 32-wide tile), C = 100
])
def test_first_block_deep_kernel_matches_plain(cuda, H, W, C0, C, kw, rule, b, K):
    args = _deep_inputs(np.random.default_rng(2), cuda, b, K, H, W, C0, C, kw, rule)
    n0 = chain.LAUNCHES["first_block_deep"]
    got = chain.first_block_deep(*args)
    assert chain.LAUNCHES["first_block_deep"] == n0 + 1
    _close(got, chain.first_block_deep_plain(*args))


@pytest.mark.parametrize("apply_cols,takes", [(64, True), (24, False), (16, False)])
def test_first_block_deep_kernel_takes_the_layouts_width(cuda, apply_cols, takes):
    """first_block_deep multiplies in the width of its transposed layout
    (GammaConv.apply_cols), here wider than C0 = 32, and refuses one without
    an instance or narrower than C0."""
    R, a1, apre, gconv, fl, pool = _deep_inputs(np.random.default_rng(7), cuda, 2, 4, 32, 64,
                                                32, 64, 4, "wsquare")
    gconv = _relaid(gconv, gconv.prep_cols, apply_cols)
    n0 = chain.LAUNCHES["first_block_deep"]
    if not takes:
        with pytest.raises(ValueError, match="channel counts or shapes"):
            chain.first_block_deep(R, a1, apre, gconv, fl, pool)
        assert chain.LAUNCHES["first_block_deep"] == n0
        return
    got = chain.first_block_deep(R, a1, apre, gconv, fl, pool)
    _close(got, chain.first_block_deep_plain(R, a1, apre, gconv, fl, pool))


@pytest.mark.parametrize("H,W,C0,C,kw,rule", [
    (128, 256, 64, 64, 4, "wsquare"),        # the 6s widths
    (50, 68, 16, 128, 4, "flat"),            # ragged in both directions
    (18, 20, 16, 8, 2, "wsquare"),           # ragged, (2,2) pool
    (36, 44, 24, 100, 2, "flat"),            # C0 = 24, C = 100
])
def test_first_block_deep_kernel_is_deterministic(cuda, H, W, C0, C, kw, rule):
    """Runs on the same inputs give the same bits: each heatmap pixel on a
    tile's ring sums the tiles' shares in a fixed order."""
    args = _deep_inputs(np.random.default_rng(4), cuda, 2, 4, H, W, C0, C, kw, rule)
    first = chain.first_block_deep(*args)
    for _ in range(3):
        assert torch.equal(first, chain.first_block_deep(*args))


@pytest.mark.parametrize("name,want,other", [
    ("chain_block", "HGMMA", "HMMA"), ("first_block_deep", "HGMMA", "HMMA"),
    ("merged_tail", "HMMA", None), ("gamma_nonneg", "HMMA", None)])
def test_tensor_core_instructions_in_sass(cuda, name, want, other):
    """chain_block's and first_block_deep's libraries multiply on wgmma
    (HGMMA in their SASS) and hold no mma.sync (HMMA); merged_tail and
    gamma_nonneg stay on mma.sync (cuobjdump of the built library)."""
    import os
    import re
    import subprocess

    from drsa_audio_tpu_torch.utils import nvcc
    lib = nvcc.build([name])[name]
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", sass)
    assert ops.count(want) > 0
    if other is not None:
        assert ops.count(other) == 0


@pytest.mark.parametrize("margin", [1e-5, 1e-6])
@pytest.mark.parametrize("ci,co", [(8, 16), (32, 32), (64, 64), (64, 100), (100, 128),
                                   (128, 128)])
def test_gamma_prep_sign_decisions_at_planted_near_ties(cuda, ci, co, margin):
    """The prep's sign decisions where z_true lies ``margin`` times the scale
    of its own sum (S = the sum of the |terms|) from zero: one pixel per
    output channel, planted by the channel's bias, above zero for even
    channels and below for odd. z_true's sign in float64 decides: the
    kernel's G must be non-zero exactly where it is positive, and there
    equal 1 / stab(z1 + b2) at rtol 1e-4, atol 1e-5 * max."""
    import ctypes
    rng = np.random.default_rng(ci * 1000 + co)
    b, H, W = 2, 16, 16
    x = torch.as_tensor(np.maximum(rng.standard_normal((b, H, W, ci)), 0).astype(np.float32),
                        device=cuda)
    w = torch.as_tensor((rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
                        .astype(np.float32), device=cuda)
    spec = vgg.LayerSpec("conv", "c", {})

    def prep(bias):
        return chain.prep_inner_weights({"c": {"weight": w, "bias": bias}}, spec,
                                        {"gamma": 0.3, "stabilizer": 1e-7})

    cv = prep(torch.zeros(co, device=cuda))
    x64 = x.double()
    conv64 = lambda wt: vgg.conv2d_same_nhwc(x64, wt.double(), None)    # noqa: E731
    c = (conv64(cv.wz1) + conv64(cv.wz3)) * cv.inv                      # z_true less b0
    S = vgg.conv2d_same_nhwc(x64, cv.wz1.double().abs() + cv.wz3.double().abs(), None) * cv.inv
    o = torch.arange(co, device=cuda)
    at = (torch.as_tensor(rng.integers(0, b, co), device=cuda),
          torch.as_tensor(rng.integers(0, H, co), device=cuda),
          torch.as_tensor(rng.integers(0, W, co), device=cuda), o)
    sign = 1.0 - 2.0 * (o % 2).double()
    cv = prep((-c[at] + sign * margin * S[at]).float())
    b1, b0, b2 = (v.double() for v in cv.biases)
    z_true = c[at] + b0
    assert ((z_true * sign) > 0.5 * margin * S[at]).all()     # planted, after the f32 bias
    G = chain._gamma_prep(x, cv, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    got = G[at].double()
    flipped = int(((got != 0) != (z_true > 0)).sum())
    assert flipped == 0, f"{flipped} of {co} planted sign decisions differ from float64"
    pos = z_true > 0
    want = 1.0 / chain.stabilize(conv64(cv.wz1)[at] + b1 + b2, cv.stab)
    torch.testing.assert_close(got[pos], want[pos], rtol=1e-4,
                               atol=1e-5 * want[pos].abs().max().item())


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


@pytest.mark.parametrize("H,W,C,C6,m,rule", [
    (128, 128, 32, 64, 2, "wsquare"),   # two merged convs
    (40, 72, 8, 16, 2, "flat"),         # ragged tiles
    (128, 128, 32, 64, 1, "wsquare"),   # one merged conv
    (36, 20, 8, 16, 1, "flat"),
])
def test_merged_tail_kernel_is_deterministic(cuda, H, W, C, C6, m, rule):
    """Runs on the same inputs give the same bits: each heatmap pixel adds
    its four patches in a fixed order, no atomics."""
    args = _merged_inputs(np.random.default_rng(8), cuda, 2, 4, H, W, C, C6, m, rule)
    first = chain.merged_tail(*args)
    for _ in range(3):
        assert torch.equal(first, chain.merged_tail(*args))


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

def _gamma_inputs(rng, b, K, ci, co, H, W, dev, gamma=0.3):
    """Random x >= 0, R, w and bias; R is zero where z_true lies within
    1e-6 of the scale of its own sum (S, the sum of the |terms|) from zero.
    There the kernel's sums (3xTF32) and the plain version's (cuDNN, f32)
    may take the sign of z_true differently, both within f32 round-off of
    it (the f32 and float64 signs differ there too), and in the LRP walk
    such a neuron's relevance is about zero. The decisions themselves are
    held to float64 by test_gamma_nonneg_sign_decisions_at_planted_near_ties."""
    x = np.maximum(rng.standard_normal((b, ci, H, W)), 0).astype(np.float32)
    x[0, 0, :2] = 0.0
    R = rng.standard_normal((K * b, co, H, W)).astype(np.float32)
    w = (rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci))).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.05).astype(np.float32)
    x, R, w, bias = (torch.as_tensor(a, device=dev) for a in (x, R, w, bias))
    if 0 < co <= 128 and ci <= 128:
        wz1, wz3 = w + gamma * w.clamp(min=0), w + gamma * w.clamp(max=0)
        conv = lambda wt: torch.nn.functional.conv2d(x.double(), wt.double(), padding=1)  # noqa
        b64 = bias.double()[:, None, None]
        z_true = (conv(wz1) + conv(wz3)) / (2 + gamma) + b64
        S = conv(wz1.abs() + wz3.abs()) / (2 + gamma) + b64.abs()
        near = (z_true.abs() < 1e-6 * S).repeat(K, 1, 1, 1)
        R = torch.where(near, 0.0, R)
    return [x, R, w, bias]


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


@pytest.mark.parametrize("ci,co,H,W", [(32, 64, 32, 32), (100, 100, 11, 6), (12, 20, 9, 7)])
def test_gamma_nonneg_kernel_is_deterministic(cuda, ci, co, H, W):
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    x, R, w, bias = _gamma_inputs(np.random.default_rng(ci + co), 3, 4, ci, co, H, W, cuda)
    first = fused_gamma.gamma_nonneg_folded(x, R, w, bias, 4, gamma=0.3, stabilizer=1e-7)
    for _ in range(3):
        assert torch.equal(first, fused_gamma.gamma_nonneg_folded(x, R, w, bias, 4, gamma=0.3,
                                                                  stabilizer=1e-7))


@pytest.mark.parametrize("margin", [1e-5, 1e-6])
@pytest.mark.parametrize("ci,co", [(8, 16), (32, 32), (64, 64), (64, 100), (100, 128),
                                   (128, 128)])
def test_gamma_nonneg_sign_decisions_at_planted_near_ties(cuda, ci, co, margin):
    """The gamma_nonneg prep's sign decisions where z_true lies ``margin``
    times the scale of its own sum (S = the sum of the |terms|) from zero,
    as test_gamma_prep_sign_decisions_at_planted_near_ties plants them: one
    pixel per output channel, above zero for even channels and below for
    odd. z_true's sign in float64 decides: m1 must be non-zero exactly where
    it is positive and m3 exactly where it is negative, and there be the
    inverse of stab(z1 + b2) and of stab(z3) in float64, at rtol 1e-4 and
    atol 1e-6 times the sum of the |terms| of that denominator."""
    import ctypes
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    rng = np.random.default_rng(ci * 1000 + co + 7)
    b, H, W, gamma, stab = 2, 16, 16, 0.3, 1e-7
    x = torch.as_tensor(np.maximum(rng.standard_normal((b, ci, H, W)), 0).astype(np.float32),
                        device=cuda)
    w = torch.as_tensor((rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
                        .astype(np.float32), device=cuda)
    wf, _, bias3 = fused_gamma.pair_weights(w, torch.zeros(co, device=cuda), gamma)
    inv = float(np.float32(1.0 / (2.0 + gamma)))
    x64 = x.double()
    conv64 = lambda wt: torch.nn.functional.conv2d(x64, wt.double(), padding=1)  # noqa: E731
    gp, gn = (lambda p: p + gamma * p.clamp(min=0)), (lambda p: p + gamma * p.clamp(max=0))
    z3_0 = conv64(gn(w))
    c = (conv64(gp(w)) + z3_0) * inv                                     # z_true less b0
    S = conv64(gp(w).abs() + gn(w).abs()) * inv
    o = torch.arange(co, device=cuda)
    at = (torch.as_tensor(rng.integers(0, b, co), device=cuda), o,
          torch.as_tensor(rng.integers(0, H, co), device=cuda),
          torch.as_tensor(rng.integers(0, W, co), device=cuda))
    sign = 1.0 - 2.0 * (o % 2).double()
    bias = (-c[at] + sign * margin * S[at]).float()
    _, _, bias3 = fused_gamma.pair_weights(w, bias, gamma)
    b1, b0, b2 = (v.double() for v in bias3)
    z_true = c[at] + b0
    assert ((z_true * sign) > 0.5 * margin * S[at]).all()     # planted, after the f32 bias
    M = torch.empty((b, H, W, 2 * co), device=cuda)
    err = fused_gamma._lib().gamma_nonneg_prep(
        x.data_ptr(), wf.data_ptr(), bias3.data_ptr(),
        M.data_ptr(), b, H, W, ci, co, inv, stab,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    torch.cuda.synchronize()
    m1, m3 = (M[at[0], at[2], at[3], 2 * o + s].double() for s in (0, 1))
    pos, neg = z_true > 0, z_true < 0
    flipped = int(((m1 != 0) != pos).sum() + ((m3 != 0) != neg).sum())
    assert flipped == 0, f"{flipped} of {2 * co} planted sign decisions differ from float64"
    # the denominators, within f32 round-off of the sums behind them (a
    # denominator far smaller than its terms is cancellation-limited)
    den1 = chain.stabilize(conv64(gp(w))[at] + b1 + b2, stab)
    den3 = chain.stabilize(z3_0[at], stab)
    S1 = conv64(gp(w).abs())[at] + b1.abs() + b2.abs()
    S3 = conv64(gn(w).abs())[at]
    for got, den, scale, sel in ((m1, den1, S1, pos), (m3, den3, S3, neg)):
        err = (1.0 / got[sel] - den[sel]).abs()
        assert (err <= 1e-4 * den[sel].abs() + 1e-6 * scale[sel]).all(), err.max().item()


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


def _logmel_case(case, b, seed, length=None):
    from drsa_audio_tpu_torch.ops import frontend
    cfg = frontend.FrontendConfig.for_case(case)
    n = length or cfg.sample_rate * cfg.slice_length
    wav = np.random.default_rng(seed).standard_normal((b, n)) * 0.3
    return cfg, wav.astype(np.float32)


def _logmel_close(wav, cfg):
    """The kernel (one launch) against the plain version and the matmul-DFT
    logmel at rtol 1e-4, atol 1e-4 in log10 units; returns the kernel's."""
    from drsa_audio_tpu_torch.ops import frontend, fused_frontend
    n0 = fused_frontend.LAUNCHES["logmel"]
    got = fused_frontend.fused_logmel(wav, cfg)
    assert fused_frontend.LAUNCHES["logmel"] == n0 + 1
    assert got.shape == (wav.shape[0], cfg.n_mels, cfg.width)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_frontend.fused_logmel_plain(wav, cfg),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, frontend.logmel(wav, cfg), rtol=1e-4, atol=1e-4)
    return got


@pytest.mark.parametrize("case", ["toy", "gtzan", "gtzan_6s"])
def test_logmel_kernel_is_deterministic(cuda, case):
    from drsa_audio_tpu_torch.ops import frontend, fused_frontend
    cfg, wav = _logmel_case(case, 5, 11)
    wav = frontend.peak_normalize(torch.as_tensor(wav, device=cuda))
    first = fused_frontend.fused_logmel(wav, cfg)
    for _ in range(3):
        assert torch.equal(first, fused_frontend.fused_logmel(wav, cfg))


@pytest.mark.parametrize("case,length,width", [
    ("gtzan", 43000, 118),     # 120 frames, the last tile 6 of 16, reflect at the end
    ("toy", 12345, 50),        # 52 frames, the last tile 2 of 16
    ("gtzan_6s", 96000, 263),  # every frame but the crop's, 263 = 16 * 16 + 7
])
def test_logmel_kernel_at_ragged_frame_counts(cuda, case, length, width):
    """A kept-frame count that is not a multiple of the block's 16-frame
    tile: the last tile keeps fewer frames, and its span runs into the
    reflect pad at the clip's end."""
    from drsa_audio_tpu_torch.ops import frontend
    cfg, wav = _logmel_case(case, 3, 12, length)
    cfg = cfg._replace(width=width)
    _logmel_close(frontend.peak_normalize(torch.as_tensor(wav, device=cuda)), cfg)


@pytest.mark.parametrize("case", ["toy", "gtzan"])
def test_logmel_kernel_loud_beside_silent(cuda, case):
    """A loud clip (noise at 1e3 times full scale, not normalised) beside a
    silent one (all -4) and a quiet one (1e-3 of full scale)."""
    cfg, wav = _logmel_case(case, 3, 13)
    wav[0] *= 1e3 / np.abs(wav[0]).max()
    wav[1] = 0.0
    wav[2] *= 1e-3 / np.abs(wav[2]).max()
    got = _logmel_close(torch.as_tensor(wav, device=cuda), cfg)
    assert bool((got[1] == -4.0).all()) and got[0].max().item() > 4.0


def test_heatmap_generator_on_card_launches_the_chain_and_matches_plain(cuda):
    """HeatmapGenerator on the 3s model at full width, 6 mel clips in
    chunks of 4: chain_block 3 times and first_layer once per chunk, and
    the heatmaps against the plain tiled walk on the same chunks; the
    shared-denominator call launches gamma_nonneg 3 times per chunk and no
    chain kernel."""
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN
    from drsa_audio_tpu_torch.xai import explain
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    specs = vgg.build_layer_specs(vgg.gtzan_3s_config())
    gen = explain.HeatmapGenerator(specs=specs, params=vgg.init_params(specs, 0, device="cuda"),
                                   U=random_orthogonal(5, 64), name_map=LRP_NAME_MAP_GTZAN,
                                   sample_class="blues")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((6, 1, 128, 128))
                        .astype(np.float32), device=cuda)
    chain.reset_launches()
    fused_gamma.reset_launches()
    raw = gen.generate_subspace_heatmaps(x, concept_flipping=True, attr_batch_size=4)
    assert chain.LAUNCHES == {"chain_block": 6, "first_layer": 2, "first_block_deep": 0,
                              "merged_tail": 0}
    onehot = torch.zeros(10, device=cuda)
    onehot[gen.class_idx] = 1.0
    with torch.inference_mode():
        want = torch.cat([explain.subspace_heatmaps(
            gen.specs_proj, gen.params, x[i:i + 4], gen.composite, 4,
            output_mask=lambda lg: lg * onehot, fused=False)[0] for i in (0, 4)])
    _close(torch.as_tensor(raw, device=cuda), want[:, 1:])
    chain.reset_launches()
    sub = gen.generate_subspace_heatmaps(x[:4], shared_denominators=True)
    assert fused_gamma.LAUNCHES["gamma_nonneg"] == 3 and sum(chain.LAUNCHES.values()) == 0
    assert np.isfinite(sub).all()
    np.testing.assert_allclose(gen.info["standard_heatmaps"][:, 0], sub.sum(axis=1), rtol=1e-5,
                               atol=1e-6 * np.abs(sub).max())


@pytest.mark.parametrize("method", ["ns", "eigh"])
def test_drsa_fit_on_card_matches_cpu(cuda, method):
    """30 steps from the same U0 on the card and on the CPU (d 64, K 4, 3
    runs, 2,000 vectors): the objectives at rtol 2e-2 (the JAX package's
    trajectory bound), every U orthogonal."""
    from drsa_audio_tpu_torch.xai.drsa import optimizer, preprocessing
    rng = np.random.default_rng(4)
    A, C = (preprocessing.normalize_vectors(torch.as_tensor(
        rng.standard_normal((2000, 64)).astype(np.float32))) for _ in range(2))
    U0 = optimizer.init_runs(0, 64, 3)
    got = optimizer.drsa_fit(U0, A.to(cuda), C.to(cuda), 4, 30, method)
    want = optimizer.drsa_fit(U0, A, C, 4, 30, method, device="cpu")
    assert got.U.device.type == "cuda"
    np.testing.assert_allclose(got.objectives.cpu().numpy(), want.objectives.numpy(), rtol=2e-2)
    eye = torch.eye(64, device=cuda)
    assert (got.U.transpose(-2, -1) @ got.U - eye).abs().max().item() <= 1e-4


def test_preprocess_data_on_card_matches_cpu(cuda):
    """The captured maps of the 3s model at layer 10 on the card against the
    CPU, through preprocess_data's inference mode (vectors of every
    position): activations, and relevances as R = c * (a + 1e-7)."""
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN
    from drsa_audio_tpu_torch.xai.drsa.preprocessing import preprocess_data
    from drsa_audio_tpu_torch.xai.lrp.engine import Composite
    specs = vgg.build_layer_specs(vgg.gtzan_3s_config())
    params = vgg.init_params(specs, 0, device="cpu")
    comp = Composite.from_list(LRP_NAME_MAP_GTZAN)
    x = np.random.default_rng(5).standard_normal((4, 1, 128, 128)).astype(np.float32)
    a, c = preprocess_data(specs, params, x, comp, 10, 2, attr_batch_size=2)
    a0, c0 = preprocess_data(specs, params, x, comp, 10, 2, attr_batch_size=2, device="cpu")
    assert a.device.type == "cuda" and a.shape == (4, 16 * 16, 64)
    _close(a, a0.to(cuda))
    _close(c * (a + 1e-7), (c0 * (a0 + 1e-7)).to(cuda))


def _patch_margin(R: np.ndarray, p: int) -> float:
    """Smallest gap between two distinct ReLU patch sums of one (clip,
    concept) of R [b, k, h, w], relative to the largest: the card and the
    CPU sum a patch in another order, so a gap below round-off could rank
    two patches otherwise."""
    b, k, h, w = R.shape
    s = np.maximum(R, 0).astype(np.float64).reshape(b, k, h // p, p, w // p, p).sum(axis=(3, 5))
    s = np.sort(s.reshape(b, k, -1), axis=-1)
    gaps = np.diff(s, axis=-1)
    return float(gaps[gaps > 0].min() / s.max())


@pytest.mark.parametrize("mode,b", [("constant", 20), ("inpainting", 4)])
def test_flipper_on_card_matches_cpu(cuda, mode, b):
    """The 3s model at full width, 4 concept maps a clip, perturbation 16:
    the per-instance scores [steps+1, b] on the card against the CPU (rtol
    1e-4, atol 1e-5 * max|preds|), then the AUPC from them."""
    from drsa_audio_tpu_torch.xai.eval import flipping
    specs = vgg.build_layer_specs(vgg.gtzan_3s_config())
    params = vgg.init_params(specs, 0, device="cuda")
    p_cpu = {n: {k: v.cpu() for k, v in d.items()} for n, d in params.items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, 1, 128, 128)).astype(np.float32)
    # each (clip, concept) ranks its 64 patches by a permutation of 1..64,
    # one unit apart, under pixel noise of 1e-3
    rank = np.stack([rng.permutation(64) + 1 for _ in range(b * 4)]).reshape(b, 4, 8, 1, 8, 1)
    R = (np.broadcast_to(rank / 256.0, (b, 4, 8, 16, 8, 16)).reshape(b, 4, 1, 128, 128)
         + rng.normal(0, 1e-3, (b, 4, 1, 128, 128))).astype(np.float32)
    assert _patch_margin(R[:, :, 0], 16) >= 1e-5
    card = flipping.Flipper(16, mode, forward_batch=50, device=cuda)
    cpu = flipping.Flipper(16, mode, forward_batch=50, device="cpu")
    got, flips, n = card.predictions(lambda t: vgg.forward(specs, params, t), x, R)
    want, _, _ = cpu.predictions(lambda t: vgg.forward(specs, p_cpu, t), x, R)
    assert got.shape == (7, b) and n == 10
    atol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(flipping.calculate_aupc(got, flips, n),
                               flipping.calculate_aupc(want, flips, n), rtol=1e-4, atol=atol)


def test_concept_flipping_on_card_launches_the_chain(cuda):
    """concept_flipping on the 3s model at full width, one clip a class:
    one generator call a class, each launching chain_block 3 times and
    first_layer once; finite AUPC [10, 1] and maps [10, 4, 128, 128]."""
    from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER, LRP_NAME_MAP_GTZAN
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    from drsa_audio_tpu_torch.xai.eval import harness
    specs = vgg.build_layer_specs(vgg.gtzan_3s_config())
    params = vgg.init_params(specs, 0, device="cuda")
    Us = {c: random_orthogonal(i, 64) for i, c in enumerate(CLASS_IDX_MAPPER)}
    x = np.random.default_rng(8).standard_normal((10, 1, 128, 128)).astype(np.float32)
    chain.reset_launches()
    aupc, mean, flips, R = harness.concept_flipping(specs, params, x, LRP_NAME_MAP_GTZAN, 10, Us,
                                                    case="gtzan", forward_batch=32)
    assert chain.LAUNCHES == {"chain_block": 30, "first_layer": 10, "first_block_deep": 0,
                              "merged_tail": 0}
    assert aupc.shape == (10, 1) and np.isfinite(aupc).all() and np.isfinite(mean).all()
    assert R.shape == (10, 4, 128, 128) and np.isfinite(R).all()


def test_explain_files_on_card_equals_explain(cuda, tmp_path):
    """The 3s service on the card: 7 files (one at 22.05 kHz, one of 0.5 s)
    in batches of 4 against explain on the same prepared waveforms, bit for
    bit. cuDNN is held to deterministic algorithms for both, so that the
    same input gives the same bits."""
    import math

    from scipy.signal import resample_poly

    from drsa_audio_tpu_torch.runtime.wavio import read_wav, write_wav
    from drsa_audio_tpu_torch.serving import ExplainerService
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_GTZAN
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    specs = vgg.build_layer_specs(vgg.gtzan_3s_config())
    svc = ExplainerService(specs, vgg.init_params(specs, 0, device="cuda"), LRP_NAME_MAP_GTZAN,
                           {"rock": random_orthogonal(3, 64)}, 4, 10, case="gtzan")
    rng = np.random.default_rng(9)
    paths, wavs = [], []
    for i, (sr, seconds) in enumerate([(16000, 3)] * 3 + [(22050, 3), (16000, 0.5)]
                                      + [(16000, 3)] * 2):
        p = str(tmp_path / f"{i}.wav")
        write_wav(p, np.clip(rng.standard_normal(int(sr * seconds)) * 0.3, -1, 1), sr)
        w, got_sr = read_wav(p)
        w = w[0]
        if got_sr != 16000:
            g = math.gcd(got_sr, 16000)
            w = resample_poly(w, 16000 // g, got_sr // g).astype(np.float32)
        paths.append(p)
        wavs.append(np.pad(w, (0, max(0, 48000 - len(w))))[:48000])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = list(svc.explain_files(paths, "rock", batch_size=4, decode_threads=3))
        want = [svc.explain(np.stack(wavs[i:i + 4]), "rock") for i in (0, 4)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert [g["logits"].shape[0] for g in got] == [4, 3]
    for g, w in zip(got, want):
        for key in ("standard_heatmaps", "subspace_heatmaps", "subspace_relevances", "mask",
                    "logits"):
            np.testing.assert_array_equal(g[key], w[key])


def test_mel2audio_on_card_matches_cpu(cuda):
    """Mel2Audio('gtzan') on the card against the CPU on one 3 s clip:
    make_audios (standard and 4 concept maps) and transform_mel, atol 1e-5
    * max|ref| (rtol 1e-4), as the CPU tests hold it to the JAX package."""
    from drsa_audio_tpu_torch.xai.sonify.mel2audio import Mel2Audio
    rng = np.random.default_rng(10)
    wav = (rng.standard_normal(48000) * 0.3).astype(np.float32)
    info = {"standard_heatmaps": rng.standard_normal((1, 1, 128, 128)).astype(np.float32),
            "subspace_heatmaps": rng.standard_normal((1, 4, 128, 128)).astype(np.float32)}
    card, cpu = Mel2Audio("gtzan", device=cuda), Mel2Audio("gtzan", device="cpu")
    for g, w in zip(card.make_audios(info, wav), cpu.make_audios(info, wav), strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
    mel, phase = cpu.transform_audio(wav)
    want = cpu.transform_mel(mel, phase).numpy()
    got = card.transform_mel(mel, phase).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _mels_card_vs_cpu(got, want, plain):
    """Card against CPU log-mels [b, 1, h, w] of the augment pipelines. Every
    clip on the mel power, rtol 1e-4, atol 5e-5 * the clip's peak; the clips
    in ``plain`` (neither filtered nor pitch-shifted) also in log10 units,
    rtol 1e-4, atol 1e-4. A filter's stopband and the top of an octave-down
    shift hold bins 60-100 dB under the peak, where float32 FFT round-off
    (cuFFT or the CPU's) is the value itself; a pitch shift's two more FFT
    round trips and resample leave up to 1.02e-5 of the peak between the
    devices (measured)."""
    got, want = got.cpu().double(), want.double()
    pg, pw = 10.0 ** got, 10.0 ** want
    peak = pw.amax(dim=(1, 2, 3), keepdim=True)
    bad = ((pg - pw).abs() > 1e-4 * pw + 5e-5 * peak).sum().item()
    assert bad == 0, f"{bad} mel-power elements outside rtol 1e-4, atol 5e-5 * peak"
    np.testing.assert_allclose(got[plain].numpy(), want[plain].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["gtzan", "gtzan_6s", "toy"])
def test_augment_pipelines_on_card_match_cpu(cuda, case):
    """The augment + log-mel pipelines with augmentation on, card against
    CPU on the same CPU-drawn draws (16 clips; the GTZAN pipelines with
    pitch shifts, filters and stretches among them)."""
    from drsa_audio_tpu_torch.models import train
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
    cfg = FrontendConfig.for_case(case)
    n = 29 * 16000 if case != "toy" else 16000
    rng = np.random.default_rng(11)
    wavs = torch.as_tensor((rng.standard_normal((16, n)) * 0.3).astype(np.float32))
    g = torch.Generator().manual_seed(3)
    if case == "toy":
        draws = train.sample_toy_draws(16, n, cfg, True, True, generator=g)
        run = train.toy_augment_and_mel
        plain = torch.ones(16, dtype=torch.bool)
    else:
        draws = train.sample_gtzan_draws(16, n, cfg, True, True, generator=g)
        run = train.gtzan_augment_and_mel
        plain = ~(draws["pitch_on"] | draws["filter_on"])
        assert draws["pitch_on"].any() and draws["filter_on"].any() and plain.any()
    with torch.no_grad():
        want = run(wavs, draws, cfg, True, True)
        got = run(wavs.to(cuda), {k: v.to(cuda) for k, v in draws.items()}, cfg, True, True)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    _mels_card_vs_cpu(got, want, plain)


@pytest.mark.parametrize("model", ["gtzan3s", "bn_small"])
def test_train_step_on_card_matches_cpu(cuda, model):
    """One train step from the same mels, params and keep masks, card
    against CPU (TF32 off): loss rtol 1e-5; every gradient and updated
    param rtol 1e-4, atol 1e-5 * max|CPU| per tensor (a param also the
    learning rate times its gradient's atol); BN state likewise.
    The conv and BatchNorm layers' gradients, summed over many positions a
    channel, at atol 2e-3 * max|CPU| (1e-2 with BatchNorm): the card's
    float32 kernels sit up to 1.2e-3 (cuDNN's backward-filter, 3s) and
    5.1e-3 (below the BN backward, 6s) of max|grad| from float64 (measured;
    the CPU's 6.7e-7 and 6.6e-5); with BatchNorm the other gradients at atol
    1e-4 * max|CPU| (5.2e-5 measured on the card, 3.1e-5 on the CPU). A bias
    that BatchNorm follows has a gradient of zero but for round-off: at the
    conv factor times the model's largest |gradient|."""
    from drsa_audio_tpu_torch.models import train
    if model == "gtzan3s":
        cfg, shape = vgg.gtzan_3s_config(), (8, 1, 128, 128)
    else:
        cfg = vgg.VGGConfig(n_filters=(8, 16), pool_kernels=((4, 4), (2, 2)), n_dense=32,
                            n_classes=4, dropout=0.2, block_depth=2, dense_depth=1,
                            input_size=(64, 64))
        shape = (8, 1, 64, 64)
    specs = vgg.build_layer_specs(cfg)
    has_bn = cfg.conv_bn or cfg.dense_bn
    rng = np.random.default_rng(12)
    mels = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    labels = torch.as_tensor(np.arange(8) % cfg.n_classes)
    masks = vgg.draw_keep_masks(specs, 8, torch.Generator().manual_seed(4))
    out = {}
    for dev in ("cpu", cuda):
        params = vgg.init_params(specs, 0, device=dev)
        trainable, state = train.split_trainable(params)
        opt = train.make_optimizer(trainable, 1e-3)
        step = train.make_train_step(specs, opt, has_bn=has_bn)
        loss, _ = step(params, mels.to(dev), labels.to(dev),
                       {"dropout": {k: v.to(dev) for k, v in masks.items()}})
        out[str(dev)] = (loss.item(), {f"{n}.{k}": (v.detach().cpu(), None if v.grad is None
                                                     else v.grad.cpu())
                                       for n, p in params.items() for k, v in p.items()})
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    summed = {f"{s.name}.{k}" for s in specs if s.kind in ("conv", "batchnorm")
              for k in ("weight", "bias")}
    cancelled = {f"{a.name}.bias" for a, b in zip(specs, specs[1:])
                 if a.kind in ("conv", "linear") and b.kind.startswith("batchnorm")}
    factor, other = (1e-2, 1e-4) if has_bn else (2e-3, 1e-5)
    top = max(gr.abs().max().item() for _, gr in pc.values() if gr is not None)
    for name, (v, gr) in pc.items():
        if gr is None:
            assert pg[name][1] is None, name
            atol = 0.0
        else:
            atol = (factor * top if name in cancelled else
                    (factor if name in summed else other) * gr.abs().max().item())
            torch.testing.assert_close(pg[name][1], gr, rtol=1e-4, atol=atol, msg=f"{name} grad")
        # an update moves a param by the learning rate times its gradient
        torch.testing.assert_close(pg[name][0], v, rtol=1e-4,
                                   atol=1e-5 * v.abs().max().item() + 1e-3 * atol, msg=name)


def test_toy_cli_chain_on_card_launches_the_chain(cuda, tmp_path):
    """The toy workflow's CLIs on the card at tests/test_torch_cli.py's
    sizes (12 clips a class, 2 epochs, K=2 at layer 10, 20 steps x 2 runs):
    the evaluation's 12 HeatmapGenerator chunks (2 DRSA, 6 random, 4
    interclass; 3 clips each) launch chain_block 3 times and first_layer
    once each, the prototype stage's one chunk the same; U orthogonal to
    1e-4 and the AUPCs finite."""
    from drsa_audio_tpu_torch.scripts import (
        extract_drsa_data, generate_toydata, optimize_subspaces, run_concept_eval,
        sonify_prototypes, train)
    from drsa_audio_tpu_torch.utils.evaluation import load_projection_matrix
    d = {k: str(tmp_path / k) for k in ("data", "model", "drsa", "sub", "eval", "son")}
    generate_toydata.main(["--out", d["data"], "--per-class", "12", "--seed", "1",
                           "--device", "cuda"])
    train.main(["--case", "toy", "--data", d["data"], "--out", d["model"], "--epochs", "2",
                "--batch-size", "8"])
    model = ["--case", "toy", "--data", d["data"], "--checkpoint", d["model"]]
    extract_drsa_data.main([*model, "--out", d["drsa"], "--layers", "10",
                            "--num-locations", "8"])
    optimize_subspaces.main(["--data", d["drsa"], "--out", f"{d['sub']}/2_concepts",
                             "--num-concepts", "2", "--steps", "20", "--runs", "2"])
    U = load_projection_matrix(f"{d['sub']}/2_concepts/class1/layer10")
    assert np.abs(U.T @ U - np.eye(16)).max() <= 1e-4
    chain.reset_launches()
    run_concept_eval.main([*model, "--subspaces", d["sub"], "--out", d["eval"],
                           "--num-concepts", "2", "--layers", "10", "--algorithms", "drsa",
                           "random", "--interclass-layer", "10"])
    assert chain.LAUNCHES == {"chain_block": 36, "first_layer": 12, "first_block_deep": 0,
                              "merged_tail": 0}
    assert np.isfinite(np.load(f"{d['eval']}/drsa_aupcs_k2_layer10.npy")).all()
    chain.reset_launches()
    sonify_prototypes.main([*model, "--subspaces", f"{d['sub']}/2_concepts", "--out", d["son"],
                            "--sample-class", "class1", "--layer", "10", "--num-concepts", "2",
                            "--subset-size", "4"])
    assert chain.LAUNCHES == {"chain_block": 3, "first_layer": 1, "first_block_deep": 0,
                              "merged_tail": 0}


def test_sharded_programs_at_world_one_under_nccl_match_the_unsharded(cuda):
    """One spawned rank in an NCCL group (parallel.launch): the 3s explain
    pipeline (8 clips, full width) launches chain_block 3 times and
    first_layer once and gives the unsharded heatmaps bit for bit; one
    sharded train step gives make_train_step's loss and params bit for bit
    (tests/test_torch_parallel_workers.py card_world1)."""
    from drsa_audio_tpu_torch.parallel.launch import launch
    from test_torch_parallel_workers import card_world1
    rng = np.random.default_rng(0)
    U = np.zeros((64, 64), np.float32)
    U[np.arange(64), rng.permutation(64)] = rng.choice([-1.0, 1.0], 64)
    data = {"U": U, "mels": rng.standard_normal((8, 1, 128, 128)).astype(np.float32)}
    (out,) = launch(1, card_world1, (data,), device="cuda", timeout_s=600)
    assert out["launches"] == {"chain_block": 3, "first_layer": 1, "first_block_deep": 0,
                               "merged_tail": 0}
    assert out["heat_equal"] and out["loss_equal"] and out["params_equal"], out
