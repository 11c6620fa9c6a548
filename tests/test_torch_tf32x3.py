"""The arithmetic of the tensor-core chain kernels (csrc/conv3x3_tc.cuh) on
the CPU: every product of the gamma conv's forward pair and transposed conv
in 3xTF32 (each operand split into hi = tf32(x) and lo = tf32(x - hi), the
product summed as lo*hi + hi*lo + hi*hi), held against pure f32 on the
inputs that the port's chain records, for the bridged 3s model and a small
model of the 6s topology ((2,4) pool above a two-conv first block, a
100-channel level). Also the re-laid taps the kernels stage, by index.

The split is what the emulation models; the card's tensor cores also add
with truncation, which the prep's sign decisions avoid by summing each
k-step's products into their f32 accumulator with round-to-nearest (see the
source). Tolerance: rtol 1e-4, atol 1e-5 * max|ref| (assert_close_lrp).
"""

import numpy as np
import pytest
import torch

from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.models.projection import insert_projection
from drsa_audio_tpu_torch.xai import explain as texp
from drsa_audio_tpu_torch.xai.lrp import chain
from test_torch_util import assert_close_lrp, both_models, signed_permutation, t


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the f32 significand to 10 bits, ties away from
    zero (add 0x1000 to the bit pattern, clear the low 13 bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def x3(conv):
    """``conv(a, w)`` in 3xTF32."""
    def run(a, w, *rest):
        ah, al = split(a)
        wh, wl = split(w)
        out = (conv(al, wh, *rest) + conv(ah, wl, *rest)) + conv(ah, wh, *rest)
        return out
    return run


def _conv_same(x, w, b=None):
    out = chain.conv2d_same_nhwc(x, w, None)
    return out if b is None else out + b


def prep_decisions(x, cv, conv):
    """The prep's sign decisions: z_true > 0 and G != 0 (G = [z_true > 0] /
    stab(z1 + b2), as chain_block_plain forms it)."""
    b1, b0, b2 = (v.view(1, 1, 1, -1) for v in cv.biases)
    z1 = conv(x, cv.wz1) + b1
    z3 = conv(x, cv.wz3)
    z_true = (z1 + z3 - b1) * cv.inv + b0
    G = (z_true > 0).to(x.dtype) / chain.stabilize(z1 + b2, cv.stab)
    return z_true > 0, G != 0


def _record(monkeypatch, run):
    """The chain_block and first_block_deep calls of ``run()`` (plain, on
    the CPU)."""
    calls = []
    for name in ("chain_block", "first_block_deep"):
        orig = getattr(chain, name)

        def rec(*args, _orig=orig, _name=name):
            calls.append((_name, args))
            return _orig(*args)
        monkeypatch.setattr(chain, name, rec)
    run()
    monkeypatch.undo()
    return calls


def _small_6s_like():
    """Port-only model of the 6s topology: block depth 2, a (2,4) pool above
    block 0, 16 then 100 then 100 channels, 32x64 input; the DRSA layer is
    the relu of block 2 (two chain_block calls, one first_block_deep)."""
    cfg = tvgg.VGGConfig(n_filters=(16, 100, 100), n_dense=8,
                         pool_kernels=((2, 4), (2, 2), (2, 2)), dropout=0.0,
                         input_size=(32, 64), n_classes=2, conv_bn=False, dense_bn=False,
                         block_depth=2)
    specs = tvgg.build_layer_specs(cfg)
    nm = [("features.0", ("wsquare", {"stabilizer": 1e-7}))] + [
        (s.name, ("gamma", {"gamma": 0.3, "stabilizer": 1e-7}))
        for s in specs[1:] if s.kind == "conv" and s.name.startswith("features")]
    return specs, tvgg.init_params(specs, 0, device="cpu"), nm, 13, 100, (32, 64)


def _chain_calls(model, monkeypatch):
    if model == "gtzan3s":
        _, _, specs, params, nm, layer, d, hw, _ = both_models("gtzan3s")
    else:
        specs, params, nm, layer, d, hw = _small_6s_like()
    sp = insert_projection(specs, layer, t(signed_permutation(5, d)), 4, input_size=hw)
    x = t(np.random.default_rng(7).standard_normal((1, 1) + hw))
    comp = texp.class_composite(nm, 4)
    with torch.no_grad():
        return _record(monkeypatch,
                       lambda: texp.subspace_heatmaps(sp, params, x, comp, 4, class_idx=0))


@pytest.mark.parametrize("model,expected", [
    ("gtzan3s", ["chain_block"] * 3),
    ("small6s", ["chain_block"] * 2 + ["first_block_deep"]),
])
def test_chain_in_3xtf32_matches_f32(model, expected, monkeypatch):
    """Every recorded chain call with all gamma-conv products in 3xTF32
    against pure f32, and no sign decision of the prep flipped."""
    calls = _chain_calls(model, monkeypatch)
    assert [n for n, _ in calls] == expected
    flips = {"z_true": 0, "G": 0}
    for name, args in calls:
        want = getattr(chain, name + "_plain")(*args)
        with monkeypatch.context() as m:
            m.setattr(chain, "conv2d_same_nhwc", x3(chain.conv2d_same_nhwc))
            m.setattr(chain, "_conv_t_nhwc", x3(chain._conv_t_nhwc))
            got = getattr(chain, name + "_plain")(*args)
        assert_close_lrp(got.numpy(), want.numpy())
        if name == "chain_block":
            pairs = zip(args[1], args[2])
        else:
            pairs = [(torch.clamp(args[1], min=0.0), args[3])]
        for x, cv in pairs:
            zw, gw = prep_decisions(x, cv, _conv_same)
            zg, gg = prep_decisions(x, cv, x3(_conv_same))
            flips["z_true"] += int((zw != zg).sum())
            flips["G"] += int((gw != gg).sum())
    assert flips == {"z_true": 0, "G": 0}


def test_tf32_rounding():
    """The emulated cvt.rna: 10 significand bits, round half away from zero,
    and hi + lo within 2^-22 of x."""
    x = torch.tensor([1.0, 1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12, 3.14159265, -2.5e-8])
    hi = tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert hi[1].item() == 1.0 + 2**-10 and hi[2].item() == -(1.0 + 2**-10)
    assert hi[3].item() == 1.0
    rng = np.random.default_rng(0)
    y = t(rng.standard_normal(10000) * 10.0 ** rng.integers(-6, 6, 10000))
    h, lo = split(y)
    assert ((h + lo - y).abs() <= 2.0**-22 * y.abs()).all()
    assert ((h - y).abs() <= 2.0**-11 * y.abs()).all()


@pytest.mark.parametrize("ci,co", [(8, 16), (64, 100), (100, 128), (12, 20)])
def test_tensor_core_tap_layouts(ci, co):
    """The mma.sync kernels' taps: fused_gamma.pair_weights' w_prep
    [ceil(Ci/8), 9, 8, 2Co] interleaves the forward pair of the conv's
    GammaConv (column 2o wz1's channel o, 2o + 1 wz3's), and
    GammaConv.w_apply_tc [ceil(Co/8), 9, 8, Ci rounded up to 8] holds the
    transposed wz1 (tap (dy, dx) reads wz1[o, i, 2 - dy, 2 - dx]); zeros
    past the counts."""
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    rng = np.random.default_rng(ci + co)
    spec = tvgg.LayerSpec("conv", "c", {})
    w, b = t(rng.standard_normal((co, ci, 3, 3))), t(rng.standard_normal(co))
    cv = chain.prep_inner_weights({"c": {"weight": w, "bias": b}}, spec, {"gamma": 0.3})
    wz1, wz3 = cv.wz1.numpy(), cv.wz3.numpy()
    wp, wa = fused_gamma.pair_weights(w, b, 0.3)[0].numpy(), cv.w_apply_tc.numpy()
    assert wp.shape == (-(-ci // 8), 9, 8, 2 * co)
    assert wa.shape == (-(-co // 8), 9, 8, -(-ci // 8) * 8)
    for s in range(wp.shape[0]):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for c in range(8):
                i = s * 8 + c
                if i < ci:
                    np.testing.assert_array_equal(wp[s, tap, c, 0::2], wz1[:, i, dy, dx])
                    np.testing.assert_array_equal(wp[s, tap, c, 1::2], wz3[:, i, dy, dx])
                else:
                    assert not wp[s, tap, c].any()
    for s in range(wa.shape[0]):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for c in range(8):
                o = s * 8 + c
                if o < co:
                    np.testing.assert_array_equal(wa[s, tap, c, :ci], wz1[o, :, 2 - dy, 2 - dx])
                    assert not wa[s, tap, c, ci:].any()
                else:
                    assert not wa[s, tap, c].any()


@pytest.mark.parametrize("ci,co", [(8, 16), (64, 100), (100, 128), (12, 20)])
def test_gamma_nonneg_tap_layouts(ci, co):
    """fused_gamma.pair_weights: w_prep the interleaved forward pair
    (test_tensor_core_tap_layouts), w_apply [Co/4, 9, 8, Ci rounded up to 8] the pair flipped
    and transposed with its rows interleaved as the prep's (m1, m3) pairs
    (reduction channel 2o + s reads wz1 (s = 0) or wz3 (s = 1) at
    [o, i, 2 - dy, 2 - dx]); zeros past the counts; biases (b1, b0, b2)."""
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    rng = np.random.default_rng(ci + co)
    w, b = t(rng.standard_normal((co, ci, 3, 3))), t(rng.standard_normal(co))
    wp, wa, bias3 = (a.numpy() for a in fused_gamma.pair_weights(w, b, 0.3))
    cv = chain.prep_inner_weights({"c": {"weight": w, "bias": b}},
                                  tvgg.LayerSpec("conv", "c", {}), {"gamma": 0.3})
    assert wp.shape == (-(-ci // 8), 9, 8, 2 * co)
    np.testing.assert_array_equal(bias3, cv.biases.numpy())
    pair = (cv.wz1.numpy(), cv.wz3.numpy())
    assert wa.shape == (co // 4, 9, 8, -(-ci // 8) * 8)
    for sl in range(wa.shape[0]):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for c in range(8):
                o, s = divmod(sl * 8 + c, 2)
                np.testing.assert_array_equal(wa[sl, tap, c, :ci], pair[s][o, :, 2 - dy, 2 - dx])
                assert not wa[sl, tap, c, ci:].any()


def _gamma_nonneg_as_kernel(x, R, w, b, K, gamma, stab):
    """gamma_nonneg_folded's two launches as the kernels index them, in f32
    on the CPU: the prep's GEMM over the interleaved columns of w_prep, M =
    (m1, m3) interleaved channels last, and the apply's GEMM over the 2*Co
    channels R[o] * M[2o + s] against w_apply, tap (dy, dx) reading the
    pixel (h + dy - 1, w + dx - 1) (the sums channels last, x, R and the
    result NCHW as the kernels read and write them)."""
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    n, ci, H, W = x.shape
    co = w.shape[0]
    wf, wt, bias3 = fused_gamma.pair_weights(w, b, gamma)
    b1, b0, b2 = bias3
    inv = float(np.float32(1.0 / (2.0 + gamma)))
    taps_f = wf.transpose(0, 1).reshape(9, -1, 2 * co)[:, :ci]          # [9, ci, 2co]
    taps_a = wt.transpose(0, 1).reshape(9, 2 * co, -1)[..., :ci]        # [9, 2co, ci]
    xp = torch.nn.functional.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    z = sum(xp[:, dy:dy + H, dx:dx + W] @ taps_f[dy * 3 + dx] for dy in range(3) for dx in range(3))
    z1, z3 = z[..., 0::2] + b1, z[..., 1::2]
    zt = (z1 + z3 - b1) * inv + b0
    m1 = torch.where(zt > 0, 1.0 / chain.stabilize(z1 + b2, stab), 0.0)
    m3 = torch.where(zt < 0, 1.0 / chain.stabilize(z3, stab), 0.0)
    M = torch.stack([m1, m3], dim=-1).reshape(n, H, W, 2 * co)
    Rh = R.view(K, n, co, H, W).permute(1, 0, 3, 4, 2)
    A = torch.nn.functional.pad(Rh.repeat_interleave(2, dim=-1) * M[:, None],
                                (0, 0, 1, 1, 1, 1))
    acc = sum(A[:, :, dy:dy + H, dx:dx + W] @ taps_a[dy * 3 + dx]
              for dy in range(3) for dx in range(3))
    out = x.permute(0, 2, 3, 1)[:, None] * acc                          # [n, K, H, W, ci]
    return out.permute(1, 0, 4, 2, 3).reshape(K * n, ci, H, W)


@pytest.mark.parametrize("n,K,ci,co,H,W", [(2, 3, 8, 16, 8, 8), (1, 2, 12, 20, 5, 6),
                                           (2, 4, 32, 64, 9, 7)])
def test_gamma_nonneg_kernel_indexing_matches_plain(n, K, ci, co, H, W):
    """The kernels' layouts, emulated, give gamma_nonneg_folded_plain's
    result (rtol 1e-4, atol 1e-5 * max|ref|)."""
    from drsa_audio_tpu_torch.xai.lrp import fused_gamma
    rng = np.random.default_rng(n * K + ci + co)
    x = t(np.maximum(rng.standard_normal((n, ci, H, W)), 0))
    R = t(rng.standard_normal((K * n, co, H, W)))
    w = t(rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
    b = t(rng.standard_normal(co) * 0.05)
    got = _gamma_nonneg_as_kernel(x, R, w, b, K, 0.3, 1e-7)
    want = fused_gamma.gamma_nonneg_folded_plain(x, R, w, b, K, 0.3, 1e-7)
    assert_close_lrp(got.numpy(), want.numpy())


@pytest.mark.parametrize("model,layer,d", [("gtzan3s", 10, 64), ("gtzan3s", 7, 64),
                                           ("toy", 10, 16), ("toy", 7, 16)])
def test_merged_tail_in_3xtf32_matches_f32(model, layer, d, monkeypatch):
    """The merged tail's recorded call (merged-tail switch on: two merged
    convs at layer 10, one at layer 7) with every gamma-conv product in
    3xTF32, as csrc/merged_tail.cu and its chain_gamma_prep launches take
    them, against pure f32 (the first-layer tail stays f32 on the FMA
    units in the kernel, so it is not emulated); no prep sign decision
    flipped."""
    monkeypatch.delenv("DRSA_CHAIN_MERGED", raising=False)
    monkeypatch.setattr(chain, "CHAIN_MERGED", True)
    _, _, specs, params, nm, _, _, hw, _ = both_models(model)
    sp = insert_projection(specs, layer, t(signed_permutation(5, d)), 4, input_size=hw)
    x = t(np.random.default_rng(7).standard_normal((2, 1) + hw))
    comp = texp.class_composite(nm, 4)
    calls = []
    orig = chain.merged_tail

    def rec(*args):
        calls.append(args)
        return orig(*args)
    with torch.no_grad(), monkeypatch.context() as m:
        m.setattr(chain, "merged_tail", rec)
        texp.subspace_heatmaps(sp, params, x, comp, 4, class_idx=0)
    assert len(calls) == 1
    args = calls[0]
    assert len(args[2]) == (2 if layer == 10 else 1)
    want = chain.merged_tail_plain(*args)
    with monkeypatch.context() as m:
        m.setattr(chain, "conv2d_same_nhwc", x3(chain.conv2d_same_nhwc))
        m.setattr(chain, "_conv_t_nhwc", x3(chain._conv_t_nhwc))
        got = chain.merged_tail_plain(*args)
    assert_close_lrp(got.numpy(), want.numpy())
    flips = 0
    for xin, cv in zip(args[1], args[2]):
        zw, gw = prep_decisions(xin, cv, _conv_same)
        zg, gg = prep_decisions(xin, cv, x3(_conv_same))
        flips += int((zw != zg).sum()) + int((gw != gg).sum())
    assert flips == 0
