"""The pre-split K-major tap layouts of the wgmma kernels
(csrc/conv3x3_wgmma.cuh; xai/lrp/taps.py wgmma_taps, GammaConv.w_prep_wg,
w_apply_wg and w_apply_pair_wg) on the CPU: every (part, slice, tap,
channel, column) entry by index against the split of the taps they re-lay,
the tile widths and column chunks at the repo's channel counts (100 -> 104
included), the per-layer cache of the record (taps.gamma_conv), and the
chain's 3xTF32 emulation (test_torch_tf32x3.py) fed from the pre-split
tiles against the same emulation splitting the weights itself, on the
calls that the bridged 3s model and the small 6s-topology model record: the
two must give the same bits.
"""

import numpy as np
import pytest
import torch

from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.xai.lrp import chain, taps
from test_torch_tf32x3 import _chain_calls, split, tf32, unlay, x3
from test_torch_util import t


def _conv(ci: int, co: int, seed: int) -> taps.GammaConv:
    rng = np.random.default_rng(seed)
    w = t(rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
    return chain.prep_inner_weights({"c": {"weight": w, "bias": t(rng.standard_normal(co))}},
                                    tvgg.LayerSpec("conv", "c", {}), {"gamma": 0.3})


def _pair_taps(cv):
    """The forward pair as the prep multiplies it: [9, Ci, 2*Co], column 2o
    wz1's output channel o, 2o + 1 wz3's."""
    return (torch.stack([cv.wz1, cv.wz3], dim=1).reshape(2 * cv.co, cv.ci, 3, 3)
            .permute(2, 3, 1, 0).reshape(9, cv.ci, 2 * cv.co))


def _apply_taps(cv):
    """The transposed wz1 as the apply multiplies it: [9, Co, Ci], tap (dy,
    dx) reading wz1[o, i, 2 - dy, 2 - dx]."""
    return cv.wz1.flip(2, 3).permute(2, 3, 0, 1).reshape(9, cv.co, cv.ci)


# the main path's (Ci, Co): 3s 32/32, 32/64, 64/64; 6s 64/64, 64/100,
# 100/100, 100/128, 128/128; the toy's 8/16, 16/16; a 20-channel count
MAIN_PATH = [(32, 32), (32, 64), (64, 64), (64, 100), (100, 100), (100, 128), (128, 128),
             (8, 16), (16, 16), (12, 20)]


@pytest.mark.parametrize("ci,co", MAIN_PATH)
def test_wgmma_tap_layouts_rebuild_the_split_taps(ci, co):
    """w_prep_wg and w_apply_wg hold hi = tf32(w) and lo = tf32(w - hi) of
    the taps at every index, zeros past the counts, in the tile widths and
    chunks the wrappers pass to the kernels (GammaConv.prep_cols,
    apply_cols; csrc/chain_block.cu takes them from there)."""
    cv = _conv(ci, co, ci * 1000 + co)
    chunk = taps.prep_chunk(2 * co)
    assert chunk == (16 if 2 * co <= 16 else 32)
    assert cv.w_prep_wg.shape == (-(-2 * co // chunk), -(-ci // 8), 2, 9, 2, chunk, 4)
    width = taps.wg_cols(ci)
    assert width == next(c for c in (8, 16, 32, 64, 104, 128) if ci <= c)
    assert cv.w_apply_wg.shape == (1, -(-co // 8), 2, 9, 2, width, 4)
    assert (cv.prep_cols, cv.apply_cols) == (chunk, width)
    for wgt, want in ((cv.w_prep_wg, _pair_taps(cv)), (cv.w_apply_wg, _apply_taps(cv))):
        hi, lo, rest = unlay(wgt, want.shape[1], want.shape[2])
        want_hi, want_lo = split(want)
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        assert rest == 0.0
        assert torch.equal(hi, tf32(hi)) and torch.equal(lo, tf32(lo))


@pytest.mark.parametrize("ci,co", [(12, 20), (100, 128)])
def test_wgmma_tap_layouts_by_index(ci, co):
    """The same entry by entry, as the kernels address them: slice s, part
    p, tap, channel half kc and column n of chunk cb hold reduction channel
    8s + 4kc + i and output column cb * chunk + n."""
    cv = _conv(ci, co, 7)
    for wgt, lay in ((cv.w_prep_wg, _pair_taps(cv)), (cv.w_apply_wg, _apply_taps(cv))):
        parts = [p.numpy() for p in split(lay)]
        wgt = wgt.numpy()
        cbs, nsl, _, _, _, chunk, _ = wgt.shape
        kr, n = lay.shape[1:]
        for cb in range(cbs):
            for s in range(nsl):
                for p in range(2):
                    for tap in range(9):
                        for kc in range(2):
                            for i in range(4):
                                r = 8 * s + 4 * kc + i
                                got = wgt[cb, s, p, tap, kc, :, i]
                                cols = np.arange(cb * chunk, (cb + 1) * chunk)
                                want = np.zeros(chunk, np.float32)
                                if r < kr:
                                    ok = cols < n
                                    want[ok] = parts[p][tap, r, cols[ok]]
                                np.testing.assert_array_equal(got, want)


def _presplit(cv):
    """{id(weight): (hi, lo)} of the gamma conv's OIHW weights as the wgmma
    kernels hold them: the forward wz1 and wz3 from w_prep_wg, the
    transposed wz1 from w_apply_wg (un-flipped), and the transposed wz3
    (zero under the relu gate, never launched) from w_prep_wg."""
    ci, co = cv.ci, cv.co
    hi, lo, _ = unlay(cv.w_prep_wg, ci, 2 * co)
    oihw = lambda a: a.reshape(3, 3, ci, co, 2).permute(4, 3, 2, 0, 1).contiguous()  # noqa: E731
    fwd = [oihw(hi), oihw(lo)]
    ahi, alo, _ = unlay(cv.w_apply_wg, co, ci)
    tr = [a.reshape(3, 3, co, ci).permute(2, 3, 0, 1).flip(2, 3).contiguous() for a in (ahi, alo)]
    return ({id(cv.wz1): (fwd[0][0], fwd[1][0]), id(cv.wz3): (fwd[0][1], fwd[1][1])},
            {id(cv.wz1): (tr[0], tr[1]), id(cv.wz3): (fwd[0][1], fwd[1][1])})


def _x3_presplit(conv, table):
    """conv(a, w) in 3xTF32 with w's hi and lo from the pre-split table."""
    def run(a, w, *rest):
        ah, al = split(a)
        wh, wl = table[id(w)]
        return (conv(al, wh, *rest) + conv(ah, wl, *rest)) + conv(ah, wh, *rest)
    return run


@pytest.mark.parametrize("model,expected", [
    ("gtzan3s", ["chain_block"] * 3),
    ("small6s", ["chain_block"] * 2 + ["first_block_deep"]),
])
def test_chain_3xtf32_from_presplit_tiles_equals_the_emulation(model, expected, monkeypatch):
    """Every recorded chain call in 3xTF32 with the weights' hi and lo taken
    from the pre-split tiles gives the same bits as with the weights split
    by the emulation itself (test_torch_tf32x3.x3), and both agree with f32
    there (test_chain_in_3xtf32_matches_f32)."""
    calls = _chain_calls(model, monkeypatch)
    assert [n for n, _ in calls] == expected
    for name, args in calls:
        convs = args[2] if name == "chain_block" else [args[3]]
        fwd, tr = {}, {}
        for cv in convs:
            f, r = _presplit(cv)
            fwd.update(f)
            tr.update(r)
        plain = getattr(chain, name + "_plain")
        with monkeypatch.context() as m:
            m.setattr(chain, "conv2d_same_nhwc", x3(chain.conv2d_same_nhwc))
            m.setattr(chain, "_conv_t_nhwc", x3(chain._conv_t_nhwc))
            want = plain(*args)
        with monkeypatch.context() as m:
            m.setattr(chain, "conv2d_same_nhwc", _x3_presplit(chain.conv2d_same_nhwc, fwd))
            m.setattr(chain, "_conv_t_nhwc", _x3_presplit(chain._conv_t_nhwc, tr))
            got = plain(*args)
        assert torch.equal(got, want)


# ------------------------------------------------------------ gamma_nonneg

def _pair(ci: int, co: int, seed: int, gamma: float = 0.3):
    """A conv's OIHW weight and bias, the plain pair (wz1, wz3) at gamma."""
    rng = np.random.default_rng(seed)
    w = t(rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
    b = t(rng.standard_normal(co))
    return w, b, (w + gamma * w.clamp(min=0), w + gamma * w.clamp(max=0))


def _flipped_pair(wz1, wz3):
    """The pair as gamma_nonneg's apply multiplies it: [9, 2*Co, Ci],
    reduction row 2o + s reading wz1 (s = 0) or wz3 (s = 1) at [o, i, 2 -
    dy, 2 - dx] for tap (dy, dx)."""
    co, ci = wz1.shape[:2]
    return (torch.stack([wz1, wz3], dim=1).reshape(2 * co, ci, 3, 3).flip(2, 3)
            .permute(2, 3, 0, 1).reshape(9, 2 * co, ci))


# the 3s and 6s models' (Ci, Co) on the shared walk, the toy's, a
# 20-channel count; 100 -> 104 in the apply's tile
GAMMA_NONNEG = [(32, 32), (32, 64), (64, 64), (64, 100), (100, 100), (100, 128), (128, 128),
                (8, 16), (12, 20)]


@pytest.mark.parametrize("ci,co", GAMMA_NONNEG)
def test_gamma_nonneg_pair_taps_rebuild_the_pair(ci, co):
    """gamma_nonneg's taps, the layer's cached GammaConv: w_prep_wg the
    interleaved forward pair (a fresh build's for the same weights, bit for
    bit) and w_apply_pair_wg the stacked flipped transpose (test_torch_tf32x3
    emulates both launches from them), each hi = tf32(w) and lo = tf32(w -
    hi) at every index, zeros past the counts, in the widths the wrapper
    passes (prep chunk 16 or 32, apply tile wg_cols(Ci): 100 -> 104);
    biases (b1, b0, b2) and inv = f32(1/(2+g))."""
    w, b, (wz1, wz3) = _pair(ci, co, ci * 1000 + co)
    cv = taps.gamma_conv(w, b, 0.3, 1e-6)
    fresh = chain.prep_inner_weights({"c": {"weight": w, "bias": b}},
                                     tvgg.LayerSpec("conv", "c", {}), {"gamma": 0.3})
    assert torch.equal(cv.w_prep_wg, fresh.w_prep_wg) and torch.equal(cv.biases, fresh.biases)
    assert cv.inv == fresh.inv == float(np.float32(1 / 2.3))
    chunk, width = taps.prep_chunk(2 * co), taps.wg_cols(ci)
    assert (cv.prep_cols, cv.apply_pair_cols) == (chunk, width)
    assert width == next(c for c in (8, 16, 32, 64, 104, 128) if ci <= c)
    assert cv.w_prep_wg.shape == (-(-2 * co // chunk), -(-ci // 8), 2, 9, 2, chunk, 4)
    assert cv.w_apply_pair_wg.shape == (1, 2 * co // 8, 2, 9, 2, width, 4)
    fwd = (torch.stack([wz1, wz3], dim=1).reshape(2 * co, ci, 3, 3)
           .permute(2, 3, 1, 0).reshape(9, ci, 2 * co))
    for wgt, want in ((cv.w_prep_wg, fwd), (cv.w_apply_pair_wg, _flipped_pair(wz1, wz3))):
        hi, lo, rest = unlay(wgt, want.shape[1], want.shape[2])
        want_hi, want_lo = split(want)
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        assert rest == 0.0
        assert torch.equal(hi, tf32(hi)) and torch.equal(lo, tf32(lo))


@pytest.mark.parametrize("ci,co", [(12, 20), (100, 128)])
def test_gamma_nonneg_apply_taps_by_index(ci, co):
    """w_apply_wg entry by entry, as the apply addresses it: slice s, part
    p, tap (dy, dx), channel half kc, lane i and column n hold reduction
    channel r = 8s + 4kc + i, i.e. the pair member r % 2 of output channel
    r // 2, at input channel n, flipped: wz[r % 2][r // 2, n, 2 - dy, 2 -
    dx]; zeros past Ci."""
    w, b, pair = _pair(ci, co, 11)
    lay = taps.build_gamma_conv(w, b, 0.3, 1e-6).w_apply_pair_wg[0].numpy()
    parts = [[a.numpy() for a in split(p)] for p in pair]           # [member][part]
    width = lay.shape[-2]
    for s in range(lay.shape[0]):
        for p in range(2):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for kc in range(2):
                    for i in range(4):
                        r = 8 * s + 4 * kc + i
                        want = np.zeros(width, np.float32)
                        want[:ci] = parts[r % 2][p][r // 2, :, 2 - dy, 2 - dx]
                        np.testing.assert_array_equal(lay[s, p, tap, kc, :, i], want)


@pytest.mark.parametrize("change", ["none", "in_place", "new_tensor", "bias", "gamma"])
def test_gamma_nonneg_pair_taps_cached_per_layer(change):
    """gamma_conv builds a layer's record once and serves it while the
    weight and bias are the same tensors, unchanged: a weight or bias
    updated in place, another weight tensor or another gamma is built anew
    (never served stale), and the rebuilt record is that of the new
    weights. An entry goes with its weight."""
    import gc

    w, b, _ = _pair(16, 32, 5)
    other, _, _ = _pair(8, 16, 6)                 # another layer, built once too
    n0 = taps.BUILDS["gamma_conv"]
    first = taps.gamma_conv(w, b, 0.3, 1e-6)
    assert taps.gamma_conv(other, None, 0.3, 1e-6) is taps.gamma_conv(other, None, 0.3, 1e-6)
    assert taps.gamma_conv(w, b, 0.3, 1e-6) is first
    assert taps.BUILDS["gamma_conv"] == n0 + 2
    gamma = 0.3
    if change == "in_place":
        with torch.no_grad():
            w.mul_(-1.0)
    elif change == "new_tensor":
        w = w.clone() * 2.0
    elif change == "bias":
        b += 1.0
    elif change == "gamma":
        gamma = 0.25
    again = taps.gamma_conv(w, b, gamma, 1e-6)
    assert taps.BUILDS["gamma_conv"] == n0 + 2 + (change != "none")
    assert (again is first) == (change == "none")
    fresh = taps.build_gamma_conv(w, b, gamma, 1e-6)
    for a, f in ((again.w_prep_wg, fresh.w_prep_wg), (again.w_apply_wg, fresh.w_apply_wg),
                 (again.w_apply_pair_wg, fresh.w_apply_pair_wg), (again.biases, fresh.biases)):
        assert torch.equal(a, f)
    entries = len(taps._CACHE)
    del other
    gc.collect()
    assert len(taps._CACHE) == entries - 1


def test_gamma_conv_of_inference_tensors_is_built_anew():
    """A weight and bias made under torch.inference_mode() keep no version
    counter: the cached accessor builds their record on every call without
    raising, never caches it, and returns what a fresh build returns."""
    w, b, _ = _pair(16, 32, 9)
    with torch.inference_mode():
        w, b = w.clone(), b.clone()
    assert w.is_inference() and b.is_inference()
    entries, n0 = len(taps._CACHE), taps.BUILDS["gamma_conv"]
    got = [taps.gamma_conv(w, b, 0.3, 1e-6) for _ in range(2)]
    assert taps.BUILDS["gamma_conv"] == n0 + 2 and len(taps._CACHE) == entries
    fresh = taps.build_gamma_conv(w, b, 0.3, 1e-6)
    for cv in got:
        for name in ("wz1", "wz3", "biases", "w_prep_wg", "w_apply_wg", "w_apply_pair_wg"):
            assert torch.equal(getattr(cv, name), getattr(fresh, name)), name
        assert (cv.inv, cv.stab) == (fresh.inv, fresh.stab)
