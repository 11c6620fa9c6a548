"""The pre-split K-major tap layouts of the wgmma chain kernels
(csrc/conv3x3_wgmma.cuh; xai/lrp/chain.py wgmma_taps, GammaConv.w_prep_wg and
w_apply_wg) on the CPU: every (part, slice, tap, channel, column) entry by
index against the split of the taps they re-lay, the tile widths and column
chunks at the repo's channel counts (100 -> 104 included), and the chain's
3xTF32 emulation (test_torch_tf32x3.py) fed from the pre-split tiles
against the same emulation splitting the weights itself, on the calls
that the bridged 3s model and the small 6s-topology model record: the two
must give the same bits.
"""

import numpy as np
import pytest
import torch

from drsa_audio_tpu_torch.models import vgg as tvgg
from drsa_audio_tpu_torch.xai.lrp import chain
from test_torch_tf32x3 import _chain_calls, split, tf32, x3
from test_torch_util import t


def _conv(ci: int, co: int, seed: int) -> chain.GammaConv:
    rng = np.random.default_rng(seed)
    w = t(rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2 / (9 * ci)))
    return chain.prep_inner_weights({"c": {"weight": w, "bias": t(rng.standard_normal(co))}},
                                    tvgg.LayerSpec("conv", "c", {}), {"gamma": 0.3})


def _unlay(wg: torch.Tensor, kr: int, n: int):
    """The (hi, lo) taps [9, kr, n] a pre-split layout [chunks, slices, 2, 9,
    2, chunk, 4] holds, and the largest entry outside them."""
    cb, nsl, _, _, _, chunk, _ = wg.shape
    full = wg.permute(2, 3, 1, 4, 6, 0, 5).reshape(2, 9, nsl * 8, cb * chunk)
    rest = full.clone()
    rest[:, :, :kr, :n] = 0
    return full[0, :, :kr, :n], full[1, :, :kr, :n], rest.abs().max().item()


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
    chunk = chain.prep_chunk(2 * co)
    assert chunk == (16 if 2 * co <= 16 else 32)
    assert cv.w_prep_wg.shape == (-(-2 * co // chunk), -(-ci // 8), 2, 9, 2, chunk, 4)
    width = chain.wg_cols(ci)
    assert width == next(c for c in (8, 16, 32, 64, 104, 128) if ci <= c)
    assert cv.w_apply_wg.shape == (1, -(-co // 8), 2, 9, 2, width, 4)
    assert (cv.prep_cols, cv.apply_cols) == (chunk, width)
    for wgt, taps in ((cv.w_prep_wg, _pair_taps(cv)), (cv.w_apply_wg, _apply_taps(cv))):
        hi, lo, rest = _unlay(wgt, taps.shape[1], taps.shape[2])
        want_hi, want_lo = split(taps)
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
        assert rest == 0.0
        assert torch.equal(hi, tf32(hi)) and torch.equal(lo, tf32(lo))


@pytest.mark.parametrize("ci,co", [(12, 20), (100, 128)])
def test_wgmma_tap_layouts_by_index(ci, co):
    """The same entry by entry, as the kernels address them: slice s, part
    p, tap, channel half kc and column n of chunk cb hold reduction channel
    8s + 4kc + i and output column cb * chunk + n."""
    cv = _conv(ci, co, 7)
    for wgt, taps in ((cv.w_prep_wg, _pair_taps(cv)), (cv.w_apply_wg, _apply_taps(cv))):
        parts = [p.numpy() for p in split(taps)]
        wgt = wgt.numpy()
        cbs, nsl, _, _, _, chunk, _ = wgt.shape
        kr, n = taps.shape[1:]
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
    hi, lo, _ = _unlay(cv.w_prep_wg, ci, 2 * co)
    oihw = lambda a: a.reshape(3, 3, ci, co, 2).permute(4, 3, 2, 0, 1).contiguous()  # noqa: E731
    fwd = [oihw(hi), oihw(lo)]
    ahi, alo, _ = _unlay(cv.w_apply_wg, co, ci)
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
