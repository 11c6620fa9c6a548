"""The port's ExplainerService.explain_files and its prefetched feed
(drsa_audio_tpu_torch.serving) against the JAX package's, mirroring
tests/test_serving.py, on the CPU (toy model, bridged weights,
signed-permutation U).

Against the JAX service: heatmaps, relevances and logits at rtol 1e-4,
atol 1e-5 * max|ref| (assert_close_lrp), the sort order equal, on files
whose decoded, resampled and padded waveforms hold no max-pool window within
POOL_MARGIN of a tie in the JAX forward (asserted). Inside the port:
explain_files bit-equal to explain on the same prepared waveforms (one
path, one batch shape)."""

import math
import threading
import time

import numpy as np
import pytest
from scipy.signal import resample_poly

from drsa_audio_tpu.serving import ExplainerService as JService
from drsa_audio_tpu_torch.runtime.wavio import read_wav, write_wav
from drsa_audio_tpu_torch.serving import ExplainerService, _prefetched
from test_torch_util import (
    POOL_MARGIN, assert_close_lrp, both_models, service_margins, signed_permutation)

CLS = "class2"
KEYS = ("standard_heatmaps", "subspace_heatmaps", "subspace_relevances", "logits")


@pytest.fixture(scope="module")
def services():
    jspecs, jparams, tspecs, tparams, nm, layer, d, _, case = both_models("toy")
    Us = {CLS: signed_permutation(11, d)}
    return (JService(jspecs, jparams, nm, Us, 4, layer, case=case),
            ExplainerService(tspecs, tparams, nm, Us, 4, layer, case=case, device="cpu"),
            (jspecs, jparams, layer, Us[CLS]))


def _files(tmp_path, seed, rates_and_lengths):
    """One seeded WAV per (sample rate, seconds)."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, (sr, seconds) in enumerate(rates_and_lengths):
        p = str(tmp_path / f"{seed}_{i}_{sr}.wav")
        write_wav(p, np.clip(rng.standard_normal(int(sr * seconds)) * 0.3, -1, 1), sr)
        paths.append(p)
    return paths


def _prepared(path, window=16000, target=16000):
    """The waveform explain_files should feed for ``path``, made here
    with the numpy reader: first channel, resampled, padded or cut."""
    wav, sr = read_wav(path)
    w = wav[0]
    if sr != target:
        g = math.gcd(sr, target)
        w = resample_poly(w, target // g, sr // g).astype(np.float32)
    return np.pad(w, (0, max(0, window - len(w))))[:window]


# 16 kHz files, an 8 kHz and a 22.05 kHz one (resampled); MIX adds a 0.5 s
# one (padded). The padded zeros make exactly tied pool windows, which the
# two frameworks need not round alike, so the JAX comparison leaves it out.
MIX_JAX = [(16000, 1.0)] * 2 + [(8000, 1.0), (22050, 1.0), (16000, 1.0), (16000, 1.0)]
MIX = MIX_JAX[:3] + [(16000, 0.5)] + MIX_JAX[3:]


def test_explain_files_matches_jax_service(services, tmp_path):
    js, ts, (jspecs, jparams, layer, U) = services
    paths = _files(tmp_path, 3, MIX_JAX)
    wavs = np.stack([_prepared(p) for p in paths])
    for i in range(0, len(paths), 3):
        margins = service_margins(jspecs, jparams, layer, U, wavs[i:i + 3], "toy")
        assert margins[0] >= POOL_MARGIN["toy"], (i, margins)
    got = list(ts.explain_files(paths, CLS, batch_size=3, decode_threads=2))
    want = list(js.explain_files(paths, CLS, batch_size=3, decode_threads=2))
    assert [g["logits"].shape[0] for g in got] == [3, 3] == [w["logits"].shape[0] for w in want]
    for g, w in zip(got, want):
        for key in KEYS:
            assert_close_lrp(g[key], w[key])
        np.testing.assert_array_equal(g["mask"], w["mask"])


def test_explain_files_equals_explain(services, tmp_path):
    """Row for row the same bits as explain on the prepared waveforms."""
    _, ts, _ = services
    paths = _files(tmp_path, 4, MIX)
    got = list(ts.explain_files(paths, CLS, batch_size=4, decode_threads=3, prefetch_depth=1))
    wavs = np.stack([_prepared(p) for p in paths])
    for out, i in zip(got, (0, 4), strict=True):
        want = ts.explain(wavs[i:i + 4], CLS)
        for key in KEYS + ("mask",):
            np.testing.assert_array_equal(out[key], want[key])


def test_explain_files_order_does_not_depend_on_the_feed(services, tmp_path):
    """The decode pool and the prefetch depth change nothing: 9 files, as
    batches of 2, through 1 thread / depth 1 and 4 threads / depth 3."""
    _, ts, _ = services
    paths = _files(tmp_path, 5, [(16000, 1.0)] * 9)
    slow = list(ts.explain_files(paths, CLS, batch_size=2, decode_threads=1, prefetch_depth=1))
    fast = list(ts.explain_files(paths, CLS, batch_size=2, decode_threads=4, prefetch_depth=3))
    assert len(slow) == len(fast) == 5
    for s, f in zip(slow, fast):
        for key in KEYS:
            np.testing.assert_array_equal(s[key], f[key])


def test_explain_files_on_short(services, tmp_path):
    """A 0.25 s file: padded (default), skipped, or refused; an unknown
    mode refused before any file is read."""
    _, ts, _ = services
    ok, short = _files(tmp_path, 6, [(16000, 1.0), (16000, 0.25)])
    padded = list(ts.explain_files([ok, short], CLS, batch_size=2))
    assert len(padded) == 1 and padded[0]["logits"].shape[0] == 2
    assert np.isfinite(padded[0]["subspace_heatmaps"]).all()
    skipped = list(ts.explain_files([ok, short], CLS, batch_size=2, on_short="skip"))
    assert len(skipped) == 1 and skipped[0]["logits"].shape[0] == 1
    np.testing.assert_array_equal(skipped[0]["logits"],
                                  ts.explain(_prepared(ok)[None], CLS)["logits"])
    assert list(ts.explain_files([short], CLS, on_short="skip")) == []
    with pytest.raises(ValueError, match="shorter than the 16000-sample"):
        list(ts.explain_files([ok, short], CLS, on_short="error"))
    with pytest.raises(ValueError, match="on_short"):
        ts.explain_files([ok], CLS, on_short="bogus").__next__()
    # a longer window than the clips: every file padded to it
    out = list(ts.explain_files([ok], CLS, window_s=1.5))
    assert out[0]["logits"].shape[0] == 1


def test_explain_files_decode_error_reaches_the_caller(services, tmp_path):
    _, ts, _ = services
    (ok,) = _files(tmp_path, 7, [(16000, 1.0)])
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    with pytest.raises(IOError, match="wav_info"):
        list(ts.explain_files([ok, ok, bad], CLS, batch_size=1))


def _wait_for(cond, seconds=10.0) -> bool:
    end = time.time() + seconds
    while time.time() < end:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_prefetched_propagates_errors():
    def boom():
        yield 1
        raise RuntimeError("decode failed")

    it = _prefetched(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetched_abandoned_iterator_stops_worker():
    closed = []

    def src():
        try:
            for i in range(10_000):
                yield i
        finally:
            closed.append(True)

    it = _prefetched(src(), depth=2)
    assert next(it) == 0
    it.close()
    assert _wait_for(lambda: closed), "the source generator was not closed"


def test_explain_files_abandoned_stops_worker_and_pool(services, tmp_path):
    """Leaving explain_files after its first batch ends the prefetch
    thread and the decode pool's threads."""
    _, ts, _ = services
    paths = _files(tmp_path, 8, [(16000, 1.0)] * 2) * 20
    before = set(threading.enumerate())
    it = ts.explain_files(paths, CLS, batch_size=2, decode_threads=3, prefetch_depth=2)
    next(it)
    assert len(set(threading.enumerate()) - before) >= 2          # the worker and the pool
    it.close()
    assert _wait_for(lambda: not [t for t in set(threading.enumerate()) - before
                                  if t.is_alive()]), threading.enumerate()
