"""The request log of drsa_audio_tpu_torch.utils.profiling on the CPU: the
span tree of one ``explain`` and of an ``explain_stream`` pair (one id a
request, parents enclosing children, interleaved requests kept apart), the
file feed's wait, the counters, the off switch, spans outside a request,
the ring's bound, the ``requests(t0, t1)`` filter, the Chrome-trace dump,
and the span names under a CPU ``torch.profiler.profile``."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from drsa_audio_tpu_torch.models.vgg import build_layer_specs, init_params, toy_config
from drsa_audio_tpu_torch.serving import ExplainerService, ExplainRequest, _prefetched
from drsa_audio_tpu_torch.utils import profiling
from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_TOY

# span -> its parent, for a request of ``explain`` or ``explain_stream``
TREE = {"service.request": None,
        "service.dispatch": "service.request",
        "service.upload": "service.dispatch",
        "frontend": "service.dispatch",
        "forward_upper": "service.dispatch",
        "lower": "service.dispatch",
        "lower.prep": "lower",
        "service.device_sort": "service.dispatch",
        "service.finalize": "service.request",
        "service.wait": "service.finalize",
        "service.readback": "service.finalize"}
PREPS = 4          # the toy model's chain: three inner gamma convs and the first layer


@pytest.fixture(scope="module")
def svc():
    specs = build_layer_specs(toy_config())
    params = init_params(specs, 0, device="cpu")
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((16, 16)))
    Us = {"class1": q.astype(np.float32), "class2": q[:, ::-1].astype(np.float32)}
    return ExplainerService(specs, params, LRP_NAME_MAP_TOY, Us, 2, 10, case="toy",
                            device="cpu")


def _wavs(seed, b=2):
    return (np.random.default_rng(seed).standard_normal((b, 16000)) * 0.3).astype(np.float32)


def _recorded(fn):
    """The requests kept while ``fn`` runs, and its result."""
    t0 = time.perf_counter()
    out = fn()
    return profiling.requests(t0, time.perf_counter()), out


def _check_tree(req):
    names = [s.name for s in req.spans]
    assert set(names) == set(TREE) and names.count("lower.prep") == PREPS
    assert all(names.count(n) == 1 for n in TREE if n != "lower.prep")
    for s in req.spans:
        parent = None if s.parent is None else req.spans[s.parent]
        assert (parent.name if parent else None) == TREE[s.name]
        assert s.start <= s.end
        if parent is not None:
            assert parent.start <= s.start and s.end <= parent.end
        assert s.device_ms is None                   # no timing events on the CPU
    assert req.error is None
    # nothing moved; the request's two clips sorted on the device
    assert req.counters == {**dict.fromkeys(profiling.COUNTERS, 0), "sort.device_clips": 2}


def test_explain_records_the_span_tree(svc):
    got, out = _recorded(lambda: svc.explain(_wavs(1), "class1"))
    assert len(got) == 1
    _check_tree(got[0])
    assert out["standard_relevance"].shape == (2,)


def test_explain_stream_keeps_interleaved_requests_apart(svc):
    reqs = [ExplainRequest(_wavs(s), s % 2) for s in (2, 3)]
    got, outs = _recorded(lambda: list(svc.explain_stream(iter(reqs))))
    assert len(got) == 2 and len(outs) == 2 and got[0].id != got[1].id
    for req in got:
        _check_tree(req)
    first, second = got
    span = {(r.id, s.name): s for r in got for s in r.spans}
    # request 2 is dispatched before request 1 is finalized, each under its own id
    assert span[second.id, "service.dispatch"].end <= span[first.id, "service.finalize"].start
    assert first.start < second.start < first.end < second.end
    assert profiling.RECORDER._active() is None


def test_the_feed_wait_is_under_the_active_request():
    rec = profiling.RECORDER
    with rec.request() as req:
        assert list(_prefetched(iter([1, 2, 3]))) == [1, 2, 3]
    waits = [s for s in req.spans if s.name == "feed.wait"]
    assert len(waits) == 4 and all(s.parent == 0 for s in waits)     # 3 items and the end


def test_copies_are_counted_pinned_or_pageable():
    rec = profiling.Recorder()
    host = torch.zeros(3, 5)
    with rec.request() as req:
        rec.count_copy("h2d_bytes", host, torch.empty(0, device="meta"))
        rec.count_copy("d2h_bytes", host[:1], torch.empty(0, device="meta"))
        rec.count_copy("d2h_bytes", host, host)                 # on the CPU: nothing moved
    assert req.counters == {"h2d_bytes.pinned": 0, "h2d_bytes.pageable": 60,
                            "d2h_bytes.pinned": 0, "d2h_bytes.pageable": 20}


def test_the_off_switch_records_nothing_and_changes_no_result(svc):
    wavs = _wavs(4)
    want = svc.explain(wavs, "class2")
    profiling.set_enabled(False)
    try:
        got, out = _recorded(lambda: svc.explain(wavs, "class2"))
        assert profiling.open_request("cpu") is None
        with profiling.request() as req:
            assert req is None and profiling.span("x").__enter__() is None
    finally:
        profiling.set_enabled(True)
    assert got == []
    for key in want:
        np.testing.assert_array_equal(out[key], want[key])


def test_spans_outside_a_request_record_nothing(svc):
    rec = profiling.RECORDER
    n = len(rec.requests())
    with profiling.span("lower.prep"):
        pass
    profiling.count_copy("h2d_bytes", torch.zeros(2), torch.empty(0, device="meta"))
    profiling.mark_done()
    profiling.wait_device()
    heat = svc._dispatch(_wavs(5), "class1")[0]
    assert heat.shape[:2] == (2, 3) and len(rec.requests()) == n


def test_the_ring_keeps_the_last_requests():
    rec = profiling.Recorder(capacity=3)
    for _ in range(5):
        with rec.request():
            with rec.span("a"):
                pass
    kept = rec.requests()
    assert [r.id for r in kept] == [2, 3, 4]
    assert profiling.REQUESTS_KEPT >= 8192 and profiling.RECORDER._ring.maxlen >= 8192


def test_requests_filter_by_the_request_span():
    rec = profiling.Recorder()
    marks = []
    for _ in range(3):
        marks.append(time.perf_counter())
        with rec.request():
            pass
    marks.append(time.perf_counter())
    assert [r.id for r in rec.requests(marks[1], marks[3])] == [1, 2]
    assert [r.id for r in rec.requests(marks[0], marks[2])] == [0, 1]
    inside = rec.requests()[1]
    assert rec.requests(inside.start + 1e-9, marks[3])[0].id == 2   # cut at its start: out


def test_an_exception_closes_the_request_with_its_error():
    rec = profiling.Recorder()
    with pytest.raises(ValueError):
        with rec.request():
            with rec.span("a"):
                raise ValueError("boom")
    (req,) = rec.requests()
    assert req.error == "ValueError" and req.spans[1].end is not None


def test_threads_keep_their_own_requests_under_stress():
    """More threads than cores, each switching often: every request is kept
    once, under its own id, with only its own thread's spans."""
    rec = profiling.Recorder()
    n_threads, n_requests = 16, 100

    def work(k):
        for _ in range(n_requests):
            with rec.request():
                with rec.span(f"t{k}"):
                    with rec.span(f"t{k}.inner"):
                        pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    kept = rec.requests()
    assert len(kept) == n_threads * n_requests == len({r.id for r in kept})
    for r in kept:
        outer, inner = r.spans[1:]
        assert inner.name == outer.name + ".inner" and (outer.parent, inner.parent) == (0, 1)


def test_dump_writes_chrome_trace(svc, tmp_path):
    got, _ = _recorded(lambda: svc.explain(_wavs(6), "class1"))
    rec = profiling.Recorder()
    rec._ring.extend(got)
    path = tmp_path / "requests.json"
    rec.dump(path)
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == len(got[0].spans)
    assert {e["ph"] for e in events} == {"X"} and {e["tid"] for e in events} == {got[0].id}
    by_name = {e["name"]: e for e in events}
    assert by_name["lower"]["args"]["parent"] == "service.dispatch"
    root = by_name["service.request"]
    assert root["args"]["h2d_bytes.pageable"] == 0 and root["args"]["error"] is None
    assert root["dur"] == pytest.approx((got[0].end - got[0].start) * 1e6)


def test_spans_enter_record_function_only_under_a_profiler(svc, monkeypatch):
    entered = []
    real = profiling._range
    monkeypatch.setattr(profiling, "_range", lambda name: entered.append(name) or real(name))
    svc.explain(_wavs(7), "class1")
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        svc.explain(_wavs(7), "class1")
    names = {e.name for e in prof.events()}
    assert set(TREE) <= names and set(TREE) <= set(entered)
