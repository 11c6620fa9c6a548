"""The readers of the program's request log (``pb.request_log``) on the
tiny CPU service: each returns its value over a window of real requests,
and None for an empty window and for a program without the log. On the
CPU nothing moves between host and device, so ``service.pageable_mb``
reads 0, and no span has device ms, so ``service.sort_ms`` reads None
unless a span is given them."""

import json
import time
import types

import numpy as np
import pytest

from tests import tiny

CELL = "gtzan3s.serve_b256"
METRICS = ["service.upload_ms", "service.issue_ms", "service.wait_ms", "lower.prep_ms",
           "service.pageable_mb"]
DEVICE = ["service.sort_ms"]      # device ms of a span: none on the CPU


@pytest.fixture(scope="module")
def window():
    """Two requests of the tiny 3s service, inside a window of the
    benchmark's form, and one request after it."""
    from pb import model, program
    c = tiny.cell(CELL, batch=2)
    cfg = c["cfg"]
    params, U = model.draw(cfg, 2 ** 31 + 5, "cpu")
    svc = program.service(cfg, params, U, "cpu")
    wavs = (np.random.default_rng(3).standard_normal(
        (2, cfg["slice_length"] * cfg["sample_rate"])) * 0.3).astype(np.float32)
    t0 = time.perf_counter()
    for cls in cfg["classes"][:2]:
        svc.explain(wavs, cls)
    t1 = time.perf_counter()
    svc.explain(wavs, cfg["classes"][2])
    return {"t0": t0, "t1": t1}


def _read(name, window):
    return tiny.run.load("metrics", name).read(types.SimpleNamespace(window=window))


def test_the_metrics_are_the_benchmarks_program_entries():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in METRICS + DEVICE:
        assert entries[name]["source"] in ("program_span", "program_counter")
        assert entries[name]["moves"] == "clips_per_s" and entries[name]["workloads"] == cells


@pytest.mark.parametrize("name", METRICS)
def test_reads_the_windows_requests(name, window):
    from drsa_audio_tpu_torch.utils import profiling
    got = profiling.requests(window["t0"], window["t1"])
    assert len(got) == 2
    value = _read(name, window)
    assert isinstance(value, float) and value >= 0.0
    if name == "service.pageable_mb":
        assert value == 0.0
    if name == "lower.prep_ms":
        assert value > 0.0 and value == pytest.approx(
            float(np.median([r.ms("lower.prep") for r in got])))


@pytest.mark.parametrize("name", METRICS + DEVICE)
def test_an_empty_window_reads_none(name, window):
    t = time.perf_counter()
    assert _read(name, {"t0": t, "t1": t}) is None


@pytest.mark.parametrize("name", METRICS + DEVICE)
def test_a_program_without_the_log_reads_none(name, window, monkeypatch):
    from drsa_audio_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "requests")
    assert _read(name, window) is None


def test_sort_ms_reads_the_device_sorts_device_ms(window, monkeypatch):
    from drsa_audio_tpu_torch.utils import profiling
    got = profiling.requests(window["t0"], window["t1"])
    spans = [next(s for s in r.spans if s.name == "service.device_sort") for r in got]
    assert len(spans) == 2 and all(s.device_ms is None for s in spans)
    assert _read("service.sort_ms", window) is None
    for s, ms in zip(spans, (0.25, 0.75)):
        monkeypatch.setattr(s, "device_ms", ms)
    assert _read("service.sort_ms", window) == pytest.approx(0.5)
    monkeypatch.setattr(spans[0], "device_ms", None)
    assert _read("service.sort_ms", window) == 0.75
