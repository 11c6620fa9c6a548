"""BENCHMARK.json against the benchmark contract's limits on names, units,
keys, sizes and bounds, and the harness's check of loaded modules."""

import json
import re

import pytest

from tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text_ok(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (tiny.REPO / p).is_dir()
    for w in BENCH["command"]:
        assert not w.startswith("/") and ".." not in w
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x cells runs of run_seconds + 60 s,
    # 2 x 90 s of compiling a cell, 1200 s spare, within 43200 s
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text_ok(c["source"]) and _text_ok(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and (tiny.REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    cells = {w["name"] for w in BENCH["workloads"]}
    metric_names = []
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text_ok(m["layer"]) and m["moves"] in metric_names
        metric_names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (tiny.HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(set(metric_names)) == len(metric_names)
    assert len(set(names)) == len(names) and len(cells) == len(BENCH["workloads"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        c = tiny.run.resolve(BENCH, w["name"])
        e2e = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
        assert all(m["moves"] in e2e for m in c["per_layer"])


@pytest.mark.parametrize("cfg", ["gtzan3s", "gtzan6s"])
def test_configs_state_their_precision_and_widths(cfg):
    c = tiny.config(cfg)
    assert c["precision"] == "float32, TF32 off" and c["assumed"]
    assert c["subspace_dim"] == {"gtzan3s": 64, "gtzan6s": 128}[cfg]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types
    run = tiny.run
    assert "drsa_audio_tpu_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "drsa_audio_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == [] or "jax" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "drsa_audio_tpu.sub", types.ModuleType("y"))
    assert "drsa_audio_tpu" in run.forbidden_modules()
