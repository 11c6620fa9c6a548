"""Every cell's files are found by name, and a cell, configuration, entry
and metric added only as new files (plus entries in BENCHMARK.json) are
found and parsed by the harness, with no edit to a file that is there."""

import importlib.util
import json
import shutil

import pytest

from tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_to_its_files(cell):
    c = tiny.run.resolve(BENCH, cell)
    assert c["cfg"]["name"] == c["workload"]["config"]
    entry = tiny.run.load("entries", c["traffic"]["entry"])
    for fn in ("setup", "window", "slice", "reference_inputs"):
        assert callable(getattr(entry, fn))
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(tiny.run.load("metrics", m["name"]).read)
    assert c["limits"] and all(isinstance(v, (int, float)) for v in c["limits"].values())
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]


def test_new_files_are_found_without_editing_any(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "gtzan3s.json").read_text())
    cfg["name"] = "newmodel"
    (pb / "configs" / "newmodel.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "newmix.json").write_text(json.dumps({"entry": "newentry", "batch": 2}))
    (pb / "entries" / "newentry.py").write_text(
        "def setup(ctx): pass\ndef window(ctx, s, keep): pass\n"
        "def slice(ctx, i): pass\ndef reference_inputs(ctx, d): pass\nMARK = 'new entry'\n")
    (pb / "metrics" / "new.metric_ms.py").write_text("def read(run):\n    return 1.5\n")
    (pb / "limits" / "newmodel.newmix.json").write_text(json.dumps({"logits": 1e-4}))
    bench["configs"].append({"name": "newmodel", "source": "https://example.org/new",
                             "file": "portbench/configs/newmodel.json", "reduced": [], "why": "new"})
    bench["workloads"].append({"name": "newmodel.newmix", "config": "newmodel",
                               "traffic": "newmix", "chips": 1, "why": "new"})
    bench["per_layer"].append({"name": "new.metric_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "service", "moves": "clips_per_s",
                               "workloads": ["newmodel.newmix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = importlib.util.spec_from_file_location("portbench_copy_run", pb / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    c = run.resolve(run.read_json(root / "BENCHMARK.json"), "newmodel.newmix")
    assert c["cfg"]["name"] == "newmodel" and c["traffic"]["entry"] == "newentry"
    assert c["limits"] == {"logits": 1e-4}
    assert run.load("entries", "newentry").MARK == "new entry"
    assert [m["name"] for m in c["per_layer"]] == ["new.metric_ms"]
    assert run.load("metrics", "new.metric_ms").read(None) == 1.5
    # the metrics without a list of cells are reported wherever their
    # end-to-end metric is, so clips_per_s and setup_s reach the new cell
    assert {m["name"] for m in c["end_to_end"]} == {"clips_per_s", "setup_s"}
    # the existing cells are untouched, and no existing file changed
    assert run.resolve(run.read_json(root / "BENCHMARK.json"), "gtzan3s.serve_b256")["per_layer"]
    for p, data in before.items():
        assert p.read_bytes() == data
