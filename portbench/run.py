#!/usr/bin/env python3
"""The benchmark of drsa_audio_tpu_torch's explain service on one GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once, from the root of a checkout. The
cell names a configuration (``portbench/configs/``) and a traffic mix
(``portbench/traffic/<traffic>.json``, which names the entry it drives in
``portbench/entries/``); its limits are ``portbench/limits/<cell>.json``,
and each metric is read by ``portbench/metrics/<metric>.py``. All are found
by name, so a cell, configuration, entry or metric is added as new files
and entries.

Set-up draws the weights, BatchNorm statistics and class projections on the
card from the seed, builds the service (the program's kernels are built by
nvcc into ``build/kernels/`` of the checkout on a first run), makes the
inputs and serves warm requests at the cell's own shape. Then the window:
requests for ``--seconds``, nothing wrapped but the front-end's capture of
the calls the comparison reads (``--trace 0``, the end-to-end metrics), or
with the service's stages spanned and a slice of requests profiled
(``--trace 1``, the per-layer metrics). After the window the program is
freed and the plain reference (``portbench/reference/``) recomputes a
seeded sample of the window's requests, the first and the last among them;
``correct`` holds when every number compared is within its limit. The last
line of standard output is the result; the last lines of standard error
are the numbers compared beside their limits.

Exits 2 without a CUDA device (or with fewer than the cell asks for), and 3
if any module whose top-level name is jax, jaxlib, flax or drsa_audio_tpu
is loaded once the window has closed; neither prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path.insert(0, str(HERE))
if str(REPO) not in sys.path:
    sys.path.insert(1, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "drsa_audio_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    safe = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    return json.loads(path.read_text())


def resolve(bench: dict, cell: str) -> dict:
    """The cell's workload entry, configuration, traffic, limits and the
    metrics it reports with and without the trace."""
    wl = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if wl is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"workload": wl, "cfg": read_json(REPO / conf["file"]),
            "traffic": read_json(HERE / "traffic" / f"{wl['traffic']}.json"),
            "limits": read_json(HERE / "limits" / f"{cell}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


class Ctx:
    """What an entry sees: the configuration, traffic, seed and device, the
    service, and the run's hooks."""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.svc = None
        self.errors: list = []
        self.cleanup: list = []
        self.spans = None

    def request_span(self):
        return self.spans.request() if self.spans is not None else contextlib.nullcontext()


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sampled(seed: int, traffic: dict) -> set:
    """The window's requests the reference recomputes: the first, and
    ``check_requests`` more drawn from the seed among the first
    ``check_span`` (the window's last one is added by the entry)."""
    import numpy as np
    rng = np.random.default_rng([seed, 7])
    span = traffic["check_span"]
    n = min(traffic["check_requests"], span - 1)
    more = rng.choice(np.arange(1, span), size=n, replace=False)
    return {0, *(int(i) for i in more)}


def compare(ctx, entry, kept: dict, captured: dict, params, U, info) -> list[tuple]:
    """The reference over each kept request's inputs, and the comparison's
    readings of each (``pb.check.numbers``)."""
    import numpy as np
    import torch
    from pb import check
    from reference import lrp

    cfg, device = ctx.cfg, ctx.device
    ref_model = lrp.Model(cfg, params)
    block = lrp.block_size(cfg)
    readings = []
    for i, (out, desc) in sorted(kept.items()):
        wavs, cls = entry.reference_inputs(ctx, desc)
        k = cfg["classes"].index(cls)
        x = torch.as_tensor(np.ascontiguousarray(wavs), dtype=torch.float32, device=device)
        ref_mel, ref_heat, ref_logits = check.reference_outputs(ref_model, cfg, x, U[k], k, block)
        kw = {}
        if captured.get(i) is not None:
            kw.update(mel=captured[i], ref_mel=ref_mel.astype(np.float64))
        reading = check.numbers(out, ref_heat, ref_logits, **kw)
        readings.append(reading)
        info({"compared": {"request": i, **check.pooled([reading])}})
    return readings


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, info=print) -> dict:
    """One run of the cell ``c`` (``resolve``'s dict); returns the result
    line's dict. ``device`` is "cuda" on the card; the tests run it on the
    CPU at tiny sizes, without the trace."""
    import torch
    from pb import check, model, program, spans, work

    cfg, traffic = c["cfg"], c["traffic"]
    t_start = T_START if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    entry = load("entries", traffic["entry"])
    ctx = Ctx(cfg, traffic, seed, device)
    params, U = model.draw(cfg, seed, device)
    theirs = {n: {k: v.clone() for k, v in p.items()} for n, p in params.items()}
    ctx.svc = program.service(cfg, theirs, U, device)
    del theirs
    capture = spans.Capture()
    try:
        entry.setup(ctx)
        _sync(device)
        keep_set = sampled(seed, traffic)
        capture.want = set(keep_set)
        capture.calls = 0
        capture.kept.clear()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        from drsa_audio_tpu_torch.xai.lrp import chain
        chain.reset_launches()
        if trace and traffic.get("stage_spans"):
            ctx.spans = spans.StageSpans(ctx.svc)
        setup_s = time.perf_counter() - t_start
        win = entry.window(ctx, seconds, lambda i: i in keep_set)
        _sync(device)
        launches = dict(chain.LAUNCHES)
        stages = None
        if ctx.spans is not None:
            stages = ctx.spans.stages()
            ctx.spans.remove()
            ctx.spans = None
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        captured = {i: capture.host(i) for i in win["kept"]}
        capture.patches.remove()
        prof = None
        if trace:
            from pb import profile
            labels = spans.Labels(ctx.svc)
            try:
                prof = profile.profiled(lambda i: entry.slice(ctx, i), traffic["profile_units"])
            finally:
                labels.remove()
    except BaseException:
        capture.patches.remove()
        for f in ctx.cleanup:
            f()
        raise
    # the program's state is freed before the reference runs
    ctx.svc = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n_req = len(win["records"])
    clips = n_req and sum(r[2] for r in win["records"]) / n_req
    from pb.stats import latencies_ms, percentile
    lat = latencies_ms(win["records"])
    info({"window": {"requests": n_req, "attempted": win["attempted"], "failed": win["failed"],
                     "request_ms_p10_p50_p90_max": [percentile(lat, q) for q in (10, 50, 90, 100)]
                     if lat else None,
                     "seconds": win["t1"] - win["t0"], "clips_per_request": clips,
                     "launches": launches, "memory_peak_bytes": peak, "setup_s": setup_s,
                     "errors": ctx.errors[:3]}})

    t_ref = time.perf_counter()
    try:
        readings = compare(ctx, entry, win["kept"], captured, params, U, info)
    finally:
        for f in ctx.cleanup:
            f()
    ok, table = check.judge(check.pooled(readings), c["limits"], captured=capture.installed)
    info({"reference_seconds": time.perf_counter() - t_ref, "requests_compared": len(readings)})

    w = work.request_work(cfg, int(round(clips)) if clips else traffic["batch"])
    run = types.SimpleNamespace(t_start=t_start, setup_s=setup_s, window=win, stages=stages,
                                profile=prof, work=w, cfg=cfg, traffic=traffic,
                                clips_per_request=clips)
    wanted = c["per_layer"] if trace else c["end_to_end"]
    metrics = {}
    for m in wanted:
        value = load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(ok and win["failed"] == 0 and n_req > 0),
              "attempted": win["attempted"], "failed": win["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if prof is not None:
        result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = table
    return result


def _card_line() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return {"nvidia_smi": out.stdout.strip().splitlines()[:1]}
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": repr(e)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ.pop("DRSA_CHAIN_MERGED", None)           # the service's default path
    c = resolve(read_json(REPO / "BENCHMARK.json"), args.workload)
    from pb import program
    importlib.import_module(program.PACKAGE)             # the program, or fail printing nothing
    import torch
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(json.dumps({"cell": args.workload, "seed": args.seed, "torch": torch.__version__,
                      "cuda": torch.version.cuda, **_card_line()}), flush=True)
    result = run_cell(c, args.seed, args.seconds, bool(args.trace),
                      info=lambda d: print(json.dumps(d), flush=True))
    for t in threading.enumerate():
        if t is not threading.current_thread():
            t.join(timeout=30)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
