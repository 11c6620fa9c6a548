#!/usr/bin/env python3
"""Readings for the limits of ``correct``, at a cell's own size, in one
process. For each seed the program serves the requests a run of the cell
compares (the first, those drawn from the seed, and one more in the last's
place) and the reference recomputes them; the numbers are pooled over them
as a run pools them. Read are the program's sound numbers, and the same
with each of ``pb.faults``' result faults planted. For each control seed
also the control's (the plain reference in the program's place, computed
with TF32 on for cuDNN and matmuls: the next precision below the
configuration's float32), the program's with the torch TF32 switches
turned on after the service is built, and the program's built with
another class's projections.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3

One JSON line a reading; ``--out`` appends them to a file too."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402


def tf32(on: bool) -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _served(ctx, entry, capture, calls):
    """[(result, desc, captured log-mel)] of the entry's requests ``calls``."""
    capture.want, capture.calls = set(range(len(calls))), 0
    capture.kept.clear()
    outs = [entry.slice(ctx, i) for i in calls]
    return [(out, desc, capture.host(j)) for j, (out, desc) in enumerate(outs)]


def readings(c: dict, seed: int, control: bool, device="cuda") -> list[dict]:
    import copy

    import numpy as np
    import torch
    from pb import check, faults, model, program, spans
    from reference import lrp

    cfg, traffic = c["cfg"], c["traffic"]
    entry = run.load("entries", traffic["entry"])
    ctx = run.Ctx(cfg, traffic, seed, device)
    params, U = model.draw(cfg, seed, device)

    def build(projections):
        theirs = {n: {k: v.clone() for k, v in p.items()} for n, p in params.items()}
        return program.service(cfg, theirs, projections, device)

    ctx.svc = build(U)
    capture = spans.Capture()
    calls = sorted(run.sampled(seed, traffic)) + [traffic["check_span"]]
    sides: dict = {}
    try:
        entry.setup(ctx)
        served = {"program": _served(ctx, entry, capture, calls)}
        if control:
            tf32(True)
            try:
                served["program_tf32"] = _served(ctx, entry, capture, calls)
            finally:
                tf32(False)
            ctx.svc = build(faults.wrong_projections(U))
            served["fault_wrong_projections"] = _served(ctx, entry, capture, calls)
        ctx.svc = None
        ref = lrp.Model(cfg, params)
        block = lrp.block_size(cfg)
        t_ref = 0.0
        for j, (_, desc, _) in enumerate(served["program"]):
            wavs, cls = entry.reference_inputs(ctx, desc)
            k = cfg["classes"].index(cls)
            x = torch.as_tensor(np.ascontiguousarray(wavs), dtype=torch.float32, device=device)
            t0 = time.perf_counter()
            mel, heat, logits = check.reference_outputs(ref, cfg, x, U[k], k, block)
            t_ref += time.perf_counter() - t0
            ref_mel = mel.astype(np.float64)

            def read(side, out, got_mel):
                sides.setdefault(side, []).append(
                    check.numbers(out, heat, logits, mel=got_mel, ref_mel=ref_mel))

            for side, got in served.items():
                read(side, got[j][0], got[j][2])
            out, _, got_mel = served["program"][j]
            for fault in faults.RESULT_FAULTS:
                read(f"fault_{fault.__name__}", fault(copy.deepcopy(out)), got_mel)
            if control:
                tf32(True)
                try:
                    mel_c, heat_c, logits_c = check.reference_outputs(ref, cfg, x, U[k], k, block)
                finally:
                    tf32(False)
                read("control_reference_tf32", check.as_output(heat_c, logits_c), mel_c)
    finally:
        capture.patches.remove()
        for f in ctx.cleanup:
            f()
    rows = [{"seed": seed, "side": side, "requests": len(r), **check.pooled(r)}
            for side, r in sides.items()]
    rows[0]["reference_s"] = t_ref
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    c = run.resolve(run.read_json(run.REPO / "BENCHMARK.json"), args.workload)
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    for s in seeds:
        for row in readings(c, s, s in args.control_seeds):
            line = json.dumps({"cell": args.workload, **row})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
