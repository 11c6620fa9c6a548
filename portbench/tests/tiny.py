"""Tiny versions of the benchmark's cells for the CPU tests: the published
front-end and layer pattern, narrow filters, a few clips."""

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
for p in (str(HERE), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402


def cell(name: str, batch: int = 4) -> dict:
    """The cell of BENCHMARK.json."""
    c = run.resolve(run.read_json(REPO / "BENCHMARK.json"), name)
    c["cfg"].update(n_filters=[8, 8, 16, 16, 16], subspace_dim=16, n_dense=16)
    c["traffic"].update(batch=batch, pool=2, check_span=4, check_requests=2, warm_requests=1,
                        max_requests=64)
    return c


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())
