"""Importing the harness, its entries, metrics and reference, and the
program's service, loads no module whose top-level name is jax, jaxlib,
flax or drsa_audio_tpu (a fresh interpreter, so that nothing this test
process holds counts)."""

import subprocess
import sys

from tests import tiny

SCRIPT = r"""
import sys
sys.path.insert(0, {here!r}); sys.path.insert(1, {repo!r})
import run, control
from pb import check, model, program, profile, spans, stats, trace, work
from reference import frontend, lrp
from pathlib import Path
for kind in ("entries", "metrics", "work"):
    for p in sorted((Path({here!r}) / kind).glob("*.py")):
        if p.stem != "__init__":
            run.load(kind, p.stem)
import drsa_audio_tpu_torch.serving, drsa_audio_tpu_torch.xai.explain
print("forbidden=" + ",".join(run.forbidden_modules()))
"""


def test_no_jax_and_no_jax_package_is_loaded():
    code = SCRIPT.format(here=str(tiny.HERE), repo=str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tiny.REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden="
