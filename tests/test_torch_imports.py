"""The port stands alone: importing any of its modules, or the chip smoke
script's imports, loads neither jax nor the JAX package."""

import ast
import os
import pkgutil
import subprocess
import sys

import jax  # noqa: F401  (both frameworks load in this test process)
import torch  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import drsa_audio_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        drsa_audio_tpu_torch.__path__, "drsa_audio_tpu_torch."))


def test_port_imports_without_jax():
    mods = _port_modules()
    for m in ("xai.lrp.chain", "xai.lrp.fused_gamma", "ops.fused_frontend",
              "xai.drsa.preprocessing", "xai.drsa.prototypes", "utils.evaluation",
              "runtime.wavio", "runtime.native", "runtime.loader", "serving", "data.toydata",
              "xai.eval.metrics", "xai.eval.stats", "xai.eval.concept_recovery",
              "xai.eval.flipping", "xai.eval.harness", "ops.stft", "xai.sonify.mel2audio",
              "utils.config", "models.experimental", "ops.augment", "models.train",
              "data.datasets", "scripts.train", "utils.utilities", "utils.profiling",
              "utils.visualization", "utils.convert", "scripts.common",
              "scripts.generate_toydata", "scripts.generate_gtzan_synth",
              "scripts.extract_drsa_data", "scripts.optimize_subspaces",
              "scripts.run_concept_eval", "scripts.sonify_prototypes",
              "scripts.demo_toy_workflow", "scripts.concept_recovery_experiment",
              "scripts.run_gtzan_synth_workflow", "parallel.sharding", "parallel.launch",
              "graft_entry"):
        assert "drsa_audio_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'drsa_audio_tpu' or m.startswith('drsa_audio_tpu.')]\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_import_no_jax():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "drsa_audio_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for p in paths:
        roots = _imported_roots(p)
        assert "jax" not in roots and "drsa_audio_tpu" not in roots, p
    assert "drsa_audio_tpu_torch" in _imported_roots(paths[0])
