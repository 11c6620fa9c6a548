"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on first
use into ``build/kernels/lib<name>-<hash>.so`` under the repository root (the
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source or header rebuilds). Nothing
here runs at import time. ``build`` starts one nvcc per missing library, all
at once, and raises if any of them fails: there is no fallback.
``check_cuda`` and ``raise_on`` are the wrappers' checks around a launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, in
    parallel. Returns {name: library path}. The compiler's resource report
    (-Xptxas -v) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib


def check_cuda(name: str, *tensors) -> None:
    """Refuse, before any launch, a tensor that is not contiguous float32 on
    the GPU."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on the GPU")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous float32")


def raise_on(err: int, name: str) -> None:
    """Raise for an entry point's return code. The entry points check the
    channel counts they take themselves and refuse others, before any
    launch, with cudaErrorInvalidValue (1)."""
    if err == 1:
        raise ValueError(f"{name}: the kernel does not take these channel counts "
                         "or shapes (cudaErrorInvalidValue)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
