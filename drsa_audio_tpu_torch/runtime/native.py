"""ctypes binding of the native runtime, ``csrc/audio_runtime.cpp``: WAV
decode, a threaded batch decode, and Telea fast-marching inpainting (the
port's own binding; drsa_audio_tpu.runtime.native is the JAX package's).

The library is compiled from the repository's source at first use, with the
C++ compiler ``$CXX`` (default ``g++``) and the flags of ``csrc/Makefile``,
into ``build/native/libaudio_runtime-<hash>.so`` under the repository root.
The hash covers the source, the flags and what ``-march=native`` resolves
to on the host, so an edited source or another CPU builds anew. A build goes
to a temporary name and is renamed into place, so that processes building at
once do not load a half-written file. There is no fallback: a missing
compiler or a failed build raises with the compiler's output, and every
return code of the library is checked. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "audio_runtime.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-pthread"]

_lib = None
_LOCK = threading.Lock()
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("channels", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
        ("frames", ctypes.c_int64),
    ]


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX): the native runtime "
                           f"is built from {SOURCE.name} at first use")
    return path


def library_path(cxx: str) -> Path:
    """Where the library for this source, these flags and this host's
    ``-march=native`` lives."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=120).stdout
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode() + target)
    return BUILD_DIR / f"libaudio_runtime-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    cxx = _compiler()
    path = library_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native runtime failed ({cxx} exited "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
        lib.wav_info.restype = ctypes.c_int
        lib.wav_decode.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64]
        lib.wav_decode.restype = ctypes.c_int
        lib.wav_decode_many.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(_F32P),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int]
        lib.wav_decode_many.restype = ctypes.c_int
        lib.telea_inpaint.argtypes = [_F32P, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.telea_inpaint.restype = ctypes.c_int
        lib.telea_inpaint_batch.argtypes = [
            _F32P, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.telea_inpaint_batch.restype = ctypes.c_int
        _lib = lib
        return lib


def _info(lib, path: str) -> _WavInfo:
    info = _WavInfo()
    rc = lib.wav_info(path.encode(), ctypes.byref(info))
    if rc != 0:
        raise IOError(f"wav_info({path}) failed: {rc}")
    return info


def decode_wav(path: str) -> tuple[np.ndarray, int]:
    """(waveform [channels, frames] float32, sample rate)."""
    lib = _load()
    info = _info(lib, path)
    buf = np.empty((info.channels, info.frames), dtype=np.float32)
    rc = lib.wav_decode(path.encode(), buf.ctypes.data_as(_F32P), info.frames)
    if rc != 0:
        raise IOError(f"wav_decode({path}) failed: {rc}")
    return buf, int(info.sample_rate)


def decode_many(paths, num_threads: int = 4) -> list:
    """Decode a list of WAV files on ``num_threads`` native threads; returns
    their [channels, frames] arrays in order."""
    lib = _load()
    paths = list(paths)
    infos = [_info(lib, p) for p in paths]
    bufs = [np.empty((inf.channels, inf.frames), np.float32) for inf in infos]
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_bufs = (_F32P * n)(*[b.ctypes.data_as(_F32P) for b in bufs])
    c_frames = (ctypes.c_int64 * n)(*[inf.frames for inf in infos])
    fails = lib.wav_decode_many(c_paths, c_bufs, c_frames, n, num_threads)
    if fails:
        raise IOError(f"wav_decode_many: {fails} of {n} files failed to decode")
    return bufs


def prefetch_batches(paths, batch_size: int, num_threads: int = 4):
    """Yield the decoded waveforms of ``paths`` in batches of ``batch_size``."""
    paths = list(paths)
    for i in range(0, len(paths), batch_size):
        yield decode_many(paths[i:i + batch_size], num_threads)


def telea_inpaint(img: np.ndarray, mask: np.ndarray, radius: int = 8) -> np.ndarray:
    """Telea-inpaint the pixels of a single-channel float image [h, w] where
    ``mask`` is nonzero; returns a filled copy, ``img`` is left as it was."""
    out = np.ascontiguousarray(img, dtype=np.float32).copy()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    if out.ndim != 2 or m.shape != out.shape:
        raise ValueError(f"telea_inpaint: image {out.shape} and mask {m.shape} "
                         "must be the same [h, w]")
    h, w = out.shape
    rc = _load().telea_inpaint(out.ctypes.data_as(_F32P), m.ctypes.data_as(_U8P), h, w, radius)
    if rc != 0:
        raise RuntimeError(f"telea_inpaint failed: {rc}")
    return out


def telea_inpaint_batch(imgs: np.ndarray, masks: np.ndarray, radius: int = 8,
                        num_threads: int = 4) -> np.ndarray:
    """telea_inpaint of each of ``imgs`` [n, h, w] with its mask, on
    ``num_threads`` native threads; returns the filled copies."""
    out = np.ascontiguousarray(imgs, dtype=np.float32).copy()
    m = np.ascontiguousarray(masks, dtype=np.uint8)
    if out.ndim != 3 or m.shape != out.shape:
        raise ValueError(f"telea_inpaint_batch: images {out.shape} and masks {m.shape} "
                         "must be the same [n, h, w]")
    n, h, w = out.shape
    rc = _load().telea_inpaint_batch(out.ctypes.data_as(_F32P), m.ctypes.data_as(_U8P),
                                     n, h, w, radius, num_threads)
    if rc != 0:
        raise RuntimeError(f"telea_inpaint_batch failed: {rc}")
    return out
