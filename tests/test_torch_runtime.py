"""The port's runtime (drsa_audio_tpu_torch.runtime: wavio, the native
binding and the loader) against the JAX package's, mirroring
tests/test_runtime.py, on the CPU.

Bit-equal throughout: the WAV write and read, the native decode against
read_wav and against the JAX package's binding, Telea inpainting against
the JAX package's binding (both libraries built from csrc/audio_runtime.cpp
with the same flags on this host). The JAX package's binding is built by
tests/conftest.py; a test that uses it first asserts that it is there,
because the JAX package falls back to other code without it."""

import os
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

from drsa_audio_tpu.runtime import native as jnative
from drsa_audio_tpu.runtime import wavio as jwavio
from drsa_audio_tpu_torch.runtime import loader, native, wavio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_raw(path, data: bytes, fmt: int, channels: int, bits: int, sr: int = 16000,
               extra_chunk: bool = False):
    """A WAV file by hand: PCM (fmt 1) or float (fmt 3), with an odd-sized
    chunk before the data when ``extra_chunk``."""
    block = channels * bits // 8
    fmt_body = struct.pack("<HHIIHH", fmt, channels, sr, sr * block, block, bits)
    body = b"WAVEfmt " + struct.pack("<I", 16) + fmt_body
    if extra_chunk:
        body += b"LIST" + struct.pack("<I", 3) + b"abc\x00"
    body += b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body) - 4) + body)


def _formats(tmp_path, rng):
    """One file per sample format the decoders take."""
    out = {}
    x = rng.uniform(-1, 1, (2, 301)).astype(np.float32)
    p = str(tmp_path / "pcm16_stereo.wav")
    jwavio.write_wav(p, x, 22050)
    out["pcm16_stereo"] = p
    p = str(tmp_path / "pcm8.wav")
    _write_raw(p, rng.integers(0, 256, 400, dtype=np.uint8).tobytes(), 1, 1, 8)
    out["pcm8"] = p
    p = str(tmp_path / "pcm32.wav")
    _write_raw(p, rng.integers(-2**31, 2**31 - 1, 2 * 150, dtype=np.int64).astype("<i4").tobytes(),
               1, 2, 32)
    out["pcm32"] = p
    p = str(tmp_path / "float32.wav")
    _write_raw(p, rng.standard_normal(257).astype("<f4").tobytes(), 3, 1, 32, extra_chunk=True)
    out["float32"] = p
    return out


def test_write_wav_matches_jax(tmp_path, rng):
    for shape in [(1000,), (1, 1000), (3, 77)]:
        x = (rng.standard_normal(shape) * 0.7).astype(np.float32)    # some clip at +-1
        a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
        wavio.write_wav(a, x, 16000)
        jwavio.write_wav(b, x, 16000)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_read_and_native_decode_match_jax(tmp_path, rng):
    """Every format: the port's read_wav, its native decode and the JAX
    package's native decode against the JAX package's read_wav."""
    assert jnative.available()
    for name, p in _formats(tmp_path, rng).items():
        want, sr = jwavio.read_wav(p)
        for got in (wavio.read_wav(p), native.decode_wav(p), loader.load_audio(p),
                    jnative.decode_wav(p)):
            assert got[1] == sr, name
            assert got[0].dtype == np.float32 and got[0].shape == want.shape, name
            np.testing.assert_array_equal(got[0], want, err_msg=name)


def test_decode_many_and_prefetch_keep_order(tmp_path, rng):
    paths = []
    for i in range(7):
        p = str(tmp_path / f"{i}.wav")
        wavio.write_wav(p, rng.uniform(-1, 1, 100 + 13 * i).astype(np.float32), 16000)
        paths.append(p)
    want = [wavio.read_wav(p)[0] for p in paths]
    for got in (native.decode_many(paths, num_threads=3), jnative.decode_many(paths, 3)):
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
    batches = list(loader.prefetch_batches(paths, 3, num_threads=2))
    assert [len(b) for b in batches] == [3, 3, 1]
    for g, w in zip([a for b in batches for a in b], want, strict=True):
        np.testing.assert_array_equal(g, w)


def test_decode_failures_raise(tmp_path, rng):
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFF\x00\x00\x00\x00NOTAWAVE")
    good = str(tmp_path / "good.wav")
    wavio.write_wav(good, np.zeros(10, np.float32), 16000)
    for p in (bad, str(tmp_path / "missing.wav")):
        with pytest.raises(IOError):
            native.decode_wav(p)
        with pytest.raises(IOError):
            native.decode_many([good, p])
    unsupported = str(tmp_path / "pcm24.wav")
    _write_raw(unsupported, bytes(30), 1, 1, 24)
    with pytest.raises(IOError, match="wav_decode"):
        native.decode_wav(unsupported)
    with pytest.raises(IOError, match="1 of 2"):
        native.decode_many([good, unsupported])


def _holes(rng, n, h, w):
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        r, c = rng.integers(0, h - 6), rng.integers(0, w - 6)
        masks[i, r:r + 6, c:c + 4] = 1
        masks[i, rng.integers(0, h), :] = 1                          # a whole row
    masks[0, :3, :3] = 1                                              # at a corner
    return masks


def test_telea_matches_jax(rng):
    """Bit-equal to the JAX package's binding; the input images are left as
    they were (copy before fill) and the known pixels are kept."""
    assert jnative.available()
    imgs = rng.standard_normal((5, 24, 20)).astype(np.float32)
    masks = _holes(rng, 5, 24, 20)
    before = imgs.copy()
    got = native.telea_inpaint_batch(imgs, masks, radius=4, num_threads=3)
    np.testing.assert_array_equal(imgs, before)
    np.testing.assert_array_equal(got, jnative.telea_inpaint_batch(imgs, masks, radius=4))
    np.testing.assert_array_equal(got[masks == 0], imgs[masks == 0])
    assert np.abs(got - imgs)[masks > 0].max() > 0
    for i in range(5):
        one = native.telea_inpaint(imgs[i], masks[i].astype(bool), radius=4)
        np.testing.assert_array_equal(one, jnative.telea_inpaint(imgs[i], masks[i], radius=4))
        np.testing.assert_array_equal(one, got[i])
    np.testing.assert_array_equal(imgs, before)


def test_telea_refuses_mismatched_shapes(rng):
    img = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError):
        native.telea_inpaint(img, np.zeros((8, 7), np.uint8))
    with pytest.raises(ValueError):
        native.telea_inpaint(img[None], np.zeros((1, 8, 8), np.uint8))
    with pytest.raises(ValueError):
        native.telea_inpaint_batch(img, np.zeros((8, 8), np.uint8))


def test_library_is_the_ports_own_build():
    """Built from csrc/audio_runtime.cpp into build/native/, never the JAX
    package's runtime/libaudio_runtime.so."""
    native._load()
    path = os.path.realpath(native._lib._name)
    assert path.startswith(os.path.join(ROOT, "build", "native") + os.sep)
    assert os.path.basename(path).startswith("libaudio_runtime-")
    assert native.SOURCE == native.ROOT / "csrc" / "audio_runtime.cpp"


def _fresh_build(monkeypatch, tmp_path, cxx):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", cxx)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path, str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.decode_wav(str(tmp_path / "x.wav"))
    with pytest.raises(RuntimeError, match="not found"):
        native.telea_inpaint(np.zeros((4, 4), np.float32), np.ones((4, 4), np.uint8))
    assert native._lib is None


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'compiler says no' >&2\nexit 3\n")
    cxx.chmod(0o755)
    _fresh_build(monkeypatch, tmp_path, str(cxx))
    with pytest.raises(RuntimeError, match="(?s)exited 3.*compiler says no"):
        native.decode_wav(str(tmp_path / "x.wav"))
    assert not list((tmp_path / "native").glob("*"))                   # no partial file left


def test_concurrent_builds_leave_one_library(tmp_path):
    """Four processes building into one empty directory at once: each gets
    a loadable library and exactly one file is left."""
    code = ("import sys, numpy as np\n"
            "from drsa_audio_tpu_torch.runtime import native\n"
            "from pathlib import Path\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "out = native.telea_inpaint(np.ones((6, 6), np.float32), np.eye(6, dtype=np.uint8))\n"
            "assert np.allclose(out, 1.0)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "native")], cwd=ROOT,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    assert [f.suffix for f in (tmp_path / "native").iterdir()] == [".so"]


def test_threads_share_one_load(rng):
    """Eight threads decoding and inpainting at once through one loaded
    library (a shortened switch interval to shake out races)."""
    imgs = rng.standard_normal((2, 16, 16)).astype(np.float32)
    masks = _holes(rng, 2, 16, 16)
    want = native.telea_inpaint_batch(imgs, masks, radius=3)
    errors, results = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            try:
                for _ in range(20):
                    results.append(np.array_equal(
                        native.telea_inpaint_batch(imgs, masks, radius=3, num_threads=2), want))
            except Exception as e:                                    # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(results) == 160 and all(results)
