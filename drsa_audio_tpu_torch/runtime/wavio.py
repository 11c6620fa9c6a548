"""WAV read and write in numpy (the port's copy of drsa_audio_tpu.runtime.
wavio).

``read_wav`` is the plain version of the native decoder
(runtime.native.decode_wav), which the tests hold it against; the port
decodes with the native one. ``write_wav`` writes 16-bit PCM.
"""

from __future__ import annotations

import struct

import numpy as np


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write mono/multi-channel float32 data as 16-bit PCM WAV."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    channels, frames = data.shape
    pcm = np.clip(data, -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    interleaved = pcm.T.reshape(-1).tobytes()

    byte_rate = sample_rate * channels * 2
    block_align = channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(interleaved)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                            byte_rate, block_align, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(interleaved)))
        f.write(interleaved)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM (8/16/32-bit int or float32) WAV file.

    Returns (data [channels, frames] float32 in [-1, 1], sample_rate).
    """
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos:pos + 4]
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 8:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}/{bits}bit")
    frames = len(x) // channels
    return x[: frames * channels].reshape(frames, channels).T.copy(), sample_rate
