"""Audio loading (the port of drsa_audio_tpu.runtime.loader), always through
the native decoder of runtime.native: where it cannot be built, loading
raises rather than decoding another way."""

from __future__ import annotations

import numpy as np

from drsa_audio_tpu_torch.runtime import native


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """(waveform [channels, frames] float32, sample rate)."""
    return native.decode_wav(path)


def prefetch_batches(paths, batch_size: int, num_threads: int = 4):
    """Yield the decoded waveforms of ``paths`` in batches of
    ``batch_size``, each batch decoded on ``num_threads`` native threads."""
    yield from native.prefetch_batches(paths, batch_size, num_threads)
