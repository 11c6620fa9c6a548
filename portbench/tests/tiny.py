"""Tiny versions of the benchmark's cells for the CPU tests: the published
front-end and layer pattern, narrow filters, a few clips; and a tiny model
of VGGish's layer pattern, stated by ``blocks`` and ``dense``."""

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


# VGGish's framing (vggish_params.py): 25 ms periodic Hann windows of 400
# samples in a 512-point FFT, a 10 ms hop, 64 HTK bands linear on the mel
# scale from 125 to 7,500 Hz, ln(mel + 0.01), 96 uncentred frames of a
# 0.96 s example, no peak normalisation
VGGISH_FRONTEND = {"sample_rate": 16000, "slice_length": 0.96, "clip_samples": 15600,
                   "n_fft": 512, "win_length": 400, "hop_length": 160, "n_mels": 64,
                   "mel_width": 96, "f_min": 125.0, "f_max": 7500.0, "triangles": "mel",
                   "log": "ln_offset", "log_offset": 0.01, "center": False, "first_frame": 0,
                   "peak_normalize": False}
OLD_KEYS = ("n_filters", "pool_kernels", "block_depth", "n_dense", "dense_depth", "dense_bn",
            "dropout")


def vggish_pattern(width: int = 8, embedding: int = 8) -> dict:
    """The 3s configuration (its front-end, classes and case) with VGGish's
    layer pattern at narrow widths: blocks of depth 1, 1, 2, 2, each ending
    in a 2x2 max-pool, then dense layers of 4 * width, 4 * width and a
    linear ``embedding`` with no ReLU, and the class layer; DRSA after the
    last conv's ReLU (features.14)."""
    cfg = {k: v for k, v in config("gtzan3s").items() if k not in OLD_KEYS}
    cfg.update(
        name="vggish_pattern", conv_bn=False, drsa_layer=14, subspace_dim=2 * width,
        blocks=[{"filters": f, "depth": d, "pool": [2, 2]}
                for f, d in ((width, 1), (width, 1), (2 * width, 2), (2 * width, 2))],
        dense=[{"out": 4 * width}, {"out": 4 * width}, {"out": embedding, "relu": False}],
        rules=[["features.0", "wsquare", {"stabilizer": 1e-7}]]
        + [[f"features.{i}", "gamma", {"gamma": 0.25, "stabilizer": 1e-7}]
           for i in (3, 6, 8, 11, 13)]
        + [[f"classifier.{i}", "epsilon", {"epsilon": 1e-7}] for i in (0, 2, 4, 5)])
    return cfg
