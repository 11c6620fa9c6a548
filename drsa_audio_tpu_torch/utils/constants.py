"""Case constants and LRP rule name-maps.

The port's own copy of the JAX package's tables (drsa_audio_tpu.utils.
constants); a test holds the two equal. Rule maps are plain data:
(layer name, (rule name, kwargs)) pairs read by xai.lrp.engine.Composite.
"""

from __future__ import annotations

CLASS_IDX_MAPPER = {
    "pop": 0,
    "metal": 1,
    "disco": 2,
    "blues": 3,
    "reggae": 4,
    "classical": 5,
    "rock": 6,
    "hiphop": 7,
    "country": 8,
    "jazz": 9,
}

CLASS_IDX_MAPPER_TOY = {"class1": 0, "class2": 1}

# Per-case DSP parameters (reference constants.py:7-24).
AUDIO_PARAMS = {
    "gtzan": {
        "sample_rate": 16000,
        "slice_length": 3,
        "num_chunks": 8,
        "n_fft": 800,
        "hop_length": 360,
        "n_mels": 128,
        "mel_width": 128,
    },
    "toy": {
        "sample_rate": 16000,
        "slice_length": 1,
        "num_chunks": 1,
        "n_fft": 480,
        "hop_length": 240,
        "n_mels": 64,
        "mel_width": 64,
    },
    "gtzan_6s": {
        "sample_rate": 16000,
        "slice_length": 6,
        "num_chunks": 4,
        "n_fft": 800,
        "hop_length": 360,
        "n_mels": 128,
        "mel_width": 256,
    },
}

# The port's front-end table: AUDIO_PARAMS' cases, whose front-end steps
# take ops.frontend.FrontendConfig's defaults, and VGGish's (vggish_params.py,
# mel_features.py): 0.96 s examples of 15,600 samples, a 400-sample periodic
# Hann window in a 512-point FFT at a hop of 160, no centring, 64 HTK bands
# linear on the mel scale from 125 to 7,500 Hz (the DC bin dropped),
# ln(mel + 0.01), 96 frames from the first, no peak normalisation.
FRONTEND_PARAMS = {
    **AUDIO_PARAMS,
    "vggish": {
        "sample_rate": 16000,
        "slice_length": 0.96,
        "clip_samples": 15600,
        "num_chunks": 1,
        "n_fft": 512,
        "win_length": 400,
        "hop_length": 160,
        "n_mels": 64,
        "mel_width": 96,
        "f_min": 125.0,
        "f_max": 7500.0,
        "triangles": "mel",
        "log": "ln_offset",
        "log_offset": 0.01,
        "center": False,
        "first_frame": 0,
        "peak_normalize": False,
    },
}

LRP_NAME_MAP_GTZAN = [
    ("features.0", ("wsquare", {"stabilizer": 1e-7})),
    ("features.3", ("gamma", {"gamma": 0.4, "stabilizer": 1e-7})),
    ("features.6", ("gamma", {"gamma": 0.4, "stabilizer": 1e-7})),
    ("features.9", ("gamma", {"gamma": 0.4 / 2, "stabilizer": 1e-7})),
    ("features.12", ("gamma", {"gamma": 0.4 / 4, "stabilizer": 1e-7})),
    ("classifier.0", ("epsilon", {"epsilon": 1e-7})),
    ("classifier.3", ("epsilon", {"epsilon": 1e-7})),
    ("classifier.6", ("epsilon", {"epsilon": 1e-7})),
]

LRP_NAME_MAP_TOY = [
    ("features.0", ("flat", {"stabilizer": 1e-7})),
    ("features.3", ("gamma", {"gamma": 0.8, "stabilizer": 1e-7})),
    ("features.6", ("gamma", {"gamma": 0.8, "stabilizer": 1e-7})),
    ("features.9", ("gamma", {"gamma": 0.8, "stabilizer": 1e-7})),
    ("features.12", ("gamma", {"gamma": 0.8, "stabilizer": 1e-7})),
    ("classifier.0", ("epsilon", {"epsilon": 1e-7})),
    ("classifier.2", ("epsilon", {"epsilon": 1e-7})),
    ("classifier.4", ("epsilon", {"epsilon": 1e-7})),
]

# 6 s GTZAN model (block_depth=2, BN folded): reference getdrsadata.py:87-108.
LRP_NAME_MAP_GTZAN_6S = [
    ("features.0", ("wsquare", {"stabilizer": 1e-7})),
    ("features.3", ("gamma", {"gamma": 0.3, "stabilizer": 1e-7})),
    ("features.7", ("gamma", {"gamma": 0.3, "stabilizer": 1e-7})),
    ("features.10", ("gamma", {"gamma": 0.3, "stabilizer": 1e-7})),
    ("features.14", ("gamma", {"gamma": 0.3 / 2, "stabilizer": 1e-7})),
    ("features.17", ("gamma", {"gamma": 0.3 / 2, "stabilizer": 1e-7})),
    ("features.21", ("gamma", {"gamma": 0.3 / 2, "stabilizer": 1e-7})),
    ("features.24", ("gamma", {"gamma": 0.3 / 2, "stabilizer": 1e-7})),
    ("features.28", ("gamma", {"gamma": 0.3 / 4, "stabilizer": 1e-7})),
    ("features.31", ("gamma", {"gamma": 0.3 / 4, "stabilizer": 1e-7})),
    ("classifier.0", ("epsilon", {"epsilon": 1e-7})),
    ("classifier.4", ("epsilon", {"epsilon": 1e-7})),
    ("classifier.8", ("epsilon", {"epsilon": 1e-7})),
]


def rescale_gamma(name_map, gamma: float):
    """Rescale every gamma rule in a name map to a new base value, keeping
    the per-depth decay pattern (base = the map's largest gamma)."""
    base = max(kw["gamma"] for _, (rule, kw) in name_map if rule == "gamma")
    return [
        (n, (rule, {**kw, "gamma": kw["gamma"] * gamma / base}
             if rule == "gamma" else kw))
        for n, (rule, kw) in name_map
    ]


# DRSA extraction layers of the 6 s model: the deep ReLU outputs of the
# BN-folded layer list (reference getdrsadata.py:119).
DRSA_LAYERS_GTZAN_6S = [19, 26, 33]

# Subspace dimensionality of the standard 5-block nets at insertion layers
# [1, 4, 7, 10, 13] (reference cpf.py:260,312).
SUBSPACE_DIMS_GTZAN = [32, 32, 64, 64, 128]
SUBSPACE_DIMS_TOY = [8, 8, 16, 16, 16]
