"""The experiment configuration tree (the port's copy of
drsa_audio_tpu.utils.config): one dataclass tree, saved to and loaded from
JSON. A file written by either package loads in the other to the same
``dataclasses.asdict``."""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from drsa_audio_tpu_torch.utils.constants import (
    AUDIO_PARAMS, DRSA_LAYERS_GTZAN_6S, LRP_NAME_MAP_GTZAN, LRP_NAME_MAP_GTZAN_6S,
    LRP_NAME_MAP_TOY,
)


@dataclasses.dataclass
class AudioConfig:
    sample_rate: int = 16000
    slice_length: int = 3
    num_chunks: int = 8
    n_fft: int = 800
    hop_length: int = 360
    n_mels: int = 128
    mel_width: int = 128

    @classmethod
    def for_case(cls, case: str) -> "AudioConfig":
        return cls(**AUDIO_PARAMS[case])


@dataclasses.dataclass
class ModelConfig:
    n_filters: Sequence[int] = (32, 32, 64, 64, 128)
    pool_kernels: Sequence[Sequence[int]] = ((2, 2),) * 5
    n_dense: int = 128
    n_classes: int = 10
    dropout: float = 0.4
    block_depth: int = 1
    dense_depth: int = 2
    input_size: Sequence[int] = (128, 128)
    conv_bn: bool = False
    dense_bn: bool = False


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 16
    learning_rate: float = 1e-4
    momentum: float = 0.99
    weight_decay: float = 1e-4
    num_epochs: int = 500
    save_step: int = 100
    validation_fold: int = 1
    seed: int = 42


@dataclasses.dataclass
class DRSAConfig:
    num_concepts: int = 4
    steps: int = 5000
    runs: int = 3
    seed: int = 42
    num_locations: int = 20
    chunks_per_song: int = 10
    layer_idcs: Sequence[int] = (1, 4, 7, 10, 13)
    ortho_method: str = "ns"


@dataclasses.dataclass
class EvalConfig:
    samples_per_class: int = 20
    num_chunks: int = 3
    perturbation_size: int = 16
    perturbation_mode: str = "constant"
    num_concepts_grid: Sequence[int] = (2, 4, 8, 16)


@dataclasses.dataclass
class ExperimentConfig:
    case: str = "gtzan"
    data_path: str = "data"
    model_path: str = "models/run0"
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    drsa: DRSAConfig = dataclasses.field(default_factory=DRSAConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)

    @property
    def lrp_name_map(self):
        if self.case == "toy":
            return LRP_NAME_MAP_TOY
        if self.case == "gtzan_6s":
            return LRP_NAME_MAP_GTZAN_6S
        return LRP_NAME_MAP_GTZAN

    def vgg_config(self):
        """The port's VGGConfig of this model."""
        from drsa_audio_tpu_torch.models.vgg import VGGConfig
        m = self.model
        return VGGConfig(
            n_filters=tuple(m.n_filters),
            pool_kernels=tuple(tuple(p) for p in m.pool_kernels),
            n_dense=m.n_dense, n_classes=m.n_classes, dropout=m.dropout,
            block_depth=m.block_depth, dense_depth=m.dense_depth,
            input_size=tuple(m.input_size), conv_bn=m.conv_bn,
            dense_bn=m.dense_bn,
        )

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls(
            case=raw.get("case", "gtzan"),
            data_path=raw.get("data_path", "data"),
            model_path=raw.get("model_path", "models/run0"),
            audio=AudioConfig(**raw.get("audio", {})),
            model=ModelConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
            drsa=DRSAConfig(**raw.get("drsa", {})),
            eval=EvalConfig(**raw.get("eval", {})),
        )

    @classmethod
    def toy_default(cls) -> "ExperimentConfig":
        return cls(
            case="toy",
            audio=AudioConfig.for_case("toy"),
            model=ModelConfig(
                n_filters=(8, 8, 16, 16, 16), n_dense=32, n_classes=2,
                dropout=0.0, input_size=(64, 64)),
            drsa=DRSAConfig(num_concepts=2),
        )

    @classmethod
    def gtzan_6s_default(cls) -> "ExperimentConfig":
        """The flagship: the 6 s block_depth-2 BN model on 128x256 mels, DRSA
        at the deep ReLU outputs {19, 26, 33}, K=4."""
        return cls(
            case="gtzan_6s",
            audio=AudioConfig.for_case("gtzan_6s"),
            model=ModelConfig(
                n_filters=(64, 64, 100, 128, 128), n_dense=100, n_classes=10,
                pool_kernels=((2, 4), (2, 2), (2, 2), (2, 2), (2, 2)),
                dropout=0.3, input_size=(128, 256), conv_bn=True,
                dense_bn=True, block_depth=2, dense_depth=2),
            drsa=DRSAConfig(num_concepts=4,
                            layer_idcs=tuple(DRSA_LAYERS_GTZAN_6S)),
        )
