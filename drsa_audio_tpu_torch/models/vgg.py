"""VGG-style CNN as an explicit layer list (the port of
drsa_audio_tpu.models.vgg).

The model is a flat list of ``LayerSpec`` nodes plus parameters keyed by
layer name (``features.N`` / ``classifier.N``, the reference's own names), so
the LRP engine can walk it as an interpreter. Parameters are a plain dict
{name: {"weight": tensor, "bias": tensor}}; ``VGG`` wraps the same tensors in
an ``nn.Module`` whose state_dict keys are ``features.N.weight`` etc.
BatchNorm layers keep torch's names too: {"weight", "bias", "running_mean",
"running_var"}, applied in eval mode; ``fold_batchnorm`` merges them into the
conv or linear layer before them, as the explain path needs.

Training (``forward(train=True)``, ``train_forward_with_bn``) follows the JAX
package's train mode: dropout from keep masks drawn beforehand
(``draw_keep_masks``, a ``torch.Generator``), BatchNorm on the batch's
statistics, and a relu whose gradient at exactly 0 is 0.5, as that of
``jnp.maximum(x, 0)`` is.

Layouts: NCHW model input, OIHW conv weights, [out, in] linear weights. The
``*_nhwc`` variants serve the conv section of the lower LRP segment, whose
activations the explain path records channels-last.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer. ``kind`` is the op; ``config`` is static."""
    kind: str            # conv | batchnorm | batchnorm1d | relu | maxpool |
                         # linear | dropout | flatten | projection |
                         # subspacefilter | invprojection
    name: str
    config: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    """Architecture hyperparameters (reference create_model.py:14-28)."""
    n_filters: Sequence[int] = (32, 64, 96, 128)
    conv_kernel: tuple = (3, 3)
    pool_kernels: Sequence[tuple] = ((4, 4), (2, 4), (2, 2), (2, 2))
    n_dense: int = 512
    n_classes: int = 10
    dropout: float = 0.2
    block_depth: int = 2
    dense_depth: int = 2
    input_size: tuple = (128, 256)
    conv_bn: bool = True
    dense_bn: bool = True

    @property
    def flat_features(self) -> int:
        h, w = self.input_size
        for ph, pw in self.pool_kernels:
            h, w = h // ph, w // pw
        return h * w * self.n_filters[-1]


def build_layer_specs(cfg: VGGConfig) -> list[LayerSpec]:
    """[Conv -> (BN) -> ReLU] * block_depth -> MaxPool per block, then
    [Linear -> (BN1d) -> ReLU -> Dropout] * dense_depth -> Linear."""
    specs: list[LayerSpec] = []
    idx = 0
    in_ch = 1
    for block, filters in enumerate(cfg.n_filters):
        for d in range(cfg.block_depth):
            specs.append(LayerSpec("conv", f"features.{idx}", {
                "in_ch": in_ch if d == 0 else filters, "out_ch": filters,
                "kernel": tuple(cfg.conv_kernel)}))
            idx += 1
            if cfg.conv_bn:
                specs.append(LayerSpec("batchnorm", f"features.{idx}",
                                       {"ch": filters}))
                idx += 1
            specs.append(LayerSpec("relu", f"features.{idx}", {}))
            idx += 1
        specs.append(LayerSpec("maxpool", f"features.{idx}",
                               {"kernel": tuple(cfg.pool_kernels[block])}))
        idx += 1
        in_ch = filters
    specs.append(LayerSpec("flatten", "flatten", {"features": cfg.flat_features}))
    idx = 0
    n_in = cfg.flat_features
    for _ in range(cfg.dense_depth):
        specs.append(LayerSpec("linear", f"classifier.{idx}",
                               {"in_f": n_in, "out_f": cfg.n_dense}))
        idx += 1
        if cfg.dense_bn:
            specs.append(LayerSpec("batchnorm1d", f"classifier.{idx}",
                                   {"ch": cfg.n_dense}))
            idx += 1
        specs.append(LayerSpec("relu", f"classifier.{idx}", {}))
        idx += 1
        if cfg.dropout:
            specs.append(LayerSpec("dropout", f"classifier.{idx}",
                                   {"rate": cfg.dropout}))
            idx += 1
        n_in = cfg.n_dense
    specs.append(LayerSpec("linear", f"classifier.{idx}",
                           {"in_f": n_in, "out_f": cfg.n_classes}))
    return specs


BN_EPS = 1e-5            # torch's BatchNorm default, as the JAX package
BN_MOMENTUM = 0.1


def init_params(specs: Sequence[LayerSpec], seed: int, device=None, scheme: str = "he") -> dict:
    """Kaiming-uniform init drawn from ``np.random.default_rng(seed)``;
    BatchNorm layers start at scale 1, bias 0, mean 0, var 1. On ``device``
    (``resolve_device``: CUDA unless named).

    scheme='he' (default): ReLU gain sqrt(2), the weight bound
    sqrt(6 / fan_in), which keeps the activation scale through deep stacks
    without BatchNorm. scheme='torch': torch's Conv2d/Linear default
    (a=sqrt(5): gain^2 = 2/6, the bound sqrt(1 / fan_in)). The bias bound is
    1 / sqrt(fan_in) under both, as the JAX package's schemes give."""
    from drsa_audio_tpu_torch.utils.device import resolve_device
    if scheme not in ("he", "torch"):
        raise ValueError(f"init_params: unknown scheme {scheme!r}")
    device = resolve_device(device, "init_params")
    gain_sq = 2.0 if scheme == "he" else 2.0 / 6.0
    rng = np.random.default_rng(seed)
    params: dict = {}

    def uniform(shape, bound):
        a = rng.uniform(-bound, bound, size=shape).astype(np.float32)
        return torch.as_tensor(a, device=device)

    for spec in specs:
        if spec.kind == "conv":
            kh, kw = spec.config["kernel"]
            ci, co = spec.config["in_ch"], spec.config["out_ch"]
            fan_in = ci * kh * kw
            params[spec.name] = {
                "weight": uniform((co, ci, kh, kw), np.sqrt(3.0 * gain_sq / fan_in)),
                "bias": uniform((co,), 1.0 / np.sqrt(fan_in))}
        elif spec.kind == "linear":
            fi, fo = spec.config["in_f"], spec.config["out_f"]
            params[spec.name] = {
                "weight": uniform((fo, fi), np.sqrt(3.0 * gain_sq / fi)),
                "bias": uniform((fo,), 1.0 / np.sqrt(fi))}
        elif spec.kind in ("batchnorm", "batchnorm1d"):
            ch = spec.config["ch"]
            params[spec.name] = {
                "weight": torch.ones(ch, device=device),
                "bias": torch.zeros(ch, device=device),
                "running_mean": torch.zeros(ch, device=device),
                "running_var": torch.ones(ch, device=device)}
    return params


def cast_params(params: dict, dtype) -> dict:
    """Conv and linear weights and biases cast to ``dtype`` (BatchNorm
    entries kept as they are), for mixed-precision inference. The explain
    path keeps float32; no path of the port calls this."""
    return {name: ({k: v.to(dtype) for k, v in p.items()} if "running_mean" not in p else p)
            for name, p in params.items()}


def conv2d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """Stride-1 'same' conv, NCHW x OIHW."""
    return F.conv2d(x, w, b, padding="same")


def conv2d_same_nhwc(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None) -> torch.Tensor:
    """Stride-1 'same' conv on NHWC x with OIHW weights (channels-last
    strides go straight to the conv)."""
    return conv2d_same(x.permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1)


def linear_apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.T + b


def maxpool2d(x: torch.Tensor, kernel: tuple) -> torch.Tensor:
    """MaxPool with stride == kernel, NCHW (values only)."""
    return F.max_pool2d(x, tuple(kernel))


def maxpool2d_nhwc(x: torch.Tensor, kernel: tuple) -> torch.Tensor:
    return maxpool2d(x.permute(0, 3, 1, 2), kernel).permute(0, 2, 3, 1)


def batchnorm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Eval-mode BatchNorm over dim 1 of NCHW or [b, features] input, in the
    JAX package's operation order: (x - mean) * (rsqrt(var + BN_EPS) * scale)
    + bias."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(p["running_var"] + BN_EPS)
    return ((x - p["running_mean"].view(shape)) * (inv * p["weight"]).view(shape)
            + p["bias"].view(shape))


def relu_train(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the JAX package's gradient: 1 above 0, 0 below, and
    0.5 at exactly 0 (``jnp.maximum`` splits a tie; ``torch.relu`` gives 0
    and ``clamp`` 1 there). 0.5 * (x + |x|) is max(x, 0) bit for bit, and
    |x|'s gradient at 0 is 0."""
    return 0.5 * (x + x.abs())


def dropout_shapes(specs: Sequence[LayerSpec]) -> dict:
    """{dropout layer name: its feature count} (each follows a linear layer's
    relu)."""
    shapes, features = {}, None
    for spec in specs:
        if spec.kind == "linear":
            features = spec.config["out_f"]
        elif spec.kind == "dropout":
            shapes[spec.name] = features
    return shapes


def draw_keep_masks(specs: Sequence[LayerSpec], batch: int,
                    generator: torch.Generator | None = None, device=None) -> dict:
    """{dropout layer name: bool keep mask [batch, features]}, each entry
    kept with probability 1 - rate (uniform < 1 - rate, as
    ``jax.random.bernoulli``), drawn from ``generator`` on its device (torch's
    default generator where None)."""
    if generator is not None:
        device = generator.device
    rates = {s.name: s.config["rate"] for s in specs if s.kind == "dropout"}
    return {name: torch.rand((batch, f), generator=generator, device=device) < 1.0 - rates[name]
            for name, f in dropout_shapes(specs).items()}


def apply_layer(spec: LayerSpec, params: dict, x: torch.Tensor, train: bool = False,
                keep: torch.Tensor | None = None) -> torch.Tensor:
    """Apply one layer, NCHW: inference semantics, or with ``train`` the
    relu's JAX gradient and, given its ``keep`` mask, dropout (kept entries
    scaled by 1 / (1 - rate)). BatchNorm applies its running statistics here;
    ``train_forward_with_bn`` normalises with the batch's."""
    kind = spec.kind
    if train and kind == "relu":
        return relu_train(x)
    if train and kind == "dropout" and keep is not None:
        return torch.where(keep, x / (1.0 - spec.config["rate"]), 0.0)
    if kind == "conv":
        p = params[spec.name]
        return conv2d_same(x, p["weight"], p.get("bias"))
    if kind == "linear":
        p = params[spec.name]
        return linear_apply(x, p["weight"], p["bias"])
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "maxpool":
        return maxpool2d(x, spec.config["kernel"])
    if kind == "flatten":
        return x.reshape(x.shape[0], -1)
    if kind in ("batchnorm", "batchnorm1d"):
        return batchnorm(x, params[spec.name])
    if kind in ("dropout", "subspacefilter"):
        return x
    if kind == "projection":
        from drsa_audio_tpu_torch.models.projection import apply_projection
        return apply_projection(x, spec.config["U"], spec.config["num_concepts"])
    if kind == "invprojection":
        from drsa_audio_tpu_torch.models.projection import apply_inv_projection
        return apply_inv_projection(x, spec.config["U"],
                                    spec.config["num_concepts"],
                                    spec.config.get("map_hw"))
    raise ValueError(f"unknown layer kind {kind}")


def apply_layer_nhwc(spec: LayerSpec, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Inference-mode apply of the conv-section layer kinds, NHWC."""
    kind = spec.kind
    if kind == "conv":
        p = params[spec.name]
        return conv2d_same_nhwc(x, p["weight"], p.get("bias"))
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "maxpool":
        return maxpool2d_nhwc(x, spec.config["kernel"])
    if kind == "dropout":
        return x
    raise ValueError(f"apply_layer_nhwc: unsupported kind {kind}")


def set_running_stats(params: dict, new: dict) -> None:
    """Write ``new``'s BatchNorm running statistics (train_forward_with_bn's
    result) into the tensors of ``params``, in place."""
    for name, p in params.items():
        if "running_mean" in p:
            p["running_mean"].copy_(new[name]["running_mean"])
            p["running_var"].copy_(new[name]["running_var"])


def fold_batchnorm(specs: Sequence[LayerSpec], params: dict):
    """Fold each BatchNorm into the conv or linear layer before it (the JAX
    package's fold_batchnorm, in its operation order):
    factor = scale / sqrt(var + BN_EPS), w' = w * factor,
    b' = (b - mean) * factor + bias. Returns (specs without the BN layers,
    params without their entries); layer names are kept, so the rule maps
    and DRSA layer indices of the folded model still apply."""
    new_specs: list[LayerSpec] = []
    new_params = dict(params)
    prev = None
    for spec in specs:
        if spec.kind in ("batchnorm", "batchnorm1d") and prev is not None:
            bn = params[spec.name]
            p = dict(new_params[prev.name])
            factor = bn["weight"] / torch.sqrt(bn["running_var"] + BN_EPS)
            shape = (-1,) + (1,) * (p["weight"].ndim - 1)
            p["weight"] = p["weight"] * factor.view(shape)
            b = p.get("bias")
            p["bias"] = ((b if b is not None else 0.0) - bn["running_mean"]) * factor + bn["bias"]
            new_params[prev.name] = p
            new_params.pop(spec.name)
            continue
        if spec.kind in ("conv", "linear"):
            prev = spec
        elif spec.kind not in ("batchnorm", "batchnorm1d"):
            prev = None
        new_specs.append(spec)
    return new_specs, new_params


def forward(specs: Sequence[LayerSpec], params: dict, x: torch.Tensor, train: bool = False,
            keep_masks: dict | None = None) -> torch.Tensor:
    """Full forward -> logits; with ``train``, dropout from ``keep_masks``
    (none where None) and the relu's JAX gradient."""
    for spec in specs:
        keep = keep_masks.get(spec.name) if train and keep_masks is not None else None
        x = apply_layer(spec, params, x, train=train, keep=keep)
    return x


def train_forward_with_bn(specs: Sequence[LayerSpec], params: dict, x: torch.Tensor,
                          keep_masks: dict | None = None, momentum: float = BN_MOMENTUM):
    """Training forward with BatchNorm on the batch's statistics: returns
    (logits, params with each BN layer's new running statistics). BN
    normalises with the biased batch variance and moves the running
    variance toward the unbiased one, running = (1 - momentum) * running +
    momentum * batch statistic (``F.batch_norm``'s training mode)."""
    new_params = dict(params)
    for spec in specs:
        if spec.kind in ("batchnorm", "batchnorm1d"):
            p = params[spec.name]
            mean, var = p["running_mean"].clone(), p["running_var"].clone()
            x = F.batch_norm(x, mean, var, p["weight"], p["bias"], training=True,
                             momentum=momentum, eps=BN_EPS)
            new_params[spec.name] = {**p, "running_mean": mean, "running_var": var}
        else:
            keep = keep_masks.get(spec.name) if keep_masks is not None else None
            x = apply_layer(spec, params, x, train=True, keep=keep)
    return x, new_params


class VGG(nn.Module):
    """The layer list as an nn.Module: state_dict keys are the reference's
    ``features.N.weight`` / ``classifier.N.bias``. ``params()`` hands the same
    tensors to the functional path. In training mode ``forward`` is
    ``train_forward_with_bn`` with keep masks from torch's default generator,
    and the BN buffers take the new running statistics."""

    def __init__(self, cfg: VGGConfig):
        super().__init__()
        self.specs = build_layer_specs(cfg)
        mods: dict[str, list] = {"features": [], "classifier": []}
        for spec in self.specs:
            if spec.kind == "flatten":
                continue
            section = spec.name.split(".")[0]
            c = spec.config
            if spec.kind == "conv":
                m = nn.Conv2d(c["in_ch"], c["out_ch"], c["kernel"], padding="same")
            elif spec.kind == "linear":
                m = nn.Linear(c["in_f"], c["out_f"])
            elif spec.kind == "maxpool":
                m = nn.MaxPool2d(c["kernel"])
            elif spec.kind == "dropout":
                m = nn.Dropout(c["rate"])
            elif spec.kind == "relu":
                m = nn.ReLU()
            elif spec.kind == "batchnorm":
                m = nn.BatchNorm2d(c["ch"], eps=BN_EPS)
            elif spec.kind == "batchnorm1d":
                m = nn.BatchNorm1d(c["ch"], eps=BN_EPS)
            else:
                raise ValueError(f"VGG: {spec.kind} layers are not ported yet")
            mods[section].append(m)
        self.features = nn.Sequential(*mods["features"])
        self.classifier = nn.Sequential(*mods["classifier"])

    def params(self) -> dict:
        out = {}
        for spec in self.specs:
            if spec.kind in ("conv", "linear", "batchnorm", "batchnorm1d"):
                section, idx = spec.name.split(".")
                m = getattr(self, section)[int(idx)]
                out[spec.name] = {"weight": m.weight, "bias": m.bias}
                if spec.kind.startswith("batchnorm"):
                    out[spec.name].update(running_mean=m.running_mean,
                                          running_var=m.running_var)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = self.params()
        if not self.training:
            return forward(self.specs, params, x)
        masks = draw_keep_masks(self.specs, x.shape[0], device=x.device)
        logits, new = train_forward_with_bn(self.specs, params, x, masks)
        with torch.no_grad():
            set_running_stats(params, new)
        return logits


def conv_out_shape(input_size, pool_kernels, conv_kernel=(3, 3),
                   out_filters: int = 128, padding="same", stride: int = 1,
                   block_depth: int = 2) -> int:
    """Analytic flattened feature count for architecture grid search
    (reference get_out_shape, create_model.py:174-211)."""
    pad = 1 if padding == "same" else 0
    h, w = input_size
    for ph, pw in pool_kernels:
        for _ in range(block_depth):
            h = (h - conv_kernel[0] + 2 * pad) // stride + 1
            w = (w - conv_kernel[1] + 2 * pad) // stride + 1
        h = (h - (ph - 1) - 1) // ph + 1
        w = (w - (pw - 1) - 1) // pw + 1
    return int(h * w * out_filters)


def gtzan_6s_config() -> VGGConfig:
    """6 s GTZAN model (reference getdrsadata.py:72-73)."""
    return VGGConfig(n_filters=(64, 64, 100, 128, 128), n_dense=100,
                     pool_kernels=((2, 4), (2, 2), (2, 2), (2, 2), (2, 2)),
                     dropout=0.3, input_size=(128, 256), n_classes=10,
                     conv_bn=True, dense_bn=True, block_depth=2)


def gtzan_3s_config() -> VGGConfig:
    """3 s GTZAN model (reference cpf.py:410-412)."""
    return VGGConfig(n_filters=(32, 32, 64, 64, 128), n_dense=128,
                     pool_kernels=((2, 2),) * 5, dropout=0.4,
                     input_size=(128, 128), n_classes=10, conv_bn=False,
                     dense_bn=False, block_depth=1)


def toy_config() -> VGGConfig:
    """Toy 2-class model on 64x64 mels (reference cpf.py:260 toy dims)."""
    return VGGConfig(n_filters=(8, 8, 16, 16, 16), n_dense=32,
                     pool_kernels=((2, 2),) * 5, dropout=0.0,
                     input_size=(64, 64), n_classes=2, conv_bn=False,
                     dense_bn=False, block_depth=1, dense_depth=2)
