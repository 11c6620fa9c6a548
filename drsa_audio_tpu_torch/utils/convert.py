"""Weight bridges: from the JAX package's parameter pytree, and from and to
the reference's own torch checkpoints.

The JAX package keeps {name: {"w", "b"}} for convs and linears and
{name: {"scale", "bias", "mean", "var"}} for BatchNorm layers; the port keeps
torch's own names, {"weight", "bias"} and {"weight", "bias", "running_mean",
"running_var"}. Layouts are identical (OIHW convs, [out, in] linears), so the
bridge only renames and moves to the device. The pytree is passed in as
numpy arrays; this module never imports the JAX package. The reference
saves ``torch.save({"model_state_dict": ...})`` checkpoints
(cxai/model/train.py:175-188) under the port's own names, which
``params_from_state_dict`` and ``state_dict_from_params`` read and write
(the port of drsa_audio_tpu.utils.convert).
"""

from __future__ import annotations

import numpy as np
import torch

_RENAME = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def from_jax_params(params_np: dict, device=None) -> dict:
    """{name: {"w": ndarray, ...}} -> the port's params on ``device``
    (``resolve_device``: CUDA unless named)."""
    from drsa_audio_tpu_torch.utils.device import resolve_device
    device = resolve_device(device, "from_jax_params")
    return {name: {_RENAME[k]: torch.as_tensor(np.array(v, np.float32),
                                               device=device)
                   for k, v in p.items()}
            for name, p in params_np.items()}


def to_state_dict(params: dict) -> dict:
    """The port's params -> flat ``features.N.weight`` keys (for
    ``VGG.load_state_dict``). A BatchNorm entry also gets torch's
    ``num_batches_tracked`` counter, at 0."""
    out = {}
    for name, p in params.items():
        out.update({f"{name}.{k}": v for k, v in p.items()})
        if "running_mean" in p:
            out[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=p["running_mean"].device)
    return out


_KEYS = {"conv": ("weight", "bias"), "linear": ("weight", "bias"),
         "batchnorm": ("weight", "bias", "running_mean", "running_var"),
         "batchnorm1d": ("weight", "bias", "running_mean", "running_var")}


def params_from_state_dict(state_dict, specs, device=None) -> dict:
    """The port's params from a torch-style state dict with the reference's
    names (``features.N.weight``, ``classifier.N.running_var``; tensor or
    ndarray values), as float32 on ``device`` (``resolve_device``: CUDA
    unless named). Layers not in ``specs`` and BatchNorm's
    ``num_batches_tracked`` are left out."""
    from drsa_audio_tpu_torch.utils.device import resolve_device
    device = resolve_device(device, "params_from_state_dict")

    def get(name):
        v = state_dict[name]
        if torch.is_tensor(v):
            return v.detach().to(device=device, dtype=torch.float32, copy=True)
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return {spec.name: {k: get(f"{spec.name}.{k}") for k in _KEYS[spec.kind]}
            for spec in specs if spec.kind in _KEYS}


def load_torch_checkpoint(path: str, specs, device=None) -> dict:
    """A reference ``best_model_*.pth`` checkpoint (``{"model_state_dict":
    ...}``, or a bare state dict) as the port's params on ``device``.
    Loaded with ``weights_only=False``, as the JAX package loads it: the
    reference's files also pickle numpy's and Python's RNG states
    (cxai/model/train.py:175-188), which torch's weights-only loader
    refuses. Load only checkpoints from a source you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model_state_dict", ckpt)
    return params_from_state_dict(state, specs, device)


def state_dict_from_params(params, specs) -> dict:
    """The inverse of ``params_from_state_dict``: ``features.N.weight``
    keys to numpy arrays, for exporting back to torch users."""
    return {f"{spec.name}.{k}": params[spec.name][k].detach().cpu().numpy()
            for spec in specs if spec.kind in _KEYS for k in _KEYS[spec.kind]}
