"""Weight bridge from the JAX package's parameter pytree.

The JAX package keeps {name: {"w", "b"}} for convs and linears and
{name: {"scale", "bias", "mean", "var"}} for BatchNorm layers; the port keeps
torch's own names, {"weight", "bias"} and {"weight", "bias", "running_mean",
"running_var"}. Layouts are identical (OIHW convs, [out, in] linears), so the
bridge only renames and moves to the device. The pytree is passed in as
numpy arrays; this module never imports the JAX package.
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
