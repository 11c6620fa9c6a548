"""Weight bridge from the JAX package's parameter pytree.

The JAX package keeps {name: {"w", "b"}}; the port keeps {name: {"weight",
"bias"}}, the reference's own naming (BatchNorm parameters are not bridged
yet). Layouts are identical (OIHW convs, [out, in]
linears), so the bridge only renames and moves to the device. The pytree is
passed in as numpy arrays; this module never imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

_RENAME = {"w": "weight", "b": "bias"}


def from_jax_params(params_np: dict, device="cuda") -> dict:
    """{name: {"w": ndarray, ...}} -> the port's params on ``device``."""
    return {name: {_RENAME[k]: torch.as_tensor(np.array(v, np.float32),
                                               device=device)
                   for k, v in p.items()}
            for name, p in params_np.items()}


def to_state_dict(params: dict) -> dict:
    """The port's params -> flat ``features.N.weight`` keys (for
    ``VGG.load_state_dict``)."""
    return {f"{name}.{k}": v for name, p in params.items() for k, v in p.items()}
