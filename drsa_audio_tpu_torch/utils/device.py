"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None, who: str = "the port") -> torch.device:
    """CUDA unless the caller names a device; raises where there is no CUDA
    device and none was named. A CUDA device is returned with its index,
    so that it compares equal to the device of a tensor placed there. On a
    CUDA device TF32 is turned off for
    cuDNN convolutions and matmuls: LRP and DRSA run in full float32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def params_on(params: dict, device) -> dict:
    """{name: {key: tensor}} with every tensor on ``device`` (the same
    tensors where they are there already)."""
    return {n: {k: v.to(device) for k, v in p.items()} for n, p in params.items()}
