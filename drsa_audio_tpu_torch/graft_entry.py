"""Entry points (the port of the repository's ``__graft_entry__``): one
forward step of the GTZAN-3s model, and a data-parallel dry run over
spawned ranks."""

from __future__ import annotations

import torch

from drsa_audio_tpu_torch.models.vgg import (
    build_layer_specs, forward, gtzan_3s_config, init_params)
from drsa_audio_tpu_torch.parallel.launch import dryrun_worker, launch
from drsa_audio_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """(fn, example_args): the GTZAN-3s forward (the reference's checkpointed
    architecture, cpf.py:410-412) on ``init_params(seed=0)``, with an
    example batch [8, 1, 128, 128] of zeros, on ``device``
    (``resolve_device``: CUDA unless named). ``fn(x)`` returns the logits
    [8, 10]."""
    device = resolve_device(device, "entry")
    specs = build_layer_specs(gtzan_3s_config())
    params = init_params(specs, seed=0, device=device)

    @torch.no_grad()
    def fn(x):
        return forward(specs, params, x)

    return fn, (torch.zeros((8, 1, 128, 128), device=device),)


def dryrun_multichip(n_devices: int, device=None, backend: str | None = None) -> list:
    """``n_devices`` spawned ranks in one group (parallel.launch), each
    running one sharded train step on raw toy waveforms, the sharded
    explain pipeline from waveforms and DRSA restarts split over the ranks,
    at tiny shapes (``launch.dryrun_worker``). ``device`` and ``backend`` as
    ``distributed_init`` takes them (CUDA and nccl unless named; nccl takes
    one rank a card). Raises if any rank fails; returns each rank's
    summary."""
    return launch(n_devices, dryrun_worker, device=device, backend=backend)
