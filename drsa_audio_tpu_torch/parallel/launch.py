"""Process groups of spawned ranks: ``launch`` runs a worker in each of n
processes joined into one group, and ``dryrun_worker`` is the body of
``graft_entry.dryrun_multichip``.

The processes are spawned, never forked: the parent may hold CUDA and
threads. A child re-imports the module of the worker it runs, so a
worker lives in a module that imports no jax. Each child runs its torch
ops on one thread: several groups at once (test workers) would otherwise
oversubscribe the host's cores.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from drsa_audio_tpu_torch.parallel.sharding import (
    distributed_init, get_mesh, make_sharded_train_step, mesh_device, replicate,
    sharded_drsa_restarts, sharded_explain_pipeline)
from drsa_audio_tpu_torch.utils.device import resolve_device


def _rank_main(rank: int, n_ranks: int, tmp: str, worker, args: tuple, device: str,
               backend: str | None) -> None:
    torch.set_num_threads(1)
    distributed_init(f"file://{tmp}/store", n_ranks, rank, backend=backend, device=device)
    try:
        out = worker(get_mesh(n_ranks, device=device), *args)
        part = os.path.join(tmp, f"rank{rank}.pkl")
        with open(part + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(part + ".tmp", part)
    finally:
        dist.destroy_process_group()


def launch(n_ranks: int, worker, args: tuple = (), device=None, backend: str | None = None,
           timeout_s: float = 900.0) -> list:
    """``worker(mesh, *args)`` in each of ``n_ranks`` spawned processes
    joined into one group (``distributed_init`` through a ``file://`` store
    in a fresh temporary directory; ``device`` and ``backend`` as there:
    CUDA and nccl unless named). ``worker`` is a module-level function and
    its result picklable. Returns the ranks' results in rank order. Raises
    if any rank fails (the others are then stopped) or if the ranks are
    not done within ``timeout_s``. nccl takes one rank a card: more ranks
    than cards raise here (gloo runs them, on CUDA tensors too)."""
    device = resolve_device(device, "launch")
    if (backend or ("nccl" if device.type == "cuda" else "gloo")) == "nccl" and (
            n_ranks > torch.cuda.device_count()):
        raise ValueError(f"launch: {n_ranks} ranks on {torch.cuda.device_count()} card(s); "
                         "nccl takes one rank a card (pass backend='gloo')")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(n_ranks, tmp, worker, tuple(args),
                                                   device.type, backend),
                                 nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"launch: {n_ranks} ranks not done in {timeout_s} s")
        results = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def dryrun_worker(mesh) -> dict:
    """One rank of ``dryrun_multichip``, on the toy model at tiny shapes:
    one sharded train step on raw waveforms through ``toy_pipeline`` (2
    clips a rank), the sharded explain pipeline from waveforms (K=4, d=16,
    layer 10), and DRSA restarts split over the ranks (one a rank, 3
    steps). Fails on a value that is not finite."""
    from drsa_audio_tpu_torch.models.projection import insert_projection
    from drsa_audio_tpu_torch.models.train import (
        make_optimizer, sample_step_draws, split_trainable, toy_pipeline)
    from drsa_audio_tpu_torch.models.vgg import build_layer_specs, init_params, toy_config
    from drsa_audio_tpu_torch.ops.frontend import FrontendConfig
    from drsa_audio_tpu_torch.utils.constants import LRP_NAME_MAP_TOY
    from drsa_audio_tpu_torch.xai.drsa.optimizer import random_orthogonal
    from drsa_audio_tpu_torch.xai.explain import class_composite

    device = mesh_device(mesh)
    n = mesh.size()
    rng = np.random.default_rng(0)
    specs = build_layer_specs(toy_config())
    params = replicate(init_params(specs, seed=0, device=device), mesh)
    fe = FrontendConfig.for_case("toy")

    trainable, _ = split_trainable(params)
    pipeline = toy_pipeline(fe)
    step = make_sharded_train_step(specs, make_optimizer(trainable, 1e-3), mesh,
                                   per_example_mel=pipeline)
    wavs = rng.standard_normal((2 * n, 16000)).astype(np.float32)
    labels = np.arange(2 * n) % 2
    draws = sample_step_draws(specs, pipeline, wavs.shape,
                              torch.Generator(device=device).manual_seed(1))
    loss, acc = step(params, wavs, labels, draws)

    K, d = 4, 16
    U = torch.as_tensor(random_orthogonal(3, d), device=device)
    explain = sharded_explain_pipeline(insert_projection(specs, 10, U, K), params,
                                       class_composite(LRP_NAME_MAP_TOY, K), mesh, K,
                                       class_idx=0, frontend_config=fe)
    heat = explain(rng.standard_normal((2 * n, 16000)).astype(np.float32))

    A = rng.standard_normal((64, d)).astype(np.float32)
    C = rng.standard_normal((64, d)).astype(np.float32)
    U0 = np.stack([random_orthogonal(5 + i, d) for i in range(n)])
    res = sharded_drsa_restarts(U0, A, C, K, mesh, steps=3)

    out = {"loss": loss.item(), "acc": acc.item(), "heat_shape": tuple(heat.shape),
           "heat_finite": bool(torch.isfinite(heat).all()),
           "objectives": res.objectives.cpu().numpy()}
    if not (np.isfinite(out["loss"]) and out["heat_finite"]
            and np.isfinite(out["objectives"]).all()):
        raise FloatingPointError(f"dryrun: a value is not finite: {out}")
    return out
