"""Data-parallel scale-out on torch.distributed (the port of
drsa_audio_tpu.parallel.sharding).

The JAX package runs one process over many devices and lets XLA split a
batch-sharded program (``shard_map``) and insert its collectives. Here one
process drives one device, PyTorch's idiom: ``distributed_init`` joins the
processes into one group, ``get_mesh`` names it as a one-dimensional
``DeviceMesh`` with the axis "data", and each sharded program runs the
unmodified single-device program on this rank's rows and returns the whole
batch on every rank, as a JAX caller gets a global array. The collectives
are explicit tensor operations, ``broadcast`` and ``all_reduce`` only: the
two that gloo also runs on CUDA tensors, so two ranks can share one card.

A batch of n rows is split into contiguous blocks in rank order, the first
n % world ranks one row longer (``shard_batch``); where the world divides
n, a rank's block is the one JAX's ``P("data")`` gives its device. Where
JAX zero-pads a ragged batch and slices the pad off, the port splits
unevenly. Every sharded program takes either the full batch, on every
rank, or this rank's rows as ``LocalRows`` (``shard_batch``,
``global_from_local``).

Outside a process group ``get_mesh`` returns a ``LocalMesh``: a world of
one on the resolved device, where the programs run with no collective.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from drsa_audio_tpu_torch.models.train import make_train_step
from drsa_audio_tpu_torch.ops.frontend import logmel, peak_normalize
from drsa_audio_tpu_torch.utils.device import params_on, resolve_device
from drsa_audio_tpu_torch.xai.drsa.optimizer import DRSAResult, drsa_fit_batched
from drsa_audio_tpu_torch.xai.drsa.preprocessing import (
    draw_clip_seeds, make_extract_fn, preprocess_data)
from drsa_audio_tpu_torch.xai.explain import subspace_heatmaps
from drsa_audio_tpu_torch.xai.lrp.engine import lrp, output_mask_class

# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The mesh of a process outside any group: a world of one."""
    device: torch.device
    mesh_dim_names: tuple = ("data",)

    @property
    def device_type(self) -> str:
        return self.device.type

    def size(self) -> int:
        return 1


class LocalRows(NamedTuple):
    """This rank's contiguous block of a batch's rows, on its device, with
    every rank's row count in rank order."""
    rows: torch.Tensor
    counts: tuple
    start: int


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None) -> None:
    """Join this process to a group of ``num_processes`` as rank
    ``process_id``; a no-op where the address is None. The address is a
    ``torch.distributed`` init method (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` is taken as tcp). The backend is
    nccl where the device (``resolve_device``: CUDA unless named) is CUDA
    and gloo on the CPU, unless named; nccl raises where it is missing. A
    CUDA rank takes the card process_id % the cards on its host."""
    if coordinator_address is None:
        return
    device = resolve_device(device, "distributed_init")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("distributed_init: this torch has no NCCL")
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    address = coordinator_address if "://" in coordinator_address else (
        f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)


def get_mesh(n_devices: int | None = None, axis_name: str = "data", device=None):
    """The one-dimensional ``DeviceMesh`` named ``axis_name`` over the
    initialised group, one rank a device (``device``: this rank's,
    ``resolve_device``); outside a group a ``LocalMesh``, a world of one.
    ``n_devices`` other than the world size raises."""
    device = resolve_device(device, "get_mesh")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"get_mesh: {n_devices} devices asked, the world holds {world} "
                         "(one rank a device; start the ranks with distributed_init)")
    if not dist.is_initialized():
        return LocalMesh(device, (axis_name,))
    return DeviceMesh(device.type, torch.arange(world), mesh_dim_names=(axis_name,))


def _layout(mesh):
    """(rank, world, this rank's device, process group or None)."""
    if isinstance(mesh, LocalMesh):
        return 0, 1, mesh.device, None
    device = resolve_device(mesh.device_type)
    return mesh.get_local_rank(), mesh.size(), device, mesh.get_group()


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    return _layout(mesh)[2]


def _counts(n: int, world: int) -> tuple:
    q, r = divmod(n, world)
    return tuple(q + (i < r) for i in range(world))


def shard_batch(x, mesh) -> LocalRows:
    """This rank's block of the rows of ``x`` (array or tensor, the full
    batch on every rank), moved to its device."""
    rank, world, device, _ = _layout(mesh)
    counts = _counts(len(x), world)
    start = sum(counts[:rank])
    return LocalRows(torch.as_tensor(x[start:start + counts[rank]]).to(device), counts, start)


def global_from_local(local, mesh, global_batch: int) -> LocalRows:
    """This rank's own rows (each rank feeds only its block, in rank
    order) as ``LocalRows`` on its device. The ranks' counts are gathered
    and must sum to ``global_batch``."""
    rank, world, device, group = _layout(mesh)
    rows = torch.as_tensor(local).to(device)
    counts = torch.zeros(world, dtype=torch.int64, device=device)
    counts[rank] = rows.shape[0]
    if group is not None:
        dist.all_reduce(counts, group=group)
    counts = tuple(counts.tolist())
    if sum(counts) != global_batch:
        raise ValueError(f"global_from_local: the ranks hold {counts} rows, "
                         f"not {global_batch}")
    return LocalRows(rows, counts, sum(counts[:rank]))


def replicate(tree, mesh):
    """A copy of ``tree`` (dicts, lists and tuples of tensors or arrays)
    on this rank's device holding rank 0's values, broadcast leaf by leaf in
    sorted key order. Leaves of other types are returned as they are."""
    _, _, device, group = _layout(mesh)

    def put(a):
        if isinstance(a, dict):
            done = {k: put(a[k]) for k in sorted(a)}
            return {k: done[k] for k in a}
        if isinstance(a, (list, tuple)):
            return type(a)(put(v) for v in a)
        if not isinstance(a, (torch.Tensor, np.ndarray)):
            return a
        t = torch.as_tensor(a).detach().to(device).clone().contiguous()
        if group is not None:
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t

    return put(tree)


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Pad the batch axis with zeros up to a multiple; returns (padded,
    original length)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = np.concatenate([x, np.zeros((rem,) + x.shape[1:], x.dtype)], axis=0)
    return x, n


def _gather(local: torch.Tensor, counts: tuple, mesh) -> torch.Tensor:
    """Every rank's block, ``counts[r]`` leading rows from rank r, stacked
    in rank order on every rank: each block broadcast from its rank into a
    slice of one buffer."""
    rank, _, _, group = _layout(mesh)
    if group is None:
        return local
    full = local.new_empty((sum(counts), *local.shape[1:]))
    start = 0
    for r, c in enumerate(counts):
        if c:
            block = full[start:start + c]
            if r == rank:
                block.copy_(local)
            dist.broadcast(block, src=dist.get_global_rank(group, r), group=group)
        start += c
    return full


def sharded(fn, mesh):
    """``fn`` (a program over a batch: rows -> a tensor or a tuple of
    tensors, each with a leading axis of a fixed number of rows per input
    row) as a data-parallel program, the counterpart of ``shard_map`` with
    the batch axis split in and out. ``call(x, *row_args)`` runs
    ``fn(rows, *their rows of row_args)`` on this rank's rows of ``x`` (the
    full batch, or ``LocalRows``; ``row_args`` hold the full batch's rows,
    or None) and returns each output for the whole batch, in row order, on
    every rank. A rank without rows (a batch smaller than the world) runs
    one zero row and keeps none of it."""
    def call(x, *row_args):
        local = x if isinstance(x, LocalRows) else shard_batch(x, mesh)
        n = local.rows.shape[0]
        args = [None if a is None else a[local.start:local.start + n] for a in row_args]
        if n == 0:
            args = [None if a is None else a.new_zeros((1, *a.shape[1:])) for a in args]
            out = fn(local.rows.new_zeros((1, *local.rows.shape[1:])), *args)
        else:
            out = fn(local.rows, *args)
        single = isinstance(out, torch.Tensor)
        gathered = []
        for o in ((out,) if single else out):
            per = o.shape[0] // max(n, 1)
            gathered.append(_gather(o[:per * n], tuple(c * per for c in local.counts), mesh))
        return gathered[0] if single else tuple(gathered)

    return call


def _specs_on(specs, device):
    """The layer list with every tensor of its configs (the projection's
    U) on ``device``."""
    return [dataclasses.replace(s, config={k: v.to(device) if torch.is_tensor(v) else v
                                           for k, v in s.config.items()})
            for s in specs]


def sharded_heatmaps(specs, params, composite, mesh, class_idx: int):
    """``call(x)``: the LRP input relevance of mels x [b, 1, h, w] for one
    class (engine.lrp), each rank explaining its rows."""
    device = mesh_device(mesh)
    placed = params_on(params, device)
    mask = output_mask_class(class_idx)

    @torch.inference_mode()
    def call(x):
        return sharded(lambda rows: lrp(specs, placed, rows, composite, mask)[0], mesh)(x)

    return call


def sharded_explain_pipeline(specs_proj, params, composite, mesh, num_concepts: int,
                             class_idx: int, frontend_config=None):
    """``call(x)``: heatmaps [b, K+1, h, w] (subspace_heatmaps, the chain
    kernels on a CUDA device), each rank explaining its rows. With
    ``frontend_config`` x is raw waveforms [b, samples] (peak_normalize,
    logmel); otherwise mels [b, 1, h, w]."""
    device = mesh_device(mesh)
    placed = params_on(params, device)
    specs_proj = _specs_on(specs_proj, device)

    def run(x):
        if frontend_config is not None:
            x = logmel(peak_normalize(x), frontend_config)[:, None]
        return subspace_heatmaps(specs_proj, placed, x, composite, num_concepts,
                                 class_idx=class_idx)[0]

    @torch.inference_mode()
    def call(x):
        return sharded(run, mesh)(x)

    return call


def sharded_drsa_extraction(specs, params, composite, mesh, layer_idx: int, class_idx: int,
                            num_locations: int | None = None):
    """``call(x, generator_or_seed=0) -> (act, ctx)``, preprocess_data over
    the ranks. With ``num_locations`` the clip seeds (``draw_clip_seeds``)
    are drawn for the whole batch from the caller's generator (or seed)
    before the split and each rank samples its clips' positions with their
    seeds, so the result is the single-process
    ``preprocess_data(..., clip_seeds=...)``'s at any world size: [b*L, d]
    each, in row order. Without, every position: [b, h*w, d]."""
    device = mesh_device(mesh)
    extract = make_extract_fn(specs, params, composite, layer_idx, device=device)

    def run(rows, seeds):
        return preprocess_data(specs, params, rows, composite, layer_idx, class_idx,
                               num_locations, extract_fn=extract, device=device,
                               clip_seeds=seeds)

    def call(x, generator_or_seed=0):
        n = sum(x.counts) if isinstance(x, LocalRows) else len(x)
        seeds = draw_clip_seeds(generator_or_seed, n) if num_locations else None
        return sharded(run, mesh)(x, seeds)

    return call


def sharded_drsa_restarts(U0, act_vecs, ctx_vecs, num_concepts: int, mesh,
                          steps: int = 2000, ortho_method: str = "ns") -> DRSAResult:
    """DRSA restarts from U0 [runs, d, d] split over the ranks, a block of
    runs each (``drsa_fit_batched`` on vectors [N, d]); U [runs, d, d] and
    objectives [runs, steps+1] gathered on every rank."""
    device = mesh_device(mesh)
    act = torch.as_tensor(act_vecs, dtype=torch.float32, device=device)[None]
    ctx = torch.as_tensor(ctx_vecs, dtype=torch.float32, device=device)[None]
    ones = torch.ones(act.shape[:2], device=device)

    def run(u0):
        res = drsa_fit_batched(u0[None], act, ctx, ones, num_concepts, steps, ortho_method,
                               device)
        return res.U[0], res.objectives[0]

    U, objectives = sharded(run, mesh)(torch.as_tensor(U0, dtype=torch.float32))
    return DRSAResult(U, objectives, objectives[:, -1].argmax())


def make_sharded_train_step(specs_or_model, optimizer: torch.optim.Optimizer, mesh,
                            per_example_mel=None, has_bn: bool = False):
    """The data-parallel ``step(params, batch, labels, draws) -> (loss,
    acc)``, equal to one single-process ``make_train_step`` step on the
    global batch (what XLA's partitioned step computes): ``make_train_step``
    over the mesh's process group on this rank's rows. ``params`` and the
    optimizer's tensors are this rank's replica (``replicate``); ``batch``
    and ``labels`` the full batch or ``LocalRows``; ``draws``
    (``sample_step_draws``) are the global batch's, drawn alike on every
    rank from generators seeded alike, and each rank takes its rows.
    Returns the global loss and accuracy."""
    _, world, _, group = _layout(mesh)
    step = make_train_step(specs_or_model, optimizer, per_example_mel, has_bn, group)

    def sharded_step(params, batch, labels, draws):
        xs = batch if isinstance(batch, LocalRows) else shard_batch(batch, mesh)
        ys = labels if isinstance(labels, LocalRows) else shard_batch(labels, mesh)
        if xs.counts != ys.counts:
            raise ValueError(f"batch rows {xs.counts} and label rows {ys.counts} differ")
        if min(xs.counts) == 0:
            raise ValueError(f"a train batch of {sum(xs.counts)} leaves a rank of {world} "
                             "without rows")
        mine = slice(xs.start, xs.start + xs.rows.shape[0])
        draws = {k: {name: v[mine] for name, v in d.items()} for k, d in draws.items()}
        return step(params, xs.rows, ys.rows, draws, sum(xs.counts))

    return sharded_step
