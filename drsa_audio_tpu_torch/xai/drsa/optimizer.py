"""DRSA subspace optimiser (the port of drsa_audio_tpu.xai.drsa.optimizer).

Projected gradient ascent on an orthogonal U (reference drsa.py:15-238):
U <- orthogonalize(U + dObj/dU), learning rate 1. The objective projects
activation and context vectors through U, sums their product over each
concept's block of d/K columns, ReLUs it, and takes a generalised F-mean
with p=2 over the vectors ("soft-max") and then p=0.5 over the concepts
("soft-min").

Restarts, and the classes of one layer, run as one batched tensor
[pairs, runs, d, d]; the gradient of the sum of the per-run objectives is
each run's own gradient, since the runs share nothing. The steps are a
Python loop that never waits for the device. Orthogonalisation is
Newton-Schulz (matmuls only; default) or ``torch.linalg.eigh``.

``init_runs`` draws from numpy (``random_orthogonal``, permutations), so its
U0 differs from the JAX package's for the same seed: to compare the two,
pass U0 to ``drsa_fit``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from drsa_audio_tpu_torch.utils.device import resolve_device


def generalized_fmean(x: torch.Tensor, p: float, axis: int = 0) -> torch.Tensor:
    """(mean(x^p))^(1/p) over ``axis`` (reference drsa.py:171-182)."""
    return torch.mean(x ** p, dim=axis) ** (1.0 / p)


def objective_fn(rel: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Soft-max over vectors (p=2), then soft-min over concepts (p=0.5).
    rel: [..., N, K] non-negative relevances; mask: optional [..., N]
    validity weights, padded rows excluded from the vectors' mean. Returns
    [...]."""
    if mask is None:
        x = generalized_fmean(rel, 2.0, axis=-2)
    else:
        m = mask.to(rel.dtype)[..., None]
        x = torch.sqrt(torch.sum(rel ** 2 * m, dim=-2) / torch.sum(m, dim=-2))
    return generalized_fmean(x, 0.5, axis=-1)


def subspace_relevances(act_vecs: torch.Tensor, ctx_vecs: torch.Tensor, U: torch.Tensor,
                        num_concepts: int) -> torch.Tensor:
    """[..., N, K] ReLU'd relevance of each concept (reference
    drsa.py:122-155); vectors [..., N, d], U [..., d, d], broadcast.
    torch.relu here, as jax.nn.relu there: its gradient at 0 is 0 (unlike
    the LRP relu gate)."""
    x = (act_vecs @ U) * (ctx_vecs @ U)
    return torch.relu(x.reshape(*x.shape[:-1], num_concepts, -1).sum(dim=-1))


def obj_val(act_vecs, ctx_vecs, U, num_concepts: int, mask=None) -> torch.Tensor:
    return objective_fn(subspace_relevances(act_vecs, ctx_vecs, U, num_concepts), mask)


def project_grad(gradient: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The gradient on the tangent of the orthogonal constraint (reference
    drsa.py:185-198; the default update does not use it)."""
    Ut = U.transpose(-2, -1)
    return gradient - Ut @ gradient @ Ut


def orthogonalize_eigh(U: torch.Tensor) -> torch.Tensor:
    """U (U^T U)^{-1/2} by a symmetric eigendecomposition
    (drsa.py:201-221); batched over leading axes."""
    S, V = torch.linalg.eigh(U.transpose(-2, -1) @ U)
    inv_sqrt = (V * (1.0 / torch.sqrt(S))[..., None, :]) @ V.transpose(-2, -1)
    return U @ inv_sqrt


def orthogonalize_ns(U: torch.Tensor, iterations: int = 24) -> torch.Tensor:
    """U (U^T U)^{-1/2} by the coupled Newton-Schulz iteration, matmuls
    only; batched over leading axes. A = U^T U is scaled by its Frobenius
    norm so that the iteration converges, and the scale undone at the end."""
    d = U.shape[-1]
    A = U.transpose(-2, -1) @ U
    norm = torch.sqrt(torch.sum(A * A, dim=(-2, -1), keepdim=True))
    Y = A / norm
    eye = torch.eye(d, dtype=U.dtype, device=U.device)
    Z = eye.expand_as(A)
    for _ in range(iterations):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return U @ (Z / torch.sqrt(norm))


class DRSAResult(NamedTuple):
    U: torch.Tensor               # [..., runs, d, d] final projection matrices
    objectives: torch.Tensor      # [..., runs, steps+1] objective before each step, and at the end
    best_run: torch.Tensor        # [...] argmax of the final objective over runs


def _ascend(U0, act, ctx, mask, num_concepts: int, steps: int, ortho_method: str):
    """The step loop on batched U0 [..., runs, d, d] against vectors that
    broadcast with it; returns (U, objectives [..., runs, steps+1]).
    Autograd runs outside inference mode, on normal copies of any inference
    tensors, so that a caller in inference mode may fit."""
    ortho = orthogonalize_ns if ortho_method == "ns" else orthogonalize_eigh
    objs = []
    with torch.inference_mode(False):
        U = U0.clone()
        act, ctx, mask = (t.clone() if t is not None and t.is_inference() else t
                          for t in (act, ctx, mask))
        with torch.enable_grad():
            for _ in range(steps):
                U = U.detach().requires_grad_(True)
                obj = obj_val(act, ctx, U, num_concepts, mask)
                (g,) = torch.autograd.grad(obj.sum(), U)
                objs.append(obj.detach())
                with torch.no_grad():
                    U = ortho(U + g)
        with torch.no_grad():
            objs.append(obj_val(act, ctx, U, num_concepts, mask))
    return U.detach(), torch.stack(objs, dim=-1)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def drsa_fit(U0, act_vecs, ctx_vecs, num_concepts: int, steps: int = 2000,
             ortho_method: str = "ns", device=None) -> DRSAResult:
    """``runs`` restarts of projected gradient ascent from U0 [runs, d, d]
    on vectors [N, d]. ``device`` defaults to CUDA and raises where there
    is none."""
    device = resolve_device(device, "drsa_fit")
    U, objectives = _ascend(_tensor(U0, device), _tensor(act_vecs, device),
                            _tensor(ctx_vecs, device), None, num_concepts, steps,
                            ortho_method)
    return DRSAResult(U, objectives, objectives[:, -1].argmax())


def drsa_fit_batched(U0, act_vecs, ctx_vecs, mask, num_concepts: int, steps: int = 2000,
                     ortho_method: str = "ns", device=None) -> DRSAResult:
    """Every (class, layer) pair of one d at once: U0 [pairs, runs, d, d],
    vectors [pairs, N_max, d] zero-padded, ``mask`` [pairs, N_max] (1 = a
    real row), padded rows left out of the objective's mean. Returns a
    DRSAResult with a leading [pairs] axis."""
    device = resolve_device(device, "drsa_fit_batched")
    U, objectives = _ascend(_tensor(U0, device), _tensor(act_vecs, device)[:, None],
                            _tensor(ctx_vecs, device)[:, None],
                            _tensor(mask, device)[:, None], num_concepts, steps, ortho_method)
    return DRSAResult(U, objectives, objectives[..., -1].argmax(dim=1))


def random_orthogonal(seed, d: int) -> np.ndarray:
    """Random orthogonal [d, d] float32 matrix: QR of a Gaussian drawn from
    ``np.random.default_rng(seed)``, sign-fixed for a unique decomposition
    (replaces scipy.stats.ortho_group.rvs, reference drsa.py:272)."""
    g = np.random.default_rng(seed).standard_normal((d, d))
    q, r = np.linalg.qr(g)
    return (q * np.sign(np.diagonal(r))[None, :]).astype(np.float32)


def init_runs(seed: int, d: int, runs: int = 3) -> np.ndarray:
    """One random orthogonal matrix, column-permuted per run (reference
    drsa.py:270-285): [runs, d, d] float32. The matrix and each permutation
    draw from their own child of ``np.random.SeedSequence(seed)``, so the
    result differs from the JAX package's init_runs for the same seed."""
    kq, *kperms = np.random.SeedSequence(seed).spawn(runs + 1)
    U = random_orthogonal(kq, d)
    return np.stack([U[:, np.random.default_rng(k).permutation(d)] for k in kperms])


def _flat(a, d: int, device) -> torch.Tensor:
    return _tensor(a, device).reshape(-1, d)


def fit_batched(datasets, num_concepts: int = 4, steps: int = 2000, runs: int = 3,
                seed: int = 42, ortho_method: str = "ns", device=None) -> DRSAResult:
    """A list of same-d datasets [(act, ctx), ...] (any leading shape,
    flattened to [N_i, d]) padded to a common N and fitted together. Every
    pair starts from init_runs(seed), as the sequential ``fit`` does, so a
    pair's result is the one ``fit`` gives it alone."""
    device = resolve_device(device, "fit_batched")
    d = datasets[0][0].shape[-1]
    flat = [(_flat(a, d, device), _flat(c, d, device)) for a, c in datasets]
    n_max = max(a.shape[0] for a, _ in flat)
    A = torch.zeros((len(flat), n_max, d), device=device)
    C = torch.zeros_like(A)
    M = torch.zeros((len(flat), n_max), device=device)
    for i, (a, c) in enumerate(flat):
        A[i, :a.shape[0]], C[i, :a.shape[0]], M[i, :a.shape[0]] = a, c, 1.0
    U0 = torch.as_tensor(init_runs(seed, d, runs), device=device).expand(len(flat), -1, -1, -1)
    return drsa_fit_batched(U0, A, C, M, num_concepts, steps, ortho_method, device)


def fit(act_vecs, ctx_vecs, num_concepts: int = 4, steps: int = 2000, runs: int = 3,
        seed: int = 42, ortho_method: str = "ns", device=None) -> DRSAResult:
    """drsa.main (reference drsa.py:241-301): ``runs`` restarts from
    init_runs(seed) on the vectors flattened to [N, d]; all runs and the
    best one."""
    device = resolve_device(device, "fit")
    d = act_vecs.shape[-1]
    return drsa_fit(init_runs(seed, d, runs), _flat(act_vecs, d, device),
                    _flat(ctx_vecs, d, device), num_concepts, steps, ortho_method, device)
