"""The DRSA-run store (the port of the run functions of
drsa_audio_tpu.utils.evaluation, reference evaluation.py:108-141 and
cpf.py:184-189): one directory per run holding ``projection_matrix.npy``
and ``train_stats.csv`` (columns "", "loss"). The layout is the JAX
package's, so a run saved by either package loads in the other."""

from __future__ import annotations

import csv
import os

import numpy as np
import torch


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def get_run_stats(path: str):
    """(final objective, trajectory) from a DRSA train_stats.csv."""
    with open(path) as f:
        losses = [float(row["loss"]) for row in csv.DictReader(f)]
    return losses[-1], losses


def get_best_run(path: str):
    """The best of the runs run*/train_stats.csv under ``path`` by final
    objective: (run number, its final objective, its directory, its
    trajectory); (None, 0.0, None, None) where none is above 0."""
    best_loss, best_run, best_path, best_losses = 0.0, None, None, None
    for d in sorted(os.listdir(path)):
        if d.startswith("."):
            continue
        stats = os.path.join(path, d, "train_stats.csv")
        if not os.path.exists(stats):
            continue
        loss, losses = get_run_stats(stats)
        if loss > best_loss:
            best_loss, best_run = loss, int(d[-1])
            best_path, best_losses = os.path.join(path, d), losses
    return best_run, best_loss, best_path, best_losses


def save_drsa_run(path: str, U, objectives) -> None:
    """One DRSA run under ``path``: U as npy, the objective trajectory as
    csv (numpy arrays or tensors on any device)."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "projection_matrix.npy"), _numpy(U))
    with open(os.path.join(path, "train_stats.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "loss"])
        for i, v in enumerate(_numpy(objectives)):
            w.writerow([i, float(v)])


def load_projection_matrix(path: str) -> np.ndarray:
    """The best run's U under ``path``."""
    _, _, best_path, _ = get_best_run(path)
    return np.load(os.path.join(best_path, "projection_matrix.npy"))
