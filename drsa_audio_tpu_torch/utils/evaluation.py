"""Model evaluation and the DRSA-run store (the port of
drsa_audio_tpu.utils.evaluation): test accuracy, the confusion matrix,
per-class accuracies and training statistics; and one directory per DRSA run
holding ``projection_matrix.npy`` and ``train_stats.csv`` (columns "",
"loss"). The layouts are the JAX package's, so a run or training CSV saved
by either package loads in the other."""

from __future__ import annotations

import csv
import os
from typing import Dict

import numpy as np
import torch

from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def get_acc(specs, params, test_batches, is_toy: bool = False):
    """Accuracy in percent over ``test_batches`` of (mels, labels), numpy or
    tensors; GTZAN items may come chunked [b, chunks, c, f, t], their labels
    then repeated per chunk. The forward runs on the params' device.
    Returns (accuracy, true labels, predictions) as numpy."""
    from drsa_audio_tpu_torch.models.vgg import forward
    device = next(iter(next(iter(params.values())).values())).device
    ytrue, ypred = [], []
    for xb, yb in test_batches:
        xb = torch.as_tensor(xb, device=device)
        yb = _numpy(yb)
        if not is_toy and xb.ndim == 5:
            chunks = xb.shape[1]
            xb = xb.reshape(-1, *xb.shape[2:])
            yb = np.repeat(yb, chunks)
        with torch.no_grad():
            pred = forward(specs, params, xb).argmax(-1)
        ytrue.extend(yb.tolist())
        ypred.extend(pred.cpu().tolist())
    ytrue, ypred = np.asarray(ytrue), np.asarray(ypred)
    return float((ytrue == ypred).mean() * 100), ytrue, ypred


def get_cm(ytrue, ypred, num_classes: int | None = None) -> np.ndarray:
    """Row-normalised confusion matrix, percent."""
    n = num_classes or (int(max(ytrue.max(), ypred.max())) + 1)
    cm = np.zeros((n, n), np.float64)
    for t, p in zip(ytrue, ypred):
        cm[t, p] += 1
    return cm / np.maximum(cm.sum(axis=1, keepdims=True), 1) * 100


def class_accs(cm: np.ndarray,
               class_mapper: Dict[str, int] = CLASS_IDX_MAPPER) -> Dict[str, float]:
    """Per-class accuracies from the confusion matrix."""
    accs = np.diag(cm) / np.maximum(cm.sum(axis=1), 1e-12) * 100
    return {name: round(float(accs[i]), 2)
            for i, name in enumerate(class_mapper) if i < len(accs)}


def get_train_stats(path: str):
    """The training-stat CSVs of ``path`` (one file, or every .csv of a
    directory in name order, as resumed runs leave them) concatenated:
    {column: list}."""
    if path.endswith(".csv"):
        files = [path]
    else:
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".csv"))
    cols = {"train_loss": [], "train_acc": [], "valid_losses": [], "valid_acc": []}
    for fname in files:
        with open(fname) as f:
            for row in csv.DictReader(f):
                for k in cols:
                    cols[k].append(float(row[k]))
    return cols


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
