"""Plotting: heatmaps, spectrograms, waveforms, AUPC curves, train stats,
DRSA subplots (the port of drsa_audio_tpu.utils.visualization; reference
cxai/utils/visualization.py).

The blue-white-red heatmap colormap is built directly and the HTK mel axis
labels use the port's ops.mel conversion, so neither zennit nor librosa is
needed. Matplotlib is imported lazily, with the Agg backend, so
compute-only hosts never need it. Every array argument may also be a
tensor, on any device: it is copied to the host first.
"""

from __future__ import annotations

import numpy as np
import torch

from drsa_audio_tpu_torch.ops.mel import hz_to_mel
from drsa_audio_tpu_torch.utils.constants import AUDIO_PARAMS


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def bwr_heatmap_colors(heatmap) -> np.ndarray:
    """Map relevance to the blue-white-red scheme used by zennit's imgify
    'bwr' (visualization.py:11-35): negative -> blue, 0 -> white, positive ->
    red. Returns an RGB array."""
    h = np.asarray(_np(heatmap), np.float64).squeeze()
    amax = np.abs(h).max() + 1e-12
    x = h / amax  # [-1, 1]
    rgb = np.ones(h.shape + (3,))
    pos = np.clip(x, 0, 1)
    neg = np.clip(-x, 0, 1)
    rgb[..., 0] -= neg          # red channel reduced by negativity
    rgb[..., 1] -= pos + neg    # green reduced by both
    rgb[..., 2] -= pos          # blue reduced by positivity
    return np.clip(rgb, 0, 1)


def vis_heatmap(heatmap, ax=None, flip: bool = True, title=None):
    """Render one relevance heatmap (mel orientation: low freqs at bottom,
    so rows are flipped — visualization.py:11-35)."""
    plt = _plt()
    img = bwr_heatmap_colors(heatmap)
    if flip:
        img = img[::-1]
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(img)
    ax.set_xticks([])
    ax.set_yticks([])
    if title:
        ax.set_title(title)
    return ax


def _mel_axis_ticks(n_mels: int, sample_rate: int):
    freqs = [512, 1024, 2048, 4096]
    m_max = hz_to_mel(sample_rate / 2)
    ticks = [hz_to_mel(f) / m_max * n_mels for f in freqs]
    return ticks, [f"{f} Hz" for f in freqs]


def plot_spectrogram(mel, case: str = "gtzan", ax=None, colorbar: bool = True,
                     title=None, remove: bool = False):
    """Log-mel display with HTK mel y-axis (visualization.py:40-93)."""
    plt = _plt()
    mel = _np(mel).squeeze()
    p = AUDIO_PARAMS[case]
    if ax is None:
        _, ax = plt.subplots()
    img = ax.imshow(mel, origin="lower", aspect="auto", cmap="viridis")
    ticks, labels = _mel_axis_ticks(p["n_mels"], p["sample_rate"])
    ax.set_yticks(ticks)
    ax.set_yticklabels(labels)
    dur = mel.shape[-1] * p["hop_length"] / p["sample_rate"]
    ax.set_xticks([0, mel.shape[-1] / 2, mel.shape[-1] - 1])
    ax.set_xticklabels(["0", f"{dur / 2:.1f}", f"{dur:.1f}"])
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("Mel bins")
    if title:
        ax.set_title(title)
    if colorbar:
        ax.figure.colorbar(img, ax=ax, format="%+2.0f " + r"$\log_{10}(A)$")
    if remove:
        ax.set_xticks([])
        ax.set_yticks([])
        ax.axis("off")
    return ax


def plot_waveform(wav, sample_rate: int = 16000, ax=None, title=None):
    """Waveform plot (visualization.py:96-120)."""
    plt = _plt()
    wav = _np(wav).squeeze()
    t = np.arange(len(wav)) / sample_rate
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(t, wav, linewidth=0.5)
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("Amplitude")
    if title:
        ax.set_title(title)
    return ax


def plot_aupcs(aupc_scores: dict, mean_logits: dict, flips_per_step):
    """AUPC curves per configuration (visualization.py:123-143,
    pf.py:312-334)."""
    plt = _plt()
    flips = np.asarray(_np(flips_per_step), np.float64)
    x = np.cumsum(flips) / flips.sum() * 100
    fig, ax = plt.subplots()
    for key, curve in mean_logits.items():
        ax.plot(x, _np(curve), marker="o",
                label=f"{key} AUPC: {_np(aupc_scores[key]).mean():.3f}")
    ax.set_xlabel("Flipped patches [%]")
    ax.set_ylabel("Averaged target class logit")
    ax.grid(ls=":", alpha=0.5)
    ax.legend()
    return fig


def plot_train_stats(stats, ax=None):
    """Accuracy/loss curves (visualization.py:147-174). stats: dict with
    train_loss/train_acc/valid_losses/valid_acc lists."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(1, 2, figsize=(10, 4))
    ax[0].plot(stats["train_loss"], label="train")
    ax[0].plot(stats["valid_losses"], label="valid")
    ax[0].set_title("Loss")
    ax[0].legend()
    ax[1].plot(stats["train_acc"], label="train")
    ax[1].plot(stats["valid_acc"], label="valid")
    ax[1].set_title("Accuracy")
    ax[1].legend()
    return ax


def plot_drsa_objective(objectives, ax=None):
    """Per-run DRSA objective trajectories (visualization.py:178-218)."""
    plt = _plt()
    objectives = _np(objectives)
    if objectives.ndim == 1:
        objectives = objectives[None]
    if ax is None:
        _, ax = plt.subplots()
    for i, run in enumerate(objectives):
        ax.plot(run, label=f"run {i + 1}")
    ax.set_xlabel("Step")
    ax.set_ylabel("DRSA objective")
    ax.legend()
    return ax


def make_drsa_subplot(mel, standard_heatmap, subspace_heatmaps, case="gtzan",
                      suptitle=None):
    """Composite 'mel + standard + K subspace heatmaps' figure
    (visualization.py:227-359; handles K = 2/4/8)."""
    plt = _plt()
    K = len(subspace_heatmaps)
    fig, axes = plt.subplots(1, K + 2, figsize=(3 * (K + 2), 3))
    plot_spectrogram(mel, case=case, ax=axes[0], colorbar=False,
                     title="Mel-Spectrogram")
    vis_heatmap(standard_heatmap, ax=axes[1], title="Standard")
    for k in range(K):
        vis_heatmap(subspace_heatmaps[k], ax=axes[2 + k], title=f"Concept {k + 1}")
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    return fig
