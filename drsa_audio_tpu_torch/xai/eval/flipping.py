"""Pixel / patch flipping evaluation, AUPC (the port of
drsa_audio_tpu.xai.eval.flipping; reference cxai/xai/pixelflipping/core.py).

The quadratic flip schedule (step t flips t^2 patches) is fixed by the
number of patches, so every step's cumulative keep mask is computed up
front and the steps' forwards run batched (``forward_batch`` bounds them).
The masks and the scores stay on the device of the input; one [steps+1, b]
array is read back at the end. 'inpainting' fills each step's hole with the
native Telea routine (runtime.native) on the host.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from drsa_audio_tpu_torch.utils.device import resolve_device


def quadratic_schedule(num_patches: int) -> list[int]:
    """Flips per step: 1, 4, 9, ... then the remainder (core.py:106-112)."""
    flips = []
    flipped = 0
    step = 1
    while flipped < num_patches:
        n = min(step * step, num_patches - flipped)
        flips.append(n)
        flipped += n
        step += 1
    return flips


def rank_patches(R: torch.Tensor, perturbation_size: int) -> torch.Tensor:
    """Patches by summed ReLU relevance, descending; equal sums keep index
    order (a stable sort, as the JAX package's). R: [b, n_concepts, h, w]
    -> [b, n_concepts, P] (core.py:189-213)."""
    b, k, h, w = R.shape
    p = perturbation_size
    patches = torch.clamp(R, min=0.0).reshape(b, k, h // p, p, w // p, p).sum(dim=(3, 5))
    return torch.sort(-patches.reshape(b, k, -1), dim=-1, stable=True).indices


def _cumulative_masks(order: torch.Tensor, flips: Sequence[int]) -> torch.Tensor:
    """Keep masks (1 = keep) on the patch grid, [steps, b, P]: at step s
    every concept's top cum_flips[s] patches are flipped, the union over
    concepts (core.py:232-234). order: [b, k, P] patch indices by rank."""
    P = order.shape[-1]
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(P, device=order.device).expand_as(order))
    min_rank = ranks.min(dim=1).values                                   # [b, P]
    cum = torch.as_tensor(np.cumsum(flips), device=order.device)
    return 1.0 - (min_rank[None] < cum[:, None, None]).float()


def _upsample_patch_mask(mask: torch.Tensor, grid_hw, p: int) -> torch.Tensor:
    """[..., gh*gw] -> [..., gh*p, gw*p] pixel mask."""
    gh, gw = grid_hw
    lead = mask.shape[:-1]
    m = mask.reshape(*lead, gh, 1, gw, 1).expand(*lead, gh, p, gw, p)
    return m.reshape(*lead, gh * p, gw * p)


def calculate_aupc(perturbed_predictions: np.ndarray, flips_per_step: np.ndarray,
                   n_classes: int) -> np.ndarray:
    """Weighted sum of logit drops (core.py:291-312).

    perturbed_predictions: [steps+1, batch]. Returns [n_classes,
    batch//n_classes], or [1, batch] where the batch does not divide."""
    frac = (perturbed_predictions[:-1] - perturbed_predictions[1:]) / 2.0
    weights = np.cumsum(flips_per_step[1:]) / flips_per_step[1:].sum()
    aupc = (weights[:, None] * frac).sum(axis=0)
    if aupc.size % n_classes:
        return aupc.reshape(1, -1)
    return aupc.reshape(n_classes, -1)


class Flipper:
    """The reference Flipper (core.py:6-136).

    ``__call__(forward_func, input_batch, R, flipping_mode)`` returns
    (AUPC per instance [n_classes, per_class], mean perturbed score per
    step, flips per step); ``predictions`` returns the per-instance scores
    [steps+1, b] they are computed from. The input and R are moved to
    ``device`` (CUDA unless named; raises where there is none), and
    ``forward_func`` is called on tensors there.

    ``flipping_mode='random'`` flips in an order drawn per clip by
    torch.randperm from a torch.Generator seeded with ``seed``: a seeded
    draw of the port's own, not the JAX package's jax.random.permutation."""

    def __init__(self, perturbation_size: int = 16, perturbation_mode: str = "constant",
                 data_normalization: str = "normalized", forward_batch: int = 0,
                 seed: int = 0, device=None):
        self.perturbation_size = perturbation_size
        self.perturbation_mode = perturbation_mode
        self.data_normalization = data_normalization
        self.forward_batch = forward_batch
        self.seed = seed
        self.device = resolve_device(device, "Flipper")

    def _order(self, R, flipping_mode, b: int, c: int, num_patches: int) -> torch.Tensor:
        if flipping_mode == "random":
            g = torch.Generator().manual_seed(self.seed)
            order = torch.stack([torch.randperm(num_patches, generator=g) for _ in range(b)])
            return order[:, None].to(self.device)
        R = torch.as_tensor(R, dtype=torch.float32, device=self.device)
        if R.ndim == 4 and R.shape[1] == c:
            R = R[:, None, 0] if c == 1 else R[:, None].sum(2)
        elif R.ndim == 5:
            R = R[:, :, 0] if R.shape[2] == 1 else R.sum(2)
        return rank_patches(R, self.perturbation_size)

    def predictions(self, forward_func: Callable, input_batch, R,
                    flipping_mode: str | None = None, class_ids=None):
        """(scores [steps+1, b] as numpy, flips per step [steps+1] with a
        leading 0, number of classes): step 0 is the unperturbed input,
        a score is the ReLU of the clip's class logit."""
        x = torch.as_tensor(input_batch, dtype=torch.float32, device=self.device)
        b, c, h, w = x.shape
        p = self.perturbation_size
        gh, gw = h // p, w // p
        flips = quadratic_schedule(gh * gw)
        keep = _cumulative_masks(self._order(R, flipping_mode, b, c, gh * gw), flips)
        pixel_masks = _upsample_patch_mask(keep, (gh, gw), p)          # [steps, b, h, w]

        with torch.inference_mode():
            logits0 = forward_func(x)
            n_classes = logits0.shape[-1]
            if class_ids is None:
                # a balanced consecutive-class batch; b < n_classes and b
                # not a multiple of n_classes keep the last class
                spc = max(b // n_classes, 1)
                class_ids = np.minimum(np.arange(b) // spc, n_classes - 1)
            class_ids = torch.as_tensor(np.asarray(class_ids), device=self.device)
            if class_ids.shape != (b,):
                raise ValueError(f"class_ids of shape {tuple(class_ids.shape)} for {b} clips")

            if self.perturbation_mode == "constant":
                perturbed = pixel_masks[:, :, None] * x[None]
            elif self.perturbation_mode == "inpainting":
                perturbed = torch.as_tensor(
                    self._inpaint_all(x.cpu().numpy(), pixel_masks.cpu().numpy()),
                    device=self.device)
            else:
                raise ValueError(f"bad perturbation_mode {self.perturbation_mode}")

            steps = len(flips)
            flat = perturbed.reshape(steps * b, c, h, w)
            fb = self.forward_batch or steps * b
            flat_ids = class_ids.repeat(steps)
            score0 = torch.clamp(logits0[torch.arange(b, device=self.device), class_ids],
                                 min=0.0)
            parts = []
            for i in range(0, steps * b, fb):
                lg = forward_func(flat[i:i + fb])
                rows = torch.arange(lg.shape[0], device=self.device)
                parts.append(torch.clamp(lg[rows, flat_ids[i:i + fb]], min=0.0))
            preds = torch.cat([score0[None], torch.cat(parts).reshape(steps, b)])
        return preds.cpu().numpy(), np.array([0] + flips), n_classes

    def __call__(self, forward_func: Callable, input_batch, R,
                 flipping_mode: str | None = None, class_ids=None):
        preds, flips, n_classes = self.predictions(forward_func, input_batch, R,
                                                   flipping_mode, class_ids)
        return calculate_aupc(preds, flips, n_classes), preds.mean(axis=1), flips

    def _inpaint_all(self, x: np.ndarray, pixel_masks: np.ndarray) -> np.ndarray:
        """Each step inpaints the cumulative hole of the PREVIOUS step's
        image with the native Telea routine, then (``data_normalization``
        'normalized' or 'min') rescales the filled pixels to the image's
        range (reference core.py:155-185)."""
        from drsa_audio_tpu_torch.runtime import native
        steps, b = pixel_masks.shape[:2]
        c = x.shape[1]
        current = x.copy()
        out = np.empty((steps,) + x.shape, np.float32)
        for s in range(steps):
            hole = (pixel_masks[s] < 0.5).astype(np.uint8)
            imgs = current[:, 0]
            filled = native.telea_inpaint_batch(imgs, hole, radius=self.perturbation_size // 2)
            if self.data_normalization in ("normalized", "min"):
                lo = filled.min(axis=(-2, -1), keepdims=True)
                hi = filled.max(axis=(-2, -1), keepdims=True)
                norm = (filled - lo) / (hi - lo + 1e-9)
                if self.data_normalization == "min":
                    norm = 2 * norm - 1
                filled = np.where(hole > 0, norm, imgs)
            current = filled[:, None]
            out[s] = current
        return out.reshape(steps, b, c, *x.shape[-2:])
