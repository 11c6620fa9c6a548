"""The comparison that decides ``correct``: the outputs of the timed
window's requests against the plain reference on the same inputs. Which of
the numbers are compared, and their limits, is each cell's limits file.

Per clip, a map's error is the L2 norm of the difference over the
reference's L2 norm. The per-clip errors are pooled over every clip
compared in the run: a heatmap number is their median (the bulk of the
clips) or their 98th percentile (robust to the rare max-pool near-tie,
broken by a fiftieth of the clips gone wrong); the concept split's, their
median. Subspace maps and relevances are compared in the reference's
concept order: the program returns them sorted, with the order it used,
and the comparison undoes that order. The other numbers are a worst case
over the clips and requests compared."""

from __future__ import annotations

import numpy as np
import torch


def _per_clip_rel(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    got = got.reshape(got.shape[0], -1).astype(np.float64)
    want = want.reshape(want.shape[0], -1).astype(np.float64)
    return np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-30)


def numbers(out: dict, ref_heat: np.ndarray, ref_logits: np.ndarray,
            mel: np.ndarray | None = None, ref_mel: np.ndarray | None = None
            ) -> tuple[dict, dict]:
    """(one request's numbers, its per-clip errors). ``out`` is the
    program's result dict; ``ref_heat`` [b, K + 1, H, W] (index 0 the
    standard map) and ``ref_logits`` the reference's; ``mel`` the log-mel
    the program's front-end produced, where it was captured."""
    b = ref_heat.shape[0]
    std = np.asarray(out["standard_heatmaps"])[:, 0]
    sub_sorted = np.asarray(out["subspace_heatmaps"])
    order = np.asarray(out["mask"])
    rel = np.asarray(out["subspace_relevances"], np.float64)
    if not (sub_sorted.shape[0] == std.shape[0] == rel.shape[0] == order.shape[0]
            == np.asarray(out["logits"]).shape[0] == b):
        return {"clips_returned": float(min(sub_sorted.shape[0], std.shape[0]))}, {}
    rows = np.arange(b)[:, None]
    ref_std = ref_heat[:, 0].astype(np.float64)
    ref_abs = np.maximum(np.abs(ref_std).sum(axis=(-2, -1)), 1e-30)
    ref_rel = ref_heat[:, 1:].astype(np.float64).sum(axis=(-2, -1))
    # the sort's own definition, exactly: a permutation, and relevances that
    # do not rise along it
    K = order.shape[1]
    perm_ok = (np.sort(order, axis=1) == np.arange(K)[None, :]).all(axis=1)
    unsorted = (~perm_ok) | (np.diff(rel, axis=1) > 0).any(axis=1)
    order = np.where(perm_ok[:, None], order, np.arange(K)[None, :])
    sub = np.empty_like(sub_sorted)
    sub[rows, order] = sub_sorted
    rel_unsorted = np.empty_like(rel)
    rel_unsorted[rows, order] = rel
    # each returned relevance is its returned map's sum (float32 round-off)
    map_sums = sub_sorted.astype(np.float64).sum(axis=(-2, -1))
    relmap = np.abs(rel - map_sums).max(axis=1) / ref_abs
    scale = np.maximum(np.abs(ref_rel).sum(axis=1), 1e-30)
    along = ref_rel[rows, order]
    logits = np.asarray(out["logits"], np.float64)
    nums = {
        "logits": float(np.abs(logits - ref_logits).max() / max(np.abs(ref_logits).max(), 1e-30)),
        "relmap_max": float(relmap.max()),
        "unsorted": float(unsorted.sum()),
        "order_gap": float((np.maximum(np.diff(along, axis=1).max(axis=1), 0.0) / scale).max()),
    }
    if mel is not None:
        d = mel.astype(np.float64) - ref_mel
        nums["logmel_rms"] = float(np.sqrt((d.reshape(d.shape[0], -1) ** 2).mean(axis=1)).max())
        nums["logmel_max"] = float(np.abs(d).max())
    clips = {
        "std": _per_clip_rel(std, ref_std),
        # the returned maps summed over the concepts, against the
        # reference's own standard pass
        "subsum": _per_clip_rel(sub_sorted.astype(np.float64).sum(axis=1), ref_std),
        "sub": _per_clip_rel(sub, ref_heat[:, 1:]),
        "rel": np.abs(rel_unsorted - ref_rel).max(axis=1) / scale,
        # a clip's relevances summed, against the reference's total
        "relsum": np.abs(rel.sum(axis=1) - ref_std.sum(axis=(-2, -1))) / ref_abs,
    }
    return nums, clips


def pooled(readings: list[tuple[dict, dict]]) -> dict:
    """The run's numbers from ``numbers``' readings of the requests
    compared: each request number's worst, and over all the clips compared
    the heatmaps' median and 98th percentile (``std_p50``, ``std_p98``,
    ``subsum_p50``, ``subsum_p98``), the relevances' total's 98th
    percentile (``relsum_p98``), the concept split's median (``sub_p50``,
    ``rel_p50``) and, printed only, the largest."""
    out: dict = {}
    for nums, _ in readings:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v)
    per_clip = [c for _, c in readings if c]
    if len(per_clip) == len(readings) and per_clip:
        clips = {k: np.concatenate([c[k] for c in per_clip]) for k in per_clip[0]}
        for k in ("std", "subsum"):
            out[f"{k}_p50"], out[f"{k}_p98"] = np.percentile(clips[k], [50, 98])
        out.update(relsum_p98=np.percentile(clips["relsum"], 98),
                   sub_p50=np.median(clips["sub"]), rel_p50=np.median(clips["rel"]),
                   **{f"{k}_max": clips[k].max() for k in ("std", "sub", "rel", "relsum")})
    return {k: float(v) if np.isfinite(v) else float("inf") for k, v in out.items()}


CAPTURED = ("logmel_rms",)   # read from the front-end's capture (pb.spans)


def judge(nums: dict, limits: dict, captured: bool = True) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {"value", "limit"}}).
    A limited number the comparison could not produce fails, except one
    that only the front-end's capture gives when the program no longer has
    the function it wraps (``captured`` False): that one reads null."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = nums.get(name)
        table[name] = {"value": value, "limit": limit}
        if value is None and not captured and name in CAPTURED:
            continue
        if value is None or not value <= limit:
            ok = False
    return ok, table


def reference_outputs(model, cfg: dict, wavs: torch.Tensor, U: torch.Tensor, class_idx: int,
                      block: int):
    """(log-mel [b, mels, width], heatmaps [b, K + 1, H, W], logits), numpy,
    from the reference, ``block`` clips at a time."""
    from reference import frontend
    mels, heats, logits = [], [], []
    with torch.no_grad():
        for i in range(0, wavs.shape[0], block):
            mel = frontend.features(wavs[i:i + block], cfg)
            h, lg = model.explain(mel[:, None], U, class_idx)
            mels.append(mel.cpu().numpy())
            heats.append(h.cpu().numpy())
            logits.append(lg.cpu().numpy())
    return np.concatenate(mels), np.concatenate(heats), np.concatenate(logits).astype(np.float64)


def as_output(heat: np.ndarray, logits: np.ndarray) -> dict:
    """A result dict shaped as the service returns one, from heatmaps
    [b, K + 1, H, W] and logits: the control, put in the program's place."""
    sub = heat[:, 1:]
    rel = sub.sum(axis=(-2, -1))
    order = np.argsort(rel, axis=-1)[:, ::-1]
    rows = np.arange(sub.shape[0])[:, None]
    return {"standard_heatmaps": heat[:, 0:1], "subspace_heatmaps": sub[rows, order],
            "subspace_relevances": rel[rows, order], "mask": order, "logits": logits}
