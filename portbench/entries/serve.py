"""``ExplainerService.explain(wavs, class)`` in a closed loop with one
client: request i sends input item i mod pool, for a class drawn per
request from the seed. Input items are seeded noise (x noise_scale,
clipped to [-1, 1]) made on the device in set-up and held on the host, as a
caller holds them; an item is ``batch`` clips of the configuration's
length (a track cut into its windows is the same layout)."""

from __future__ import annotations

import time

import numpy as np


def setup(ctx) -> None:
    import torch
    from reference.frontend import settings
    cfg, tr = ctx.cfg, ctx.traffic
    samples = settings(cfg)["clip_samples"]
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    wavs = torch.randn(tr["pool"], tr["batch"], samples, generator=g, device=ctx.device)
    ctx.pool = (wavs * tr["noise_scale"]).clamp_(-1.0, 1.0).cpu().numpy()
    del wavs
    rng = np.random.default_rng(ctx.seed)
    ctx.classes = rng.integers(0, cfg["n_classes"], size=tr["max_requests"])
    out = None
    for i in range(tr["warm_requests"]):
        out = ctx.svc.explain(ctx.pool[i % tr["pool"]], cfg["classes"][int(ctx.classes[-1 - i])])
    # The window copies each result it keeps into one of these, made here.
    # Held where the seed draws them, the program's own arrays moved the
    # host heap's layout, and with it the speed of every later request, by
    # the seed; copied, the window allocates and holds the same for all.
    ctx.slots = [{k: v.copy() for k, v in out.items()}
                 for _ in range(tr["check_requests"] + 1)]


def _copied(out: dict, slot: dict) -> dict:
    for k, v in out.items():
        np.copyto(slot[k], v)
    return slot


def _request(ctx, i):
    return i % ctx.traffic["pool"], ctx.cfg["classes"][int(ctx.classes[i])]


def window(ctx, seconds: float, keep) -> dict:
    """Requests until ``seconds`` have passed; returns the records, the
    outputs kept (``keep(i)`` true, and always the last), the failures."""
    records, kept, failed, last = [], {}, 0, None
    t0 = time.perf_counter()
    i = 0
    while True:
        item, cls = _request(ctx, i)
        with ctx.request_span():
            t = time.perf_counter()
            try:
                out = ctx.svc.explain(ctx.pool[item], cls)
            except Exception as e:          # a failed request counts, the window goes on
                out, failed = None, failed + 1
                ctx.errors.append(repr(e))
            t1 = time.perf_counter()
        if out is not None:
            records.append((t, t1, ctx.pool.shape[1]))
            desc = {"item": item, "class": cls, "call": i}
            if keep(i):
                kept[i] = (_copied(out, ctx.slots[len(kept)]), desc)
            last = (i, out, desc)
        i += 1
        if t1 - t0 >= seconds or i >= len(ctx.classes):
            break
    if last is not None:
        kept[last[0]] = last[1:]
    return {"t0": t0, "t1": t1, "records": records, "attempted": i, "failed": failed,
            "kept": kept}


def slice(ctx, i: int) -> tuple[dict, dict]:
    """Request ``i`` alone: (its result, what ``reference_inputs`` takes)."""
    item, cls = _request(ctx, i)
    return ctx.svc.explain(ctx.pool[item], cls), {"item": item, "class": cls, "call": i}


def reference_inputs(ctx, desc) -> tuple[np.ndarray, str]:
    return ctx.pool[desc["item"]], desc["class"]
