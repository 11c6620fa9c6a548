"""DRSA training-data extraction (the port of
drsa_audio_tpu.xai.drsa.preprocessing).

The activation and relevance maps at the DRSA layer come from the LRP
interpreter's ``capture`` (engine.lrp, the walk stopping at the captured
layer); vectors are then read at sampled positions (training) or at every
position (inference), and the context vector is c = R / (a + 1e-7).

Sampling draws from a ``torch.Generator`` (or an integer seed), one
``randperm`` per clip, so the locations differ from the JAX package's for
the same integer: to compare the two, pass the JAX indices to
``gather_vectors``. With ``clip_seeds`` (``draw_clip_seeds``, the JAX
package's ``clip_keys``) each clip draws from a generator of its own, so
its positions do not depend on the clips beside it: the sharded extraction
(parallel.sharding) draws the seeds for the whole batch and gives each
rank its rows' seeds.
"""

from __future__ import annotations

from typing import Sequence

import torch

from drsa_audio_tpu_torch.models.vgg import LayerSpec
from drsa_audio_tpu_torch.utils.device import params_on, resolve_device
from drsa_audio_tpu_torch.xai.lrp.engine import Composite, lrp, output_mask_class


def extract_act_rel_maps(specs: Sequence[LayerSpec], params: dict, input_batch: torch.Tensor,
                         composite: Composite, layer_idx: int, class_idx: int,
                         one_hot_encoded: bool = False):
    """(activation maps, relevance maps) at ``features.{layer_idx}``'s
    output, each [b, d, h, w] (reference get_intermediate,
    preprocessing.py:106-176). Runs on the device of the inputs."""
    name = f"features.{layer_idx}"
    _, _, captured = lrp(specs, params, input_batch, composite,
                         output_mask_class(class_idx, one_hot_encoded),
                         capture=(name,), stop_after_capture=True)
    return captured[name]


def make_extract_fn(specs, params, composite: Composite, layer_idx: int,
                    one_hot_encoded: bool = False, device=None):
    """``fn(x, class_idx) -> (act_maps, rel_maps)`` for one layer and every
    class; pass it to ``preprocess_data(extract_fn=...)``. The params are
    moved to ``device`` (CUDA by default; raises where there is none) once,
    here. It carries the identities of the layer, class encoding,
    composite, specs, params and device it was built for, and
    ``preprocess_data`` refuses it when they are not the ones it is called
    with."""
    device = resolve_device(device, "make_extract_fn")
    placed = params_on(params, device)

    def fn(x: torch.Tensor, class_idx: int):
        return extract_act_rel_maps(specs, placed, x, composite, layer_idx, int(class_idx),
                                    one_hot_encoded)

    fn.layer_idx = layer_idx
    fn.one_hot_encoded = one_hot_encoded
    fn.composite_id = id(composite)
    fn.specs_id = id(specs)
    fn.params_id = id(params)
    fn.device = device
    return fn


def compute_context_vectors(activation_vectors: torch.Tensor, relevance_vectors: torch.Tensor,
                            eps: float = 1e-7) -> torch.Tensor:
    """c = R / (a + eps) (reference preprocessing.py:179-193)."""
    return relevance_vectors / (activation_vectors + eps)


def _generator(seed_or_generator) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def draw_clip_seeds(generator, batch_size: int) -> torch.Tensor:
    """One seed per clip, int64 [batch_size], drawn from ``generator`` (a
    torch.Generator or an integer seed), for ``clip_seeds``."""
    g = _generator(generator)
    return torch.randint(0, 2 ** 62, (batch_size,), generator=g, device=g.device,
                         dtype=torch.int64).cpu()


def sample_spatial_locations(generator, batch_size: int, map_hw, num_locations: int,
                             clip_seeds=None) -> torch.Tensor:
    """Per-clip random positions without replacement (reference
    preprocessing.py:196-216): the first ``num_locations`` of a
    ``randperm`` of the flattened map per clip, drawn on the host from
    ``generator`` (a torch.Generator or an integer seed), one clip after
    the other. With ``clip_seeds`` (int64 [batch_size]) clip i draws from
    a generator seeded with ``clip_seeds[i]`` alone and ``generator`` is
    not used. Returns int64 [batch_size, num_locations]."""
    total = int(map_hw[0]) * int(map_hw[1])
    if clip_seeds is not None:
        seeds = torch.as_tensor(clip_seeds, dtype=torch.int64).tolist()
        if len(seeds) != batch_size:
            raise ValueError(f"{len(seeds)} clip seeds for {batch_size} clips")
        gens = [torch.Generator().manual_seed(s) for s in seeds]
    else:
        gens = [_generator(generator)] * batch_size
    return torch.stack([torch.randperm(total, generator=g)[:num_locations] for g in gens])


def gather_vectors(maps: torch.Tensor, idcs) -> torch.Tensor:
    """Channel vectors at per-clip positions: maps [b, d, h, w], idcs
    [b, L] into the flattened map -> [b*L, d] (reference
    get_vectors_from_maps, preprocessing.py:234-256)."""
    b, d = maps.shape[:2]
    idcs = torch.as_tensor(idcs, dtype=torch.int64, device=maps.device)
    vecs = torch.gather(maps.reshape(b, d, -1), 2, idcs[:, None, :].expand(b, d, -1))
    return vecs.transpose(-2, -1).reshape(-1, d)


def all_vectors(maps: torch.Tensor) -> torch.Tensor:
    """[b, d, h, w] -> [b, h*w, d] (inference mode, preprocessing.py:80-84)."""
    b, d = maps.shape[:2]
    return maps.reshape(b, d, -1).transpose(-2, -1)


def normalize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    """v / rms(all entries) / d^0.25, the DRSA paper's stabilisation
    (reference preprocessing.py:219-231)."""
    vectors = torch.as_tensor(vectors)
    d = vectors.shape[-1]
    return vectors / torch.sqrt(torch.mean(torch.square(vectors))) / d ** 0.25


def preprocess_data(specs, params, input_batch, composite: Composite, layer_idx: int,
                    class_idx: int, num_locations: int | None = None,
                    one_hot_encoded: bool = False, generator=None,
                    attr_batch_size: int | None = 64, extract_fn=None, device=None,
                    clip_seeds=None):
    """(activation vectors, context vectors) for DRSA (reference
    preprocess_data, preprocessing.py:18-89).

    With ``num_locations`` (training mode) that many positions are sampled
    per clip from ``generator`` (a torch.Generator or an integer seed;
    default seed 0), or from ``clip_seeds`` (int64 [b], one generator per
    clip; ``generator`` is then not used) -> [b*L, d] each; without
    (inference mode) every position -> [b, h*w, d]. ``attr_batch_size``
    runs the LRP pass that many clips at a time, as the reference does at
    64; the positions are drawn after, for the whole batch, so chunking
    does not move them.
    ``extract_fn`` (make_extract_fn) must have been built for this call's
    layer, class encoding, composite, specs, params and device.

    ``device`` defaults to CUDA and raises where there is none. The vectors
    are returned there, outside inference mode, ready for the optimiser."""
    device = resolve_device(device, "preprocess_data")
    if extract_fn is not None:
        want = (layer_idx, one_hot_encoded, id(composite), id(specs), id(params), device)
        got = (getattr(extract_fn, "layer_idx", layer_idx),
               getattr(extract_fn, "one_hot_encoded", one_hot_encoded),
               getattr(extract_fn, "composite_id", id(composite)),
               getattr(extract_fn, "specs_id", id(specs)),
               getattr(extract_fn, "params_id", id(params)),
               getattr(extract_fn, "device", device))
        if got != want:
            raise ValueError(
                "extract_fn was built for a different (layer, one_hot, composite, specs, "
                f"params, device) than preprocess_data was called with: {got} != {want}")
    else:
        extract_fn = make_extract_fn(specs, params, composite, layer_idx, one_hot_encoded,
                                     device)
    x = torch.as_tensor(input_batch, dtype=torch.float32, device=device)
    b = x.shape[0]
    with torch.no_grad():
        if attr_batch_size and b > attr_batch_size:
            parts = [extract_fn(x[i:i + attr_batch_size], class_idx)
                     for i in range(0, b, attr_batch_size)]
            act_maps = torch.cat([p[0] for p in parts])
            rel_maps = torch.cat([p[1] for p in parts])
        else:
            act_maps, rel_maps = extract_fn(x, class_idx)
        if num_locations:
            idcs = sample_spatial_locations(0 if generator is None else generator, b,
                                            act_maps.shape[-2:], num_locations, clip_seeds)
            act_vecs = gather_vectors(act_maps, idcs)
            rel_vecs = gather_vectors(rel_maps, idcs)
        else:
            act_vecs, rel_vecs = all_vectors(act_maps), all_vectors(rel_maps)
        return act_vecs, compute_context_vectors(act_vecs, rel_vecs)
