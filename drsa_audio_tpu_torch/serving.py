"""Explain service (the port of drsa_audio_tpu.serving).

``ExplainerService.explain(wavs, class_name)`` runs waveform -> log-mel ->
VGG forward -> upper LRP backward -> K concept clones through the lower
chain -> standard and subspace heatmaps, on the GPU unless the caller asks
for ``device="cpu"``. The projection U and the class are per-request inputs.
``explain_files`` streams WAV files from disk: the native decoder
(runtime.loader) on a thread pool, resampling and padding on the host, and
whole batches prepared ahead on a background thread (``_prefetched``), while
the device explains the previous batch. Only the caller's thread touches the
device.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from drsa_audio_tpu_torch.models.projection import insert_projection
from drsa_audio_tpu_torch.models.vgg import LayerSpec
from drsa_audio_tpu_torch.ops.frontend import FrontendConfig, logmel, peak_normalize
from drsa_audio_tpu_torch.parallel.sharding import mesh_device, sharded
from drsa_audio_tpu_torch.runtime.loader import load_audio
from drsa_audio_tpu_torch.utils.constants import CLASS_IDX_MAPPER, CLASS_IDX_MAPPER_TOY
from drsa_audio_tpu_torch.utils import profiling
from drsa_audio_tpu_torch.utils.device import params_on, resolve_device
from drsa_audio_tpu_torch.xai.explain import class_composite, sort_concepts, subspace_heatmaps


@dataclasses.dataclass
class ExplainRequest:
    """One batch of fixed-length waveforms to explain for one class."""
    wavs: np.ndarray          # [b, samples]
    class_idx: int


def _prefetched(gen: Iterable, depth: int = 2) -> Iterator:
    """Run a generator on a background thread with ``depth`` items of
    lookahead (a bounded queue), so that the host work inside it (decode,
    resample, stacking) overlaps what the consumer does with each item.
    An exception in the generator re-raises at the consumer. If the
    consumer abandons the iterator (break, close, garbage collection), the
    worker sees the stop event, closes the source generator (releasing its
    decode pool) and exits."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    errs: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not _put(item):
                    break
        except BaseException as e:     # re-raised at the consumer below
            errs.append(e)
        finally:
            if hasattr(gen, "close"):
                gen.close()            # unwind the source's with-blocks
            _put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            with profiling.span("feed.wait"):
                item = q.get()
            if item is sentinel:
                if errs:
                    raise errs[0]
                return
            yield item
    finally:
        stop.set()


def _prepare(path: str, window: int, target_sr: int, on_short: str) -> np.ndarray | None:
    """One file as ``explain_files`` feeds it: decoded (first channel),
    polyphase-resampled to ``target_sr``, cut to ``window`` samples, and,
    where shorter, zero-padded (``on_short='pad'``), dropped (``'skip'``:
    None) or refused (``'error'``: ValueError)."""
    wav, sr = load_audio(path)
    w = wav[0]
    if sr != target_sr:
        from scipy.signal import resample_poly
        g = math.gcd(int(sr), target_sr)
        w = resample_poly(w, target_sr // g, int(sr) // g).astype(np.float32)
    if len(w) < window:
        if on_short == "skip":
            return None
        if on_short == "error":
            raise ValueError(f"{path}: {len(w)} samples (@{target_sr} Hz) is shorter "
                             f"than the {window}-sample analysis window")
        w = np.pad(w, (0, window - len(w)))
    return w[:window]


class ExplainerService:
    """explain(wavs, class_name) -> dict of standard/subspace heatmaps and
    relevances (mirroring HeatmapGenerator.info) and the logits.

    ``device`` defaults to CUDA and raises where there is none. On a CUDA
    device the service turns TF32 off for cuDNN convolutions and matmuls:
    LRP runs in full float32.

    With a ``mesh`` (parallel.sharding ``get_mesh``) the service is one
    rank of a data-parallel group and runs on the rank's device: every rank
    calls ``explain`` with the same request, explains and sorts its block of
    the clips, and gathers the sorted heatmaps, their relevances and order
    and the logits of the whole batch, in row order, before the readback, so
    that every rank returns the same dict."""

    def __init__(self, specs: Sequence[LayerSpec], params: dict, name_map,
                 Us: dict, num_concepts: int, layer_idx: int,
                 case: str = "gtzan", class_idx_mapper: dict | None = None,
                 device=None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(device, "ExplainerService")
        if mesh is not None and self.device != mesh_device(mesh):
            raise ValueError(f"ExplainerService: device {self.device} is not the mesh's "
                             f"{mesh_device(mesh)}")
        self.config = FrontendConfig.for_case(case)
        self.specs = list(specs)
        self.params = params_on(params, self.device)
        self.num_concepts = num_concepts
        self.layer_idx = layer_idx
        self.mapper = class_idx_mapper or (
            CLASS_IDX_MAPPER_TOY if case == "toy" else CLASS_IDX_MAPPER)
        self.n_classes = len(self.mapper)
        self.Us = {cls: torch.as_tensor(np.array(U, np.float32), device=self.device)
                   for cls, U in Us.items()}
        self.composite = class_composite(name_map, num_concepts)

    def _dispatch(self, wavs, class_name: str, fused: bool | None = None):
        """Enqueue one request, the subspace sort included; returns on the
        device (with a mesh, the whole batch's, gathered from the ranks)
        heatmaps [b, K+1, h, w] (the standard map, then the concept maps by
        descending relevance), the logits, the relevances [b, K+1] of those
        maps and the order [b, K] of the concepts."""
        with profiling.span("service.dispatch"):
            onehot = torch.zeros(self.n_classes, device=self.device)
            onehot[self.mapper[class_name]] = 1.0
            cfg = self.config
            specs_proj = insert_projection(
                self.specs, self.layer_idx, self.Us[class_name],
                self.num_concepts, input_size=(cfg.n_mels, cfg.width))

            def run(x):
                with profiling.span("frontend", device=True):
                    mels = logmel(peak_normalize(x) if cfg.peak_normalize else x, cfg)[:, None]
                heat, logits = subspace_heatmaps(
                    specs_proj, self.params, mels, self.composite,
                    self.num_concepts, output_mask=lambda lg: lg * onehot[None, :],
                    fused=fused)
                with profiling.span("service.device_sort", device=True):
                    heat, rel, order = sort_concepts(heat)
                    profiling.count("sort.device_clips", heat.shape[0])
                return heat, logits, rel, order

            with torch.inference_mode():
                wavs = np.asarray(wavs, np.float32)
                if self.mesh is not None:
                    out = sharded(run, self.mesh)(wavs)
                else:
                    with profiling.span("service.upload"):
                        host = torch.as_tensor(wavs)
                        x = host.to(self.device)
                        profiling.count_copy("h2d_bytes", host, x)
                    out = run(x)
            profiling.mark_done()
            return out

    def explain(self, wavs: np.ndarray, class_name: str,
                fused: bool | None = None) -> dict:
        """``fused=False`` runs the lower segment through the plain tiled
        walk instead of the chain kernels (for comparison).

        On a CUDA device the returned arrays are views of page-locked host
        memory (``_finalize``): a caller that keeps many results holds that
        memory, and can copy the arrays (``np.array(x)``) to let it go."""
        with profiling.request(self.device):
            out = self._dispatch(wavs, class_name, fused)
            with profiling.span("service.finalize"):
                out = self._finalize(out)
        return out

    def explain_stream(self, requests: Iterable[ExplainRequest]) -> Iterator[dict]:
        """Enqueue request i+1 before reading back request i, so the host's
        work on one overlaps the device's on the other. A request's span in
        the request log opens when the stream asks ``requests`` for it."""
        it, end = iter(requests), object()
        pending = None
        while True:
            rec = profiling.open_request(self.device)
            with profiling.activate(rec):
                req = next(it, end)
                if req is end:
                    break
                cls = next(k for k, v in self.mapper.items() if v == req.class_idx)
                out = self._dispatch(req.wavs, cls)
            if pending is not None:
                yield self._finish(*pending)
            pending = rec, out
        if pending is not None:
            yield self._finish(*pending)

    def _finish(self, rec, out) -> dict:
        """``_finalize`` under the request ``rec``, which it closes."""
        with profiling.activate(rec):
            with profiling.span("service.finalize"):
                result = self._finalize(out)
        profiling.close_request(rec)
        del result["standard_relevance"]      # in explain()'s dict only
        return result

    def _finalize(self, out) -> dict:
        """The wait and the readback of ``_dispatch``'s outputs: ``explain``'s
        result dict, whose maps and relevances are views of the arrays read
        back, bit for bit.

        From a CUDA device each output is copied into a page-locked block
        of PyTorch's caching host allocator: every copy is enqueued on the
        device's current stream, then the host waits once, on an event after
        the last. A block goes back to the allocator's cache only when the
        last array viewing it is gone, so a later request reuses it without
        page faults and never writes under a result still held. A caller
        that keeps many results holds that page-locked memory, and can copy
        the arrays (``np.array(x)``) to let it go. On the CPU the arrays are
        views of the outputs' own storage."""
        profiling.wait_device()
        with profiling.span("service.readback"):
            dev = out[0].device
            if dev.type == "cuda":
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out]
                for h, t in zip(host, out):
                    h.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                done.synchronize()
            else:
                host = [t.cpu() for t in out]
            for h, d in zip(host, out):
                profiling.count_copy("d2h_bytes", h, d)
            heat, logits, rel, order = (t.numpy() for t in host)
        return {"standard_heatmaps": heat[:, :1], "subspace_heatmaps": heat[:, 1:],
                "subspace_relevances": rel[:, 1:], "mask": order, "logits": logits,
                "standard_relevance": rel[:, 0]}

    def explain_files(self, paths: Sequence[str], class_name: str, batch_size: int = 32,
                      window_s: float | None = None, on_short: str = "pad",
                      decode_threads: int = 4, prefetch_depth: int = 2) -> Iterator[dict]:
        """Decode -> resample -> slice -> explain, streaming one result dict
        per batch of ``batch_size`` files, in the order of ``paths``.

        Files decode on a ``decode_threads``-wide pool (the native decoder
        releases the GIL), with at most max(2 * batch_size, 2 *
        decode_threads) of them in flight, and ``prefetch_depth`` whole
        batches are prepared ahead on a background thread. Inputs are
        checked, not trusted: a file at another sample rate is resampled
        to the service's, and one shorter than the analysis window
        (``window_s``, default the case's clip, ``clip_samples``) is padded, skipped
        or refused by ``on_short``."""
        if on_short not in ("pad", "skip", "error"):
            raise ValueError(f"on_short must be pad|skip|error, got {on_short!r}")
        window = (int(window_s * self.config.sample_rate) if window_s
                  else self.config.clip_samples)
        args = (window, self.config.sample_rate, on_short)
        class_idx = self.mapper[class_name]

        def requests():
            inflight = max(2 * batch_size, 2 * decode_threads)
            with ThreadPoolExecutor(decode_threads) as ex:
                pending = collections.deque()
                it = iter(paths)
                for p in it:
                    pending.append(ex.submit(_prepare, p, *args))
                    if len(pending) >= inflight:
                        break
                batch = []
                while pending:
                    w = pending.popleft().result()   # in the order of paths
                    p_next = next(it, None)
                    if p_next is not None:
                        pending.append(ex.submit(_prepare, p_next, *args))
                    if w is None:
                        continue
                    batch.append(w)
                    if len(batch) == batch_size:
                        yield ExplainRequest(np.stack(batch), class_idx)
                        batch = []
                if batch:
                    yield ExplainRequest(np.stack(batch), class_idx)

        yield from self.explain_stream(_prefetched(requests(), prefetch_depth))
