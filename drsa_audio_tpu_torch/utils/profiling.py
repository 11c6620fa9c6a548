"""Tracing and per-phase timing (the port of
drsa_audio_tpu.utils.profiling), and the explain service's request log.

``PhaseTimer`` accumulates wall-clock blocks with a summary table;
``trace`` wraps ``torch.profiler.profile`` so any pipeline can write a
TensorBoard-viewable trace, and ``annotate`` names a region inside it.

The request log (``Recorder``; the process's one is ``RECORDER``, reached
through the module's functions). The service opens a request for each batch
it explains (``request``, or ``open_request`` / ``activate`` /
``close_request`` where requests interleave, as in ``explain_stream``).
Inside the request that is active on the thread, the program's stages open
named spans (``span``): a start and an end on ``time.perf_counter``, the
enclosing span and the request's id. A span opened where no request is
active records nothing. Per request, ``count_copy`` adds the bytes moved
host to device (``h2d_bytes``) and device to host (``d2h_bytes``), tagged
``pinned`` or ``pageable`` by the host tensor, and ``count`` adds to any
other counter (``sort.device_clips``: the clips the service sorted on the
device; ``chain.wide_launches``: the kernel launches of the chain_block
calls with a conv over 128 channels, each such call the device span
``chain.wide``). On a CUDA device a span opened with ``device=True`` also records a
pair of timing events; they are resolved to ms when the request closes,
after ``wait_device`` has waited for its device work, so no event outlives
its request. While a ``torch.profiler`` is active
(``trace``), and only then, each span also enters ``record_function``
under its own name, so the device timeline carries the program's stages.

Closed requests are kept in a bounded ring (``REQUESTS_KEPT``), read by
``requests(t0, t1)`` and written as Chrome-trace JSON by ``dump(path)``.
Recording is on by default; ``set_enabled(False)`` makes every span and
counter a no-op.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler


class PhaseTimer:
    """Accumulates wall-clock per named phase."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'phase':24s} {'calls':>6s} {'total_s':>10s} {'mean_ms':>10s}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {n:6d} {total:10.3f} {total / n * 1e3:10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiler trace of the block, written to ``log_dir`` for TensorBoard
    (``tensorboard_trace_handler``): host activity always, the CUDA
    device's where there is one. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield


# --- the request log ---------------------------------------------------------

REQUESTS_KEPT = 8192
REQUEST = "service.request"
COUNTERS = ("h2d_bytes.pinned", "h2d_bytes.pageable", "d2h_bytes.pinned", "d2h_bytes.pageable")


def _profiler_on() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _range(name: str):
    """An entered ``record_function`` range; closed by ``__exit__``."""
    rf = _autograd_profiler.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """One named stretch of a request: host-clock seconds, the index of the
    enclosing span in the request's ``spans`` (None for the request's own),
    and, for a device span on CUDA, the device ms between its events."""

    __slots__ = ("name", "start", "end", "parent", "device_ms")

    def __init__(self, name: str, start: float, parent: int | None):
        self.name, self.start, self.end, self.parent = name, start, None, parent
        self.device_ms = None

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e3


class Request:
    """One request's spans (``spans[0]`` is ``service.request``) and
    counters, under the id its spans share."""

    __slots__ = ("id", "spans", "counters", "error", "_stack", "_stream", "_events",
                 "_done", "_waited", "_range")

    def __init__(self, rid: int, stream):
        self.id = rid
        self.spans = [Span(REQUEST, time.perf_counter(), None)]
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.error = None
        self._stack = [0]
        self._stream = stream          # the CUDA stream the device spans time, or None
        self._events = []              # (span, start event, end event), until resolved
        self._done = None              # untimed event at the end of the device work
        self._waited = False           # the host has waited for ``_done``
        self._range = None             # its record_function range, under a profiler

    @property
    def start(self) -> float:
        return self.spans[0].start

    @property
    def end(self) -> float | None:
        return self.spans[0].end

    def ms(self, name: str) -> float:
        """Host ms of every span named ``name``, summed."""
        return sum(s.ms for s in self.spans if s.name == name)

    def device_ms(self, name: str) -> float | None:
        """Device ms of every span named ``name``, summed; None if none was timed."""
        got = [s.device_ms for s in self.spans if s.name == name and s.device_ms is not None]
        return sum(got) if got else None

    def _resolve(self) -> None:
        """Device ms of every span whose end event has completed (all of
        them once the host has waited for the request's device work); every
        event dropped."""
        for span, ev0, ev1 in self._events:
            if ev1 is not None and (self._waited or ev1.query()):
                span.device_ms = ev0.elapsed_time(ev1)
        self._events.clear()
        self._done = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    """A span of ``req`` for a ``with`` block."""

    __slots__ = ("req", "name", "device", "i", "events", "range")

    def __init__(self, req: Request, name: str, device: bool):
        self.req, self.name, self.device = req, name, device

    def __enter__(self):
        req = self.req
        self.i = i = len(req.spans)
        span = Span(self.name, 0.0, req._stack[-1])
        req.spans.append(span)
        req._stack.append(i)
        self.range = self.events = None
        if _profiler_on():
            self.range = _range(self.name)
        if self.device and req._stream is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(req._stream)
            self.events = [span, ev, None]
            req._events.append(self.events)
        span.start = time.perf_counter()
        return span

    def __exit__(self, *exc):
        req = self.req
        req.spans[self.i].end = time.perf_counter()
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(req._stream)
            self.events[2] = ev
        if self.range is not None:
            self.range.__exit__(None, None, None)
        req._stack.pop()
        return False


class Recorder:
    """The request log: the request active on each thread, and a ring of
    the last ``capacity`` closed requests."""

    def __init__(self, capacity: int = REQUESTS_KEPT):
        self.enabled = True
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._local = threading.local()

    def _active(self) -> Request | None:
        return getattr(self._local, "request", None)

    def open_request(self, device=None) -> Request | None:
        """A new request on ``device`` (None when recording is off); not
        active until ``activate``d, kept once ``close_request``d."""
        if not self.enabled:
            return None
        dev = torch.device(device) if device is not None else None
        stream = torch.cuda.current_stream(dev) if dev is not None and dev.type == "cuda" else None
        req = Request(next(self._ids), stream)
        if _profiler_on():
            req._range = _range(REQUEST)
        return req

    def close_request(self, req: Request | None) -> None:
        if req is None:
            return
        req.spans[0].end = time.perf_counter()
        if req._range is not None:
            req._range.__exit__(None, None, None)
            req._range = None
        req._resolve()
        with self._lock:
            self._ring.append(req)

    @contextlib.contextmanager
    def activate(self, req: Request | None):
        """``req`` is the thread's active request for the block."""
        prev = self._active()
        self._local.request = req
        try:
            yield req
        finally:
            self._local.request = prev

    @contextlib.contextmanager
    def request(self, device=None):
        """One request, open and active for the block, closed (and kept)
        after it; an exception's type is kept as its ``error``."""
        req = self.open_request(device)
        try:
            with self.activate(req):
                yield req
        except BaseException as e:
            if req is not None:
                req.error = type(e).__name__
            raise
        finally:
            self.close_request(req)

    def span(self, name: str, device: bool = False):
        """A span of the active request for the ``with`` block (a no-op
        outside one). ``device``: on CUDA, also time the block's device work
        by a pair of events."""
        req = self._active()
        if req is None:
            return _NO_SPAN
        return _OpenSpan(req, name, device)

    def count_copy(self, name: str, host: torch.Tensor, other: torch.Tensor) -> None:
        """Add ``host``'s bytes to the active request's counter ``name``
        (``h2d_bytes`` or ``d2h_bytes``), tagged pinned or pageable by
        ``host``; nothing when ``other`` (the tensor on the other side of
        the copy) is on the CPU, where nothing moved."""
        req = self._active()
        if req is None or other.device.type == "cpu":
            return
        key = f"{name}.{'pinned' if host.is_pinned() else 'pageable'}"
        req.counters[key] += host.numel() * host.element_size()

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the active request's counter ``name`` (from 0 where
        the request has none yet)."""
        req = self._active()
        if req is not None:
            req.counters[name] = req.counters.get(name, 0) + n

    def mark_done(self) -> None:
        """Record, on CUDA, the untimed event that ``wait_device`` waits for:
        the end of the device work the active request has enqueued."""
        req = self._active()
        if req is not None and req._stream is not None:
            req._done = torch.cuda.Event()
            req._done.record(req._stream)

    def wait_device(self) -> None:
        """The span ``service.wait``: the host blocked until the active
        request's device work (``mark_done``) is done. Its device spans are
        resolved to ms when it closes."""
        req = self._active()
        if req is None:
            return
        with _OpenSpan(req, "service.wait", False):
            if req._done is not None:
                req._done.synchronize()
                req._waited = True

    def requests(self, t0: float = float("-inf"), t1: float = float("inf")) -> list[Request]:
        """The kept requests whose ``service.request`` span lies inside
        [t0, t1] (``time.perf_counter`` seconds), oldest first."""
        with self._lock:
            kept = list(self._ring)
        return [r for r in kept if r.start >= t0 and r.end <= t1]

    def dump(self, path) -> None:
        """The kept requests as Chrome-trace JSON (``chrome://tracing``,
        Perfetto): one row a request, spans as complete events in µs of
        ``time.perf_counter``, the counters and any error on the request's
        own span, device ms on the device spans."""
        pid = os.getpid()
        events = []
        for req in self.requests():
            for s in req.spans:
                args = {"request": req.id,
                        "parent": None if s.parent is None else req.spans[s.parent].name}
                if s.device_ms is not None:
                    args["device_ms"] = s.device_ms
                if s.parent is None:
                    args.update(req.counters, error=req.error)
                events.append({"name": s.name, "ph": "X", "ts": s.start * 1e6,
                               "dur": (s.end - s.start) * 1e6, "pid": pid, "tid": req.id,
                               "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


RECORDER = Recorder()


def set_enabled(on: bool) -> None:
    """Turn the request log on or off for the process: while off, no
    request is opened, and every span and counter is a no-op."""
    RECORDER.enabled = bool(on)


open_request = RECORDER.open_request
close_request = RECORDER.close_request
activate = RECORDER.activate
request = RECORDER.request
span = RECORDER.span
count_copy = RECORDER.count_copy
count = RECORDER.count
mark_done = RECORDER.mark_done
wait_device = RECORDER.wait_device
requests = RECORDER.requests
dump = RECORDER.dump
