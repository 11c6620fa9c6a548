"""Spans the harness records from its own files, around the program's calls
into each layer, by wrapping module attributes for one run; and the capture
of what the front-end received and produced, for the comparison.

If a later version of the program renames or removes a wrapped function,
that wrapper is not installed: its spans stay empty and the metrics that
read them are left out of the line (the front-end's capture: the numbers
it feeds are not compared, and the checks say so); the run goes on."""

from __future__ import annotations

import collections
import contextlib
import importlib
import time

SERVING = "drsa_audio_tpu_torch.serving"
EXPLAIN = "drsa_audio_tpu_torch.xai.explain"


class Patches:
    """setattr-based wrappers, undone by ``remove``."""

    def __init__(self):
        self._undo = []

    def wrap(self, owner, attr: str, make) -> bool:
        fn = getattr(owner, attr, None)
        if fn is None:
            return False
        setattr(owner, attr, make(fn))
        self._undo.append((owner, attr, fn))
        return True

    def remove(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


class Capture:
    """Keeps, for chosen calls, the log-mel the front-end returned (a device
    tensor, no copy in the window).
    Calls are counted from 0 in the order the program makes them."""

    def __init__(self):
        self.calls = 0
        self.want: set = set()
        self.kept: dict = {}
        self.recent = collections.deque(maxlen=2)
        self.patches = Patches()
        serving = importlib.import_module(SERVING)
        self.installed = self.patches.wrap(serving, "logmel", self._make)

    def _make(self, fn):
        def logmel(wav, *args, **kwargs):
            out = fn(wav, *args, **kwargs)
            i = self.calls
            self.calls += 1
            if i in self.want:
                self.kept[i] = out
            self.recent.append((i, out))
            return out
        return logmel

    def host(self, i: int):
        """The log-mel of call ``i`` as numpy, or None."""
        got = self.kept.get(i)
        for j, out in self.recent:
            if got is None and j == i:
                got = out
        return None if got is None else got.float().cpu().numpy()


class StageSpans:
    """The service's stages per request, as ``chip_smoke.staged_request``
    took them: CUDA events where each device stage ends (so the device
    stages are contiguous spans of the device's timeline), the device
    synchronised before the readback, and the host clock around the readback
    and the sort. One dict of ms a request; a stage whose function is gone
    is missing from it."""

    ORDER = ["start", "uploaded", "frontend", "forward_upper", "lower"]

    def __init__(self, svc):
        import torch
        self.torch = torch
        self.requests: list[dict] = []
        self._events: dict = {}
        self._host: dict = {}
        self.patches = Patches()
        serving = importlib.import_module(SERVING)
        explain = importlib.import_module(EXPLAIN)
        self.patches.wrap(serving, "peak_normalize", self._device("uploaded", before=True))
        self.patches.wrap(serving, "logmel", self._device("frontend"))
        self.patches.wrap(explain, "explain_forward_upper", self._device("forward_upper"))
        self.patches.wrap(explain, "explain_lower", self._device("lower"))
        self.patches.wrap(svc, "_finalize", self._host_stage("readback", sync=True))
        self.patches.wrap(serving, "sort_subspaces", self._host_stage("sort"))
        self.svc = svc

    def _mark(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self._events[name] = ev

    def _device(self, name, before=False):
        def make(fn):
            def run(*args, **kwargs):
                if before:
                    self._mark(name)
                out = fn(*args, **kwargs)
                if not before:
                    self._mark(name)
                return out
            return run
        return make

    def _host_stage(self, name, sync=False):
        def make(fn):
            def run(*args, **kwargs):
                if sync:
                    self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self._host[name] = (time.perf_counter() - t0) * 1e3
                return out
            return run
        return make

    @contextlib.contextmanager
    def request(self):
        self._events, self._host = {}, {}
        self._mark("start")
        yield
        self.requests.append((self._events, self._host))

    def remove(self):
        self.patches.remove()
        if "_finalize" in vars(self.svc):
            del self.svc._finalize              # back to the class's method

    def stages(self) -> list[dict]:
        """ms per stage and request (after the device is synchronised)."""
        self.torch.cuda.synchronize()
        out = []
        for events, host in self.requests:
            row = {}
            for a, b in zip(self.ORDER, self.ORDER[1:]):
                if a in events and b in events:
                    row[b] = events[a].elapsed_time(events[b])
            if "readback" in host:
                row["readback"] = host["readback"] - host.get("sort", 0.0)
            if "sort" in host:
                row["sort"] = host["sort"]
            out.append(row)
        return out


class Labels:
    """record_function ranges around the same calls, for the profiled
    slice: an idle gap on the device is named by the innermost range that
    spans it."""

    NAMES = [(SERVING, "peak_normalize", "frontend.peak_normalize"),
             (SERVING, "logmel", "frontend.logmel"),
             (EXPLAIN, "explain_forward_upper", "explain_forward_upper"),
             (EXPLAIN, "explain_lower", "explain_lower"),
             (SERVING, "sort_subspaces", "service.sort_subspaces")]

    def __init__(self, svc):
        from torch.profiler import record_function
        self.patches = Patches()
        self.svc = svc

        def label(name):
            def make(fn):
                def run(*args, **kwargs):
                    with record_function(name):
                        return fn(*args, **kwargs)
                return run
            return make

        for mod, attr, name in self.NAMES:
            self.patches.wrap(importlib.import_module(mod), attr, label(name))
        self.patches.wrap(svc, "_finalize", label("service._finalize"))
        self.patches.wrap(svc, "_dispatch", label("service._dispatch"))

    def remove(self):
        self.patches.remove()
        for attr in ("_finalize", "_dispatch"):
            if attr in vars(self.svc):
                delattr(self.svc, attr)
