"""Spans at the program's layer boundaries, recorded only while a torch
profiler records.

`with span("phase_e.forward"): ...` marks one layer's work. With no profiler
recording (`torch.autograd.profiler._is_profiler_enabled`, the flag that
`torch.profiler.profile` sets), `span` returns one shared context that does
nothing: no clock read, no event, no `record_function`, no allocation.

Under a profiler a span
- is a `record_function("sivae.<name>")` range, so it sits on the
  profiler's host timeline, on the kernels' clock, beside its children and
  the ops inside it (`export_chrome_trace` writes them all out);
- reads the host clock at entry and exit, and knows its parent on its
  thread, so its self time leaves out the host time of its child spans;
- where CUDA is in use, records a timing event pair on the stream current
  at entry (the pipeline's side stream inside its `torch.cuda.stream`
  block). A span's device time runs from the stream reaching its first
  event to reaching its second: the work it enqueued, bubbles inside
  included. On one stream the children's device times add up to at most
  their parent's.

The store keeps totals by name, never one record a span, so a long profiled
job does not grow it: `summary()` gives {name: {"count", "host_s",
"self_s", "device_s"}} (`device_s` None where no event was recorded), after
waiting for the event pairs still in flight; `reset()` empties it. Spans
record from any thread (the pipeline's producer records its own).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as autograd_profiler

PREFIX = "sivae."


class _Off:
    """The context of every span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class SpanStore:
    """Totals of the spans by name; the event pairs not yet completed are
    held until they are, then folded into their name's device time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, list] = {}   # name -> [count, host_s, self_s, device_s]
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def add(self, name: str, host_s: float, self_s: float, events=None) -> None:
        with self._lock:
            t = self._totals.setdefault(name, [0, 0.0, 0.0, None])
            t[0] += 1
            t[1] += host_s
            t[2] += self_s
            if events is not None:
                self._pending.append((name,) + events)
            self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        still = []
        for name, start, end in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                still.append((name, start, end))
                continue
            t = self._totals[name]
            t[3] = (t[3] or 0.0) + start.elapsed_time(end) * 1e-3
        self._pending = still

    def summary(self) -> Dict[str, Dict[str, Optional[float]]]:
        with self._lock:
            self._fold(wait=True)
            return {name: {"count": c, "host_s": h, "self_s": s, "device_s": d}
                    for name, (c, h, s, d) in self._totals.items()}

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._pending.clear()


STORE = SpanStore()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "range", "t0", "child_s", "stream", "start")

    def __init__(self, name: str):
        self.name = name
        self.child_s = 0.0
        self.start = None

    def __enter__(self):
        self.range = autograd_profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        _stack().append(self)
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        events = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            events = (self.start, end)
        self.range.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_s += host_s
        STORE.add(self.name, host_s, host_s - self.child_s, events)
        return False


def span(name: str):
    """The context of one span named `name` (recorded as "sivae.<name>"):
    a recording span while a torch profiler records, else a shared no-op."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def summary() -> Dict[str, Dict[str, Optional[float]]]:
    """{name: {"count", "host_s", "self_s", "device_s"}} of every span
    recorded since the last `reset()`; waits for the device times still in
    flight."""
    return STORE.summary()


def reset() -> None:
    """Forget every span recorded so far."""
    STORE.reset()
