"""Reduction of a profiled window to device figures.

Device activity is a set of intervals (kernels, copies, fills) that may
overlap: the pipeline's side stream and NCCL run beside the compute stream.
So busy time is the measure of their union, never a sum of durations, and
"exposed" time of a class of kernels is the part of its union that no
other kernel covers.

`summarise(events, window)` takes plain tuples, so the arithmetic is tested
without a profiler: device events (name, start_us, end_us) and host ops
(name, start_us, end_us, thread).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]

PORT_NAMESPACE = "sivae::"


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering exactly what `intervals` cover."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def measure(intervals: Sequence[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def minus(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Measure of union(a) not covered by union(b)."""
    ua, ub = union(a), union(b)
    total, j = 0.0, 0
    for s, e in ua:
        covered = 0.0
        while j < len(ub) and ub[j][1] <= s:
            j += 1
        k = j
        while k < len(ub) and ub[k][0] < e:
            covered += max(0.0, min(e, ub[k][1]) - max(s, ub[k][0]))
            k += 1
        total += (e - s) - covered
    return total


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


@dataclass
class TraceSummary:
    """Figures of one profiled window, in seconds."""

    window_s: float
    busy_s: float
    kernels: int                       # kernel launches (no copies or fills)
    port_s: float                      # summed device time of the port's kernels
    library_s: float                   # union of every other kernel
    nccl_exposed_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def summarise(device: Sequence[Tuple[str, float, float]],
              host: Sequence[Tuple[str, float, float, int]],
              window: Interval, main_thread: Optional[int] = None,
              top: int = 10) -> TraceSummary:
    lo, hi = window
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in device if b > lo and a < hi]
    kernels = [(n, a, b) for n, a, b in dev if not is_copy(n)]
    busy = union([(a, b) for _, a, b in dev])
    port = [(a, b) for n, a, b in kernels if PORT_NAMESPACE in n]
    other = [(a, b) for n, a, b in kernels if PORT_NAMESPACE not in n]
    nccl = [(a, b) for n, a, b in kernels if is_nccl(n)]
    not_nccl = [(a, b) for n, a, b in kernels if not is_nccl(n)]
    by_name: Dict[str, float] = {}
    for n, a, b in kernels:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(
        window_s=(hi - lo) * 1e-6, busy_s=measure(busy) * 1e-6, kernels=len(kernels),
        port_s=sum(b - a for a, b in port) * 1e-6, library_s=measure(other) * 1e-6,
        nccl_exposed_s=minus(nccl, not_nccl) * 1e-6,
        device_ops=[(n, s * 1e-6) for n, s in ops],
        idle_gaps=idle_by_host_op(busy, host, window, main_thread, top))


def idle_by_host_op(busy: Sequence[Interval], host: Sequence[Tuple[str, float, float, int]],
                    window: Interval, main_thread: Optional[int], top: int
                    ) -> List[Tuple[str, float]]:
    """The idle time of the window (the gaps between busy intervals), each
    gap named by the innermost host op running on the main thread when it
    began; summed by name, the `top` largest."""
    lo, hi = window
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    ops = sorted((a, b, n) for n, a, b, th in host
                 if main_thread is None or th == main_thread)
    totals: Dict[str, float] = {}
    stack: List[Tuple[float, str]] = []   # (end, name) of the ops open, innermost last
    i = 0
    for ga, gb in gaps:   # in time order; one thread's ops nest
        while i < len(ops) and ops[i][0] <= ga:
            a, b, n = ops[i]
            while stack and stack[-1][0] <= a:
                stack.pop()
            stack.append((b, n))
            i += 1
        while stack and stack[-1][0] <= ga:
            stack.pop()
        name = stack[-1][1] if stack else "(no host op)"
        totals[name] = totals.get(name, 0.0) + (gb - ga)
    return [(n, s * 1e-6) for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


WINDOW_SPAN = "port_bench.window"


def from_profiler(prof) -> TraceSummary:
    """The summary of the `WINDOW_SPAN` record in a finished
    `torch.profiler.profile`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, window, main = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            a, b = e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3
        else:
            a, b = e.start_us(), e.start_us() + e.duration_us()
        name = e.name()
        if e.device_type() == cuda:
            device.append((name, a, b))
        else:
            th = e.start_thread_id()
            host.append((name, a, b, th))
            if name == WINDOW_SPAN:
                window, main = (a, b), th
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN!r} record")
    # a host range (`record_function`) also appears on the device's timeline,
    # spanning its kernels: it is no device work
    ranges = {h[0] for h in host}
    device = [d for d in device if d[0] not in ranges]
    return summarise(device, [h for h in host if h[0] != WINDOW_SPAN], window, main)
