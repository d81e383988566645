"""A profiler window reduced to what the per-layer readers need.

The window is the annotation ``WINDOW`` around the traced updates where
the trace holds it (on the host, else its copy on the device), else the
span of every event the trace holds: on the card the profiler records
CUDA activity alone (kernels, copies, memsets and the runtime's calls), so
that recording every torch op on the host does not slow the host and
inflate the idle time it is to measure. Device activity is every kernel,
copy and memset inside the window (clipped to it); the device is busy
over the union of their intervals. An idle gap is a stretch of the window
in which nothing ran on the device; it is labelled with the innermost host
event (a runtime call such as ``cudaLaunchKernel`` or ``Command Buffer
Full``, or a torch op where the host was traced too) that spans its
middle: what the host was doing while the device waited.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np

WINDOW = "benchmark.window"
_DEVICE_KINDS = ("kernel", "memcpy", "memset")
_FLASH = re.compile(r"flash_(fwd|dq|dkv)(_tc)?_kernel")
GEMM = re.compile(r"gemm|cutlass|xmma|nvjet|cublas", re.IGNORECASE)


class Window:
    """``kernels``: ``[(name, start_ns, end_ns)]``; ``other``: copies and
    memsets; ``host``: ``[(name, start_ns, end_ns)]``; ``span``: the
    window's ``(start_ns, end_ns)``."""

    def __init__(self, span: Tuple[int, int], kernels, other, host):
        self.span = span
        self.kernels = kernels
        self.other = other
        self.host = host

    @property
    def window_ns(self) -> int:
        return self.span[1] - self.span[0]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of every device interval, sorted, clipped to the window."""
        lo, hi = self.span
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels + self.other
                     if e > lo and s < hi)
        merged: List[List[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.span
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def kernel_ns_by_name(self) -> dict:
        out: dict = defaultdict(int)
        for name, s, e in self.kernels:
            out[name] += e - s
        return dict(out)

    def flash_launches(self) -> dict:
        """``{(kind, dtype): [ns of each launch]}``, dtype ``bf16`` for the
        tensor-core (``_tc``) kernels, ``f32`` for the others."""
        out: dict = defaultdict(list)
        for name, s, e in self.kernels:
            m = _FLASH.search(name)
            if m:
                out[(m.group(1), "bf16" if m.group(2) else "f32")].append(e - s)
        return dict(out)

    def gap_labels(self, gaps) -> List[str]:
        """The innermost host event around each gap's middle."""
        if not self.host:
            return ["(no host event)"] * len(gaps)
        names = [h[0] for h in self.host]
        starts = np.array([h[1] for h in self.host], dtype=np.int64)
        ends = np.array([h[2] for h in self.host], dtype=np.int64)
        out = []
        for s, e in gaps:
            mid = (s + e) // 2
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            if len(inside) == 0:
                out.append("(between host events)")
            else:
                out.append(names[inside[np.argmin(ends[inside] - starts[inside])]])
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        what the host was doing, ``[[name, seconds], ...]`` each."""
        ops = sorted(self.kernel_ns_by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = self.gaps()
        idle: dict = defaultdict(int)
        for (s, e), label in zip(gaps, self.gap_labels(gaps)):
            idle[label] += e - s
        idle_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(n), ns / 1e9] for n, ns in ops],
                "idle_gaps": [[_short(n), ns / 1e9] for n, ns in idle_top]}


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _kind(event, host_names) -> Optional[str]:
    """``kernel``, ``memcpy``, ``memset`` for a device event, None for the
    device's copy of a host annotation. Where the profiler names the
    activity (``activity_type``, newer PyTorch) that decides; else copies
    and memsets go by their names and a device event that bears a host
    event's name is an annotation."""
    kind = str(event.activity_type()).lower() if hasattr(event, "activity_type") else ""
    if kind:
        return next((k for k in _DEVICE_KINDS if k in kind), None)
    name = event.name()
    if name.startswith(("Memcpy", "Memset")):
        return name[:6].lower()
    return None if name in host_names else "kernel"


def reduce(prof) -> Optional[Window]:
    """The ``Window`` of a finished ``torch.profiler.profile``; None when the
    trace holds no event."""
    events = prof.profiler.kineto_results.events()
    span = None
    kernels, other, host, device = [], [], [], []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if not str(ev.device_type()).endswith("CPU"):
            device.append((ev, name, start, end))
        elif name == WINDOW:
            span = (start, end)
        else:
            host.append((name, start, end))
    host_names = {h[0] for h in host} | {WINDOW}
    for ev, name, start, end in device:
        if name == WINDOW and span is None:
            span = (start, end)
        kind = _kind(ev, host_names)
        if kind == "kernel":
            kernels.append((name, start, end))
        elif kind is not None:
            other.append((name, start, end))
    if span is None:
        every = host + kernels + other
        if not every:
            return None
        span = (min(e[1] for e in every), max(e[2] for e in every))
    lo, hi = span

    def clipped(ivs):
        return [(n, max(s, lo), min(e, hi)) for n, s, e in ivs if e > lo and s < hi]

    return Window(span, clipped(kernels), clipped(other),
                  [h for h in host if h[2] >= lo and h[1] <= hi])
