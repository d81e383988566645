"""The program's own spans and counters laid over a profiler window.

The port's tracer (``gradaccum_tpu_torch/obs/trace.py``) stamps its events
with CLOCK_REALTIME, the base ``torch.profiler`` gives its events, so its
spans lie on the window's time axis. Each update is one ``train/step``
span holding ``train/upload``, per micro-batch ``train/forward``,
``train/backward`` and ``train/accumulate``, then ``train/clip`` and
``train/optimizer``; a ``flash`` counter event after each step carries the
flash wrapper's launches and host ns so far.

Every idle gap of the window (``Window.gaps``) is split, instant by
instant, by the innermost span of the main thread (the one that trains)
covering it. The
classes of ``CLASSES`` partition the idle time: the shares of the window
they read sum to ``device_idle_share``. A program whose tracer holds no
span inside the window (disabled, or on another clock), or a window in
which no kernel ran, reads nothing.
"""

from __future__ import annotations

import bisect
import threading
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

STEP = "train/step"
OUTSIDE = "(outside train/step)"
# metric class -> the innermost spans whose idle time it reads; "loop"
# takes train/step's own time and the time outside any train/step
CLASSES = {
    "upload": ("train/upload",),
    "micro": ("train/forward", "train/backward"),
    "accum": ("train/accumulate", "train/clip"),
    "optimizer": ("train/optimizer",),
    "loop": (STEP, OUTSIDE),
}
# the runtime's kernel launches, which the clock check finds inside the steps
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC")

Span = Tuple[str, int, int]  # (name, start_ns, end_ns)


def program_events() -> List[dict]:
    """The main thread's events of the program's global tracer, as Chrome
    trace events (none when the tracer is disabled); every event where the
    tracer numbers no threads."""
    from gradaccum_tpu_torch.obs import trace

    tracer = trace.get_tracer()
    events = tracer.snapshot()
    tid_of = getattr(tracer, "thread_tid", None)
    if tid_of is None:
        return events
    main = tid_of(threading.main_thread().ident)
    return [e for e in events if e["tid"] == main]


def _ns(event: dict) -> Tuple[int, int]:
    start = int(event["ts"]) * 1000
    return start, start + int(event.get("dur", 0)) * 1000


def train_spans(window, events) -> List[Span]:
    """The ``train/*`` spans of ``events`` (one thread's) that overlap the
    window, in ns, clipped to it, in order; none without a ``train/step``."""
    lo, hi = window.span
    inside = []
    for e in events:
        if e.get("ph") != "X" or not e["name"].startswith("train/"):
            continue
        s, t = _ns(e)
        if t > lo and s < hi:
            inside.append((e["name"], max(s, lo), min(t, hi)))
    if not any(n == STEP for n, _, _ in inside):
        return []
    return sorted(inside, key=lambda x: (x[1], -x[2]))


def segments(spans: List[Span]) -> List[Tuple[int, int, str]]:
    """The time the spans cover cut where any starts or ends, each piece
    labelled with its innermost span: the latest to start among those
    covering it, then the shortest."""
    cuts = sorted({p for _, s, t in spans for p in (s, t)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        covering = [(s, -(t - s), n) for n, s, t in spans if s <= a and t >= b]
        if covering:
            out.append((a, b, max(covering)[2]))
    return out


def idle_split(window, spans: List[Span]) -> Dict[str, int]:
    """Idle ns of the window by the innermost span at each instant
    (``OUTSIDE`` where no span is open); sums to the window's idle time."""
    segs = segments(spans)
    out: Dict[str, int] = defaultdict(int)
    i = 0
    for s, e in window.gaps():
        while i < len(segs) and segs[i][1] <= s:
            i += 1
        t, j = s, i
        while t < e:
            if j < len(segs) and segs[j][0] <= t:
                a, b, name = segs[j]
                end = min(b, e)
                out[name] += end - t
                t = end
                if b <= e:
                    j += 1
                continue
            end = min(segs[j][0], e) if j < len(segs) else e
            out[OUTSIDE] += end - t
            t = end
    return dict(out)


def shares(window, spans: List[Span]) -> Dict[str, float]:
    """Each class's idle time in % of the window (``CLASSES``)."""
    split = idle_split(window, spans)
    return {cls: 100.0 * sum(split.get(n, 0) for n in names) / window.window_ns
            for cls, names in CLASSES.items()}


def launches_inside_steps(window, spans: List[Span]) -> Tuple[int, int]:
    """(kernel-launch runtime calls of the window inside a ``train/step``
    span, all of them): the check that the two clocks agree."""
    steps = [(s, t) for n, s, t in spans if n == STEP]
    calls = [(s, t) for n, s, t in window.host if n in LAUNCHES]
    inside = sum(any(a <= s and t <= b for a, b in steps) for s, t in calls)
    return inside, len(calls)


def calls_by_span(window, spans: List[Span]) -> Dict[str, Counter]:
    """The window's runtime calls other than kernel launches (copies,
    syncs, a full queue) by the innermost span at each call's start: where
    the host waits on the card."""
    segs = segments(spans)
    starts = [a for a, _, _ in segs]
    out: Dict[str, Counter] = defaultdict(Counter)
    for name, s, _ in window.host:
        if name in LAUNCHES:
            continue
        i = bisect.bisect_right(starts, s) - 1
        out[segs[i][2] if i >= 0 and s < segs[i][1] else OUTSIDE][name] += 1
    return dict(out)


def read_share(ctx, cls: str) -> Optional[float]:
    """Class ``cls``'s share of the window; None without device activity in
    the window (as ``device_idle_share``) or without a program span in it."""
    w = ctx.window
    if w is None or not w.kernels:
        return None
    spans = train_spans(w, program_events())
    if not spans:
        return None
    return shares(w, spans)[cls]


def flash_host_us(window, events) -> Optional[float]:
    """Δ host ns over Δ launches of the ``flash`` counter, from its last
    event at or before the window's start to its last inside the window,
    in µs a launch; None without two such events or without launches."""
    lo, hi = window.span
    before = inside = None
    for e in events:
        if e.get("ph") != "C" or e["name"] != "flash":
            continue
        t = _ns(e)[0]
        if t <= lo and (before is None or t >= before[0]):
            before = (t, e["args"])
        elif lo < t <= hi and (inside is None or t >= inside[0]):
            inside = (t, e["args"])
    if before is None or inside is None:
        return None
    launched = inside[1]["launches"] - before[1]["launches"]
    if launched <= 0:
        return None
    return (inside[1]["host_ns"] - before[1]["host_ns"]) / launched / 1e3
