"""Structured span tracer: one timeline for training and resilience.

The port of ``gradaccum_tpu/obs/trace.py``: host-side spans, instant and
counter events rendered as Chrome/Perfetto trace-event JSON (load
``trace.json`` in ``chrome://tracing`` or https://ui.perfetto.dev), with
the same events, fields and serialization, so a trace of the port and one of
the JAX package compare byte for byte under a logical clock.

Design constraints (the hot-path contract):

- **Host-side, no device syncs.** Call sites only record ints/floats they
  already hold; nothing here may force a readback. A span times the host.
  On the card a ``train/step`` span spans the whole update all the same:
  the host blocks on a full launch queue and on the pageable upload, so
  the card's back-pressure lands inside it.
- **Strict no-op when disabled.** ``GRADACCUM_OBS=0`` (or an installed
  :class:`NullTracer`) makes every hook one attribute load + branch; call
  sites guard argument-dict construction behind ``tracer.enabled``.
- **Two clocks on every event.** ``ts`` comes from the tracer's injectable
  ``clock`` (by default CLOCK_REALTIME in seconds, ``time.time_ns()``: the
  base ``torch.profiler`` gives its host and device events, so a wall trace
  lies on a profiler trace's time axis; tests inject a logical clock), and
  ``args.seq`` is a monotonically increasing logical sequence number.
- **Deterministic mode.** ``Tracer(deterministic=True)`` removes every
  wall-clock-derived field (thread ids collapse to 0, no wall timestamps),
  so two seeded runs export byte-identical JSON. It also leaves out the
  spans inside an update (``timed`` is False: :class:`UpdateSpans`), which
  time the host and nothing else, so its events are JAX's.
- **Bounded by default.** Events land in a ring (``capacity``), so an
  always-on tracer costs bounded memory; the flight recorder dumps that
  ring on crash or drain. ``capacity=None`` keeps everything.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional


def obs_enabled() -> bool:
    """The kill switch: ``GRADACCUM_OBS=0`` disables the global tracer."""
    return os.environ.get("GRADACCUM_OBS", "1") != "0"


class _NullSpan:
    """Shared no-op context manager (one instance, zero per-call state)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is a no-op, ``enabled`` is False
    so call sites skip building argument dicts entirely."""

    enabled = False
    deterministic = False
    timed = False

    def span(self, name, cat="", **args):
        return _NULL_SPAN

    def event(self, name, cat="", **args):
        return None

    def counter(self, name, cat="", **values):
        return None

    def complete(self, name, start, cat="", **args):
        return None

    def now(self) -> float:
        return 0.0

    def snapshot(self) -> List[dict]:
        return []

    def clear(self) -> None:
        pass


NULL = NullTracer()


class _Span:
    """Context manager emitting one complete ('X') event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracer.clock()
        return self

    def set(self, **args) -> None:
        """Attach args discovered mid-span."""
        self._args.update(args)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._args["error"] = exc_type.__name__
        # inlined Tracer._complete: one clock read + lock + append — this
        # runs once per train step, so the call chain stays
        # flat on purpose
        tr = self._tracer
        t0 = self._t0
        dur = tr.clock() - t0
        ident = threading.get_ident() if tr._wall_tids else 0
        ring = tr._ring
        with tr._lock:
            seq = tr._seq
            tr._seq = seq + 1
            if ring.maxlen is not None and len(ring) == ring.maxlen:
                tr.dropped += 1
            ring.append((seq, "X", self._name, self._cat, t0, dur, ident,
                         self._args))
        return False


class Tracer:
    """Bounded-ring span/event recorder in Chrome trace-event terms.

    ``clock`` maps to the exported ``ts`` axis and is interpreted in
    SECONDS (scaled to trace-format microseconds); inject a logical clock
    (e.g. ``lambda: float(step)``) for deterministic replays. All emit
    paths are thread-safe (the train loop and the checkpoint writer's
    thread share one tracer).

    ``timed`` is True unless ``deterministic``: only then are the spans
    inside an update recorded (:class:`UpdateSpans`).

    Hot-path layout: the ring holds compact tuples
    ``(seq, ph, name, cat, ts, dur, thread_ident, args)`` — one clock
    read, one lock, one append per emit. The Chrome trace-event dicts
    (µs timestamps, small tid numbering) are materialized off the hot
    path in :meth:`snapshot`.
    """

    enabled = True

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        deterministic: bool = False,
        capacity: Optional[int] = 8192,
    ):
        self.deterministic = deterministic
        self.timed = not deterministic
        if clock is None:
            # the caller injects its logical clock
            clock = (lambda: 0.0) if deterministic else _wall_clock
        self.clock = clock
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}
        # deterministic traces pin tid 0; wall traces record the raw
        # thread ident per event and number threads at snapshot time
        self._wall_tids = not deterministic
        self.dropped = 0  # events evicted from the ring (capacity pressure)

    # -- emission ---------------------------------------------------------

    def now(self) -> float:
        return self.clock()

    def _append(self, ph, name, cat, ts, dur, args) -> None:
        ident = threading.get_ident() if self._wall_tids else 0
        ring = self._ring
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
            if ring.maxlen is not None and len(ring) == ring.maxlen:
                self.dropped += 1
            ring.append((seq, ph, name, cat, ts, dur, ident, args))

    def span(self, name: str, cat: str = "", **args) -> _Span:
        """Context manager: emits a complete span over the enclosed code."""
        return _Span(self, name, cat, args)

    def event(self, name: str, cat: str = "", **args) -> None:
        """Instant event at ``now()``."""
        self._append("i", name, cat, self.clock(), 0.0, args)

    def counter(self, name: str, cat: str = "", **values) -> None:
        """Counter ('C') event at ``now()``: one series per keyword."""
        self._append("C", name, cat, self.clock(), 0.0, values)

    def complete(self, name: str, start: float, cat: str = "", **args) -> None:
        """Complete span with an explicit ``start`` (clock units) — for
        durations computed retroactively (queue wait measured at admit)."""
        self._append("X", name, cat, start, self.clock() - start, args)

    @staticmethod
    def _us(seconds: float) -> int:
        return int(round(seconds * 1e6))

    # -- export -----------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """The ring in emission order, materialized as Chrome trace-event
        dicts (the flight recorder's view). ``args`` dicts are copied, so
        mutating a snapshot never corrupts the live ring."""
        us = self._us
        with self._lock:
            out = []
            for seq, ph, name, cat, ts, dur, ident, raw in self._ring:
                if ident:
                    tid = self._tids.get(ident)
                    if tid is None:
                        tid = self._tids[ident] = len(self._tids)
                else:
                    tid = 0
                args = dict(raw)
                args["seq"] = seq
                if ph == "X":
                    out.append({
                        "name": name, "cat": cat, "ph": "X", "ts": us(ts),
                        "dur": us(max(0.0, dur)), "pid": 0, "tid": tid,
                        "args": args,
                    })
                elif ph == "C":
                    out.append({
                        "name": name, "cat": cat, "ph": "C", "ts": us(ts), "pid": 0,
                        "tid": tid, "args": args,
                    })
                else:
                    out.append({
                        "name": name, "cat": cat, "ph": ph, "s": "g",
                        "ts": us(ts), "pid": 0, "tid": tid, "args": args,
                    })
            return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def thread_tid(self, ident: int) -> Optional[int]:
        """The ``tid`` that :meth:`snapshot` gives thread ``ident``
        (``threading.get_ident()``): 0 in deterministic mode, None for a
        thread no snapshot has held yet."""
        if not self._wall_tids:
            return 0
        with self._lock:
            return self._tids.get(ident)

    def to_chrome(self, events: Optional[List[dict]] = None) -> dict:
        if events is None:
            events = self.snapshot()
        meta = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "gradaccum"},
        }]
        return {"displayTimeUnit": "ms", "traceEvents": meta + events}

    def to_bytes(self) -> bytes:
        """Canonical serialization: sorted keys, fixed separators — the
        byte-identical-under-a-seed contract leans on this."""
        return (json.dumps(self.to_chrome(), sort_keys=True,
                           separators=(",", ":")) + "\n").encode()

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns ``path``."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            f.write(self.to_bytes())
        return path


def _wall_clock() -> float:
    """CLOCK_REALTIME in seconds, the base of ``torch.profiler``'s events."""
    return time.time_ns() / 1e9


class UpdateSpans:
    """The spans inside one update: ``spans(name, **args)`` opens span
    ``name`` (category ``train``) carrying the update's ``step`` when the
    tracer is ``timed``, else the shared no-op. Built once per update, so a
    disabled site costs one attribute test."""

    __slots__ = ("_tracer", "_step", "timed")

    def __init__(self, tracer, step: int):
        self._tracer, self._step = tracer, step
        self.timed = tracer.timed

    def __call__(self, name: str, **args):
        if not self.timed:
            return _NULL_SPAN
        return self._tracer.span(name, cat="train", step=self._step, **args)


NO_SPANS = UpdateSpans(NULL, 0)


# -- global tracer ------------------------------------------------------------

_GLOBAL: Optional[Tracer] = None
_GLOBAL_LOCK = threading.Lock()
# set_tracer marks the global EXPLICIT: the env kill switch governs only
# the default lazily-created tracer, never one a caller installed on
# purpose (a test or a smoke run must record even under GRADACCUM_OBS=0
# in the ambient environment — install NULL to disable explicitly)
_EXPLICIT = False


def get_tracer():
    """The process-global tracer (a bounded ring), or :data:`NULL` when
    ``GRADACCUM_OBS=0``. Call sites re-resolve per use, so flipping the env
    var or installing a custom tracer takes effect immediately. A tracer
    installed via :func:`set_tracer` / :func:`installed` wins over the
    kill switch."""
    global _GLOBAL
    if _EXPLICIT:
        return _GLOBAL if _GLOBAL is not None else NULL
    if not obs_enabled():
        return NULL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Tracer()
    return _GLOBAL


def resolve(pinned) -> "Tracer | NullTracer":
    """The one definition of pin-vs-global tracer semantics: an explicitly
    pinned tracer wins; ``None`` means re-resolve the global NOW (so a
    tracer installed after the owner was built still sees its events).
    The FlightRecorder routes through
    here — change the contract in one place."""
    return pinned if pinned is not None else get_tracer()


def set_tracer(tracer) -> Optional[Tracer]:
    """Install ``tracer`` as the global; returns the previous one.
    ``None`` resets to the default (kill-switch-governed) tracer."""
    global _GLOBAL, _EXPLICIT
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, tracer
        _EXPLICIT = tracer is not None
    return prev


@contextlib.contextmanager
def installed(tracer) -> Iterator:
    """Scoped ``set_tracer`` (tests, smoke runs); restores the previous
    tracer AND its explicit/default standing on exit."""
    global _EXPLICIT
    with _GLOBAL_LOCK:
        prev_explicit = _EXPLICIT
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
        with _GLOBAL_LOCK:
            _EXPLICIT = prev_explicit
