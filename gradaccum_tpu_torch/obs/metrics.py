"""Metrics registry: counters / gauges / histograms behind one API.

The port of ``gradaccum_tpu/obs/metrics.py``:

- :class:`Counter` (monotonic), :class:`Gauge` (last value + step),
  :class:`Histogram` (wraps ``utils/timing.py :: LatencySeries``, so every
  percentile is computed one way).
- ``snapshot()`` — one JSON-able dict of everything (the flight recorder
  embeds it in crash dumps).
- ``to_prometheus()`` — Prometheus text exposition (quantiles exported
  summary-style), byte for byte JAX's for the same operations.
- ``publish(scalars, step)`` — the EventWriter bridge: the Estimator
  publishes its scalars through the registry, which records them as gauges
  and streams them to TensorBoard when a backend is present.

Everything is host-side ints/floats; nothing here touches a device.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional

from gradaccum_tpu_torch.utils.timing import LatencySeries

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _escape_label(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote and newline must be escaped or a replica label carrying an odd
    string (a mesh spec, an error message) breaks the whole scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: Optional[Dict[str, str]]) -> str:
    """Prometheus-style rendering, '' when unlabeled. Sorted so the same
    label set always produces the same instrument key."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _full_name(name: str, labels: Optional[Dict[str, str]]) -> str:
    return name + _label_str(labels)


class Counter:
    """Monotonic counter. Single-writer per subsystem by design (the
    serving engine is single-threaded; the train loop is one thread), so
    ``inc`` stays a bare add on the hot path. ``labels`` is an optional
    DIMENSION on the metric name (e.g. ``{"replica": "2"}``) — the same
    base name with different labels is a different instrument, rendered
    Prometheus-style on export."""

    __slots__ = ("name", "value", "labels")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value, plus the step it was set at (if any)."""

    __slots__ = ("name", "value", "step", "labels")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = labels
        self.value: Optional[float] = None
        self.step: Optional[int] = None

    def set(self, value: float, step: Optional[int] = None) -> None:
        self.value = float(value)
        if step is not None:
            self.step = int(step)


class Histogram:
    """A sample distribution backed by a :class:`LatencySeries` — pass an
    existing series to EXPOSE it (the serving metrics' TTFT series lands in
    the registry without double bookkeeping)."""

    __slots__ = ("name", "series", "labels")

    def __init__(self, name: str, series: Optional[LatencySeries] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = labels
        self.series = series if series is not None else LatencySeries()

    def observe(self, x: float) -> None:
        self.series.add(x)

    def summary(self) -> dict:
        return self.series.summary()


class MetricsRegistry:
    """Named counters/gauges/histograms with JSON + Prometheus export and
    an optional EventWriter bridge (``subdir`` scopes the TensorBoard
    stream, e.g. ``"serving"``)."""

    def __init__(self, event_writer=None, subdir: str = ""):
        self._writer = event_writer
        self._subdir = subdir
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # family base name -> HELP text (first non-None registration wins;
        # families without one export their name as the help line)
        self._help: Dict[str, str] = {}

    # -- instrument accessors (memoized; type conflicts are bugs) ---------

    def _note_help(self, name: str, help: Optional[str]) -> None:
        if help is not None and name not in self._help:
            self._help[name] = str(help)

    def counter(self, name: str,
                labels: Optional[Dict[str, str]] = None,
                help: Optional[str] = None) -> Counter:
        key = _full_name(name, labels)
        with self._lock:
            self._note_help(name, help)
            c = self._counters.get(key)
            if c is None:
                self._check_free(name, self._counters)
                c = self._counters[key] = Counter(name, labels)
            return c

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None,
              help: Optional[str] = None) -> Gauge:
        key = _full_name(name, labels)
        with self._lock:
            self._note_help(name, help)
            g = self._gauges.get(key)
            if g is None:
                self._check_free(name, self._gauges)
                g = self._gauges[key] = Gauge(name, labels)
            return g

    def histogram(self, name: str,
                  series: Optional[LatencySeries] = None,
                  labels: Optional[Dict[str, str]] = None,
                  help: Optional[str] = None) -> Histogram:
        key = _full_name(name, labels)
        with self._lock:
            self._note_help(name, help)
            h = self._histograms.get(key)
            if h is None:
                self._check_free(name, self._histograms)
                h = self._histograms[key] = Histogram(name, series, labels)
            elif series is not None and h.series is not series:
                # a rebuilt owner (e.g. a new ServingMetrics on a shared
                # registry) re-registers its live series; rebind so exports
                # track the instance that is actually recording
                h.series = series
            return h

    def find(self, name: str):
        """The first instrument of family ``name`` as ``(kind, instrument)``
        — kind one of "counter"/"gauge"/"histogram" — or ``(None, None)``."""
        kind, insts = self.find_all(name)
        return (kind, insts[0]) if insts else (None, None)

    def find_all(self, name: str):
        """EVERY instrument of family ``name`` as ``(kind, [instruments])``
        — or ``(None, [])``. The SLO evaluator's pull hook: a fleet
        registers one labeled instrument per replica under the same family
        name, and an objective on that family must see the whole fleet,
        not whichever replica registered first."""
        with self._lock:
            for kind, store in (("counter", self._counters),
                                ("gauge", self._gauges),
                                ("histogram", self._histograms)):
                insts = [i for i in store.values() if i.name == name]
                if insts:
                    return kind, insts
        return None, []

    def _check_free(self, name: str, own: dict) -> None:
        # a conflict is the same FAMILY (base name) under another type —
        # compare instrument names, not the label-suffixed registry keys,
        # or a labeled counter could shadow an unlabeled gauge and the
        # export would merge both under one wrong TYPE line
        for kind in (self._counters, self._gauges, self._histograms):
            if kind is not own and any(i.name == name
                                       for i in kind.values()):
                raise ValueError(
                    f"metric {name!r} already registered as a different type"
                )

    # -- the EventWriter bridge ------------------------------------------

    def bind_writer(self, event_writer) -> None:
        """Point the bridge at ``event_writer`` — owners whose writer can
        be swapped out (the Estimator recreates it after ``close()`` +
        resume) re-bind so publishes never stream into a detached writer
        nothing will flush."""
        self._writer = event_writer

    def publish(self, scalars: Dict[str, float], step: int,
                subdir: Optional[str] = None,
                labels: Optional[Dict[str, str]] = None) -> None:
        """Record ``scalars`` as gauges AND stream them to the EventWriter
        (when one is attached and active) — the one call replacing direct
        ``EventWriter.scalars`` use. ``labels`` lands on the gauges (a
        replica's engine publishes the SAME gauge names, labeled)."""
        for tag, value in scalars.items():
            self.gauge(tag, labels=labels).set(value, step=step)
        if self._writer is not None and self._writer.active:
            self._writer.scalars(
                scalars, step=step,
                subdir=self._subdir if subdir is None else subdir,
            )

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    # -- export -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Everything, as one JSON-able dict."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in counters.items()},
            "gauges": {
                n: {"value": g.value, "step": g.step}
                for n, g in gauges.items()
            },
            "histograms": {n: h.summary() for n, h in hists.items()},
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition. Histograms export summary-style
        quantiles (p50/p90/p99) plus ``_count``. Every family gets a
        ``# HELP`` line (the registered help text, or the instrument name)
        ahead of its ``# TYPE`` line, and label values are escaped per the
        exposition format, so the payload stays promtool-valid even with
        odd replica/mesh label strings."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
            help_texts = dict(self._help)
        # the exposition format requires every sample of a metric family
        # to form ONE contiguous group under its TYPE line — a fleet's
        # replicas register the same base names interleaved, so bucket by
        # family (first-registration order) before rendering
        families: Dict[str, tuple] = {}

        def bucket(pn: str, name: str, kind: str, rows) -> None:
            fam = families.get(pn)
            if fam is None:
                fam = families[pn] = (name, kind, [])
            fam[2].extend(rows)

        for c in counters.values():
            pn = _prom_name(c.name)
            bucket(pn, c.name, "counter",
                   [f"{pn}{_label_str(c.labels)} {c.value}"])
        for g in gauges.values():
            if g.value is None:
                continue
            pn = _prom_name(g.name)
            bucket(pn, g.name, "gauge",
                   [f"{pn}{_label_str(g.labels)} {g.value}"])
        for h in hists.values():
            pn = _prom_name(h.name)
            s = h.summary()
            rows = []
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                if s.get(key) is not None:
                    qlabels = dict(h.labels or {}, quantile=q)
                    rows.append(f"{pn}{_label_str(qlabels)} {s[key]}")
            rows.append(f"{pn}_count{_label_str(h.labels)} {s['count']}")
            bucket(pn, h.name, "summary", rows)
        lines = []
        for pn, (name, kind, rows) in families.items():
            lines.append(
                f"# HELP {pn} {_escape_help(help_texts.get(name, name))}"
            )
            lines.append(f"# TYPE {pn} {kind}")
            lines.extend(rows)
        return "\n".join(lines) + ("\n" if lines else "")
