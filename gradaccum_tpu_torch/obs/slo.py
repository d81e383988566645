"""Sliding-window SLOs evaluated as multi-window burn-rate alerts (the
port of ``gradaccum_tpu/obs/slo.py``: the same objectives, trackers and
serialization, so an alert stream equals JAX's byte for byte).

The metrics registry answers "what are the numbers NOW"; this module
answers the operator question behind it: *are we meeting our objectives,
and if not, how fast are we burning the error budget?* Each
:class:`Objective` names one indicator (a registry gauge, a counter rate,
or a windowed latency percentile), a good/bad threshold, and a target
good-fraction; the :class:`SLOEvaluator` classifies every sample against
the threshold and tracks the bad fraction over MULTIPLE sliding windows
(the SRE-workbook shape: a long window so one blip cannot page, a short
window so a real regression pages fast). An alert FIRES when every
window's burn rate — bad fraction over the error budget ``1 - target`` —
exceeds its factor, and RESOLVES when any drops back under.

Determinism contract: the evaluator's ``clock`` is
injectable and every alert record is built only from sample values and
that clock — no wall time, no thread ids — so a seeded simulation run
on the logical tick clock produces a byte-identical alert stream
(:meth:`SLOEvaluator.alerts_bytes`) across runs. Alert transitions also
land on the obs tracer (``slo/alert`` events) and bump an
``slo/alerts_fired_total`` registry counter, so the existing flight-dump
and trace tooling sees them without new plumbing.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from gradaccum_tpu_torch.obs import trace as obs_trace
from gradaccum_tpu_torch.utils.timing import LatencySeries

#: Objective.kind values — how ``SLOEvaluator.tick`` turns the registry
#: instrument named by ``metric`` into one indicator sample.
KIND_GAUGE = "gauge"            # the gauge's current value
KIND_COUNTER_RATE = "counter_rate"  # d(counter)/d(clock) between ticks
KIND_PERCENTILE = "percentile"  # histogram percentile (use window= series)
KIND_AUTO = "auto"              # sniff the registry for the family's type

_KINDS = (KIND_GAUGE, KIND_COUNTER_RATE, KIND_PERCENTILE, KIND_AUTO)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One service-level objective.

    A sample is GOOD when ``value op threshold`` holds (``op`` is ``"<="``
    or ``">="``). ``target`` is the objective proper — the fraction of
    samples that must be good — and ``1 - target`` the error budget.
    ``windows`` is ``((seconds, burn_factor), ...)`` in CLOCK units (ticks
    under the simulation clock); the alert fires only when EVERY window
    burns faster than its factor.

    ``event``/``field`` make the objective replayable from a recorded
    trace (``examples/slo_check.py``): samples come from events named
    ``event`` — an "X" span's duration in seconds when ``field`` is None,
    else ``args[field]``.
    """

    name: str
    metric: str
    threshold: float
    op: str = "<="
    target: float = 0.99
    windows: Tuple[Tuple[float, float], ...] = ((240.0, 2.0), (60.0, 6.0))
    kind: str = KIND_AUTO
    percentile: float = 99.0
    event: Optional[str] = None
    field: Optional[str] = None

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise ValueError(f"op must be '<=' or '>=', got {self.op!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1) — 1.0 leaves no error budget to "
                f"burn — got {self.target}"
            )
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if not self.windows:
            raise ValueError("at least one (window, burn_factor) is required")
        for w, f in self.windows:
            if w <= 0 or f <= 0:
                raise ValueError(
                    f"windows need positive (length, factor), got {(w, f)}"
                )

    def good(self, value: float) -> bool:
        return (value <= self.threshold if self.op == "<="
                else value >= self.threshold)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["windows"] = [list(w) for w in self.windows]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Objective":
        d = dict(d)
        if "windows" in d:
            d["windows"] = tuple((float(w), float(f)) for w, f in d["windows"])
        return cls(**d)


class BurnRateTracker:
    """Per-objective state: the good/bad sample rings and firing edge."""

    def __init__(self, objective: Objective):
        self.objective = objective
        # one ring per window: (t, good) pairs, evicted once older than
        # the window length relative to the newest evaluation time
        self._rings = [deque() for _ in objective.windows]
        self.firing = False
        self.last_value: Optional[float] = None
        self.samples = 0
        self.violations = 0

    def _evict(self, now: float) -> None:
        for (length, _), ring in zip(self.objective.windows, self._rings):
            cutoff = now - length
            while ring and ring[0][0] <= cutoff:
                ring.popleft()

    def burns(self, now: float) -> List[Optional[float]]:
        """Burn rate per window (bad fraction / error budget); None for a
        window with no samples yet."""
        self._evict(now)
        budget = 1.0 - self.objective.target
        out = []
        for ring in self._rings:
            if not ring:
                out.append(None)
                continue
            bad = sum(1 for _, good in ring if not good)
            out.append((bad / len(ring)) / budget)
        return out

    def observe(self, value: float, now: float) -> Optional[dict]:
        """Ingest one sample; returns the alert TRANSITION record when the
        firing state flips (fire/resolve), else None."""
        good = self.objective.good(value)
        self.last_value = float(value)
        self.samples += 1
        if not good:
            self.violations += 1
        for ring in self._rings:
            ring.append((now, good))
        burns = self.burns(now)
        firing = all(
            b is not None and b >= factor
            for b, (_, factor) in zip(burns, self.objective.windows)
        )
        if firing == self.firing:
            return None
        self.firing = firing
        return {
            "slo": self.objective.name,
            "state": "fire" if firing else "resolve",
            "at": float(now),
            "value": float(value),
            "burns": [
                [float(w), None if b is None else float(b)]
                for (w, _), b in zip(self.objective.windows, burns)
            ],
        }


class SLOEvaluator:
    """Evaluates a set of :class:`Objective`\\ s against pushed samples
    and/or a pulled :class:`~gradaccum_tpu_torch.obs.metrics.MetricsRegistry`.

    Two feeding modes, freely mixed:

    - **push** — ``observe(name, value, now=...)`` delivers one indicator
      sample directly (the Estimator pushes its nonfinite-skip rate).
    - **pull** — ``tick(now=...)`` samples every objective whose
      ``metric`` resolves: an attached source callable first, then the
      bound registry (gauge value, counter rate over the tick interval,
      or histogram percentile per ``Objective.kind``).

    ``clock`` defaults to wall monotonic; inject the logical tick clock
    for deterministic alert streams. Transition records accumulate in
    ``alerts`` (the stream) and mirror onto the obs tracer / registry.

    ``interval`` throttles the PULL path: only every Nth ``tick()`` call
    actually samples (call-count based, so it stays deterministic) — a
    serving loop can tick every engine tick while percentile objectives
    are only computed at a scrape-like cadence. Pushed ``observe``
    samples are never throttled.
    """

    def __init__(
        self,
        objectives: Sequence[Objective],
        registry=None,
        clock: Optional[Callable[[], float]] = None,
        tracer=None,
        interval: int = 1,
    ):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.trackers: Dict[str, BurnRateTracker] = {
            o.name: BurnRateTracker(o) for o in objectives
        }
        self._registry = registry
        self._tracer = tracer
        if clock is None:
            t0 = time.monotonic()
            clock = lambda: time.monotonic() - t0
        self.clock = clock
        self._sources: Dict[str, Callable[[], Optional[float]]] = {}
        # counter-rate state: objective name -> (t, counter value)
        self._rate_prev: Dict[str, Tuple[float, float]] = {}
        self.interval = int(interval)
        self._tick_calls = 0
        self.alerts: List[dict] = []
        # one lock around tracker state: the serving loop ticks/observes
        # while the /slo telemetry endpoint's handler threads read status
        # — the telemetry contract requires every hook it calls to be
        # thread-safe, same as Sentinel.status and the registry
        self._lock = threading.Lock()

    @property
    def objectives(self) -> List[Objective]:
        return [t.objective for t in self.trackers.values()]

    @property
    def tracer(self):
        return obs_trace.resolve(self._tracer)

    def bind_registry(self, registry) -> None:
        self._registry = registry

    def attach(self, name: str, fn: Callable[[], Optional[float]]) -> None:
        """Explicit sample source for objective ``name`` (wins over the
        registry). ``fn`` returning None skips that tick's sample."""
        if name not in self.trackers:
            raise KeyError(f"unknown objective {name!r}")
        self._sources[name] = fn

    # -- sample ingestion -------------------------------------------------

    def _record(self, transition: Optional[dict]) -> None:
        if transition is None:
            return
        with self._lock:
            self.alerts.append(transition)
        tr = self.tracer
        if tr.enabled:
            tr.event("slo/alert", cat="slo", **{
                k: v for k, v in transition.items() if k != "burns"
            })
        if self._registry is not None and transition["state"] == "fire":
            self._registry.counter(
                "slo/alerts_fired_total", labels={"slo": transition["slo"]},
                help="SLO burn-rate alert firings",
            ).inc()

    def observe(self, name: str, value: float,
                now: Optional[float] = None) -> None:
        """Push one indicator sample for objective ``name``."""
        tracker = self.trackers.get(name)
        if tracker is None:
            raise KeyError(f"unknown objective {name!r}")
        t = self.clock() if now is None else float(now)
        with self._lock:
            transition = tracker.observe(value, t)
        self._record(transition)

    # -- registry pull ----------------------------------------------------

    def _registry_value(self, o: Objective, now: float) -> Optional[float]:
        """One FLEET-WIDE sample for ``o.metric``: a replicated engine
        registers one labeled instrument per replica under the same family
        name, so counters sum into the fleet rate, labeled gauges sum, and
        percentiles are computed over every replica's merged samples —
        never just whichever replica registered first."""
        reg = self._registry
        if reg is None:
            return None
        found_kind, insts = reg.find_all(o.metric)
        if not insts:
            return None
        kind = o.kind
        if kind == KIND_AUTO:
            kind = {"counter": KIND_COUNTER_RATE, "gauge": KIND_GAUGE,
                    "histogram": KIND_PERCENTILE}[found_kind]
        if kind == KIND_COUNTER_RATE and found_kind == "counter":
            total = float(sum(i.value for i in insts))
            prev = self._rate_prev.get(o.name)
            self._rate_prev[o.name] = (now, total)
            if prev is None or now <= prev[0]:
                return None  # first tick primes the rate
            return (total - prev[1]) / (now - prev[0])
        if kind == KIND_GAUGE and found_kind == "gauge":
            values = [i.value for i in insts if i.value is not None]
            if not values:
                return None
            return float(values[0]) if len(insts) == 1 else float(sum(values))
        if kind == KIND_PERCENTILE and found_kind == "histogram":
            q = o.percentile
            if len(insts) == 1:
                return insts[0].series.percentiles((q,))[f"p{q:g}"]
            merged = LatencySeries()
            for i in insts:
                merged.extend(i.series.samples())
            return merged.percentiles((q,))[f"p{q:g}"]
        return None

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Sample every resolvable objective once; returns this tick's
        alert transitions (also appended to ``alerts``). Only every
        ``interval``-th call evaluates — the rest return immediately."""
        self._tick_calls += 1
        if (self._tick_calls - 1) % self.interval:
            return []
        t = self.clock() if now is None else float(now)
        transitions = []
        for name, tracker in self.trackers.items():
            src = self._sources.get(name)
            value = (src() if src is not None
                     else self._registry_value(tracker.objective, t))
            if value is None:
                continue
            with self._lock:
                transition = tracker.observe(float(value), t)
            self._record(transition)
            if transition is not None:
                transitions.append(transition)
        return transitions

    # -- export ------------------------------------------------------------

    def firing(self) -> List[str]:
        with self._lock:
            return [n for n, t in self.trackers.items() if t.firing]

    def status(self, now: Optional[float] = None) -> dict:
        """Per-objective live view (the ``/slo`` telemetry endpoint) —
        thread-safe against a concurrently ticking serving loop, like
        every hook the telemetry server calls."""
        t = self.clock() if now is None else float(now)
        out = {}
        with self._lock:
            for name, tracker in self.trackers.items():
                o = tracker.objective
                out[name] = {
                    "metric": o.metric,
                    "objective": f"{o.metric} {o.op} {o.threshold:g} "
                                 f"for {o.target:g} of samples",
                    "firing": tracker.firing,
                    "last_value": tracker.last_value,
                    "samples": tracker.samples,
                    "violations": tracker.violations,
                    "burns": [
                        {"window": w, "factor": f,
                         "burn": b if b is None else round(b, 6)}
                        for (w, f), b in zip(o.windows, tracker.burns(t))
                    ],
                }
            return {
                "objectives": out,
                "firing": [n for n, tr in self.trackers.items()
                           if tr.firing],
                "alerts": len(self.alerts),
            }

    def alerts_bytes(self) -> bytes:
        """Canonical serialization of the alert stream — the
        byte-identical-under-a-seed contract for SLO evaluation."""
        with self._lock:
            alerts = list(self.alerts)
        return (json.dumps(alerts, sort_keys=True,
                           separators=(",", ":")) + "\n").encode()


# -- stock objective sets ------------------------------------------------------


def default_serving_objectives(
    ttft_p99: float = 8.0,
    queue_wait_p99: float = 16.0,
    tokens_per_s_floor: float = 1.0,
    rejected_per_s: float = 0.5,
    windows: Tuple[Tuple[float, float], ...] = ((240.0, 2.0), (60.0, 6.0)),
) -> List[Objective]:
    """The serving SLO set the ROADMAP's ops item asks for: TTFT p99,
    queue-wait p99, a tokens/s floor, and the client-visible rejection
    rate. Thresholds are in the evaluator's CLOCK units (ticks under the
    simulation clock, seconds on a wall server) — tune per deployment."""
    return [
        Objective("serve/ttft_p99", "serving/ttft", ttft_p99,
                  kind=KIND_PERCENTILE, percentile=99.0, windows=windows),
        Objective("serve/queue_wait_p99", "serving/queue_wait",
                  queue_wait_p99, kind=KIND_PERCENTILE, percentile=99.0,
                  windows=windows, event="req/queue"),
        Objective("serve/tokens_per_s", "serving/tokens_emitted_total",
                  tokens_per_s_floor, op=">=", kind=KIND_COUNTER_RATE,
                  windows=windows),
        Objective("serve/rejected_rate", "serving/rejected_total",
                  rejected_per_s, kind=KIND_COUNTER_RATE, windows=windows),
    ]


def default_training_objectives(
    skip_rate: float = 0.25,
    windows: Tuple[Tuple[float, float], ...] = ((64.0, 2.0), (16.0, 4.0)),
) -> List[Objective]:
    """Training-side SLOs: the nonfinite-skip rate (guard-skipped
    micro-batches per host step) — a sustained burn here means the run is
    throwing away data, not surviving a blip. Windows are in STEPS (the
    Estimator ticks the evaluator on the step counter)."""
    return [
        Objective("train/nonfinite_skip_rate", "train/nonfinite_skip_rate",
                  skip_rate, target=0.9, windows=windows,
                  event="train/nonfinite_skip", field="skipped"),
    ]


def load_spec(path_or_dict) -> List[Objective]:
    """Objectives from a JSON spec file (or an already-parsed dict):
    ``{"objectives": [{...Objective fields...}, ...]}`` — the format
    ``examples/slo_check.py`` replays and the README documents."""
    if isinstance(path_or_dict, dict):
        spec = path_or_dict
    else:
        with open(path_or_dict) as f:
            spec = json.load(f)
    objs = spec.get("objectives")
    if not isinstance(objs, list) or not objs:
        raise ValueError("spec needs a non-empty 'objectives' list")
    return [Objective.from_dict(d) for d in objs]
