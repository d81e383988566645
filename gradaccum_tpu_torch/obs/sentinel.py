"""Anomaly sentinel: rolling baselines, heartbeat leases, remediation (the
port of ``gradaccum_tpu/obs/sentinel.py``: every kind, the same records,
so an anomaly log equals JAX's byte for byte).

The SLO evaluator (``obs/slo.py``) answers "are we meeting explicit
objectives"; the sentinel answers the complementary question — *does the
system look like itself?* — and closes the loop by invoking remediation.
It keeps per-replica rolling baselines (EWMA mean + EWMA absolute
deviation, a streaming stand-in for median/MAD that needs O(1) state) and
a tick-heartbeat lease per replica, and detects four anomaly classes:

- ``latency_cliff`` — a tick duration many deviations above its replica's
  baseline, sustained for ``cliff_consecutive`` ticks (one GC pause or
  scheduler burp never fires it);
- ``stall`` / ``dead_replica`` — the heartbeat lease expired while the
  engine (or one replica of a fleet) last reported itself busy: the
  ROADMAP's "distinguish slow from gone" precursor;
- ``scale_storm`` — the dynamic loss scale halved ``storm_halvings``
  times inside one window (a run drowning in overflow, not riding one);
- ``engine_fault`` — edge-triggered note from the serving fault handler,
  so faults land in the same anomaly log operators read;
- ``degenerate_draft`` — a speculative engine's draft accept rate pinned
  below the floor: speculation has become pure overhead (the per-replica
  accept-rate feed comes from the serving loop, so one replica's stale
  draft is visible even when the fleet average looks fine);
- ``preemption_storm`` — an admission-policy engine's windowed preemption
  rate pinned above the ceiling: optimistic admission is thrashing (every
  admitted request evicts another — swap/re-prefill churn instead of
  tokens). The policy's own governor backs admission off first; this
  anomaly is the fleet-visible escalation, and its stock remediation
  routes the replica through recover + bounded requeue.
- ``tier_thrash`` — a tiered-swap engine's windowed demotion rate pinned
  above the ceiling: parked records are ping-ponging between the host
  and disk rungs of the memory ladder (``memory/tiers.py``) faster than
  they are being resumed — swap has stopped being cheaper than
  re-prefill, and the host rung (``swap_max_bytes``) should grow or
  admission should back off.

- ``healer_frozen`` — terminal, raised BY the self-healing escalation
  ladder (``resilience/healer.py``) when it froze itself (flap or rung
  exhaustion): severity "page", no automatic remediation — a human
  resets the ladder.

Every NEW anomaly lands as a ``sentinel/anomaly`` span event, a flight
recorder dump (``sentinel-<kind>``), and a registry counter bump, then
runs the remediation callbacks registered for its kind — which are bound
to the EXISTING recovery contract (``ServingServer.request_recover`` →
recover + bounded requeue, ``DrainConsensus.request`` → agreed drain; see
``resilience/remediation.py``). Anomalies are level-held: a kind/replica
pair fires once and must resolve (heartbeat resumes, latency returns to
baseline) before it can fire again. The lifecycle is observable at both
edges: :meth:`Sentinel.on` hooks the fire, :meth:`Sentinel.on_resolve`
the resolve (what the healer's verification windows consume), every
record carries a ``severity`` (per-kind defaults in :data:`SEVERITY`,
overridable), and :meth:`Sentinel.ack` lets an operator acknowledge a
firing anomaly without resolving it.

Determinism: like the tracer and the SLO evaluator, the clock is
injectable and anomaly records carry only sample-derived fields, so a
seeded simulation produces a byte-identical anomaly log.

Replica fleets (``serving/replicated.py``) feed the per-replica leases and
``fire`` a fleet-lease ``dead_replica`` from outside; live reconfiguration
runs inside ``maintenance``. The healer (``resilience/healer.py``) rides
``on``/``on_resolve`` and borrows this sentinel's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from gradaccum_tpu_torch.obs import trace as obs_trace

STALL = "stall"
DEAD_REPLICA = "dead_replica"
LATENCY_CLIFF = "latency_cliff"
SCALE_STORM = "scale_storm"
ENGINE_FAULT = "engine_fault"
DEGENERATE_DRAFT = "degenerate_draft"
PREEMPTION_STORM = "preemption_storm"
TIER_THRASH = "tier_thrash"
# terminal: the self-healing ladder (resilience/healer.py) froze itself
# (flap or rung exhaustion) and is waiting for an operator — automation
# must never thrash, so this kind has NO automatic remediation
HEALER_FROZEN = "healer_frozen"

KINDS = (STALL, DEAD_REPLICA, LATENCY_CLIFF, SCALE_STORM, ENGINE_FAULT,
         DEGENERATE_DRAFT, PREEMPTION_STORM, TIER_THRASH, HEALER_FROZEN)

# default severity per kind: "warning" degrades service, "critical"
# threatens it, "page" demands a human NOW (the ladder already gave up)
SEVERITY = {
    STALL: "critical",
    DEAD_REPLICA: "critical",
    LATENCY_CLIFF: "warning",
    SCALE_STORM: "critical",
    ENGINE_FAULT: "warning",
    DEGENERATE_DRAFT: "warning",
    PREEMPTION_STORM: "warning",
    TIER_THRASH: "warning",
    HEALER_FROZEN: "page",
}


class RollingBaseline:
    """EWMA mean + EWMA absolute deviation — a robust-ish streaming
    baseline in two floats. ``score(x)`` is the deviation multiple of
    ``x`` over the mean (deviation units, not strict sigmas)."""

    __slots__ = ("alpha", "mean", "dev", "n")

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.dev = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        x = float(x)
        if self.mean is None:
            self.mean = x
        else:
            # deviation against the PRE-update mean, so a level shift
            # registers as deviation before the mean chases it
            a = self.alpha
            self.dev = (1 - a) * self.dev + a * abs(x - self.mean)
            self.mean = (1 - a) * self.mean + a * x
        self.n += 1

    def score(self, x: float) -> float:
        if self.mean is None:
            return 0.0
        # the floor keeps a near-zero-variance baseline (idle ticks all
        # identical) from turning the first normal wobble into infinity
        denom = max(self.dev, abs(self.mean) * 1e-3, 1e-9)
        return (float(x) - self.mean) / denom


@dataclasses.dataclass
class Anomaly:
    """One anomaly-log record (fire / ack / resolve transition)."""

    kind: str
    state: str  # "fire" | "ack" | "resolve"
    at: float
    replica: Optional[int] = None
    detail: Dict[str, object] = dataclasses.field(default_factory=dict)
    severity: str = "warning"
    acked: bool = False  # set on the FIRING record when an operator acks

    def to_dict(self) -> dict:
        return {"kind": self.kind, "state": self.state, "at": self.at,
                "replica": self.replica, "severity": self.severity,
                "acked": self.acked, "detail": dict(self.detail)}


class Sentinel:
    """Baseline keeper, lease checker, and remediation dispatcher.

    Feeding (all host-side, all cheap):

    - ``heartbeat(replica=, tick=, busy=)`` once per clean tick;
    - ``observe_tick(duration, replica=)`` with the tick's wall cost;
    - ``observe_scale(scale)`` with each loss-scale sample;
    - ``note_fault(...)`` from a fault handler (edge-triggered record —
      remediation is NOT run for it; the caller's own recovery already
      is the remediation).

    ``check(now=)`` evaluates the leases; the serving loop calls it each
    iteration, and ``start()`` runs it on a background thread every
    ``check_interval`` seconds as the backstop for a loop that stopped
    iterating (a wedged tick also trips the server's watchdog).

    Thread-safety: one lock around all mutable state — feeders (engine
    loop, replica pool threads) and the checker thread may interleave.
    """

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        tracer=None,
        flight=None,
        registry=None,
        lease: float = 5.0,
        cliff_score: float = 8.0,
        cliff_warmup: int = 8,
        cliff_consecutive: int = 2,
        storm_halvings: int = 3,
        storm_window: float = 64.0,
        accept_floor: float = 0.1,
        accept_warmup: int = 8,
        accept_consecutive: int = 8,
        preempt_ceiling: float = 0.5,
        preempt_warmup: int = 8,
        preempt_consecutive: int = 8,
        thrash_ceiling: float = 0.5,
        thrash_warmup: int = 8,
        thrash_consecutive: int = 8,
        check_interval: Optional[float] = None,
        severity: Optional[Dict[str, str]] = None,
    ):
        if clock is None:
            t0 = time.monotonic()
            clock = lambda: time.monotonic() - t0
        self.clock = clock
        self._tracer = tracer
        self.flight = flight
        self.registry = registry
        self.lease = float(lease)
        self.cliff_score = float(cliff_score)
        self.cliff_warmup = int(cliff_warmup)
        self.cliff_consecutive = int(cliff_consecutive)
        self.storm_halvings = int(storm_halvings)
        self.storm_window = float(storm_window)
        self.accept_floor = float(accept_floor)
        self.accept_warmup = int(accept_warmup)
        self.accept_consecutive = int(accept_consecutive)
        self.preempt_ceiling = float(preempt_ceiling)
        self.preempt_warmup = int(preempt_warmup)
        self.preempt_consecutive = int(preempt_consecutive)
        self.thrash_ceiling = float(thrash_ceiling)
        self.thrash_warmup = int(thrash_warmup)
        self.thrash_consecutive = int(thrash_consecutive)
        self.check_interval = check_interval
        self._lock = threading.Lock()
        # replica key (None = the single engine) -> lease state
        self._hb: Dict[Optional[int], Tuple[float, Optional[int], bool]] = {}
        self._tick_base: Dict[Optional[int], RollingBaseline] = {}
        self._cliff_run: Dict[Optional[int], int] = {}
        # latency_cliff samples dropped because the replica's heartbeat
        # lease was already paging (stall/dead_replica) — one silence must
        # not double-page as two anomalies
        self.deduped_cliffs = 0
        self._scales: deque = deque()  # (t, scale)
        self._accept_n: Dict[Optional[int], int] = {}
        self._accept_run: Dict[Optional[int], int] = {}
        self._preempt_n: Dict[Optional[int], int] = {}
        self._preempt_run: Dict[Optional[int], int] = {}
        self._thrash_n: Dict[Optional[int], int] = {}
        self._thrash_run: Dict[Optional[int], int] = {}
        self._severity = dict(SEVERITY)
        if severity:
            unknown = set(severity) - set(KINDS)
            if unknown:
                raise ValueError(f"severity overrides for unknown kinds "
                                 f"{sorted(unknown)} (not in {KINDS})")
            self._severity.update(severity)
        self._remedies: Dict[str, List[Callable[[Anomaly], None]]] = {}
        self._resolve_hooks: Dict[str, List[Callable[[Anomaly], None]]] = {}
        self._firing: Dict[Tuple[str, Optional[int]], Anomaly] = {}
        self.anomalies: List[Anomaly] = []  # the log (fire + resolve)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # planned-maintenance depth: lease checks pause while > 0 (a live
        # reconfiguration stops every heartbeat on purpose — that silence
        # must not read as stall/dead_replica)
        self._maintenance = 0

    @property
    def tracer(self):
        return obs_trace.resolve(self._tracer)

    # -- remediation registry ---------------------------------------------

    def on(self, kind: str, callback: Callable[[Anomaly], None]) -> "Sentinel":
        """Register ``callback(anomaly)`` for ``kind`` (or ``"*"`` for
        every kind). Callbacks run inline on the detecting thread; an
        exception is recorded on the tracer and swallowed — a broken
        remediation must not kill the detector."""
        if kind != "*" and kind not in KINDS:
            raise ValueError(f"unknown anomaly kind {kind!r} (not in {KINDS})")
        self._remedies.setdefault(kind, []).append(callback)
        return self

    def on_resolve(self, kind: str,
                   callback: Callable[[Anomaly], None]) -> "Sentinel":
        """Register ``callback(resolve_record)`` for ``kind`` (or ``"*"``),
        run when a firing anomaly of that kind RESOLVES — the other half of
        the lifecycle :meth:`on` covers. Same contract as remediation
        callbacks: inline on the resolving thread, exceptions recorded on
        the tracer and swallowed (a broken hook must not block the
        resolve). The self-healing ladder (``resilience/healer.py``) is
        the primary consumer: a resolve inside a rung's verification
        window is what distinguishes a healed anomaly from one that needs
        escalation."""
        if kind != "*" and kind not in KINDS:
            raise ValueError(f"unknown anomaly kind {kind!r} (not in {KINDS})")
        self._resolve_hooks.setdefault(kind, []).append(callback)
        return self

    def off(self, kind: str, callback) -> None:
        """Remove a callback registered with :meth:`on` (a no-op when it
        was never registered) — what lets a replaced healer detach its
        lifecycle hooks instead of reacting as a ghost ladder."""
        with self._lock:
            lst = self._remedies.get(kind)
            if lst and callback in lst:
                lst.remove(callback)

    def off_resolve(self, kind: str, callback) -> None:
        """Remove a callback registered with :meth:`on_resolve`."""
        with self._lock:
            lst = self._resolve_hooks.get(kind)
            if lst and callback in lst:
                lst.remove(callback)

    # -- transitions -------------------------------------------------------

    def _fire(self, kind: str, replica: Optional[int], detail: dict,
              now: float, remediate: bool = True) -> Optional[Anomaly]:
        key = (kind, replica)
        with self._lock:
            if key in self._firing:
                return None  # level-held: already firing
            anomaly = Anomaly(kind, "fire", float(now), replica, detail,
                              severity=self._severity.get(kind, "warning"))
            self._firing[key] = anomaly
            self.anomalies.append(anomaly)
            remedies = (self._remedies.get(kind, [])
                        + self._remedies.get("*", []))
        tr = self.tracer
        if tr.enabled:
            tr.event("sentinel/anomaly", cat="sentinel", kind=kind,
                     state="fire", replica=replica, **detail)
        if self.registry is not None:
            self.registry.counter(
                "sentinel/anomalies_total", labels={"kind": kind},
                help="sentinel anomaly firings",
            ).inc()
        if self.flight is not None:
            try:  # the anomaly is the story; a failed postmortem is not
                self.flight.dump(f"sentinel-{kind}",
                                 extra=anomaly.to_dict())
            except Exception:  # noqa: BLE001
                pass
        if remediate:
            for cb in remedies:
                name = getattr(cb, "__name__", repr(cb))
                try:
                    cb(anomaly)
                    if tr.enabled:
                        tr.event("sentinel/remediation", cat="sentinel",
                                 kind=kind, replica=replica, action=name)
                except Exception as e:  # noqa: BLE001
                    if tr.enabled:
                        tr.event("sentinel/remediation", cat="sentinel",
                                 kind=kind, replica=replica, action=name,
                                 error=type(e).__name__)
        return anomaly

    def _resolve(self, kind: str, replica: Optional[int], now: float,
                 detail: Optional[dict] = None) -> None:
        key = (kind, replica)
        with self._lock:
            if key not in self._firing:
                return
            fired = self._firing.pop(key)
            record = Anomaly(kind, "resolve", float(now), replica,
                             detail or {}, severity=fired.severity)
            self.anomalies.append(record)
            hooks = (self._resolve_hooks.get(kind, [])
                     + self._resolve_hooks.get("*", []))
        tr = self.tracer
        if tr.enabled:
            tr.event("sentinel/anomaly", cat="sentinel", kind=kind,
                     state="resolve", replica=replica, **(detail or {}))
        for cb in hooks:
            try:
                cb(record)
            except Exception as e:  # noqa: BLE001 — a broken hook must not block
                if tr.enabled:
                    tr.event("sentinel/resolve_hook", cat="sentinel",
                             kind=kind, replica=replica,
                             error=type(e).__name__)

    # -- external detectors (the healer, operator tooling) -----------------

    def fire(self, kind: str, replica: Optional[int] = None,
             detail: Optional[dict] = None, remediate: bool = True,
             now: Optional[float] = None) -> Optional["Anomaly"]:
        """Raise an anomaly from OUTSIDE the sentinel's own detectors —
        same level-held contract, span event, flight dump, counter and
        (optionally) remediation dispatch as an internal fire. The
        self-healing ladder uses this for its terminal ``healer_frozen``
        signal; tests use it to drive remediation paths directly. Returns
        the record, or None when the kind/replica pair was already
        firing."""
        if kind not in KINDS:
            raise ValueError(f"unknown anomaly kind {kind!r} (not in {KINDS})")
        t = self.clock() if now is None else float(now)
        return self._fire(kind, replica, dict(detail or {}), t,
                          remediate=remediate)

    def resolve(self, kind: str, replica: Optional[int] = None,
                detail: Optional[dict] = None,
                now: Optional[float] = None) -> None:
        """Resolve a firing anomaly from outside (the counterpart of
        :meth:`fire`; a no-op when nothing is firing)."""
        t = self.clock() if now is None else float(now)
        self._resolve(kind, replica, t, detail)

    def is_firing(self, kind: str, replica: Optional[int] = None) -> bool:
        with self._lock:
            return (kind, replica) in self._firing

    def ack(self, kind: str, replica: Optional[int] = None,
            by: str = "operator", now: Optional[float] = None) -> bool:
        """Acknowledge a FIRING anomaly: the operator has seen it and owns
        it. Records an ``ack`` transition in the anomaly log (and marks
        the firing record), without resolving — the level stays held until
        the underlying signal clears. Remediation/resolve hooks do not
        run for acks. Returns False when nothing was firing."""
        t = self.clock() if now is None else float(now)
        key = (kind, replica)
        with self._lock:
            fired = self._firing.get(key)
            if fired is None:
                return False
            fired.acked = True
            self.anomalies.append(
                Anomaly(kind, "ack", t, replica, {"by": by},
                        severity=fired.severity, acked=True))
        tr = self.tracer
        if tr.enabled:
            tr.event("sentinel/anomaly", cat="sentinel", kind=kind,
                     state="ack", replica=replica, by=by)
        return True

    # -- feeders -----------------------------------------------------------

    def heartbeat(self, replica: Optional[int] = None,
                  tick: Optional[int] = None, busy: bool = True,
                  now: Optional[float] = None) -> None:
        """One clean tick happened on ``replica`` (None = the single
        engine). ``busy=False`` parks the lease (an idle engine is not
        stalled). A resumed heartbeat auto-resolves that replica's
        stall/dead anomaly."""
        t = self.clock() if now is None else float(now)
        with self._lock:
            self._hb[replica] = (t, tick, bool(busy))
        kind = STALL if replica is None else DEAD_REPLICA
        self._resolve(kind, replica, t, {"tick": tick})

    def observe_tick(self, duration: float, replica: Optional[int] = None,
                     now: Optional[float] = None) -> None:
        """Feed one tick's duration into the replica's rolling baseline;
        fires ``latency_cliff`` after ``cliff_consecutive`` warmed samples
        beyond ``cliff_score`` deviations. Samples inside a
        :meth:`maintenance` window are DROPPED entirely: a reconfig's
        quiesce/rebuild ticks (pool teardown, re-compile at the new
        shape) are planned cost, and feeding them would poison the
        baseline into masking — or worse, firing — a cliff right after
        the pool resize."""
        t = self.clock() if now is None else float(now)
        with self._lock:
            if self._maintenance:
                return
            lease_kind = STALL if replica is None else DEAD_REPLICA
            if (lease_kind, replica) in self._firing:
                # this replica's silence is ALREADY paging as a lease
                # expiry — the giant duration sample a wedged loop
                # eventually reports is the same cause, and firing a
                # cliff on top would double-page it (and poison the
                # baseline against the replica's eventual recovery)
                self._cliff_run[replica] = 0
                self.deduped_cliffs += 1
                return
            base = self._tick_base.get(replica)
            if base is None:
                base = self._tick_base[replica] = RollingBaseline()
            warmed = base.n >= self.cliff_warmup
            score = base.score(duration) if warmed else 0.0
            cliff = warmed and score >= self.cliff_score
            if cliff:
                run = self._cliff_run.get(replica, 0) + 1
                self._cliff_run[replica] = run
                baseline = base.mean
                # a cliff sample must not feed the baseline: two slow ticks
                # would drag the EWMA up and mask the third
            else:
                run = self._cliff_run[replica] = 0
                base.update(duration)
        if cliff and run >= self.cliff_consecutive:
            self._fire(LATENCY_CLIFF, replica, {
                "duration": float(duration),
                "baseline": round(float(baseline), 9),
                "score": round(float(score), 3),
                "consecutive": run,
            }, t)
        elif not cliff:
            self._resolve(LATENCY_CLIFF, replica, t)

    def observe_scale(self, scale: float, now: Optional[float] = None) -> None:
        """Feed one dynamic-loss-scale sample; ``storm_halvings`` drops
        within ``storm_window`` clock units fire ``scale_storm``."""
        t = self.clock() if now is None else float(now)
        with self._lock:
            self._scales.append((t, float(scale)))
            cutoff = t - self.storm_window
            while self._scales and self._scales[0][0] <= cutoff:
                self._scales.popleft()
            halvings = sum(
                1 for i in range(1, len(self._scales))
                if self._scales[i][1] < self._scales[i - 1][1]
            )
        if halvings >= self.storm_halvings:
            self._fire(SCALE_STORM, None,
                       {"halvings": halvings, "scale": float(scale)}, t)
        else:
            self._resolve(SCALE_STORM, None, t)

    def observe_accept(self, rate: Optional[float],
                       replica: Optional[int] = None,
                       now: Optional[float] = None) -> None:
        """Feed one speculative engine's recent draft accept fraction
        (None = no speculation this tick, ignored). A draft whose
        acceptances sit below ``accept_floor`` for ``accept_consecutive``
        warmed samples fires ``degenerate_draft`` — speculation is then
        pure overhead (k draft steps plus a k+1-wide verify per emitted
        token), and an operator should shrink k, refresh the draft, or
        turn speculation off on that replica. Recovery above the floor
        auto-resolves the anomaly."""
        if rate is None:
            return
        t = self.clock() if now is None else float(now)
        with self._lock:
            n = self._accept_n.get(replica, 0) + 1
            self._accept_n[replica] = n
            low = n > self.accept_warmup and float(rate) < self.accept_floor
            run = self._accept_run.get(replica, 0) + 1 if low else 0
            self._accept_run[replica] = run
        if low and run >= self.accept_consecutive:
            self._fire(DEGENERATE_DRAFT, replica,
                       {"accept_rate": round(float(rate), 4),
                        "floor": self.accept_floor}, t)
        elif not low:
            self._resolve(DEGENERATE_DRAFT, replica, t)

    def observe_preemptions(self, rate: Optional[float],
                            replica: Optional[int] = None,
                            now: Optional[float] = None) -> None:
        """Feed one admission-policy engine's recent preemption rate
        (preemptions/tick over the serving metrics' 64-tick window; None
        = no admission plane, ignored). A rate pinned above
        ``preempt_ceiling`` for ``preempt_consecutive`` warmed samples
        fires ``preemption_storm`` — the pool is churning evictions
        instead of emitting tokens, and an operator should grow blocks,
        raise the quantile, or fall back to reserve admission. Recovery
        below the ceiling auto-resolves, same level-held contract as
        every other kind."""
        if rate is None:
            return
        t = self.clock() if now is None else float(now)
        with self._lock:
            n = self._preempt_n.get(replica, 0) + 1
            self._preempt_n[replica] = n
            high = (n > self.preempt_warmup
                    and float(rate) > self.preempt_ceiling)
            run = self._preempt_run.get(replica, 0) + 1 if high else 0
            self._preempt_run[replica] = run
        if high and run >= self.preempt_consecutive:
            self._fire(PREEMPTION_STORM, replica,
                       {"preemption_rate": round(float(rate), 4),
                        "ceiling": self.preempt_ceiling}, t)
        elif not high:
            self._resolve(PREEMPTION_STORM, replica, t)

    def observe_tier_spills(self, rate: Optional[float],
                            replica: Optional[int] = None,
                            now: Optional[float] = None) -> None:
        """Feed one tiered-swap engine's recent demotion rate
        (host→disk demotions/tick over the serving metrics' 64-tick
        window; None = no tiered store, ignored). A rate pinned above
        ``thrash_ceiling`` for ``thrash_consecutive`` warmed samples
        fires ``tier_thrash`` — the memory ladder is shuttling parked
        records between rungs faster than resumes drain them, so swap
        has stopped being cheaper than re-prefill. An operator should
        grow the host rung (``swap_max_bytes``), grow the pool, or back
        admission off. Recovery below the ceiling auto-resolves, same
        level-held contract as every other kind."""
        if rate is None:
            return
        t = self.clock() if now is None else float(now)
        with self._lock:
            n = self._thrash_n.get(replica, 0) + 1
            self._thrash_n[replica] = n
            high = (n > self.thrash_warmup
                    and float(rate) > self.thrash_ceiling)
            run = self._thrash_run.get(replica, 0) + 1 if high else 0
            self._thrash_run[replica] = run
        if high and run >= self.thrash_consecutive:
            self._fire(TIER_THRASH, replica,
                       {"demotion_rate": round(float(rate), 4),
                        "ceiling": self.thrash_ceiling}, t)
        elif not high:
            self._resolve(TIER_THRASH, replica, t)

    def note_fault(self, error: str = "", replica: Optional[int] = None,
                   now: Optional[float] = None) -> None:
        """Edge-triggered fault record from a fault handler. Remediation
        is deliberately NOT run — the caller (the server's recover/requeue
        path) IS the remediation; this puts the fault in the anomaly log
        and immediately clears the level so the next fault records too."""
        t = self.clock() if now is None else float(now)
        self._fire(ENGINE_FAULT, replica, {"error": error}, t,
                   remediate=False)
        self._resolve(ENGINE_FAULT, replica, t)

    # -- planned maintenance ----------------------------------------------

    @contextlib.contextmanager
    def maintenance(self):
        """Pause lease-expiry checks AND tick-baseline feeding across a
        PLANNED interruption (live reconfiguration, checkpoint swap):
        every loop stops heartbeating while the engine rebuilds — that
        silence must not fire stall/dead_replica — and the rebuild's own
        tick costs (:meth:`observe_tick` samples that straddle the
        quiesce) must not be absorbed into the latency baselines, or the
        first post-resize ticks read as a false ``latency_cliff``.
        Reentrant. On exit, every lease restarts at the current clock so
        the maintenance window itself never counts against the next
        check."""
        with self._lock:
            self._maintenance += 1
        try:
            yield self
        finally:
            now = self.clock()
            with self._lock:
                self._maintenance -= 1
                if self._maintenance == 0:
                    self._hb = {r: (now, tick, busy)
                                for r, (_, tick, busy) in self._hb.items()}

    # -- the lease check ---------------------------------------------------

    def check(self, now: Optional[float] = None) -> List[Anomaly]:
        """Evaluate heartbeat leases; returns anomalies fired by THIS
        call. A replica whose last heartbeat said ``busy`` and is older
        than ``lease`` is stalled (single engine) or dead (fleet). A
        no-op inside a :meth:`maintenance` window."""
        t = self.clock() if now is None else float(now)
        with self._lock:
            if self._maintenance:
                return []
            expired = [
                (replica, hb_t, tick)
                for replica, (hb_t, tick, busy) in self._hb.items()
                if busy and t - hb_t > self.lease
            ]
        fired = []
        for replica, hb_t, tick in expired:
            kind = STALL if replica is None else DEAD_REPLICA
            a = self._fire(kind, replica, {
                "last_heartbeat": float(hb_t), "last_tick": tick,
                "lease": self.lease,
            }, t)
            if a is not None:
                fired.append(a)
        return fired

    # -- background checker ------------------------------------------------

    def start(self) -> "Sentinel":
        """Run ``check`` every ``check_interval`` seconds on a daemon
        thread — the backstop for a serving loop wedged inside a tick
        (which cannot reach its own per-iteration check)."""
        if self.check_interval is None:
            raise ValueError("start() needs check_interval")
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.check_interval):
                try:
                    self.check()
                except Exception:  # noqa: BLE001 — the checker must survive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="obs-sentinel")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- export ------------------------------------------------------------

    def firing(self) -> List[Tuple[str, Optional[int]]]:
        with self._lock:
            return sorted(self._firing, key=lambda k: (k[0], k[1] is not None,
                                                       k[1] or 0))

    def status(self) -> dict:
        """Live view for the telemetry plane / operator tooling."""
        with self._lock:
            hb = {
                ("engine" if r is None else f"replica {r}"): {
                    "at": t, "tick": tick, "busy": busy,
                }
                for r, (t, tick, busy) in self._hb.items()
            }
            baselines = {
                ("engine" if r is None else f"replica {r}"): {
                    "mean": None if b.mean is None else round(b.mean, 9),
                    "dev": round(b.dev, 9), "samples": b.n,
                }
                for r, b in self._tick_base.items()
            }
            n_anomalies = len(self.anomalies)
        return {
            "firing": [{"kind": k, "replica": r,
                        "severity": self._severity.get(k, "warning")}
                       for k, r in self.firing()],
            "heartbeats": hb,
            "tick_baselines": baselines,
            "anomalies": n_anomalies,
        }

    def anomalies_bytes(self) -> bytes:
        """Canonical serialization of the anomaly log (fires + resolves)
        — byte-identical across seeded runs under a deterministic clock."""
        with self._lock:
            records = [a.to_dict() for a in self.anomalies]
        return (json.dumps(records, sort_keys=True,
                           separators=(",", ":")) + "\n").encode()
