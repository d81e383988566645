"""Self-healing control plane: an autonomous escalation ladder.

The port of ``gradaccum_tpu/resilience/healer.py`` (host code: a ladder
state machine, locks and futures over the serving engine; no kernel).
The sentinel (``obs/sentinel.py``) detects; the remediation bindings
(``resilience/remediation.py``) gave each anomaly ONE hard-wired action.
This module closes the remaining gap to unattended operation: every
anomaly class gets an ORDERED LADDER of remediations — cheapest
sufficient first — and the :class:`Healer` walks it like an SRE runs a
playbook:

- **fire** → apply the first applicable rung (skipping rungs this
  deployment cannot take: no fleet → no replica drain, fixed pool → no
  pool grow);
- **verification window** — the anomaly must RESOLVE within the rung's
  window (clock units; ticks under the deterministic sim clock) or the
  healer ESCALATES to the next rung. A rung whose ``apply`` raises (a
  refused reconfig, a dead server) escalates immediately instead of
  wedging the ladder;
- **cooldown + flap detector** — a healed anomaly starts a cooldown
  (no re-entry until it passes); ``flap_limit`` heal→refire oscillations
  inside ``flap_window`` FREEZE the ladder and fire the terminal
  ``healer_frozen`` anomaly (severity "page", no automatic remediation)
  — automation must never thrash, so a frozen key stays frozen until an
  operator calls :meth:`Healer.reset`;
- **remediation budget** — at most ``budget_limit`` actions per
  ``budget_window`` per replica (mirroring the server's ``max_requeues``
  contract): an exhausted budget HOLDS the ladder (one ``budget_held``
  transition recorded) until the window slides, rather than letting an
  unhealable anomaly burn unbounded reconfigs;
- **exhaustion** — escalating past the last rung also freezes: the
  ladder is out of ideas, which is exactly when a human must decide.

The healer runs ON the serving loop thread(s): ``ServingServer`` polls
:meth:`poll` right next to the watchdog each iteration (free-running
fleets poll from every replica loop; the healer is internally locked and
its actions — ``request_recover``, ``request_reconfig`` — are the
server's thread-safe entry points, executed under the owning replica's
lock by the loop that claims them). Every transition is a
``healer/transition`` span event and a registry counter, healer-initiated
reconfig specs carry ``initiator="healer"`` so operators can tell
autonomous actions from their own in ``ReconfigResult`` and /metrics, and
the whole ladder state (rung positions, cooldowns, budgets, frozen
flags) snapshots into ``ServingServer.stats()["healer"]`` and the
``healer_frozen`` flight dump — a postmortem shows *why* the healer did
what it did.

Determinism: the healer borrows the sentinel's injectable clock, so a
seeded simulation replays byte-identical ladder decisions.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from gradaccum_tpu_torch.obs import sentinel as obs_sentinel
from gradaccum_tpu_torch.obs import trace as obs_trace
from gradaccum_tpu_torch.resilience import remediation as remediation_lib

Key = Tuple[str, Optional[int]]


class _Ladder:
    """Per-(kind, replica) ladder state."""

    __slots__ = ("rung", "applied_at", "fired_at", "firing", "frozen",
                 "frozen_reason", "cooldown_until", "heals", "escalate_now",
                 "budget_noted", "timeout_noted", "actions_taken")

    def __init__(self):
        self.rung = -1                 # -1 = idle (no rung applied)
        self.applied_at: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.firing = False
        self.frozen = False
        self.frozen_reason: Optional[str] = None
        self.cooldown_until = 0.0
        self.heals: deque = deque()    # heal times (flap detection)
        self.escalate_now = False      # a rung's apply FAILED: don't wait
        self.budget_noted = False      # one budget_held event per hold
        self.timeout_noted = False     # one verify_timeout event per rung
        self.actions_taken = 0         # lifetime actions for this key


def default_ladders(server=None, consensus=None,
                    checkpoint: Optional[str] = None,
                    pool_grow_factor: float = 1.5,
                    max_blocks: Optional[int] = None,
                    ) -> Dict[str, List[remediation_lib.Remediation]]:
    """The stock escalation matrix. Only ladders whose actuator targets are provided are built;
    rungs a deployment cannot take (no fleet, no paging, no admission
    policy) are skipped at runtime by their ``applies`` checks.

    ====================  =============================================
    anomaly               ladder (cheapest sufficient first)
    ====================  =============================================
    ``latency_cliff``     recover+requeue → replica drain → pool grow
    ``stall``             recover+requeue
    ``dead_replica``      targeted recover → replica EXCISE (proof-gated
                          removal + survivor re-dispatch) → replica ADD
                          (provision replacement capacity)
    ``preemption_storm``  governor pin → pool grow
    ``tier_thrash``       governor pin → pool grow
    ``scale_storm``       checkpoint rollback (serving, if ``checkpoint``)
                          / drain consensus (training, if ``consensus``)
    ====================  =============================================

    The ``dead_replica`` ladder is deliberately ordered detect → remove
    → replace: a recover that sticks ends it cheaply; an excise only
    lands when the membership registry can PROVE the member dead (a
    partitioned-but-alive replica refuses the excise and the ladder
    moves past it); the add rung restores fleet width either way.

    ``tier_thrash`` (memory/tiers.py spill churn) shares the
    preemption-storm rungs on purpose: records ping-pong between the
    host and disk rungs because too many requests are being parked,
    so the cures are the same — admit less, or grow the pool so fewer
    victims park at all.
    """
    ladders: Dict[str, List[remediation_lib.Remediation]] = {}
    if server is not None:
        recover = remediation_lib.recover_rung(server)
        drain_rep = remediation_lib.drain_replica_rung(server)
        grow = remediation_lib.pool_grow_rung(
            server, factor=pool_grow_factor, max_blocks=max_blocks)
        ladders[obs_sentinel.LATENCY_CLIFF] = [recover, drain_rep, grow]
        ladders[obs_sentinel.STALL] = [recover]
        ladders[obs_sentinel.DEAD_REPLICA] = [
            recover,
            remediation_lib.excise_replica_rung(server),
            remediation_lib.add_replica_rung(server)]
        ladders[obs_sentinel.PREEMPTION_STORM] = [
            remediation_lib.governor_pin_rung(server), grow]
        ladders[obs_sentinel.TIER_THRASH] = [
            remediation_lib.governor_pin_rung(server), grow]
        if checkpoint is not None:
            ladders[obs_sentinel.SCALE_STORM] = [
                remediation_lib.rollback_rung(server, checkpoint)]
    if consensus is not None:
        ladders.setdefault(obs_sentinel.SCALE_STORM, []).append(
            remediation_lib.drain_rung(consensus))
    return ladders


class Healer:
    """Escalation-ladder driver over one :class:`Sentinel`.

    ``ladders`` maps anomaly kinds to ordered
    :class:`~gradaccum_tpu_torch.resilience.remediation.Remediation` rungs
    (:func:`default_ladders` builds the stock matrix). The healer
    subscribes to the sentinel's fire/resolve lifecycle at construction;
    the serving loop drives time by calling :meth:`poll` each iteration
    (idle iterations included — verification windows must keep expiring
    while the engine has nothing to decode).

    Knobs (clock units = the sentinel clock's): ``verify_window`` ticks
    a rung gets before escalation, ``cooldown`` ticks after a heal
    before the ladder may act on a refire, ``flap_limit`` heals inside
    ``flap_window`` that freeze the key, ``budget_limit`` actions per
    ``budget_window`` per replica. Per-rung ``verify_window``/
    ``cooldown`` overrides win over the healer defaults.
    """

    def __init__(
        self,
        sentinel: obs_sentinel.Sentinel,
        ladders: Dict[str, List[remediation_lib.Remediation]],
        clock: Optional[Callable[[], float]] = None,
        verify_window: float = 8.0,
        cooldown: float = 16.0,
        flap_limit: int = 3,
        flap_window: float = 128.0,
        budget_limit: int = 4,
        budget_window: float = 64.0,
        tracer=None,
        registry=None,
    ):
        if obs_sentinel.HEALER_FROZEN in ladders:
            raise ValueError(
                "healer_frozen is the healer's own terminal signal — "
                "binding a ladder to it would let automation remediate "
                "its own give-up")
        unknown = set(ladders) - set(obs_sentinel.KINDS)
        if unknown:
            raise ValueError(f"ladders for unknown anomaly kinds "
                             f"{sorted(unknown)}")
        for kind, rungs in ladders.items():
            if not rungs:
                raise ValueError(f"empty ladder for {kind!r}")
        self.sentinel = sentinel
        self.ladders = {k: list(v) for k, v in ladders.items()}
        self.clock = clock if clock is not None else sentinel.clock
        self.verify_window = float(verify_window)
        self.cooldown = float(cooldown)
        self.flap_limit = int(flap_limit)
        self.flap_window = float(flap_window)
        self.budget_limit = int(budget_limit)
        self.budget_window = float(budget_window)
        self._tracer = tracer
        self.registry = registry if registry is not None \
            else sentinel.registry
        # RLock: a rung's apply may fire a sentinel anomaly whose hook
        # re-enters the healer on the same thread
        self._lock = threading.RLock()
        self._state: Dict[Key, _Ladder] = {}
        # remediation budget is PER REPLICA across kinds (mirroring the
        # per-request max_requeues contract): one replica's runaway
        # ladder must not starve another's
        self._actions: Dict[Optional[int], deque] = {}
        self.heal_log: List[dict] = []   # fired_at/resolved_at/mttr/rung
        self.actions_total = 0
        self.healed_total = 0
        self.frozen_total = 0
        for kind in self.ladders:
            self.sentinel.on(kind, self._observe_fire)
            self.sentinel.on_resolve(kind, self._observe_resolve)

    def detach(self) -> None:
        """Unsubscribe this healer's lifecycle hooks from its sentinel.
        Required when REPLACING a ladder over the same sentinel
        (``ServingServer.attach_healer`` does it for you) — a detached
        healer otherwise keeps reacting to fires as a ghost: its flap
        detector can trip and page on anomalies the live ladder owns."""
        for kind in self.ladders:
            self.sentinel.off(kind, self._observe_fire)
            self.sentinel.off_resolve(kind, self._observe_resolve)

    @property
    def tracer(self):
        return obs_trace.resolve(self._tracer)

    # -- observability -----------------------------------------------------

    def _event(self, kind: str, replica, reason: str, **extra) -> None:
        tr = self.tracer
        if tr.enabled:
            tr.event("healer/transition", cat="healer", kind=kind,
                     replica=replica, reason=reason, **extra)
        if self.registry is not None:
            self.registry.counter(
                "healer/transitions_total", labels={"reason": reason},
                help="healer ladder transitions",
            ).inc()

    # -- sentinel lifecycle hooks (inline on the detecting thread) ---------

    def _observe_fire(self, anomaly) -> None:
        key = (anomaly.kind, anomaly.replica)
        freeze = False
        with self._lock:
            st = self._state.setdefault(key, _Ladder())
            st.firing = True
            st.fired_at = anomaly.at
            st.budget_noted = False
            if st.rung >= 0 and not st.frozen and st.applied_at is not None:
                # a rung can outlive its episode only through a
                # verify-rejected resolve; if THAT rung's window already
                # lapsed while nothing was firing, this refire is a NEW
                # incident — restart at the cheapest rung instead of
                # escalating past rungs that were never given a chance
                rung = self.ladders[anomaly.kind][st.rung]
                window = (self.verify_window if rung.verify_window is None
                          else rung.verify_window)
                if anomaly.at - st.applied_at >= window:
                    st.rung = -1
                    st.applied_at = None
                    st.escalate_now = False
                    st.timeout_noted = False
            if not st.frozen:
                # flap check: heals that have not aged out of the window
                while st.heals and anomaly.at - st.heals[0] > self.flap_window:
                    st.heals.popleft()
                if len(st.heals) >= self.flap_limit:
                    st.frozen = True
                    st.frozen_reason = "flap"
                    st.rung = -1
                    st.applied_at = None
                    self.frozen_total += 1
                    freeze = True
        self._event(anomaly.kind, anomaly.replica,
                    "flap_freeze" if freeze else "fire")
        if freeze:
            self._fire_frozen(key, "flap")

    _observe_fire.__name__ = "healer_observe"

    def _observe_resolve(self, record) -> None:
        key = (record.kind, record.replica)
        healed = None
        with self._lock:
            st = self._state.get(key)
            if st is None or not st.firing:
                return
            if st.rung >= 0 and not st.frozen:
                rung = self.ladders[record.kind][st.rung]
                if not rung.verify(record):
                    # the rung's own predicate rejects this resolution as
                    # coincidence: keep the window running (a refire will
                    # re-enter; expiry escalates)
                    st.firing = False
                    self._event(record.kind, record.replica,
                                "verify_rejected", rung=rung.name)
                    return
                mttr = record.at - st.fired_at
                st.heals.append(record.at)
                st.cooldown_until = record.at + (
                    self.cooldown if rung.cooldown is None else rung.cooldown)
                healed = {"kind": record.kind, "replica": record.replica,
                          "rung": st.rung, "action": rung.name,
                          "fired_at": st.fired_at, "resolved_at": record.at,
                          "mttr": mttr}
                self.heal_log.append(healed)
                self.healed_total += 1
                st.rung = -1
                st.applied_at = None
                st.escalate_now = False
                st.timeout_noted = False
            st.firing = False
        if healed is not None:
            self._event(record.kind, record.replica, "healed",
                        rung=healed["rung"], action=healed["action"],
                        mttr=round(healed["mttr"], 6))

    _observe_resolve.__name__ = "healer_observe_resolve"

    # -- budget ------------------------------------------------------------

    def _budget_free(self, replica, now: float, pending: int = 0) -> bool:
        """``pending`` counts charges this same poll already planned for
        the replica (across anomaly kinds) — without it, N kinds planned
        in one pass would each see the pre-charge count and together
        overshoot the limit."""
        q = self._actions.setdefault(replica, deque())
        while q and now - q[0] > self.budget_window:
            q.popleft()
        return len(q) + pending < self.budget_limit

    def _charge(self, replica, now: float) -> None:
        self._actions.setdefault(replica, deque()).append(now)
        self.actions_total += 1

    def _refund(self, replica, now: float) -> None:
        """Give back a charge whose rung turned out inapplicable at
        apply time (returned False) — the documented contract is that
        skips are budget-free."""
        q = self._actions.get(replica)
        if q:
            try:
                q.remove(now)
            except ValueError:
                pass
        self.actions_total = max(0, self.actions_total - 1)

    # -- the driver --------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> List[dict]:
        """One ladder pass: apply first rungs for fresh anomalies,
        escalate expired verification windows, freeze exhausted/flapping
        keys. Called by the serving loop each iteration (any thread; the
        healer locks internally). Returns the actions taken by THIS call
        (for tests and the sim driver)."""
        t = self.clock() if now is None else float(now)
        plans = []  # (key, st, rung_index) decided under the lock
        planned: Dict[Optional[int], int] = {}  # same-poll budget holds
        with self._lock:
            for key, st in self._state.items():
                if st.frozen or not st.firing:
                    continue
                kind, replica = key
                ladder = self.ladders[kind]
                if st.rung < 0:
                    if t < st.cooldown_until:
                        continue  # healed recently: let the cooldown pass
                    start = 0
                elif st.escalate_now:
                    start = st.rung + 1
                else:
                    rung = ladder[st.rung]
                    window = (self.verify_window
                              if rung.verify_window is None
                              else rung.verify_window)
                    if t - st.applied_at < window:
                        continue  # verification window still open
                    if not st.timeout_noted:
                        # one transition per expiry, not one per poll — a
                        # budget hold must not flood the span stream
                        st.timeout_noted = True
                        self._event(kind, replica, "verify_timeout",
                                    rung=st.rung, action=rung.name)
                    start = st.rung + 1
                # budget pre-check: with no action possible there is
                # nothing to search or emit (rung skips would repeat
                # every poll for the duration of the hold)
                if not self._budget_free(replica, t,
                                         planned.get(replica, 0)):
                    if not st.budget_noted:
                        st.budget_noted = True
                        self._event(kind, replica, "budget_held",
                                    rung=start,
                                    limit=self.budget_limit,
                                    window=self.budget_window)
                    continue  # hold at the current rung until it frees
                planned[replica] = planned.get(replica, 0) + 1
                plans.append((key, st, start))
            decisions = []
            for key, st, start in plans:
                kind, replica = key
                ladder = self.ladders[kind]
                idx = start
                while idx < len(ladder):
                    rung = ladder[idx]
                    if not rung.applies(self._anomaly_for(key)):
                        self._event(kind, replica, "skip", rung=idx,
                                    action=rung.name)
                        idx += 1
                        continue
                    break
                if idx >= len(ladder):
                    st.frozen = True
                    st.frozen_reason = "exhausted"
                    st.rung = -1
                    st.applied_at = None
                    st.escalate_now = False
                    self.frozen_total += 1
                    decisions.append((key, st, None, None))
                    continue
                self._charge(replica, t)
                st.rung = idx
                st.applied_at = t
                st.escalate_now = False
                st.budget_noted = False
                st.timeout_noted = False
                st.actions_taken += 1
                decisions.append((key, st, idx, ladder[idx]))
        # actions run OUTSIDE the lock: a rung may call back into the
        # sentinel (and through it, into this healer's hooks)
        taken = []
        for key, st, idx, rung in decisions:
            kind, replica = key
            if rung is None:
                self._event(kind, replica, "exhausted_freeze")
                self._fire_frozen(key, "exhausted")
                continue
            anomaly = self._anomaly_for(key)
            try:
                applied = rung.apply(anomaly,
                                     escalate=self._escalate_cb(key, idx))
            except Exception as e:  # noqa: BLE001 — a broken rung must not wedge
                with self._lock:
                    st.escalate_now = True
                self._event(kind, replica, "apply_error", rung=idx,
                            action=rung.name, error=type(e).__name__)
                taken.append({"kind": kind, "replica": replica,
                              "rung": idx, "action": rung.name,
                              "error": type(e).__name__})
                continue
            if not applied:
                # inapplicable after all: refund the charge (skips are
                # budget-free by contract) and escalate straight past it
                # at the next poll
                with self._lock:
                    st.escalate_now = True
                    st.actions_taken -= 1
                    self._refund(replica, t)
                self._event(kind, replica, "skip", rung=idx,
                            action=rung.name)
                continue
            self._event(kind, replica, "apply", rung=idx, action=rung.name)
            taken.append({"kind": kind, "replica": replica, "rung": idx,
                          "action": rung.name})
        return taken

    def _escalate_cb(self, key: Key, idx: int):
        """The async-failure channel handed to each rung's apply: actions
        that only ENQUEUE work (``request_reconfig`` returns a Future the
        loop thread settles later) report a refusal/degrade through this
        instead of raising, and the ladder escalates at the next poll
        exactly as if apply had raised. One-shot and rung-scoped: a
        report landing after the ladder already moved on is ignored."""

        def escalate(reason: str = "async_failure") -> None:
            with self._lock:
                st = self._state.get(key)
                if st is None or st.frozen or st.rung != idx:
                    return
                st.escalate_now = True
            self._event(key[0], key[1], "apply_failed_async", rung=idx,
                        error=str(reason))

        return escalate

    def _anomaly_for(self, key: Key):
        """The live firing record for ``key`` (or a stub if the sentinel
        already dropped it — rungs only read kind/replica)."""
        with self.sentinel._lock:
            rec = self.sentinel._firing.get(key)
        if rec is not None:
            return rec
        return obs_sentinel.Anomaly(key[0], "fire", 0.0, key[1])

    def _fire_frozen(self, key: Key, why: str) -> None:
        kind, replica = key
        self.sentinel.fire(
            obs_sentinel.HEALER_FROZEN, replica=replica,
            detail={"anomaly": kind, "why": why,
                    "ladder": [r.name for r in self.ladders[kind]],
                    "healer": self.status()},
            remediate=False,
        )

    # -- operator surface --------------------------------------------------

    def reset(self, kind: Optional[str] = None,
              replica: Optional[int] = None) -> int:
        """Operator unfreeze: clear frozen/flap state for one kind (all
        replicas when ``replica`` is None) or for every ladder when
        ``kind`` is None, and resolve the matching ``healer_frozen``
        anomalies — but ONLY for replicas with no OTHER ladder still
        frozen (healer_frozen is level-held per replica, so resolving it
        while a second frozen ladder remains would silence the page with
        nothing left to re-raise it). Returns the number of keys reset."""
        n = 0
        with self._lock:
            touched = set()
            for (k, r), st in self._state.items():
                if kind is not None and k != kind:
                    continue
                if replica is not None and r != replica:
                    continue
                if st.frozen or st.heals:
                    n += 1
                st.frozen = False
                st.frozen_reason = None
                st.heals.clear()
                st.rung = -1
                st.applied_at = None
                st.escalate_now = False
                st.budget_noted = False
                st.timeout_noted = False
                st.cooldown_until = 0.0
                touched.add(r)
            still_frozen = {r for (_, r), st in self._state.items()
                            if st.frozen}
            to_resolve = [r for r in touched if r not in still_frozen]
        for r in to_resolve:
            self.sentinel.resolve(obs_sentinel.HEALER_FROZEN, replica=r)
        if n:
            self._event(kind or "*", replica, "reset", keys=n)
        return n

    def frozen(self) -> List[dict]:
        with self._lock:
            return [{"kind": k, "replica": r, "why": st.frozen_reason}
                    for (k, r), st in sorted(
                        self._state.items(),
                        key=lambda kv: (kv[0][0], kv[0][1] is not None,
                                        kv[0][1] or 0))
                    if st.frozen]

    def status(self) -> dict:
        """The whole ladder state, snapshot-able into
        ``ServingServer.stats()["healer"]`` and flight dumps."""
        with self._lock:
            ladders = {}
            for (k, r), st in self._state.items():
                name = k if r is None else f"{k}@{r}"
                ladders[name] = {
                    "firing": st.firing,
                    "rung": st.rung,
                    "action": (None if st.rung < 0
                               else self.ladders[k][st.rung].name),
                    "applied_at": st.applied_at,
                    "cooldown_until": st.cooldown_until,
                    "recent_heals": len(st.heals),
                    "frozen": st.frozen,
                    "frozen_reason": st.frozen_reason,
                    "actions_taken": st.actions_taken,
                }
            budgets = {
                ("engine" if r is None else f"replica {r}"): len(q)
                for r, q in self._actions.items() if q
            }
            return {
                "ladders": ladders,
                "budget_in_window": budgets,
                "actions_total": self.actions_total,
                "healed_total": self.healed_total,
                "frozen_total": self.frozen_total,
                "heals": list(self.heal_log[-8:]),
            }

    def manifest(self) -> dict:
        """Static healer knobs for the engine/fleet export manifest —
        redeploying with these reproduces the ladder policy this server
        was validated at."""
        return {
            "ladders": {k: [r.name for r in rungs]
                        for k, rungs in self.ladders.items()},
            "verify_window": self.verify_window,
            "cooldown": self.cooldown,
            "flap_limit": self.flap_limit,
            "flap_window": self.flap_window,
            "budget_limit": self.budget_limit,
            "budget_window": self.budget_window,
        }
