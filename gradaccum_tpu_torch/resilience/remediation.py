"""Standard remediation bindings: sentinel anomaly → existing contract.

The port of the first half of ``gradaccum_tpu/resilience/remediation.py``.
The obs sentinel (``obs/sentinel.py``) detects; this module decides what
detection DOES, by binding anomaly kinds to the recovery machinery that
already exists — never a new side channel:

- :func:`recover_and_requeue` routes through
  :meth:`~gradaccum_tpu_torch.serving.server.ServingServer.request_recover`,
  i.e. the engine-fault path (``Engine.recover`` → bounded requeue →
  flight dump) executed on the loop thread where the engine lock is safe;
- :func:`request_drain` marks this host preempted on a
  :class:`~gradaccum_tpu_torch.resilience.preemption.DrainConsensus`, so the
  next ``decide()`` round agrees a cluster-wide drain to a common step —
  the same path a SIGTERM takes;
- :func:`request_reconfig` routes through
  :meth:`~gradaccum_tpu_torch.serving.server.ServingServer.request_reconfig`,
  a live reconfiguration (``serving/reconfig.py``) on the loop thread.

:func:`bind_default_remediations` wires the stock matrix: latency cliffs,
stalls, dead replicas, preemption storms and tier thrash recover and
requeue; a loss-scale storm drains the training job.

**Escalation-ladder rungs.** The self-healing ladder
(``resilience/healer.py``) needs more than fire-and-forget callbacks: a
rung must know whether it APPLIES to this deployment (draining a replica
needs a fleet; growing a pool needs paging), how long the anomaly gets to
RESOLVE before the ladder escalates past it, and how to VERIFY the heal
beyond "the level dropped". :class:`Remediation` packages one rung — name,
apply, applicability, verify predicate, per-rung window and cooldown
overrides — and the ``*_rung`` factories bind the stock actuators: the
recover/requeue contract, replica drain, excise and add and the pool resize
through ``serving/reconfig.py`` (specs tagged ``initiator="healer"`` so
operators can tell autonomous actions from their own), the admission thrash
governor's pin, the checkpoint rollback and the drain consensus. Each
reaches the server's existing entry points (``request_recover``,
``request_reconfig``) or the engine's governor; none is a new side channel.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional

from gradaccum_tpu_torch.obs import sentinel as obs_sentinel


def recover_and_requeue(server):
    """Remediation callback: ask ``server`` (a :class:`ServingServer`) to
    run its engine-fault recovery at the next loop iteration."""

    def remedy(anomaly):
        who = "" if anomaly.replica is None else f" replica {anomaly.replica}"
        # the replica rides along so a server that runs one loop per
        # replica can route the recovery to the anomalous one (the lockstep
        # server recovers the whole engine and ignores it)
        server.request_recover(f"sentinel:{anomaly.kind}{who}",
                               replica=anomaly.replica)

    remedy.__name__ = "recover_and_requeue"
    return remedy


def request_drain(consensus):
    """Remediation callback: mark this host preempted on ``consensus`` (a
    :class:`DrainConsensus`) — the next decide() round agrees the drain
    exactly as if SIGTERM had arrived here."""

    def remedy(anomaly):
        consensus.request()

    remedy.__name__ = "request_drain"
    return remedy


def request_reconfig(server, spec_fn):
    """Remediation callback: ask ``server`` (a :class:`ServingServer`) to
    run a live reconfiguration at its next loop iteration. ``spec_fn(anomaly)``
    builds the :class:`~gradaccum_tpu_torch.serving.reconfig.ReconfigSpec`
    (None skips), e.g. a pool grow on a preemption storm::

        sentinel.on(obs_sentinel.PREEMPTION_STORM,
                    remediation.request_reconfig(
                        server, lambda a: reconfig.pool_resize(BIGGER)))

    It runs under the engine lock with the watchdog and the sentinel's
    leases suspended: the quiesce -> park -> rebuild -> resume contract an
    operator's reconfiguration takes."""

    def remedy(anomaly):
        spec = spec_fn(anomaly)
        if spec is not None:
            server.request_reconfig(spec)

    remedy.__name__ = "request_reconfig"
    return remedy


def bind_default_remediations(sentinel, server=None, consensus=None):
    """The stock remediation matrix. Only the bindings whose target is
    provided are installed; returns ``sentinel`` for chaining.

    ========================= =====================================
    anomaly                   remediation
    ========================= =====================================
    ``latency_cliff``         ``server`` recover + bounded requeue
    ``stall``                 ``server`` recover + bounded requeue
    ``dead_replica``          ``server`` recover + bounded requeue
    ``preemption_storm``      ``server`` recover + bounded requeue
    ``tier_thrash``           ``server`` recover + bounded requeue
    ``scale_storm``           ``consensus`` drain request
    ``engine_fault``          (none — the fault handler already ran)
    ========================= =====================================

    ``preemption_storm`` rides the same recover path on purpose: a pool
    churning evictions holds half-finished streams hostage; recover
    releases every slot and the bounded requeue replays them through the
    (by then governed) admission gate.
    """
    if server is not None:
        remedy = recover_and_requeue(server)
        for kind in (obs_sentinel.LATENCY_CLIFF, obs_sentinel.STALL,
                     obs_sentinel.DEAD_REPLICA,
                     obs_sentinel.PREEMPTION_STORM,
                     obs_sentinel.TIER_THRASH):
            sentinel.on(kind, remedy)
    if consensus is not None:
        sentinel.on(obs_sentinel.SCALE_STORM, request_drain(consensus))
    return sentinel


# -- escalation-ladder rungs --------------------------------------------------


class Remediation:
    """One rung of an escalation ladder (``resilience/healer.py``).

    ``apply(anomaly)`` performs the action; it may return ``False`` to
    report "inapplicable after all" (the ladder skips to the next rung
    without charging the remediation budget), and it may RAISE — a refused
    reconfig, a dead server — in which case the ladder records the failure
    and escalates instead of wedging. An apply that only ENQUEUES work
    (``request_reconfig`` hands back a Future the loop thread settles later)
    can accept an ``escalate`` keyword — a one-shot callable the healer
    provides — and report an asynchronous refusal or degrade through it; the
    ladder then escalates at the next poll exactly as if apply had raised.
    ``applies`` is the cheap static pre-check (no fleet → no replica drain).
    ``verify(anomaly)`` is consulted when the anomaly resolves inside this
    rung's verification window: ``False`` rejects the resolution as
    coincidence and keeps the window running (default: trust the sentinel's
    level). ``verify_window`` / ``cooldown`` override the healer's defaults
    for this rung (clock units: ticks under a tick clock)."""

    def __init__(
        self,
        name: str,
        apply: Callable[..., Optional[bool]],
        applies: Optional[Callable[[obs_sentinel.Anomaly], bool]] = None,
        verify: Optional[Callable[[obs_sentinel.Anomaly], bool]] = None,
        verify_window: Optional[float] = None,
        cooldown: Optional[float] = None,
    ):
        self.name = str(name)
        self._apply = apply
        try:
            params = inspect.signature(apply).parameters
            # passed BY KEYWORD, so only functions that name an ``escalate``
            # parameter (or take **kwargs) receive it: a positional-only or
            # differently-named second parameter never gets a surprise one
            self._wants_escalate = (
                "escalate" in params
                or any(p.kind == p.VAR_KEYWORD for p in params.values()))
        except (TypeError, ValueError):
            self._wants_escalate = False
        self._applies = applies
        self._verify = verify
        self.verify_window = verify_window
        self.cooldown = cooldown

    def applies(self, anomaly) -> bool:
        return True if self._applies is None else bool(self._applies(anomaly))

    def apply(self, anomaly, escalate=None) -> bool:
        if self._wants_escalate:
            return self._apply(anomaly, escalate=escalate) is not False
        return self._apply(anomaly) is not False

    def verify(self, anomaly) -> bool:
        return True if self._verify is None else bool(self._verify(anomaly))

    def __repr__(self) -> str:  # ladder snapshots and span events
        return f"Remediation({self.name!r})"


def _server_engines(server):
    engine = server._engine
    return list(getattr(engine, "replicas", None) or [engine])


def _target_engines(server, anomaly):
    """The engines a replica-scoped anomaly's rung acts on: JUST the
    anomalous replica of a fleet, every engine otherwise."""
    engines = _server_engines(server)
    r = anomaly.replica
    if r is not None and len(engines) > 1 and 0 <= int(r) < len(engines):
        return [engines[int(r)]]
    return engines


def _watch_reconfig(fut, escalate) -> None:
    """Report an enqueued reconfiguration's eventual refusal (the Future
    fails, e.g. with ``ReconfigError``), cancellation or degrade (an
    ``ok=False`` result) back to the ladder through the healer's
    ``escalate``; without it a refused healer-initiated reconfiguration
    would read as a successful apply and the ladder would wait out the whole
    verification window for an action that never ran."""
    if escalate is None:
        return

    def done(f):
        try:
            exc = f.exception()
        except Exception:  # noqa: BLE001 — cancelled: nothing ran
            escalate("cancelled")
            return
        if exc is not None:
            escalate(type(exc).__name__)
        elif getattr(f.result(), "ok", True) is False:
            escalate("degraded")

    fut.add_done_callback(done)


def recover_rung(server, verify_window: Optional[float] = None) -> Remediation:
    """Rung 0 almost everywhere: the recover + bounded-requeue contract via
    :meth:`ServingServer.request_recover`, targeted at the anomalous replica
    on a free-running fleet."""

    def apply(anomaly):
        who = "" if anomaly.replica is None else f" replica {anomaly.replica}"
        server.request_recover(f"healer:{anomaly.kind}{who}", replica=anomaly.replica)

    return Remediation("recover_requeue", apply, verify_window=verify_window)


def _fleet_applies(server):
    def applies(anomaly):
        return anomaly.replica is not None and hasattr(server._engine, "replicas")

    return applies


def drain_replica_rung(server, verify_window: Optional[float] = None) -> Remediation:
    """Take the anomalous replica OUT of service (its work re-dispatches
    across its siblings with the handles rebound): the rung above a targeted
    recover that did not stick. Fleet-only, and needs the anomaly to name a
    replica; inapplicable otherwise (the ladder skips it)."""
    applies = _fleet_applies(server)

    def apply(anomaly, escalate=None):
        from gradaccum_tpu_torch.serving import reconfig as reconfig_lib

        if not applies(anomaly):
            return False
        _watch_reconfig(server.request_reconfig(
            reconfig_lib.replica_drain(anomaly.replica, initiator="healer")), escalate)

    return Remediation("replica_drain", apply, applies=applies, verify_window=verify_window)


def excise_replica_rung(server, replace: bool = True, max_replicas: Optional[int] = None,
                        verify_window: Optional[float] = None) -> Remediation:
    """EXCISE the anomalous replica: the drain's fleet-supervision twin for
    a member the membership registry holds DEAD (lease expired AND probe
    failed). The reconfiguration proves the departure with one
    partial-consensus round the corpse cannot vote in, rebinds its displaced
    streams across the survivors and retires its dispatch slot. It REFUSES
    (``ok=False`` → ``escalate("degraded")``) a member that is not provably
    dead — a partitioned but live replica's probe keeps it SUSPECT — so the
    ladder moves on to capacity instead of killing live streams.

    With ``replace`` (the default) a SUCCESSFUL excise chains a healer-tagged
    ``replica_add`` to restore the fleet's width: the removal resolves the
    anomaly, so on the success path the ladder never reaches its own add
    rung and the replacement must ride the heal. Bounded by the same
    ``max_replicas`` cap as :func:`add_replica_rung`. Fleet-only, needs a
    named replica."""
    applies = _fleet_applies(server)

    def apply(anomaly, escalate=None):
        from gradaccum_tpu_torch.serving import reconfig as reconfig_lib

        if not applies(anomaly):
            return False
        fut = server.request_reconfig(
            reconfig_lib.replica_excise(anomaly.replica, initiator="healer"))
        _watch_reconfig(fut, escalate)
        if replace:
            def chain(f):
                try:
                    if f.exception() is not None or getattr(f.result(), "ok", True) is False:
                        return  # refused or failed: the ladder escalates
                except Exception:  # noqa: BLE001 — cancelled
                    return
                if not _below_add_cap(server._engine, max_replicas):
                    return
                server.request_reconfig(reconfig_lib.replica_add(initiator="healer"))

            fut.add_done_callback(chain)

    return Remediation("replica_excise", apply, applies=applies, verify_window=verify_window)


def _below_add_cap(engine, max_replicas: Optional[int]) -> bool:
    """Autonomous scale-out stays bounded: the default cap is the fleet's
    construction width + 2 (unbounded self-provisioning is how automation
    eats a machine)."""
    cap = max_replicas if max_replicas is not None else engine._generations[0][1] + 2
    return len(engine.active_replicas) < cap


def add_replica_rung(server, max_replicas: Optional[int] = None,
                     verify_window: Optional[float] = None) -> Remediation:
    """Provision one NEW replica into the live fleet: the capacity rung
    above excision (after a member is removed, or when one cannot be,
    restore the fleet's width instead of running short-handed). Bounded by
    ``max_replicas`` (default: the fleet's construction size + 2).
    Fleet-only."""

    def applies(anomaly):
        return hasattr(server._engine, "replicas")

    def apply(anomaly, escalate=None):
        from gradaccum_tpu_torch.serving import reconfig as reconfig_lib

        engine = server._engine
        if not hasattr(engine, "replicas"):
            return False
        if not _below_add_cap(engine, max_replicas):
            return False  # at the scale-out cap: nothing to do
        _watch_reconfig(server.request_reconfig(reconfig_lib.replica_add(initiator="healer")),
                        escalate)

    return Remediation("replica_add", apply, applies=applies, verify_window=verify_window)


def pool_grow_rung(server, factor: float = 1.5, max_blocks: Optional[int] = None,
                   verify_window: Optional[float] = None) -> Remediation:
    """Grow the paged block pool by ``factor`` through a healer-tagged live
    ``pool_resize``: the capacity rung for pressure-shaped anomalies.
    Inapplicable on a contiguous cache, and a no-op (skip) once
    ``max_blocks`` is reached: unbounded autonomous growth is how automation
    eats a machine. On a serving mesh the count rounds up to a multiple
    of its TP width, which the resize requires."""
    if factor <= 1.0:
        raise ValueError(f"pool grow factor must be > 1, got {factor}")

    def applies(anomaly):
        return _server_engines(server)[0].paged

    def apply(anomaly, escalate=None):
        from gradaccum_tpu_torch.serving import reconfig as reconfig_lib

        eng = _server_engines(server)[0]
        if not eng.paged:
            return False
        nb = int(eng.num_blocks * factor + 0.999999)
        if eng.mesh is not None:
            nb += (-nb) % eng.tp
        if max_blocks is not None:
            nb = min(nb, int(max_blocks))
        if nb <= eng.num_blocks:
            return False  # already at the growth cap: nothing to do
        _watch_reconfig(server.request_reconfig(reconfig_lib.pool_resize(nb, initiator="healer")),
                        escalate)

    return Remediation("pool_grow", apply, applies=applies, verify_window=verify_window)


def governor_pin_rung(server, ticks: int = 256,
                      verify_window: Optional[float] = None) -> Remediation:
    """Pin the admission thrash governor to worst-case budgets for
    ``ticks``: the cheapest preemption-storm rung (stop admitting
    optimistically BEFORE paying for a recover or a pool grow). Inapplicable
    without an admission policy."""

    def applies(anomaly):
        return any(getattr(e, "admission_policy", None) is not None
                   for e in _target_engines(server, anomaly))

    def apply(anomaly):
        # a replica-scoped storm pins ONLY that replica's governor: a healthy
        # neighbor keeps its optimistic admission
        pinned = False
        for e in _target_engines(server, anomaly):
            policy = getattr(e, "admission_policy", None)
            if policy is not None:
                if hasattr(server, "pin_governor"):
                    # under the engine lock, and sent to a mesh's followers
                    server.pin_governor(e, ticks)
                else:
                    policy.pin(e.tick_count, ticks)
                pinned = True
        return pinned or False

    return Remediation("governor_pin", apply, applies=applies, verify_window=verify_window)


def rollback_rung(server, checkpoint: str,
                  verify_window: Optional[float] = None) -> Remediation:
    """Swap the serving weights back to the last good manifested checkpoint
    (the directory restore quarantines corrupt candidates and falls back):
    the terminal rung for anomalies that smell like a bad deploy.
    Healer-tagged like every autonomous reconfiguration."""

    def apply(anomaly, escalate=None):
        from gradaccum_tpu_torch.serving import reconfig as reconfig_lib

        _watch_reconfig(server.request_reconfig(
            reconfig_lib.checkpoint_swap(checkpoint=checkpoint, initiator="healer")), escalate)

    return Remediation("checkpoint_rollback", apply, verify_window=verify_window)


def drain_rung(consensus, verify_window: Optional[float] = None) -> Remediation:
    """Request a cluster-agreed drain: the training side's terminal rung
    (the SIGTERM path), the same contract as :func:`request_drain`."""

    def apply(anomaly):
        consensus.request()

    return Remediation("drain_consensus", apply, verify_window=verify_window)
