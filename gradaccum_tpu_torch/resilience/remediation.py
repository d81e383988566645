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

The escalation-ladder rungs of JAX's module (``Remediation`` and the
``*_rung`` factories) come with the healer (ROADMAP.md item 5h, second
half).
"""

from __future__ import annotations

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
