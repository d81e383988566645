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
  the same path a SIGTERM takes.

:func:`bind_default_remediations` wires the stock matrix: latency cliffs,
stalls, dead replicas, preemption storms and tier thrash recover and
requeue; a loss-scale storm drains the training job.

JAX's :func:`request_reconfig` binding waits for live reconfiguration and
the escalation-ladder rungs (``Remediation`` and the ``*_rung`` factories)
for the healer; :func:`request_reconfig` raises ``NotImplementedError``
naming its item.
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
    """JAX's binding of an anomaly to a live reconfiguration; not ported
    yet."""
    from gradaccum_tpu_torch.serving.engine import RECONFIG_ITEM

    raise NotImplementedError(f"remediation.request_reconfig waits for {RECONFIG_ITEM}")


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
