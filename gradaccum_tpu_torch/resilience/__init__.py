"""Fault tolerance: seeded fault injection and the machinery that survives
it (the port of ``gradaccum_tpu/resilience/``).

- :mod:`faults` — a deterministic, seeded fault-injection harness: crash
  points (pre/post train step, mid checkpoint write), injectable NaN/Inf
  batches and IO errors, all driven by a seeded schedule so every failure
  replays exactly. Zero overhead when nothing is installed.
- :mod:`manifest` — per-file sha256 checksum manifest for checkpoint
  directories; corrupt files are detected at restore time and quarantined.
- :mod:`retry` — bounded retry-with-backoff for transient IO.
- :mod:`preemption` — SIGTERM handling so a preempted trainer drains its
  async checkpoint writer and lands one final checkpoint, and the drain
  consensus that makes every rank land the same one.

- :mod:`watchdog` — stall detection for the serving tick loop.
- :mod:`remediation` — sentinel anomalies bound to the recover/requeue and
  drain contracts, and first-class
  :class:`~gradaccum_tpu_torch.resilience.remediation.Remediation` rungs
  that package each action with applicability and verify predicates.
- :mod:`healer` — the autonomous escalation ladder over those rungs:
  per-anomaly-class remediation chains with verification windows, cooldown
  and a flap freeze (terminal ``healer_frozen``), and bounded remediation
  budgets; the self-healing control plane a ServingServer polls on its loop.
"""

from gradaccum_tpu_torch.resilience import (
    faults,
    healer,
    manifest,
    preemption,
    remediation,
    retry,
    watchdog,
)
from gradaccum_tpu_torch.resilience.healer import Healer, default_ladders
from gradaccum_tpu_torch.resilience.remediation import (
    Remediation,
    add_replica_rung,
    drain_replica_rung,
    drain_rung,
    excise_replica_rung,
    governor_pin_rung,
    pool_grow_rung,
    recover_rung,
    rollback_rung,
)
from gradaccum_tpu_torch.resilience.faults import (
    FaultInjector,
    FaultSchedule,
    FaultSpec,
    InjectedCrash,
    InjectedIOError,
)
from gradaccum_tpu_torch.resilience.preemption import (
    DrainConsensus,
    LocalDrainBus,
    PreemptionHandler,
)
from gradaccum_tpu_torch.resilience.retry import retry_io
from gradaccum_tpu_torch.resilience.watchdog import Watchdog

__all__ = [
    "faults",
    "healer",
    "manifest",
    "preemption",
    "remediation",
    "retry",
    "watchdog",
    "Healer",
    "Remediation",
    "default_ladders",
    "add_replica_rung",
    "drain_replica_rung",
    "drain_rung",
    "excise_replica_rung",
    "governor_pin_rung",
    "pool_grow_rung",
    "recover_rung",
    "rollback_rung",
    "DrainConsensus",
    "FaultInjector",
    "FaultSchedule",
    "FaultSpec",
    "InjectedCrash",
    "InjectedIOError",
    "LocalDrainBus",
    "PreemptionHandler",
    "Watchdog",
    "retry_io",
]
