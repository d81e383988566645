"""Fault tolerance: seeded fault injection and the machinery that survives
it (the port of ``gradaccum_tpu/resilience/``, its training half).

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

JAX's ``watchdog``, ``healer`` and ``remediation`` serve the serving stack
and are not ported yet (ROADMAP.md).
"""

from gradaccum_tpu_torch.resilience import faults, manifest, preemption, retry
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

__all__ = [
    "faults",
    "manifest",
    "preemption",
    "retry",
    "DrainConsensus",
    "FaultInjector",
    "FaultSchedule",
    "FaultSpec",
    "InjectedCrash",
    "InjectedIOError",
    "LocalDrainBus",
    "PreemptionHandler",
    "retry_io",
]
