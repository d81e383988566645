"""Deterministic, seeded fault injection (the port of
``gradaccum_tpu/resilience/faults.py``: the same points, kinds, specs and
seeded schedules, so a schedule from a seed equals JAX's).

A :class:`FaultSchedule` is a list of :class:`FaultSpec` — *fire fault KIND
at POINT when the caller's index equals AT* — optionally generated from a
seed so a failure scenario replays exactly. A :class:`FaultInjector` holds
a schedule plus the log of what actually fired; installing it (module
global, or the :func:`installed` context manager) arms the hooks that the
training loop and the checkpoint writer call.

Fault points the port fires (the ``index`` each site passes):

- ``PRE_TRAIN_STEP`` — before dispatching a train step; index = micro-batch
  step count *before* the step. The only point where data-corruption kinds
  (``nan``/``inf``/``overflow_storm``) apply: the host batch is poisoned so
  the step sees genuinely non-finite gradients.
- ``POST_TRAIN_STEP`` — after a train step returned; index = step count
  *after* the step (micro-batches consumed).
- ``MID_CKPT_WRITE`` — between the two halves of a checkpoint tmp-file
  write; index = checkpoint step. ``crash`` leaves a truncated ``.tmp``
  (the sweep's job), ``io_error`` exercises retry-with-backoff.

The serving tier's points (``MID_DECODE_TICK``, ``MID_SWAP_IO``,
``POOL_PAGE_TABLE``, ``MID_RECONFIG``, ``FLEET_STEP``) and kinds
(``slow_tick``, ``corrupt``, the fleet kinds) are kept as names, with
JAX's validation, so schedules drawn from a seed stay equal to JAX's;
nothing in the port fires them until serving is ported (ROADMAP.md).

Kinds: ``crash`` raises :class:`InjectedCrash` (simulated process death —
deliberately NOT an OSError, so IO retry loops never swallow it);
``io_error`` raises :class:`InjectedIOError` (an OSError, so retry paths
treat it as a real transient failure); ``nan``/``inf`` return the kind
string for the call site to apply via :func:`corrupt_batch`;
``overflow_storm`` is a BURST of consecutive Inf micro-batches (``span``
successive indices from ``at``), seeded via
:meth:`FaultSchedule.overflow_storm`.

When no injector is installed every hook is one global load + compare —
nothing here touches the hot path in production.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

PRE_TRAIN_STEP = "pre_train_step"
POST_TRAIN_STEP = "post_train_step"
MID_CKPT_WRITE = "mid_checkpoint_write"
MID_DECODE_TICK = "mid_decode_tick"
MID_SWAP_IO = "mid_swap_io"
POOL_PAGE_TABLE = "pool_page_table"
MID_RECONFIG = "mid_reconfig"
FLEET_STEP = "fleet_step"
POINTS = (PRE_TRAIN_STEP, POST_TRAIN_STEP, MID_CKPT_WRITE, MID_DECODE_TICK,
          MID_SWAP_IO, POOL_PAGE_TABLE, MID_RECONFIG, FLEET_STEP)

KIND_CRASH = "crash"
KIND_IO_ERROR = "io_error"
KIND_NAN = "nan"
KIND_INF = "inf"
KIND_OVERFLOW_STORM = "overflow_storm"
KIND_SLOW_TICK = "slow_tick"
KIND_CORRUPT = "corrupt"
KIND_REPLICA_KILL = "replica_kill"
KIND_REPLICA_WEDGE = "replica_wedge"
KIND_LEASE_PARTITION = "lease_partition"
KINDS = (KIND_CRASH, KIND_IO_ERROR, KIND_NAN, KIND_INF,
         KIND_OVERFLOW_STORM, KIND_SLOW_TICK, KIND_CORRUPT,
         KIND_REPLICA_KILL, KIND_REPLICA_WEDGE, KIND_LEASE_PARTITION)
# kinds whose firing corrupts the caller's data via corrupt_batch
DATA_KINDS = (KIND_NAN, KIND_INF, KIND_OVERFLOW_STORM)
# kinds the fleet supervisor applies to FaultSpec.target (membership
# corruption — they only make sense at the FLEET_STEP point)
FLEET_KINDS = (KIND_REPLICA_KILL, KIND_REPLICA_WEDGE, KIND_LEASE_PARTITION)


class InjectedCrash(RuntimeError):
    """Simulated process death at a fault point."""

    def __init__(self, point: str, index: int):
        super().__init__(f"injected crash at {point} index={index}")
        self.point = point
        self.index = index


class InjectedIOError(OSError):
    """Simulated transient IO failure (an OSError: retry paths retry it)."""

    def __init__(self, point: str, index: int):
        super().__init__(f"injected IO error at {point} index={index}")
        self.point = point
        self.index = index


@dataclasses.dataclass
class FaultSpec:
    """Fire ``kind`` at ``point`` when the call-site index equals ``at``.

    ``at=None`` matches ANY index (e.g. "every decode tick"). ``count`` is
    how many firings this spec is good for — an ``io_error`` with
    ``count=2`` fails the first two attempts and lets the third retry
    succeed. ``span`` widens the match to the ``span`` consecutive indices
    ``[at, at + span)`` — the burst shape of ``overflow_storm`` (its count
    defaults to its span so the whole burst fires). ``delay`` is the
    ``slow_tick`` sleep in seconds. ``target`` aims a fleet kind at one
    replica index (the supervisor applies the fault to that member).
    """

    point: str
    at: Optional[int]
    kind: str = KIND_CRASH
    count: Optional[int] = None
    span: int = 1
    delay: float = 0.0
    target: Optional[int] = None

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; one of {POINTS}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.span < 1:
            raise ValueError(f"span must be >= 1, got {self.span}")
        if self.span > 1 and self.at is None:
            raise ValueError("span needs an explicit start index (at=)")
        if self.count is None:
            # a burst is good for its whole width by default
            self.count = self.span
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.kind == KIND_SLOW_TICK and self.delay <= 0:
            raise ValueError("slow_tick needs delay > 0 (seconds)")
        if self.kind in FLEET_KINDS:
            if self.point != FLEET_STEP:
                raise ValueError(
                    f"{self.kind} only fires at {FLEET_STEP!r} (it corrupts "
                    "fleet membership, which only the supervisor can apply)"
                )
            if self.target is None or self.target < 0:
                raise ValueError(
                    f"{self.kind} needs target= (the replica index to hit)"
                )
        elif self.target is not None:
            raise ValueError(
                f"target= only applies to the fleet kinds {FLEET_KINDS}")


class FaultSchedule:
    """An ordered fault plan with per-spec remaining-firing budgets."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = list(specs)
        self._remaining = [s.count for s in self.specs]

    @classmethod
    def seeded(
        cls,
        seed: int,
        n_faults: int = 1,
        points: Sequence[str] = POINTS,
        kinds: Sequence[str] = (KIND_CRASH,),
        index_range: Tuple[int, int] = (0, 100),
    ) -> "FaultSchedule":
        """A deterministic random plan: same seed, same faults, every time."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            point = points[int(rng.integers(len(points)))]
            # fleet kinds only fire at the membership poll and need a
            # victim; pin both so a mixed-kind draw pool stays valid
            # (the point draw above still happens, keeping the rng
            # stream — and thus every non-fleet spec — seed-stable)
            target = None
            if kind in FLEET_KINDS:
                point = FLEET_STEP
                target = 0
            specs.append(FaultSpec(
                point=point,
                at=int(rng.integers(index_range[0], index_range[1])),
                kind=kind,
                delay=0.05 if kind == KIND_SLOW_TICK else 0.0,
                target=target,
            ))
        return cls(specs)

    @classmethod
    def overflow_storm(
        cls,
        seed: int,
        point: str = PRE_TRAIN_STEP,
        start_range: Tuple[int, int] = (0, 20),
        length_range: Tuple[int, int] = (3, 9),
    ) -> "FaultSchedule":
        """A seeded BURST of consecutive non-finite micro-batches: start
        and length drawn from the ranges, then every index in
        ``[start, start + length)`` poisons its batch with Inf — the
        systematic-overflow scenario (loss-scale halving, all-bad
        windows). Same seed, same storm, every time."""
        rng = np.random.default_rng(seed)
        start = int(rng.integers(start_range[0], start_range[1]))
        length = int(rng.integers(length_range[0], length_range[1]))
        return cls([FaultSpec(point, at=start, kind=KIND_OVERFLOW_STORM,
                              span=length)])

    def match(self, point: str, index: int) -> Optional[FaultSpec]:
        """Consume and return the first armed spec matching (point, index)."""
        for i, spec in enumerate(self.specs):
            if self._remaining[i] <= 0 or spec.point != point:
                continue
            if spec.at is not None and not (
                spec.at <= index < spec.at + spec.span
            ):
                continue
            self._remaining[i] -= 1
            return spec
        return None


class FaultInjector:
    """A schedule plus the log of what fired (for assertions in tests)."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.fired: List[Tuple[str, int, str]] = []  # (point, index, kind)
        self._lock = threading.Lock()  # ckpt writer + engine threads both fire

    def fire(self, point: str, index: int) -> Optional[str]:
        spec = self.fire_spec(point, index)
        return None if spec is None else spec.kind

    def fire_spec(self, point: str, index: int) -> Optional[FaultSpec]:
        """Like :meth:`fire` but returns the matched SPEC — call sites
        that need the fault's parameters beyond its kind (the fleet
        supervisor reads ``target``) use this form."""
        with self._lock:
            spec = self.schedule.match(point, index)
            if spec is None:
                return None
            self.fired.append((point, index, spec.kind))
        # injected faults land on the obs timeline too, so a flight dump
        # or trace correlates every fault with its downstream effect spans
        # (recover, requeue, resume) — the chaos smoke asserts exactly that
        from gradaccum_tpu_torch.obs import trace as obs_trace

        tr = obs_trace.get_tracer()
        if tr.enabled:
            tr.event("fault/injected", cat="resilience", point=point,
                     index=index, kind=spec.kind)
        if spec.kind == KIND_CRASH:
            raise InjectedCrash(point, index)
        if spec.kind == KIND_IO_ERROR:
            raise InjectedIOError(point, index)
        if spec.kind == KIND_SLOW_TICK:
            # a wedged-but-alive dispatch: stall OUTSIDE the lock (other
            # threads' fault points must stay live), then proceed normally
            time.sleep(spec.delay)
            return spec
        # data/corrupt/fleet kinds: the call site applies the spec itself
        return spec


_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = injector
    return injector


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def installed(injector: FaultInjector):
    install(injector)
    try:
        yield injector
    finally:
        uninstall()


def fire(point: str, index: int) -> Optional[str]:
    """Hook call sites use. No injector installed: one load + compare."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.fire(point, index)


def fire_spec(point: str, index: int) -> Optional[FaultSpec]:
    """Spec-returning hook (fleet supervision reads ``target`` off it).
    No injector installed: one load + compare."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.fire_spec(point, index)


def corrupt_batch(batch, kind: str):
    """Poison every float leaf of a host batch with NaN/Inf (returns a new
    batch; int leaves — token ids, labels — pass through untouched).
    ``overflow_storm`` poisons with Inf — overflow is what it simulates."""
    if kind not in DATA_KINDS:
        raise ValueError(f"corrupt_batch only applies data kinds "
                         f"{DATA_KINDS}, got {kind!r}")
    bad = np.nan if kind == KIND_NAN else np.inf

    def poison(leaf):
        if isinstance(leaf, dict):
            return {key: poison(v) for key, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(poison(v) for v in leaf)
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            return np.full_like(arr, bad)
        return leaf

    return poison(batch)
