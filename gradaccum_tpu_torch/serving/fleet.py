"""Fleet membership supervision: liveness leases, SUSPECT/DEAD staging,
and the partial-consensus excise proof.

The port of ``gradaccum_tpu/serving/fleet.py``. Every replica of a
``ReplicatedEngine`` holds a liveness lease on a
:class:`~gradaccum_tpu_torch.resilience.preemption.LocalDrainBus` (the
serving loop renews, the supervisor reads), and a lifecycle decides what
the fleet may still ask of each member:

- **ACTIVE**: lease fresh. Routable, votes in consensus rounds.
- **SUSPECT**: lease stale (older than ``suspect_after``), or expired while
  the out-of-band probe still sees progress. New admissions stop routing
  here and waiting work is hedged to siblings; in-flight streams stay,
  since the member may come back.
- **DEAD**: lease EXPIRED *and* the probe failed. An expired lease with a
  live probe is a ``lease_partition`` (the renewal path broke, the member
  did not), so only the two signals together make DEAD.
- **EXCISED**: decommissioned, never evaluated again.

Before the fleet rebinds a dead member's streams, the survivors run one
consensus round without its vote: the bus's slow-vs-gone lease check
proves the missing member departed and the round resolves PARTIALLY, naming
it in ``last_partial()``. That is the :class:`ExciseProof`.

Each :meth:`FleetSupervisor.poll` fires the ``FLEET_STEP`` fault point; a
scheduled ``replica_kill``, ``replica_wedge`` or ``lease_partition`` lands on
its ``target``. The lease clock is injectable: ``ReplicatedEngine`` gives it
the fleet's tick clock, so lease math never reads wall time.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from gradaccum_tpu_torch.resilience import faults
from gradaccum_tpu_torch.resilience.preemption import LocalDrainBus

# -- lifecycle states ---------------------------------------------------------

ACTIVE = "active"
SUSPECT = "suspect"
DEAD = "dead"
EXCISED = "excised"    # terminal: decommissioned, never re-evaluated

STATES = (ACTIVE, SUSPECT, DEAD, EXCISED)


@dataclass
class Transition:
    """One lifecycle edge, as recorded in the membership log."""

    replica: int
    old: str
    new: str
    at: float
    reason: str = ""


@dataclass
class ExciseProof:
    """Outcome of the partial-consensus round run before an excision."""

    replica: int
    step: int
    decision: Tuple[bool, int]
    absent: Tuple[int, ...]       # hosts the round resolved without
    voters: Tuple[int, ...]       # survivors whose submissions made it
    partial: bool                 # True unless the corpse somehow voted

    @property
    def valid(self) -> bool:
        """The proof holds iff the round resolved without the dead
        member's vote — it was absent AND provably gone."""
        return self.partial and self.replica in self.absent


class FleetSupervisor:
    """Membership registry for a replicated serving fleet.

    The serving loop calls :meth:`heartbeat` once per clean replica
    tick (the same cadence as the sentinel heartbeat) and
    :meth:`poll` once per supervision interval; everything else reads.
    ``probe`` is the out-of-band liveness check consulted only once a
    lease has fully expired — in-process fleets wire it to "has the
    engine's tick advanced since the last poll", a real RPC fleet
    would wire a ping. ``clock`` is injectable so lease math is
    deterministic in tests (same contract as ``LocalDrainBus``).
    """

    def __init__(
        self,
        num_replicas: int,
        *,
        lease_ttl: float = 5.0,
        suspect_after: Optional[float] = None,
        probe: Optional[Callable[[int], bool]] = None,
        clock: Optional[Callable[[], float]] = None,
        bus_timeout: float = 5.0,
    ):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if lease_ttl <= 0:
            raise ValueError(f"lease_ttl must be > 0, got {lease_ttl}")
        self.lease_ttl = float(lease_ttl)
        # stale-but-not-expired is the SUSPECT band; default half the ttl
        self.suspect_after = (self.lease_ttl / 2 if suspect_after is None
                              else float(suspect_after))
        if not (0 < self.suspect_after <= self.lease_ttl):
            raise ValueError(
                f"suspect_after must be in (0, lease_ttl={self.lease_ttl}], "
                f"got {self.suspect_after}")
        self._probe = probe
        self._clock = clock if clock is not None else time.monotonic
        self._bus_timeout = float(bus_timeout)
        self._lock = threading.RLock()
        self.bus = LocalDrainBus(num_replicas, timeout=self._bus_timeout,
                                 lease_ttl=self.lease_ttl, clock=self._clock)
        now = self._clock()
        self._state: Dict[int, str] = {}
        self._renewed: Dict[int, float] = {}
        self._since: Dict[int, float] = {}
        for i in range(num_replicas):
            self._admit_locked(i, now)
        # injected fleet faults (also settable directly by tests)
        self._killed: set = set()
        self._wedged: set = set()
        self._partitioned: set = set()
        self.log: List[Transition] = []
        self.proofs: List[ExciseProof] = []
        self.polls = 0
        self.dropped_renewals = 0

    # -- membership --------------------------------------------------------

    def _admit_locked(self, replica: int, now: float) -> None:
        self._state[int(replica)] = ACTIVE
        self._renewed[int(replica)] = now
        self._since[int(replica)] = now
        # the bus needs one renewal on record before expiry can ever
        # count as PROOF of departure (never-renewed is merely unknown)
        self.bus.renew(int(replica), now)

    def add_member(self, replica: int, now: Optional[float] = None) -> None:
        """Admit a new replica (live ADD). Widens the consensus bus —
        survivors' lease history carries over so in-flight slow-vs-gone
        judgments are unaffected."""
        with self._lock:
            now = self._clock() if now is None else float(now)
            if replica in self._state and self._state[replica] != EXCISED:
                raise ValueError(f"replica {replica} is already a member")
            if replica >= self.bus.num_hosts:
                wide = LocalDrainBus(replica + 1, timeout=self._bus_timeout,
                                     lease_ttl=self.lease_ttl,
                                     clock=self._clock)
                for h, at in self.bus._leases.items():
                    wide.renew(h, at)
                wide.partial_rounds = self.bus.partial_rounds
                wide._last_partial = self.bus.last_partial()
                self.bus = wide
            old = self._state.get(replica)
            self._admit_locked(replica, now)
            self.log.append(Transition(replica, old or "(new)", ACTIVE, now,
                                       reason="add_member"))

    def decommission(self, replica: int,
                     now: Optional[float] = None) -> None:
        """Mark ``replica`` excised: terminal, out of routing, out of
        future lifecycle evaluation. Its bus lease stays expired, so
        later consensus rounds keep resolving without its vote."""
        with self._lock:
            now = self._clock() if now is None else float(now)
            old = self._state.get(int(replica))
            if old == EXCISED:
                return
            self._state[int(replica)] = EXCISED
            self._since[int(replica)] = now
            self.log.append(Transition(int(replica), old or "(new)", EXCISED,
                                       now, reason="decommission"))

    def members(self) -> List[int]:
        with self._lock:
            return sorted(i for i, s in self._state.items() if s != EXCISED)

    # -- leases ------------------------------------------------------------

    def heartbeat(self, replica: int, now: Optional[float] = None) -> bool:
        """Renew ``replica``'s lease (called from its tick/loop
        heartbeat). Returns False when the renewal was DROPPED — the
        member is partitioned (injected fault) or already halted."""
        r = int(replica)
        with self._lock:
            if self._state.get(r, EXCISED) == EXCISED:
                return False
            if r in self._partitioned or r in self._killed or r in self._wedged:
                self.dropped_renewals += 1
                return False
            now = self._clock() if now is None else float(now)
            self._renewed[r] = now
        self.bus.renew(r, now)
        return True

    def lease_age(self, replica: int, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else float(now)
        with self._lock:
            return now - self._renewed.get(int(replica), now)

    # -- lifecycle ---------------------------------------------------------

    def state(self, replica: int) -> str:
        with self._lock:
            return self._state.get(int(replica), EXCISED)

    def states(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._state)

    def routable(self, replica: int) -> bool:
        """Only ACTIVE members take NEW admissions; SUSPECT members keep
        their in-flight streams but are skipped by the dispatcher."""
        return self.state(replica) == ACTIVE

    def halted(self, replica: int) -> bool:
        """True when an injected kill/wedge means the serving loop must
        not tick this replica (simulating the process being gone or
        stuck — the loop is how the fault becomes observable)."""
        with self._lock:
            return replica in self._killed or replica in self._wedged

    def partitioned(self, replica: int) -> bool:
        with self._lock:
            return replica in self._partitioned

    def inject(self, kind: str, target: int) -> None:
        """Apply a fleet fault kind to ``target`` (also reachable via a
        scheduled ``FLEET_STEP`` :class:`~gradaccum_tpu_torch.resilience.
        faults.FaultSpec`)."""
        with self._lock:
            if kind == faults.KIND_REPLICA_KILL:
                self._killed.add(int(target))
            elif kind == faults.KIND_REPLICA_WEDGE:
                self._wedged.add(int(target))
            elif kind == faults.KIND_LEASE_PARTITION:
                self._partitioned.add(int(target))
            else:
                raise ValueError(f"not a fleet fault kind: {kind!r}")

    def heal_injection(self, target: int) -> None:
        """Lift every injected fault on ``target`` (a healed partition,
        or a replaced member's id being recycled)."""
        with self._lock:
            self._killed.discard(int(target))
            self._wedged.discard(int(target))
            self._partitioned.discard(int(target))

    def poll(self, now: Optional[float] = None) -> List[Transition]:
        """Evaluate every member's lease and stage lifecycle
        transitions. Fires the ``FLEET_STEP`` fault point first, so a
        scheduled fleet fault lands before the evaluation that should
        observe its consequences."""
        spec = faults.fire_spec(faults.FLEET_STEP, self.polls)
        with self._lock:
            self.polls += 1
        if spec is not None and spec.kind in faults.FLEET_KINDS:
            self.inject(spec.kind, spec.target)
        now = self._clock() if now is None else float(now)
        moved: List[Transition] = []
        with self._lock:
            for r, old in list(self._state.items()):
                if old == EXCISED:
                    continue
                age = now - self._renewed[r]
                if age <= self.suspect_after:
                    new, why = ACTIVE, "lease fresh"
                elif age <= self.lease_ttl:
                    new, why = SUSPECT, f"lease stale ({age:.3g}s)"
                else:
                    # expired — consult the out-of-band probe before
                    # declaring death; a live probe means the RENEWAL
                    # PATH died, not the member (lease_partition)
                    alive = bool(self._probe(r)) if self._probe else False
                    if alive:
                        new = SUSPECT
                        why = f"lease expired ({age:.3g}s) but probe alive"
                    else:
                        new = DEAD
                        why = f"lease expired ({age:.3g}s), probe failed"
                if new != old:
                    self._state[r] = new
                    self._since[r] = now
                    t = Transition(r, old, new, now, reason=why)
                    self.log.append(t)
                    moved.append(t)
        return moved

    # -- excise proof -------------------------------------------------------

    def excise_proof(self, replica: int, step: int,
                     timeout: Optional[float] = None) -> ExciseProof:
        """Run one consensus round WITHOUT ``replica``'s vote.

        Every survivor submits to the bus; the round resolves
        partially the moment the bus's lease check proves every missing
        member gone (renewed once, then expired). The returned proof is
        only :attr:`~ExciseProof.valid` when the dead member is named
        among the absent — callers must check before rebinding its
        streams."""
        dead = int(replica)
        with self._lock:
            survivors = [i for i, s in self._state.items()
                         if s not in (EXCISED,) and i != dead
                         and i not in self._killed and i not in self._wedged]
        if not survivors:
            raise RuntimeError(
                f"cannot prove excision of replica {dead}: no survivor "
                "may vote (a fleet of corpses has no quorum)")
        results: Dict[int, object] = {}

        def _vote(host: int) -> None:
            try:
                results[host] = self.bus.exchange(host, True, int(step))
            except Exception as exc:  # surfaced below, not swallowed
                results[host] = exc

        threads = [threading.Thread(target=_vote, args=(h,), daemon=True,
                                    name=f"fleet-excise-vote-{h}")
                   for h in survivors]
        for t in threads:
            t.start()
        deadline = time.monotonic() + (self._bus_timeout if timeout is None
                                       else float(timeout))
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        errs = {h: r for h, r in results.items() if isinstance(r, Exception)}
        if errs or len(results) != len(survivors):
            raise RuntimeError(
                f"excise proof round for replica {dead} failed: "
                f"{len(results)}/{len(survivors)} survivors resolved, "
                f"errors={errs}")
        decision = next(iter(results.values()))
        absent = self.bus.last_partial()
        proof = ExciseProof(
            replica=dead, step=int(step), decision=decision,
            absent=absent, voters=tuple(sorted(survivors)),
            partial=dead in absent)
        with self._lock:
            self.proofs.append(proof)
        return proof

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """Snapshot for ``stats()`` / operators."""
        now = self._clock()
        with self._lock:
            return {
                "members": {
                    r: {"state": s,
                        "lease_age": round(now - self._renewed[r], 6),
                        "since": self._since[r]}
                    for r, s in sorted(self._state.items())
                },
                "polls": self.polls,
                "dropped_renewals": self.dropped_renewals,
                "partial_rounds": self.bus.partial_rounds,
                "injected": {
                    "killed": sorted(self._killed),
                    "wedged": sorted(self._wedged),
                    "partitioned": sorted(self._partitioned),
                },
                "transitions": len(self.log),
                "proofs": len(self.proofs),
            }
