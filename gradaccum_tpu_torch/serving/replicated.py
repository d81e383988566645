"""Data-parallel serving: N engines behind one front door, on one card.

The port of ``gradaccum_tpu/serving/replicated.py``. A
:class:`ReplicatedEngine` runs ``replicas`` independent
:class:`~gradaccum_tpu_torch.serving.engine.Engine` instances, each with its
own KV pool and scheduler, behind the interface ``ServingServer`` and
``SimulationDriver`` already speak.

- **Disjoint id lattices.** Replica ``i`` issues ``i, i+N, i+2N, ...``
  (``Engine(id_start=i, id_stride=N)``), so ``rid % N`` is the routing
  table; ``add_replica`` opens a wider generation above every issued id.
- **Prefix affinity, then least load.** A submit goes to the replica whose
  prefix cache holds the longest live match, ties broken by load and index;
  a full candidate falls through quietly, and only a whole-fleet refusal is
  a client-visible ``QueueFull``.
- **Concurrent ticks.** ``step()`` ticks the replicas on a thread pool
  (sequentially under a deterministic tracer); a tick that faults on some
  replicas re-raises, ``recover()`` resets only those, and the healthy
  replicas' events are held for the next clean tick.
- **Supervision.** Every member holds a lease on the fleet's tick clock
  (``serving/fleet.py``); a SUSPECT member's waiting work is hedged to
  siblings, a DEAD one is excised behind a partial-consensus proof.

All replicas share the one card (``tp=None`` or ``tp=1``): one copy of the
weights, one pool per replica, every tick on the current CUDA stream.

``tp > 1`` runs every replica as a tensor-parallel engine
(``Engine(mesh=serving_mesh(tp))``) over the first ``tp`` ranks of the
process group, one process per rank: each process holds rank r's block of
every replica, with one copy of its block of the weights shared by all of
them, and each replica has a process group of its own (created in replica
order on every rank), so replicas ticking on the thread pool never
interleave their collectives. Dispatch (affinity, least load, the id
lattice), supervision and the lease clock are host bookkeeping on the tick
clock, identical on every rank under the engine's SPMD contract: every rank
makes the same fleet calls in the same order. ``drain()`` submits nothing
once its loops start, so it stays rank-identical too.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set

import numpy as np
import torch.distributed as dist

from gradaccum_tpu_torch.models.gpt import GPTConfig
from gradaccum_tpu_torch.obs import trace as obs_trace
from gradaccum_tpu_torch.obs.metrics import MetricsRegistry
from gradaccum_tpu_torch.parallel.mesh import serving_mesh
from gradaccum_tpu_torch.serving import fleet as fleet_lib
from gradaccum_tpu_torch.serving import reconfig as reconfig_lib
from gradaccum_tpu_torch.serving.engine import Engine, StepEvents, _tree_to, rank_tree
from gradaccum_tpu_torch.serving.metrics import ServingMetrics
from gradaccum_tpu_torch.serving.scheduler import QueueFull, Request, Scheduler
from gradaccum_tpu_torch.utils.platform import resolve_device


class _FleetDict:
    """Routes rid-keyed dict access to the owning replica's dict
    (through the fleet's generation-aware ``_owner`` map — ``rid % N``
    within the lattice generation that issued the rid, with hedged rids
    following their adoptive replica). Covers the operations the
    server/driver/tests actually perform on ``engine.results`` /
    ``engine.status``."""

    def __init__(self, fleet: "ReplicatedEngine", attr: str):
        self._fleet = fleet
        self._engines = fleet.replicas
        self._attr = attr

    def _d(self, rid: int) -> Dict:
        return getattr(self._engines[self._fleet._owner(rid)], self._attr)

    def get(self, rid, default=None):
        return self._d(rid).get(rid, default)

    def pop(self, rid, *default):
        return self._d(rid).pop(rid, *default)

    def __getitem__(self, rid):
        return self._d(rid)[rid]

    def __setitem__(self, rid, value):
        self._d(rid)[rid] = value

    def __contains__(self, rid) -> bool:
        return rid in self._d(rid)

    def __len__(self) -> int:
        return sum(len(getattr(e, self._attr)) for e in self._engines)

    def keys(self):
        ks = []
        for e in self._engines:
            ks.extend(getattr(e, self._attr).keys())
        return ks

    def values(self):
        vs = []
        for e in self._engines:
            vs.extend(getattr(e, self._attr).values())
        return vs

    def items(self):
        its = []
        for e in self._engines:
            its.extend(getattr(e, self._attr).items())
        return its

    def __iter__(self):
        # without this, iteration falls into the legacy __getitem__
        # protocol and yields VALUES for rids 0.. until a KeyError —
        # callers written against the dict-typed Engine surface must get
        # the rid keys
        return iter(self.keys())


class _FleetMetrics:
    """Aggregate metrics facade: the SimulationDriver rewires ``clock``
    (propagated to every replica, so TTFT/latency come out on ONE logical
    tick clock) and operators read ``summary()`` — per-replica blocks
    plus fleet totals. All replicas share one registry, so
    ``to_prometheus()`` is the whole fleet with replica labels."""

    def __init__(self, fleet: "ReplicatedEngine"):
        self._fleet = fleet

    @property
    def clock(self):
        return self._fleet.replicas[0].metrics.clock

    @clock.setter
    def clock(self, fn) -> None:
        for e in self._fleet.replicas:
            e.metrics.clock = fn

    def summary(self) -> dict:
        per = [e.metrics.summary() for e in self._fleet.replicas]
        # excised members stay in the list, MARKED — dropping them would
        # renumber every later replica's block and hide that the fleet
        # shrank (their final counters are part of the fleet's history)
        for i, p in enumerate(per):
            p["excised"] = i in self._fleet._excised
            p["membership"] = self._fleet.fleet.state(i)
        proposed = sum(p["spec_proposed"] for p in per)
        accepted = sum(p["spec_accepted"] for p in per)
        return {
            "replicas": len(per),
            "excised_replicas": sorted(self._fleet._excised),
            "active_replicas": self._fleet.active_replicas,
            "tokens_emitted": sum(p["tokens_emitted"] for p in per),
            "rejected": sum(p["rejected"] for p in per),
            "finished": _sum_dicts(p["finished"] for p in per),
            "spec_proposed": proposed,
            "spec_accepted": accepted,
            "spec_accept_rate": (accepted / proposed) if proposed else None,
            # admission plane: preemption is PER-REPLICA (each engine
            # evicts and re-admits within its own pool), so the fleet
            # numbers are plain sums — requeue-after-fault stays the
            # server's fleet-wide concern, unchanged
            "preemptions": sum(p["preemptions"] for p in per),
            "swap_bytes_out": sum(p["swap_bytes_out"] for p in per),
            "swap_bytes_in": sum(p["swap_bytes_in"] for p in per),
            "swap_store_bytes": sum(p["swap_store_bytes"] for p in per),
            "reconfigs": _sum_dicts(p["reconfigs"] for p in per),
            "reconfigs_by_initiator": _sum_dicts(
                p["reconfigs_by_initiator"] for p in per),
            "per_replica": per,
        }

    def to_prometheus(self) -> str:
        return self._fleet.registry.to_prometheus()

    def flush(self) -> None:
        for e in self._fleet.replicas:
            e.metrics.flush()


def _sum_dicts(dicts) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


class ReplicatedEngine:
    """N data-parallel :class:`Engine` replicas behind one Engine-shaped
    interface, all on one card.

    ``tp``: ``None`` (no mesh) or ``1`` (each replica on a one-rank serving
    mesh, tagged ``model=1`` as JAX tags it); both put every replica on
    ``device``, sharing one copy of the weights. ``tp > 1``: every replica
    a tensor-parallel engine over the ranks ``0..tp-1`` (module
    docstring). JAX carves ``replicas x tp`` devices; in the port the
    replicas share the ranks, as tp=1 replicas share the card, so the
    process group needs ``tp`` ranks, and fewer raise JAX's
    ``ValueError``. ``engine_kwargs`` go to every replica verbatim
    (num_slots, max_len, page_size, prefix_cache, ...); each replica gets its
    OWN scheduler (``scheduler_factory`` to customize) and its own
    :class:`ServingMetrics` on one shared registry with a ``replica`` label.
    ``fleet_lease_ttl`` and ``fleet_suspect_after`` are in fleet ticks.
    """

    def __init__(
        self,
        params,
        cfg: GPTConfig,
        replicas: int = 2,
        tp: Optional[int] = 1,
        scheduler_factory=None,
        tracer=None,
        sentinel=None,
        latency_window: Optional[int] = None,
        fleet_lease_ttl: float = 8.0,
        fleet_suspect_after: Optional[float] = None,
        device="cuda",
        **engine_kwargs,
    ):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        for k in ("mesh", "replica_id", "id_start", "id_stride", "scheduler", "metrics"):
            if k in engine_kwargs:
                raise ValueError(f"{k!r} is managed per replica — pass "
                                 "ReplicatedEngine-level knobs instead")
        self.cfg = cfg
        self.tp = None if tp is None else int(tp)
        self.device = resolve_device(device)
        meshes = [self._mesh_for(i, replicas) for i in range(replicas)]
        # one copy of the weights (this rank's block of them on a mesh) on
        # the card for every replica, and a draft carved from them shares
        # their copies: Engine keeps a placed tree that is on its device
        moved: Dict[int, object] = {}
        placed: Dict[int, object] = {}
        params = _tree_to(rank_tree(params, cfg, meshes[0], placed), self.device, moved)
        if engine_kwargs.get("draft_params") is not None:
            engine_kwargs["draft_params"] = _tree_to(
                rank_tree(engine_kwargs["draft_params"], engine_kwargs.get("draft_cfg", cfg),
                          meshes[0], placed), self.device, moved)
        self._tracer = tracer
        # an attached obs sentinel gets one heartbeat PER REPLICA per clean
        # replica tick (from step()): a replica whose ticks keep faulting
        # goes quiet and its lease expires into a dead_replica anomaly
        self.sentinel = sentinel
        self.registry = MetricsRegistry(subdir="serving")
        self.metrics = _FleetMetrics(self)
        self.replicas: List[Engine] = []
        # kept for live replica ADD: a member built later must be the engine
        # the fleet would have built at construction
        self._engine_kwargs = dict(engine_kwargs)
        self._scheduler_factory = scheduler_factory
        self._latency_window = latency_window
        for i in range(replicas):
            self.replicas.append(self._build(params, i, i, replicas, meshes[i]))
        self.results = _FleetDict(self, "results")
        self.status = _FleetDict(self, "status")
        self._tick = 0
        self._faulted: Set[int] = set()
        # replicas taken out of service by a replica_scale reconfiguration
        # (drained: no dispatch, no ticks; the engine object and its slice
        # of the id lattice stay provisioned so activation is instant and
        # in-generation rid % N routing never changes)
        self._inactive: Set[int] = set()
        # terminal subset of _inactive: members removed by excision — never
        # activatable, never evaluated, marked (not dropped) in stats
        self._excised: Set[int] = set()
        # id-lattice GENERATIONS, oldest first: (base_rid, modulus). A rid
        # is owned by the newest generation whose base it reaches — so
        # in-flight rids keep their original owner across add_replica while
        # new rids route through the widened modulus
        self._generations: List[tuple] = [(0, replicas)]
        # hedged rids: requests moved (same rid) off a SUSPECT member to an
        # adoptive sibling; consulted by _owner ahead of the generations
        self._moved: Dict[int, int] = {}
        # warm-up admission ramp for freshly-added replicas: replica ->
        # admissions taken so far; concurrent load is capped at 2**count
        # until the cap clears num_slots, so a cold member can't absorb a
        # thundering herd on its first tick. The ramp also ages out after
        # a fixed number of supervision intervals (_warmup_age) — an
        # unsaturated fleet would otherwise never route the newcomer
        # enough admissions to graduate it
        self._warmup: Dict[int, int] = {}
        # membership registry: leases measured on the fleet tick clock
        # (max replica tick — advances while ANY member makes progress, so
        # an idle fleet never false-expires), probed out-of-band via tick
        # progress (a partitioned member keeps ticking; a dead one freezes)
        self._warmup_age: Dict[int, int] = {}
        self._probe_seen: Dict[int, int] = {}
        self.fleet = fleet_lib.FleetSupervisor(
            replicas, lease_ttl=fleet_lease_ttl,
            suspect_after=fleet_suspect_after,
            probe=self._probe_replica, clock=self._fleet_clock)
        # healthy replicas' events from a partially-faulted tick, delivered
        # with the next clean tick (see step())
        self._held: List[StepEvents] = []
        self._pool = (ThreadPoolExecutor(
            max_workers=replicas, thread_name_prefix="serving-replica")
            if replicas > 1 else None)

    def _mesh_for(self, i: int, total: int):
        """Replica ``i``'s serving mesh (the same rule at construction and
        at live ADD): none for ``tp=None``, a one-rank mesh for ``tp=1``,
        else a mesh of its own over the ranks ``0..tp-1``. Every rank must
        build the replicas in the same order (``dist.new_group``)."""
        tp = self.tp
        if tp is None:
            return None
        if tp == 1:
            return serving_mesh(1)
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if tp > world:
            raise ValueError(f"replicas={total} x tp={tp} needs {tp} devices, have {world} "
                             f"(the port's replicas share the ranks 0..{tp - 1}, as tp=1 "
                             "replicas share the card)")
        return serving_mesh(tp, devices=range(tp))

    def _build(self, params, idx: int, id_start: int, id_stride: int, mesh) -> Engine:
        """Replica ``idx`` as construction builds it (and live ADD too)."""
        sched = self._scheduler_factory() if self._scheduler_factory is not None else Scheduler()
        return Engine(params, self.cfg, mesh=mesh, replica_id=idx, id_start=id_start,
                      id_stride=id_stride, scheduler=sched,
                      metrics=ServingMetrics(registry=self.registry, replica_id=idx,
                                             latency_window=self._latency_window),
                      tracer=self._tracer, device=self.device, **self._engine_kwargs)

    def _fleet_clock(self) -> float:
        """Lease clock = the fleet's furthest tick. Advances while any
        member makes progress; freezes when the whole fleet is idle (an
        idle fleet must never expire into false SUSPECTs)."""
        return float(max(e.tick_count for e in self.replicas))

    def _probe_replica(self, replica: int) -> bool:
        """Out-of-band liveness probe: has the member's OWN tick advanced
        since the last probe? Bypasses the heartbeat path on purpose — a
        ``lease_partition`` drops renewals while the member keeps
        ticking, and this is what keeps it SUSPECT instead of DEAD."""
        cur = self.replicas[replica].tick_count
        seen = self._probe_seen.get(replica)
        self._probe_seen[replica] = cur
        return seen is None or cur > seen

    def _owner(self, rid: int) -> int:
        """Owning replica index for a request id: hedged rids follow
        their adoptive replica; everything else routes within the newest
        id-lattice generation whose base the rid reaches."""
        rid = int(rid)
        home = self._moved.get(rid)
        if home is not None:
            return home
        for base, mod in reversed(self._generations):
            if rid >= base:
                return rid % mod
        return rid % self._generations[0][1]

    # -- introspection ----------------------------------------------------

    @property
    def tracer(self):
        return obs_trace.resolve(self._tracer)

    @property
    def idle(self) -> bool:
        return all(e.idle for e in self.replicas) and not self._held

    @property
    def tick_count(self) -> int:
        return self._tick

    @property
    def paged(self) -> bool:
        return self.replicas[0].paged

    @property
    def prefix_cache(self):
        return self.replicas[0].prefix_cache

    @property
    def max_len(self) -> int:
        return self.replicas[0].max_len

    @property
    def queue_depth(self) -> int:
        return sum(e.scheduler.depth for e in self.replicas)

    @property
    def parked_depth(self) -> int:
        """Fleet-wide preemption backlog (each replica parks and resumes
        within its own pool — parked requests never migrate replicas,
        their K/V or swap record lives with the pool that owns it)."""
        return sum(e.scheduler.parked_depth for e in self.replicas)

    def decode_compile_count(self) -> int:
        """Fleet total. The per-replica bound is the invariant: each
        replica's tick sees one shape signature per block size."""
        return sum(e.decode_compile_count() for e in self.replicas)

    def prefill_compile_count(self) -> int:
        return sum(e.prefill_compile_count() for e in self.replicas)

    def obs_tags(self) -> dict:
        tags = {"replicas": len(self.replicas)}
        mesh = self.replicas[0].mesh
        if mesh is not None:
            tags["mesh"] = ",".join(f"{n}={mesh.shape[n]}" for n in mesh.axis_names)
        return tags

    def manifest(self) -> dict:
        """Fleet shape for the export manifest: replica count, mesh axes,
        and every replica's full knob set (per-replica paging included)."""
        mesh = self.replicas[0].mesh
        return {
            "replicas": len(self.replicas),
            "tp": self.tp,
            "mesh": (None if mesh is None
                     else {n: int(mesh.shape[n]) for n in mesh.axis_names}),
            # fleet-level healer policy (ServingServer sets it when a
            # Healer is attached) — one ladder governs every replica
            "healer": getattr(self, "healer_knobs", None),
            "engines": [e.manifest() for e in self.replicas],
        }

    # -- request intake ----------------------------------------------------

    def _candidates(self, prompt: np.ndarray) -> List[int]:
        """ACTIVE replica indices in dispatch order: longest live prefix
        match first (affinity — the blocks are THERE, a different replica
        would cold-miss), then least loaded, then lowest index
        (determinism). Drained/excised replicas are out of the order
        entirely; SUSPECT members (stale lease) take no NEW admissions
        unless the whole fleet is suspect (degraded routing beats
        refusing service on what may be a supervision false positive);
        warming members (fresh ADD) sort last under their admission-ramp
        load cap, and when NOTHING else is routable the cap yields —
        a fleet rebuilt entirely from fresh ADDs takes backpressure
        (``QueueFull``) rather than a false "drained" refusal."""
        keys, ramp, capped, suspects = [], [], [], []
        for i, e in enumerate(self.replicas):
            if i in self._inactive:
                continue
            shared = 0
            if e.prefix_cache is not None and prompt.size > e.page_size:
                shared = len(e.prefix_cache.match(prompt))
            load = e.scheduler.depth + e.pool.active_count
            if not self.fleet.routable(i):
                suspects.append((load, i))
                continue
            if i in self._warmup:
                (ramp if load < (1 << self._warmup[i])
                 else capped).append((load, i))
                continue
            keys.append((-shared, load, i))
        order = [i for _, _, i in sorted(keys)] + \
                [i for _, i in sorted(ramp)]
        if not order:
            order = [i for _, i in sorted(suspects)]
        if not order:
            # every routable member is a warming replica at its ramp
            # cap: the cap exists to spread a thundering herd across
            # SEASONED siblings, and there are none — route anyway and
            # let Engine.submit apply real backpressure, because the
            # capacity exists as soon as the ramp advances or ages out
            order = [i for _, i in sorted(capped)]
        if not order:
            raise RuntimeError(
                "every replica is drained — activate one "
                "(reconfig.replica_activate) before submitting"
            )
        return order

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, rng_seed: int = 0,
               deadline_ticks: Optional[int] = None) -> int:
        """Dispatch to the best replica; falls through the candidate order
        on backpressure and re-raises the BEST replica's QueueFull (its
        message names the saturated replica) only when every replica is
        full. Validation errors (never-fitting request) propagate
        immediately — no replica could take it."""
        arr = np.asarray(prompt, np.int32).reshape(-1)
        order = self._candidates(arr)
        for idx in order:
            try:
                rid = self.replicas[idx].submit(
                    prompt, max_new_tokens, eos_id=eos_id, rng_seed=rng_seed,
                    deadline_ticks=deadline_ticks, _quiet_full=True,
                )
            except QueueFull:
                continue
            self._note_warmup_admit(idx)
            return rid
        # every replica refused: resubmit to the best candidate WITHOUT
        # the quiet flag so exactly ONE client-visible rejection lands in
        # telemetry — the probe attempts above record none, keeping
        # rejected_total an honest count of requests clients lost
        try:
            rid = self.replicas[order[0]].submit(
                prompt, max_new_tokens, eos_id=eos_id, rng_seed=rng_seed,
                deadline_ticks=deadline_ticks,
            )
        except QueueFull as exc:
            if self._excised:
                # a shrunken fleet must say so: the stale pre-excision
                # replica count would send operators hunting a member
                # that no longer exists
                gone = ", ".join(f"replica {i} excised"
                                 for i in sorted(self._excised))
                raise QueueFull(
                    f"{exc} ({gone}; {len(self.active_replicas)} active)"
                ) from None
            raise
        self._note_warmup_admit(order[0])
        return rid

    def _note_warmup_admit(self, idx: int) -> None:
        """Advance a warming replica's admission ramp (cap doubles per
        admission; the ramp retires once it clears the slot count)."""
        if idx in self._warmup:
            self._warmup[idx] += 1
            if (1 << self._warmup[idx]) >= self.replicas[idx].pool.num_slots:
                del self._warmup[idx]
                self._warmup_age.pop(idx, None)

    # -- the tick ----------------------------------------------------------

    def step(self) -> StepEvents:
        """One fleet tick: every replica ticks once (concurrently when
        there are several), events merged in replica order. Held events
        from a previous partially-faulted tick are delivered first,
        filtered to requests whose results the fault handler has not
        already reconciled away."""
        t = self._tick
        snt = self.sentinel
        # drained replicas sit ticks out entirely: no work can reach them
        # and a parked lease on an intentionally idle engine must not
        # masquerade as a heartbeat; halted members (injected kill/wedge)
        # sit out because the fault IS the missing tick
        active = [i for i in range(len(self.replicas))
                  if i not in self._inactive and not self.fleet.halted(i)]
        if self._pool is None:
            evs = []
            for i in active:
                evs.append(self.replicas[i].step())
                self.fleet.heartbeat(i)
                if snt is not None:
                    snt.heartbeat(replica=i,
                                  tick=self.replicas[i].tick_count,
                                  busy=not self.replicas[i].idle)
        else:
            tr = self.tracer
            if tr.enabled and getattr(tr, "deterministic", False):
                # a deterministic tracer promises byte-identical event
                # order across seeded runs; racing replica threads into
                # the one shared ring would break it — tick sequentially
                waits = [(i, self.replicas[i].step) for i in active]
            else:
                futures = [(i, self._pool.submit(self.replicas[i].step))
                           for i in active]
                waits = [(i, f.result) for i, f in futures]
            evs, errors = [], []
            for i, w in waits:
                try:
                    evs.append(w())
                    self.fleet.heartbeat(i)
                    if snt is not None:
                        # only a CLEAN replica tick renews the lease — a
                        # replica stuck faulting goes quiet and expires
                        # into a dead_replica anomaly
                        snt.heartbeat(replica=i,
                                      tick=self.replicas[i].tick_count,
                                      busy=not self.replicas[i].idle)
                except Exception as exc:  # noqa: BLE001 — re-raised below
                    errors.append(exc)
                    self._faulted.add(i)
            if errors:
                # healthy replicas' events must not vanish with the
                # neighbor's exception: hold them for the next clean tick
                self._held.extend(evs)
                raise errors[0]
        emitted, finished, admitted = [], [], []
        tagged = [(True, ev) for ev in self._held] + \
                 [(False, ev) for ev in evs]
        for held, ev in tagged:
            for rid, tok in ev.emitted:
                if held and rid not in self.results:
                    continue  # reconciled by the fault handler already
                emitted.append((rid, tok))
            for rid, reason in ev.finished:
                if held and rid not in self.results:
                    continue
                finished.append((rid, reason))
            admitted.extend(ev.admitted)
        self._held = []
        self._tick = t + 1
        self.supervise()
        return StepEvents(emitted, finished, admitted, t)

    # -- fleet supervision --------------------------------------------------

    def supervise(self) -> List["fleet_lib.Transition"]:
        """One supervision interval: renew intentionally-idle (drained)
        members' leases, poll the membership registry, and hedge a
        newly-SUSPECT member's WAITING work to siblings. Lockstep
        ``step()`` calls this every tick; the free-running server calls
        it from its maintenance cadence."""
        for i in self._inactive:
            self.fleet.heartbeat(i)
        for i in list(self._warmup):
            self._warmup_age[i] = self._warmup_age.get(i, 0) + 1
            if self._warmup_age[i] >= 16:
                del self._warmup[i]
                self._warmup_age.pop(i, None)
        moved = self.fleet.poll()
        tr = self.tracer
        for t in moved:
            if tr.enabled:
                tr.event("fleet/transition", cat="serving",
                         replica=t.replica, old=t.old, new=t.new,
                         reason=t.reason, **self.obs_tags())
            if t.new == fleet_lib.SUSPECT:
                self._hedge_replica(t.replica)
            elif t.new == fleet_lib.DEAD:
                snt = getattr(self, "sentinel", None)
                if snt is not None:
                    # the registry's own verdict reaches the healer even
                    # when the member died IDLE (its heartbeat lease was
                    # parked, so the lease detector stays silent); fire()
                    # dedups against an already-firing lease anomaly
                    snt.fire("dead_replica", replica=t.replica,
                             detail={"source": "fleet_lease",
                                     "reason": t.reason})
        return moved

    def _hedge_replica(self, replica: int) -> int:
        """Move a SUSPECT member's WAITING work — parked first, then the
        fresh queue — to siblings, keeping each request's rid (the
        ``_moved`` remap reroutes results/status/cancel to the adoptive
        replica, so front-end handles survive untouched). Running slots
        stay put: the member may well recover and finish them, and if it
        is later declared DEAD the excision path rescues them. A parked
        request's replica-local resume state (swap record, parked K/V)
        cannot migrate, so it replays from scratch on its new home —
        the fault-requeue contract (greedy replay token-identical).
        Siblings with no queue room decline; the request then stays with
        its suspect owner rather than being dropped."""
        replica = self._check_replica(replica)
        e = self.replicas[replica]
        hedged = 0
        waiting: List[Request] = []
        while e.scheduler.parked_depth:
            req = e.scheduler.pop_parked()
            rid = req.request_id
            e._parked_state.pop(rid, None)
            if e._swap_store is not None:
                e._swap_store.discard(rid)
            waiting.append(req)
        waiting.extend(e.scheduler.drain_queue())
        for req in waiting:
            rid = req.request_id
            dst = None
            try:
                order = self._candidates(req.prompt)
            except RuntimeError:
                order = []  # nothing routable anywhere: keep ownership
            for j in order:
                if j == replica:
                    continue
                sib = self.replicas[j]
                try:
                    sib.scheduler.submit(self._rebase_deadline(req, e, sib))
                except QueueFull:
                    continue
                dst = j
                break
            if dst is None:
                # no sibling capacity: the suspect member keeps it
                e.scheduler.submit(req)
                continue
            self._moved[rid] = dst
            # the result stream restarts on the adoptive replica (replay
            # from scratch); stale partial output must not prefix it
            e.results.pop(rid, None)
            e.status.pop(rid, None)
            self.replicas[dst].results[rid] = []
            self.replicas[dst].status[rid] = "queued"
            hedged += 1
        if hedged and self.tracer.enabled:
            self.tracer.event("fleet/hedge", cat="serving", replica=replica,
                              hedged=hedged, **self.obs_tags())
        return hedged

    @staticmethod
    def _rebase_deadline(req: Request, src: Engine, dst: Engine) -> Request:
        """Re-express a request's deadline in the adoptive replica's tick
        frame (each engine counts its own ticks)."""
        if req.deadline_tick is None:
            return req
        remaining = max(0, req.deadline_tick - src.tick_count)
        return dataclasses.replace(req, deadline_tick=dst.tick_count + remaining,
                           submit_tick=dst.tick_count)

    # -- lifecycle ----------------------------------------------------------

    def pop_result(self, request_id: int):
        out = self.replicas[self._owner(request_id)].pop_result(request_id)
        self._moved.pop(int(request_id), None)
        return out

    def cancel(self, request_id: int) -> bool:
        out = self.replicas[self._owner(request_id)].cancel(request_id)
        self._moved.pop(int(request_id), None)
        return out

    def recover(self) -> List[Request]:
        """Reset ONLY the replicas whose last ``step()`` raised (all of
        them when none is recorded — a defensive full sweep for callers
        that hit an error outside step). Healthy replicas keep their
        in-flight requests; their held events survive for the next clean
        tick."""
        targets = sorted(self._faulted) if self._faulted \
            else range(len(self.replicas))
        self._faulted.clear()
        failed: List[Request] = []
        for i in targets:
            failed.extend(self.replicas[i].recover())
        return failed

    # -- live reconfiguration (replica scale + fleet-wide fan-out) ---------

    @property
    def active_replicas(self) -> List[int]:
        """Replica indices currently in service (dispatch candidates)."""
        return [i for i in range(len(self.replicas))
                if i not in self._inactive]

    def _check_replica(self, replica) -> int:
        if replica is None or not 0 <= int(replica) < len(self.replicas):
            raise ValueError(
                f"replica must be in [0, {len(self.replicas)}), "
                f"got {replica}"
            )
        return int(replica)

    def drain_replica(self, replica: int):
        """Take one replica out of service while its siblings keep
        serving: dispatch stops routing to it FIRST, its running slots go
        through the same preempt→park path pool pressure uses, and every
        displaced request (parked work oldest-first, then the fresh
        queue) is returned with its original prompt/budget/seed for
        re-dispatch across the fleet. Partial results are discarded — a
        displaced request replays from scratch on its new home, exactly
        the fault-requeue contract (greedy replay is token-identical;
        streaming consumers may observe a duplicated prefix). Displaced
        requests re-enter queue-waiting, so their queue DEADLINES apply
        again — the same rule the parked-expiry contract already sets
        for preempted requests (``Scheduler.expire``). NOT thread-safe;
        a ServingServer runs this under the replica's lock via
        ``request_reconfig``."""
        replica = self._check_replica(replica)
        e = self.replicas[replica]
        self._inactive.add(replica)  # no new work routes here from now on
        preempted: List[int] = []
        for slot, req in enumerate(e._slot_req):
            if req is not None and e._active[slot]:
                # the park is consumed immediately below (the request
                # replays from scratch on a sibling) — staging its K/V
                # to the host store would be a wasted device->host copy
                e._preempt(slot, preempted, stage_swap=False)
        displaced: List[Request] = []
        while e.scheduler.parked_depth:
            req = e.scheduler.pop_parked()
            rid = req.request_id
            e._parked_state.pop(rid, None)
            if e._swap_store is not None:
                e._swap_store.discard(rid)
            e.results.pop(rid, None)
            e.status.pop(rid, None)
            displaced.append(req)
        for req in e.scheduler.drain_queue():
            e.results.pop(req.request_id, None)
            e.status.pop(req.request_id, None)
            displaced.append(req)
        # requests previously hedged ONTO this replica just got displaced
        # with the rest — their remap entries must not keep routing their
        # (about to be reissued) rids here
        self._moved = {r: d for r, d in self._moved.items() if d != replica}
        if self.sentinel is not None:
            # the drained replica stops ticking ON PURPOSE: park its
            # heartbeat lease, or the planned silence fires a false
            # dead_replica (and a spurious recover remediation) one
            # lease interval later
            self.sentinel.heartbeat(replica=replica, tick=e.tick_count,
                                    busy=False)
        return displaced

    def activate_replica(self, replica: int) -> None:
        """Return a drained replica to the dispatch candidate order (it
        rejoins with an empty pool, like a fresh engine). Excision is
        terminal — an excised member cannot be reactivated; provision
        new capacity with :meth:`add_replica` instead."""
        replica = self._check_replica(replica)
        if replica in self._excised:
            raise ValueError(
                f"replica {replica} is excised — excision is terminal; "
                "add_replica() provisions replacement capacity")
        self._inactive.discard(replica)

    def add_replica(self) -> int:
        """Provision one NEW replica into the live fleet (the capacity
        half of excise-and-replace; also plain horizontal scale-out).

        The id lattice WIDENS by one generation: a fresh base rid above
        everything issued so far opens a ``rid % (N+1)`` modulus that
        only new submissions reach — every in-flight rid stays below the
        base and keeps routing to its original owner through the old
        modulus until it retires. Existing engines are rebased onto the
        widened lattice (their next issue lands in the new generation),
        the new engine is built exactly as construction would have built
        it (the same weights on the card, no copy; its own pool, which it
        allocates while the others serve; its own metrics labels), and it
        joins dispatch behind a warm-up admission ramp.
        NOT thread-safe; a ServingServer runs this under maintenance()
        via ``request_reconfig(reconfig.replica_add())``."""
        idx = len(self.replicas)
        total = idx + 1
        mesh = self._mesh_for(idx, total)
        base = max(e._next_id for e in self.replicas)
        # smallest rid >= base owned by each lattice position under the
        # widened modulus; rebase BEFORE the new engine exists so no old
        # engine can issue below the new generation's base
        for j, e in enumerate(self.replicas):
            e.rebase_ids(base + ((j - base) % total), total)
        eng = self._build(self.replicas[0].params, idx, base + ((idx - base) % total), total,
                          mesh)
        self.replicas.append(eng)
        self._generations.append((base, total))
        self._warmup[idx] = 0
        self.fleet.add_member(idx)
        # lockstep step() fans ticks across a pool sized at construction —
        # rebuild it one wider (free-running server loops don't use it)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(
            max_workers=total, thread_name_prefix="serving-replica")
        if self.tracer.enabled:
            self.tracer.event("fleet/add_replica", cat="serving",
                              replica=idx, generations=len(self._generations),
                              **self.obs_tags())
        return idx

    def excise_replica(self, replica: int):
        """Remove a DEAD member: prove its departure with one
        partial-consensus round the member cannot vote in, then drain
        its displaced work to siblings and decommission its dispatch
        slot. Returns ``(displaced, proof)``. Refuses (raises
        RuntimeError) unless the membership registry has the member at
        DEAD — a SUSPECT member may only be drained, and a partitioned
        member's live probe keeps it SUSPECT precisely so this refusal
        protects it."""
        replica = self._check_replica(replica)
        if replica in self._excised:
            raise RuntimeError(f"replica {replica} is already excised")
        state = self.fleet.state(replica)
        if state != fleet_lib.DEAD:
            raise RuntimeError(
                f"excision refused: replica {replica} is {state!r}, not "
                f"{fleet_lib.DEAD!r} — only a member whose lease expired "
                "AND whose probe failed may be excised")
        proof = self.fleet.excise_proof(replica, step=self._tick)
        if not proof.valid:
            raise RuntimeError(
                f"excision refused: consensus round resolved WITH replica "
                f"{replica} present (absent={proof.absent}) — it is not "
                "provably gone")
        displaced = self.drain_replica(replica)
        self._excised.add(replica)
        self._warmup.pop(replica, None)
        self._warmup_age.pop(replica, None)
        self.fleet.decommission(replica)
        if self.tracer.enabled:
            self.tracer.event("fleet/excise", cat="serving", replica=replica,
                              displaced=len(displaced),
                              voters=list(proof.voters), **self.obs_tags())
        return displaced, proof

    def reconfigure(self, spec, resubmit: bool = True):
        """Fleet-wide live reconfiguration. ``pool_resize`` and
        ``checkpoint_swap`` fan out to every ACTIVE replica (a
        path-based checkpoint is restored ONCE and distributed in
        memory, so N replicas cost one disk read and one quarantine
        decision); ``replica_scale`` drains or activates one replica,
        re-dispatching a drained replica's displaced work across its
        siblings (``resubmit=False`` hands the displaced requests back
        in ``result.detail["displaced"]`` instead — the ServingServer
        path, which must rebind stream handles itself).

        Atomicity: every REFUSAL (shrink below demand, divisibility) is
        pre-checked across all active replicas before any of them
        mutates, so a refused fleet resize genuinely changes nothing. A
        crash-point KILL mid-fan-out can still leave replicas at
        different configurations — each individually clean (old-or-new,
        everything parked) — and retrying the same spec converges the
        stragglers."""
        tr = self.tracer
        if spec.kind == reconfig_lib.REPLICA_SCALE:
            if spec.action == "add":
                idx = self.add_replica()
                result = reconfig_lib.ReconfigResult(
                    spec.kind, ok=True, tick=self._tick,
                    initiator=spec.initiator,
                    detail={"replica": idx, "action": "add",
                            "active_replicas": self.active_replicas,
                            "generations": [list(g)
                                            for g in self._generations],
                            "warmup": True},
                )
                e = self.replicas[idx]
                replica = idx
            else:
                replica = self._check_replica(spec.replica)
                e = self.replicas[replica]
            if spec.action == "activate":
                try:
                    self.activate_replica(replica)
                except ValueError as exc:
                    # excision is terminal: structured refusal, no mutation
                    result = reconfig_lib.ReconfigResult(
                        spec.kind, ok=False, reason=str(exc),
                        tick=self._tick, initiator=spec.initiator,
                        detail={"replica": replica, "action": "activate"},
                    )
                else:
                    result = reconfig_lib.ReconfigResult(
                        spec.kind, ok=True, tick=self._tick,
                        initiator=spec.initiator,
                        detail={"replica": replica, "action": "activate",
                                "active_replicas": self.active_replicas},
                    )
            elif spec.action in ("drain", "excise"):
                src_tick = e.tick_count
                proof = None
                if spec.action == "excise":
                    try:
                        displaced, proof = self.excise_replica(replica)
                    except RuntimeError as exc:
                        # refusal (member not provably dead): structured,
                        # nothing mutated — the healer ladder escalates
                        result = reconfig_lib.ReconfigResult(
                            spec.kind, ok=False, reason=str(exc),
                            tick=self._tick, initiator=spec.initiator,
                            detail={"replica": replica, "action": "excise"},
                        )
                        e.metrics.record_reconfig(
                            spec.kind, ok=False, preempted=0,
                            initiator=spec.initiator)
                        if tr.enabled:
                            tr.event("serve/reconfig", cat="serving",
                                     kind=spec.kind, ok=False,
                                     replica=replica, action=spec.action,
                                     initiator=spec.initiator,
                                     **self.obs_tags())
                        return result
                else:
                    displaced = self.drain_replica(replica)
                moved: Dict[int, int] = {}
                failed: List[int] = []
                if resubmit:
                    for req in displaced:
                        remaining = (None if req.deadline_tick is None
                                     else max(0, req.deadline_tick
                                              - src_tick))
                        try:
                            moved[req.request_id] = self.submit(
                                req.prompt, req.max_new_tokens,
                                eos_id=req.eos_id, rng_seed=req.rng_seed,
                                deadline_ticks=remaining,
                            )
                        except Exception:  # noqa: BLE001 — QueueFull etc.
                            failed.append(req.request_id)
                result = reconfig_lib.ReconfigResult(
                    spec.kind, ok=not failed,
                    reason=(None if not failed
                            else f"{len(failed)} displaced request(s) "
                                 "found no sibling capacity"),
                    preempted=len(displaced), tick=self._tick,
                    initiator=spec.initiator,
                    detail={"replica": replica, "action": spec.action,
                            "active_replicas": self.active_replicas,
                            "resubmitted": moved, "failed": failed,
                            **({} if proof is None else {"excise_proof": {
                                "voters": list(proof.voters),
                                "absent": list(proof.absent),
                                "decision": list(proof.decision),
                                "valid": proof.valid}}),
                            **({} if resubmit
                               else {"displaced": displaced})},
                )
            e.metrics.record_reconfig(spec.kind, ok=result.ok,
                                      preempted=result.preempted,
                                      initiator=spec.initiator)
            if tr.enabled:
                tr.event("serve/reconfig", cat="serving", kind=spec.kind,
                         ok=result.ok, replica=replica,
                         action=spec.action, initiator=spec.initiator,
                         **self.obs_tags())
            return result
        if spec.kind == reconfig_lib.CHECKPOINT_SWAP:
            lead = self.replicas[0]
            whole = None  # the serving weights whole (one gather on a mesh)
            if spec.checkpoint is not None:
                whole = lead.whole_params()
                try:
                    new_params = reconfig_lib.restore_tree(spec.checkpoint, whole)
                except reconfig_lib.restore_errors() as exc:
                    # one quarantine decision for the whole fleet: every
                    # replica keeps serving the old weights
                    return reconfig_lib.ReconfigResult(
                        spec.kind, ok=False, reason=f"checkpoint rejected: {exc}",
                        tick=self._tick, initiator=spec.initiator,
                        detail={"checkpoint": spec.checkpoint, "quarantined": True})
                spec = reconfig_lib.checkpoint_swap(params=new_params,
                                                    draft_params=spec.draft_params,
                                                    initiator=spec.initiator)
            if spec.unchanged_hint is None:
                # hash the weights ONCE for the whole fleet (replicas carry
                # identical params), whole trees on a mesh as at tp=1
                if whole is None:
                    whole = lead.whole_params()
                spec = dataclasses.replace(spec, unchanged_hint=(
                    reconfig_lib.params_digest(whole)
                    == reconfig_lib.params_digest(reconfig_lib.as_tree(spec.params))))
            # onto the card once (this rank's block on a mesh): every
            # replica takes the same copy
            moved: Dict[int, object] = {}
            placed: Dict[int, object] = {}
            spec = dataclasses.replace(
                spec, params=_tree_to(rank_tree(spec.params, self.cfg, lead.mesh, placed),
                                      self.device, moved),
                draft_params=(None if spec.draft_params is None else _tree_to(
                    rank_tree(spec.draft_params, lead.draft_cfg or self.cfg, lead.mesh,
                              placed), self.device, moved)))
        if spec.kind == reconfig_lib.POOL_RESIZE:
            # refuse BEFORE any replica mutates: a mid-loop refusal
            # (one replica's demand above the new size) must never tear
            # the fleet into mixed block counts
            for i in self.active_replicas:
                reconfig_lib.validate_pool_resize(self.replicas[i], spec)
        per = [self.replicas[i].reconfigure(spec)
               for i in self.active_replicas]
        ok = all(r.ok for r in per)
        return reconfig_lib.ReconfigResult(
            spec.kind, ok=ok,
            reason=None if ok else next(r.reason for r in per if not r.ok),
            preempted=sum(r.preempted for r in per), tick=self._tick,
            initiator=spec.initiator,
            detail={"per_replica": [r.to_dict() for r in per]},
        )

    def drain(self, max_ticks: int = 100_000) -> None:
        """Free-run every replica to idle CONCURRENTLY — each replica
        ticks on its own thread at its own pace, no cross-replica barrier
        (``step()``'s lockstep exists for the deterministic driver; a real
        fleet's replicas never wait for each other). Per-replica results
        stay poppable afterwards; per-tick StepEvents are not merged, so
        this is for closed-load draining (benchmarks, batch jobs), not for
        a streaming front-end."""
        if len(self.replicas) == 1:
            self.replicas[0].run_until_idle(max_ticks)
            return
        futures = [self._pool.submit(e.run_until_idle, max_ticks)
                   for e in self.replicas]
        errors = []
        for i, f in enumerate(futures):
            try:
                f.result()
            except Exception as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)
                self._faulted.add(i)
        if errors:
            raise errors[0]

    def run_until_idle(self, max_ticks: int = 100_000) -> List[StepEvents]:
        events = []
        while not self.idle:
            if len(events) >= max_ticks:
                raise RuntimeError(f"fleet not idle after {max_ticks} ticks")
            events.append(self.step())
        return events

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        for e in self.replicas:
            e.close()
