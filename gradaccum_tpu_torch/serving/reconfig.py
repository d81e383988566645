"""Live engine reconfiguration: the serving analogue of crash-resume.

The port of ``gradaccum_tpu/serving/reconfig.py``. A reconfiguration is a
controlled preemption of the whole engine: quiesce admissions (fresh
traffic waits behind a ``reconfiguring`` stall label), preempt every running
slot through the preempt -> park path (K/V staged to the host swap store,
or dropped for a re-prefill resume), rebuild what the spec changes, and let
the parked requests resume token for token through the same resume path
pool pressure uses. Reconfiguration adds no second recovery path.

Three kinds behind one :class:`ReconfigSpec`:

- **pool resize** (:func:`pool_resize`): grow or shrink a paged engine's
  ``num_blocks``. A GROW appends a block segment (``PagedCachePool.grow``)
  with no preemption and the prefix cache kept; a shrink preempts, parks
  and rebuilds. Shrinking below the largest in-flight reservation refuses
  with a :class:`ReconfigError` carrying ``demand`` and ``supply``; on a
  serving mesh, so does a count the model axis does not divide (JAX's
  words). The appended segment and the rebuilt pool hold each rank's own
  heads, as the pool they replace did: there is nothing to place again.
- **checkpoint swap** (:func:`checkpoint_swap`): new weights from a
  checkpoint written by ``estimator/checkpoint.py :: save`` as
  ``{"params": decode_tree, "step": n}`` (restored with quarantine through
  ``restore_params``) or from an in-memory tree. A corrupt checkpoint
  degrades: ``ok=False`` and the old weights keep serving. Byte-identical
  weights keep the swapped K/V; changed weights discard the swap records
  and clear the prefix cache, so no stream decodes new weights against old
  K/V. Without ``draft_params`` a speculative engine keeps its old draft
  (a stale draft costs accept rate, never correctness). On a serving mesh
  every rank restores the whole tree (its template the whole tree,
  gathered) and keeps its block; the weights-unchanged verdict compares
  whole trees, so it reads as at tp=1.
- **replica scale** (:func:`replica_drain`, :func:`replica_activate`,
  :func:`replica_excise`, :func:`replica_add`): fleet operations, applied
  by ``serving/replicated.py :: ReplicatedEngine.reconfigure``.

``resilience/faults.py :: MID_RECONFIG`` fires twice per reconfiguration:
index ``2n`` after the preempt (old configuration, everything parked) and
``2n+1`` after the rebuild (new configuration, everything parked), so a
kill lands in one of two clean states. The count ``n`` advances even
through a kill, so a retry fires fresh indices.

:func:`params_digest` hashes numpy dtype names, shapes and bytes in JAX's
leaf order (keys sorted at every level), so weights carried over from JAX
digest to JAX's own hex string.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from gradaccum_tpu_torch.resilience import faults
from gradaccum_tpu_torch.serving.cache_pool import PagedCachePool
from gradaccum_tpu_torch.serving.engine import _tree_to, rank_tree

POOL_RESIZE = "pool_resize"
CHECKPOINT_SWAP = "checkpoint_swap"
REPLICA_SCALE = "replica_scale"
KINDS = (POOL_RESIZE, CHECKPOINT_SWAP, REPLICA_SCALE)


class ReconfigError(RuntimeError):
    """A spec the engine REFUSES, nothing changed: a shrink below live
    demand, a resize of a fixed pool, a replica op on a single engine. A
    checkpoint-swap rejection is not one: it degrades (``ok=False``)."""

    def __init__(self, message: str, demand: Optional[int] = None,
                 supply: Optional[int] = None):
        super().__init__(message)
        self.demand = demand
        self.supply = supply


@dataclasses.dataclass(frozen=True)
class ReconfigSpec:
    """One reconfiguration order; build it with the helpers below."""

    kind: str
    num_blocks: Optional[int] = None     # pool_resize
    checkpoint: Optional[str] = None     # checkpoint_swap: file or directory
    params: Any = None                   # checkpoint_swap: in-memory tree
    draft_params: Any = None             # checkpoint_swap: optional new draft
    replica: Optional[int] = None        # replica_scale target
    action: Optional[str] = None         # replica_scale: drain|activate|excise|add
    # "operator" or "healer": carried into the result, the span and the
    # metric labels
    initiator: str = "operator"
    # a fleet fan-out computes the weights-unchanged verdict once
    unchanged_hint: Optional[bool] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown reconfig kind {self.kind!r}; one of {KINDS}")

    def to_dict(self) -> dict:
        return {"kind": self.kind, "num_blocks": self.num_blocks,
                "checkpoint": self.checkpoint, "replica": self.replica,
                "action": self.action, "initiator": self.initiator,
                "inline_params": self.params is not None}


def pool_resize(num_blocks: int, initiator: str = "operator") -> ReconfigSpec:
    """Grow or shrink a paged engine's block pool to ``num_blocks``."""
    if int(num_blocks) < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    return ReconfigSpec(POOL_RESIZE, num_blocks=int(num_blocks), initiator=initiator)


def checkpoint_swap(checkpoint: Optional[str] = None, params: Any = None,
                    draft_params: Any = None, initiator: str = "operator") -> ReconfigSpec:
    """Swap the serving weights: from a checkpoint file or directory
    (restored with quarantine and fallback) or an in-memory decode tree (or
    ``GPTLM``). ``draft_params`` refreshes a speculative engine's draft."""
    if (checkpoint is None) == (params is None):
        raise ValueError("checkpoint_swap needs exactly one of checkpoint= (a path) or "
                         "params= (a tree)")
    return ReconfigSpec(CHECKPOINT_SWAP, checkpoint=checkpoint, params=params,
                        draft_params=draft_params, initiator=initiator)


def replica_drain(replica: int, initiator: str = "operator") -> ReconfigSpec:
    """Take one replica out of service: its work re-dispatches across the
    siblings and dispatch stops routing to it."""
    return ReconfigSpec(REPLICA_SCALE, replica=int(replica), action="drain",
                        initiator=initiator)


def replica_activate(replica: int, initiator: str = "operator") -> ReconfigSpec:
    """Bring a drained replica back into the dispatch order (cold pool)."""
    return ReconfigSpec(REPLICA_SCALE, replica=int(replica), action="activate",
                        initiator=initiator)


def replica_excise(replica: int, initiator: str = "operator") -> ReconfigSpec:
    """Remove a DEAD replica without its cooperation, behind the fleet's
    partial-consensus proof; terminal."""
    return ReconfigSpec(REPLICA_SCALE, replica=int(replica), action="excise",
                        initiator=initiator)


def replica_add(initiator: str = "operator") -> ReconfigSpec:
    """Mint a new replica into the live fleet: the id lattice widens by a
    generation and the newcomer joins behind a warm-up admission ramp."""
    return ReconfigSpec(REPLICA_SCALE, action="add", initiator=initiator)


@dataclasses.dataclass
class ReconfigResult:
    """What one reconfiguration did; ``ok=False`` means it degraded (old
    state kept serving). A refused spec raises instead."""

    kind: str
    ok: bool
    reason: Optional[str] = None
    preempted: int = 0
    tick: int = 0
    initiator: str = "operator"
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "ok": self.ok, "reason": self.reason,
                "preempted": self.preempted, "tick": self.tick,
                "initiator": self.initiator, "detail": dict(self.detail)}


def _leaves(tree):
    """Leaves in JAX's ``tree_leaves`` order: dict keys sorted at every level."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for child in tree:
            yield from _leaves(child)
    else:
        yield tree


def params_digest(params) -> str:
    """sha256 over every leaf's dtype name, shape and bytes: whether the
    weights changed, and with them whether swapped K/V may be restored."""
    h = hashlib.sha256()
    for leaf in _leaves(params):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous()
            if t.dtype == torch.bfloat16:
                # numpy has no bfloat16: hash its bits under JAX's name
                name, arr = "bfloat16", t.view(torch.int16).numpy()
            else:
                arr = t.numpy()
                name = str(arr.dtype)
        else:
            arr = np.asarray(leaf)
            name = str(arr.dtype)
        h.update(name.encode())
        h.update(str(tuple(arr.shape)).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def agree_tick(consensus, requested: bool, tick: int):
    """One fleet-wide round over the drain-consensus transport: every host
    gives (do I want a reconfig, my tick) and receives (any wants one, max
    tick). Use a ``DrainConsensus`` of its own for reconfig rounds."""
    return consensus.decide(bool(requested), int(tick))


# -- the engine-level application --------------------------------------------


def _quiesce(engine) -> None:
    """Admissions wait out the reconfiguration; the stall label says why."""
    if engine.scheduler.depth:
        engine.scheduler.record_stall("reconfiguring")


def _preempt_all(engine, keep_swap: bool = True) -> int:
    """Every running slot through the park path. ``keep_swap=False`` (the
    weights changed) parks without staging K/V and discards the records of
    requests parked earlier: every parked request re-prefills."""
    preempted = []
    for slot, req in enumerate(engine._slot_req):
        if req is not None and engine._active[slot]:
            engine._preempt(slot, preempted, stage_swap=keep_swap)
    if not keep_swap and engine._swap_store is not None:
        for rid, pk in engine._parked_state.items():
            if pk.swapped:
                engine._swap_store.discard(rid)
                pk.swapped = False
    return len(preempted)


def _demand_blocks(engine) -> int:
    """The shrink floor: the largest single in-flight reservation (live,
    parked or pending), not their sum. Parked requests resume one at a time
    against a drainable pool, and the rebuild clears the prefix cache, so
    sharing is never counted."""
    pool = engine.pool
    need = 0
    for slot, req in enumerate(engine._slot_req):
        if req is not None:
            limit = int(engine._slot_limit[slot]) or (req.prompt.size + req.max_new_tokens)
            need = max(need, pool.blocks_for(limit))
    for pk in engine._parked_state.values():
        need = max(need, pool.blocks_for(pk.limit))
    for r in engine.scheduler.pending():
        need = max(need, pool.blocks_for(r.prompt.size + r.max_new_tokens))
    return need


def validate_pool_resize(engine, spec: ReconfigSpec) -> None:
    """Every refusal a pool resize can raise, nothing mutated (a fleet
    checks every replica before any rebuilds)."""
    if not engine.paged:
        raise ReconfigError("pool_resize needs paged mode (the fixed pool's shape is "
                            "num_slots x max_len — there is no block count to resize)")
    nb = int(spec.num_blocks)
    if engine.mesh is not None and nb % engine.tp:
        raise ReconfigError(f"num_blocks {nb} not divisible by the model axis ({engine.tp}) "
                            "— the paged pool shards its BLOCK axis")
    demand = _demand_blocks(engine)
    if nb < demand:
        raise ReconfigError(
            f"cannot shrink to {nb} blocks: live+parked demand needs {demand} (the largest "
            "in-flight request's worst case must still fit, or it could never resume)",
            demand=demand, supply=nb)


def _pool_resize(engine, spec: ReconfigSpec) -> ReconfigResult:
    validate_pool_resize(engine, spec)
    nb = int(spec.num_blocks)
    if nb > engine.num_blocks:
        return _pool_grow_incremental(engine, nb)
    _quiesce(engine)
    preempted = _preempt_all(engine)
    # crash point A: the old pool, everything parked
    faults.fire(faults.MID_RECONFIG, 2 * engine._reconfig_count)
    old_nb = engine.num_blocks
    if engine.prefix_cache is not None:
        # every old block vanishes; no stale hash may outlive the rebuild
        engine.prefix_cache.clear()
    pool = PagedCachePool(engine.cfg, len(engine._slot_req), engine.max_len,
                          engine.page_size, nb, prefix_cache=engine.prefix_cache,
                          cache_dtype=engine.cache_dtype, device=engine.device, tp=engine.tp)
    if engine.admission_policy is not None and engine.admission_policy.mode != "reserve":
        pool.allow_overcommit = True
    engine.pool = pool
    engine.num_blocks = nb
    engine._slot_len[:] = 0
    engine._slot_limit[:] = 0
    engine._slot_cow[:] = 0
    # the rebuilt table through the upload-time bounds check every tick uses
    pool.page_table_device()
    # crash point B: the new pool, everything parked
    faults.fire(faults.MID_RECONFIG, 2 * engine._reconfig_count + 1)
    return ReconfigResult(POOL_RESIZE, ok=True, preempted=preempted, tick=engine._tick,
                          detail={"old_num_blocks": old_nb, "new_num_blocks": nb})


def _pool_grow_incremental(engine, nb: int) -> ReconfigResult:
    """GROW without touching anyone: a second block segment addressed
    through the same page table. Running slots, swap records and the prefix
    cache all stay; nothing is preempted."""
    # crash point A: nothing mutated yet
    faults.fire(faults.MID_RECONFIG, 2 * engine._reconfig_count)
    old_nb = engine.num_blocks
    engine.pool.grow(nb - old_nb)
    engine.num_blocks = nb
    # the remapped table through the bounds check, against the new total
    engine.pool.page_table_device()
    # crash point B: the segment appended and the table republished
    faults.fire(faults.MID_RECONFIG, 2 * engine._reconfig_count + 1)
    return ReconfigResult(POOL_RESIZE, ok=True, preempted=0, tick=engine._tick,
                          detail={"old_num_blocks": old_nb, "new_num_blocks": nb,
                                  "incremental": True,
                                  "segments": list(engine.pool.segments)})


def _host_template(params):
    """A host copy of the engine's tree to restore a checkpoint into: the
    serving tensors (and a draft viewing them) are never written."""
    if isinstance(params, dict):
        return {key: _host_template(child) for key, child in params.items()}
    return params.detach().to("cpu", copy=True)


def restore_tree(checkpoint: str, template):
    """Restore ``{"params": tree, ...}`` from ``checkpoint`` into a host copy
    of ``template``; raises what ``restore_params`` raises."""
    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib

    tree = _host_template(template)
    ckpt_lib.restore_params(checkpoint, tree)
    return tree


def restore_errors():
    """What a rejected checkpoint raises: quarantined, missing, unreadable,
    or not this model's tree."""
    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib

    return (ckpt_lib.CheckpointCorruptError, FileNotFoundError, OSError, ValueError,
            KeyError)


def as_tree(params):
    """A ``GPTLM`` as its decode tree; a tree as it is."""
    if isinstance(params, torch.nn.Module):
        from gradaccum_tpu_torch.interop import params_tree

        return params_tree(params)
    return params


def _checkpoint_swap(engine, spec: ReconfigSpec) -> ReconfigResult:
    whole = None  # the serving weights whole (gathered once on a mesh)
    if spec.params is not None:
        new_params = as_tree(spec.params)
    else:
        whole = engine.whole_params()
        try:
            new_params = restore_tree(spec.checkpoint, whole)
        except restore_errors() as e:
            # a poisoned checkpoint is quarantined and the OLD weights keep
            # serving: a bad artifact never takes the fleet down
            return ReconfigResult(CHECKPOINT_SWAP, ok=False, reason=f"checkpoint rejected: {e}",
                                  tick=engine._tick,
                                  detail={"checkpoint": spec.checkpoint, "quarantined": True})
    if spec.unchanged_hint is not None:
        unchanged = bool(spec.unchanged_hint)
    else:
        if whole is None:
            whole = engine.whole_params()
        unchanged = params_digest(whole) == params_digest(new_params)
    _quiesce(engine)
    # changed weights: no stream may decode them against the old K/V
    preempted = _preempt_all(engine, keep_swap=unchanged)
    faults.fire(faults.MID_RECONFIG, 2 * engine._reconfig_count)
    # a draft carved from the new weights shares their copies on the card;
    # on a mesh each rank keeps its block of both
    moved: Dict[int, torch.Tensor] = {}
    placed: Dict[int, torch.Tensor] = {}
    engine.params = _tree_to(rank_tree(new_params, engine.cfg, engine.mesh, placed),
                             engine.device, moved)
    draft_refreshed = False
    if spec.draft_params is not None and engine.speculate_k:
        engine.draft_params = _tree_to(rank_tree(spec.draft_params, engine.draft_cfg,
                                                 engine.mesh, placed), engine.device, moved)
        draft_refreshed = True
    if not unchanged and engine.prefix_cache is not None:
        # shared-prefix entries index K/V the OLD weights computed
        engine.prefix_cache.clear()
    faults.fire(faults.MID_RECONFIG, 2 * engine._reconfig_count + 1)
    return ReconfigResult(CHECKPOINT_SWAP, ok=True, preempted=preempted, tick=engine._tick,
                          detail={"weights_unchanged": unchanged,
                                  "checkpoint": spec.checkpoint,
                                  "draft_refreshed": draft_refreshed})


def apply(engine, spec: ReconfigSpec) -> ReconfigResult:
    """Apply ``spec`` to one ``Engine`` between ticks (the caller holds
    whatever serializes ``step()``). Raises :class:`ReconfigError` for a
    refused spec (state untouched); returns ``ok=False`` for a degraded
    checkpoint swap; a crash-point kill leaves a clean old or new
    configuration with everything parked and propagates."""
    if spec.kind == REPLICA_SCALE:
        raise ReconfigError("replica_scale is a fleet operation — apply it through "
                            "ReplicatedEngine.reconfigure or ServingServer.request_reconfig")
    tr = engine.tracer
    tick0 = engine._tick
    engine.reconfiguring = True
    try:
        with engine._wd_suspend():
            if spec.kind == POOL_RESIZE:
                result = _pool_resize(engine, spec)
            else:
                result = _checkpoint_swap(engine, spec)
    finally:
        engine.reconfiguring = False
        # advances through a crash-point kill too: a retry fires fresh indices
        engine._reconfig_count += 1
    result.initiator = spec.initiator
    engine.last_reconfig = result
    engine.metrics.record_reconfig(result.kind, ok=result.ok, preempted=result.preempted,
                                   initiator=spec.initiator)
    if tr.enabled:
        tr.event("serve/reconfig", cat="serving", kind=spec.kind, ok=result.ok,
                 preempted=result.preempted, tick=tick0, initiator=spec.initiator,
                 **engine._obs_args)
    return result
