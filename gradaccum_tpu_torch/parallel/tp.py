"""Tensor parallelism: JAX's Megatron rules, and the collectives that run them.

The port of ``gradaccum_tpu/parallel/tp.py``. JAX only places the
parameters (regex -> ``PartitionSpec`` rules over the ``model`` axis) and
GSPMD inserts the collectives. The port has no such compiler, so the rules
here are JAX's, word for word, and the models issue the collectives
themselves from these building blocks, each a ``torch.autograd.Function``
over a mesh axis (a :class:`~.mesh.DataMesh`):

- :func:`copy_to`: identity forward, SUM all-reduce backward. It goes
  before a column-parallel layer (QKV, the FFN's intermediate, the tied
  head): each rank's slice of the output gives a part of the input's
  gradient, and the parts sum.
- :func:`reduce_from`: SUM all-reduce forward, identity backward. It goes
  after a row-parallel layer (the attention output, the FFN output): each
  rank's slice of the input gives a part of the output. Its bias is
  replicated and is added once, after the reduce.
- :func:`vocab_parallel_embed`: the lookup in a vocab-sharded table. Ids
  outside this rank's rows give zeros, then a SUM all-reduce: exactly one
  rank adds a nonzero row, so the rows are the whole table's bit for bit.
- :func:`gather_slices`: an all-gather along a dimension whose backward
  takes this rank's slice and does NOT sum: what follows it (the loss) is
  replicated, so every rank already holds the whole gradient, and a sum
  would scale it by the axis width.

Sums of a low-precision tensor run in float32 and round once.

:class:`ShardingPlan` is the placement a train step runs under
(:func:`plan_scope`): which mesh axes split each parameter. The ops that
need a statistic over a whole parameter read it there: the global norm
(:func:`sharded_sq_norm`: one scalar all-reduce per update), the guard's
finite verdict (:func:`all_finite`, pmin'd over the model and expert
groups) and Adam-mini's per-tensor mean square (:func:`whole_mean_sq`).
Without a plan each is the single-device computation.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from gradaccum_tpu_torch.parallel.mesh import EXPERT_AXIS, MODEL_AXIS, DataMesh
from gradaccum_tpu_torch.parallel.sharding import P, placement


def bert_tp_rules(axis: str = MODEL_AXIS):
    """Rules for the BERT parameter names (they apply to the whole train
    state: moments and accumulators share the parameters' names, so the
    same regexes shard them identically)."""
    return [
        # column-parallel: shard the output features
        (r"(query|key|value)/kernel", P(None, axis)),
        (r"(query|key|value)/bias", P(axis)),
        (r"intermediate/kernel", P(None, axis)),
        (r"intermediate/bias", P(axis)),
        # row-parallel: shard the input features; outputs all-reduce
        (r"attention/output/kernel", P(axis, None)),
        (r"ffn_output/kernel", P(axis, None)),
        # big embedding table: shard the vocab dim
        (r"word_embeddings/embedding", P(axis, None)),
    ]


def gpt_tp_rules(axis: str = MODEL_AXIS):
    """The GPT family reuses BERT's parameter names, so its Megatron layout
    is :func:`bert_tp_rules` verbatim; ``position_embeddings`` and the
    LayerNorms match no rule and stay replicated."""
    return bert_tp_rules(axis)


def bert_tp_ep_rules(model_axis: str = MODEL_AXIS, expert_axis: str = EXPERT_AXIS):
    """data x model x expert rules for a MoE-FFN BERT: attention and
    embeddings as :func:`bert_tp_rules`, each expert-stacked leaf split 2-D
    (experts over ``expert``, the per-expert matmul Megatron-style over
    ``model``); the router stays replicated."""
    return [
        (r"w_in", P(expert_axis, None, model_axis)),
        (r"b_in", P(expert_axis, model_axis)),
        (r"w_out", P(expert_axis, model_axis, None)),
        (r"b_out", P(expert_axis, None)),
    ] + bert_tp_rules(model_axis)


# --------------------------------------------------------------------------
# Collectives with their gradients
# --------------------------------------------------------------------------


def _sum(x: torch.Tensor, mesh: DataMesh, tag: str) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh`` (a new tensor), in float32
    or wider."""
    wide = x.detach().to(torch.promote_types(x.dtype, torch.float32)).contiguous().clone()
    mesh.all_reduce_(wide, tag=tag)
    return wide.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, "copy_to"), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh, "reduce_from")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, dim=dim, tag="gather")

    @staticmethod
    def backward(ctx, g):
        m, d = ctx.mesh, ctx.dim
        size = g.shape[d] // m.world
        return g.narrow(d, m.rank * size, size), None, None


def copy_to(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Identity forward, SUM all-reduce of the gradient over ``mesh``."""
    return x if mesh.solo else _CopyTo.apply(x, mesh)


def reduce_from(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """SUM all-reduce over ``mesh`` forward, identity backward."""
    return x if mesh.solo else _ReduceFrom.apply(x, mesh)


def gather_slices(x: torch.Tensor, mesh: DataMesh, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    backward keeps this rank's slice of the gradient, unsummed."""
    if mesh.solo:
        return x
    return _GatherSlices.apply(x.contiguous(), mesh, dim % x.dim())


def vocab_parallel_embed(ids: torch.Tensor, table: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Rows ``ids`` of the whole table, from this rank's ``table`` rows
    ``[rank*V/n, (rank+1)*V/n)``: ids outside them give zeros, and a SUM
    all-reduce adds the one rank's row. Differentiable in ``table``."""
    rows = table.shape[0]
    local = ids.long() - mesh.rank * rows
    inside = (local >= 0) & (local < rows)
    found = F.embedding(torch.where(inside, local, torch.zeros_like(local)), table)
    found = found * inside[..., None].to(found.dtype)
    return reduce_from(found, mesh)


def vocab_rows_(grad: torch.Tensor, ids: torch.Tensor, cotangents: torch.Tensor,
                mesh: DataMesh) -> torch.Tensor:
    """Scatter-add the row ``cotangents`` of ``ids`` into this rank's block
    ``grad`` of a vocab-sharded table gradient: only the ids in its own
    rows land (the sparse embedding path under the table's sharding)."""
    rows = grad.shape[0]
    local = ids.long() - mesh.rank * rows
    inside = (local >= 0) & (local < rows)
    return grad.index_add_(0, local[inside], cotangents[inside].to(grad.dtype))


def axis_of(param: torch.Tensor, dim: int) -> Optional[str]:
    """The mesh axis that splits dimension ``dim`` of ``param`` (its
    :func:`~.sharding.placement`), or None."""
    dims = placement(param)
    return None if dims is None else dims[dim]


# --------------------------------------------------------------------------
# The placement a step runs under
# --------------------------------------------------------------------------


class ShardingPlan:
    """How a model's parameters lie on a :class:`~.mesh.Mesh`: ``dims``
    maps every parameter name to its torch-layout placement (one axis or
    None per dimension). ``group`` is the mesh over every axis that splits
    some parameter: the ranks that together hold one whole copy."""

    def __init__(self, mesh, dims: Dict[str, tuple]):
        self.mesh = mesh
        self.dims = dict(dims)
        used = {a for d in self.dims.values() for a in d if a}
        self.axes = tuple(a for a in mesh.axis_names if a in used)
        self.group = mesh.over(self.axes)

    def leaf_axes(self, name: str) -> tuple:
        """The axes that split parameter ``name`` (mesh order)."""
        used = {a for a in self.dims.get(name, ()) if a}
        return tuple(a for a in self.axes if a in used)

    def owns(self, name: str) -> bool:
        """Whether this rank counts its block of ``name`` in a sum over
        ``group``: the one rank of each block's copies whose coordinates on
        the axes that do not split it are 0."""
        axes = self.leaf_axes(name)
        return all(self.mesh.coords[a] == 0 for a in self.axes if a not in axes)


_PLAN: contextvars.ContextVar = contextvars.ContextVar("gradaccum_plan", default=None)
_SPLITS: contextvars.ContextVar = contextvars.ContextVar("gradaccum_splits", default=None)


@contextlib.contextmanager
def plan_scope(plan: Optional[ShardingPlan]):
    """Run the body under ``plan`` (None: no sharding)."""
    token = _PLAN.set(plan)
    try:
        yield plan
    finally:
        _PLAN.reset(token)


@contextlib.contextmanager
def split_scope(splits: Dict[str, DataMesh]):
    """Run the body with the named leaves further split over the given
    meshes (ZeRO-1's update on its data block)."""
    token = _SPLITS.set(splits)
    try:
        yield
    finally:
        _SPLITS.reset(token)


def active_plan() -> Optional[ShardingPlan]:
    return _PLAN.get()


def _sq(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(t.float()))


def sharded_sq_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Σ g² over the whole of every gradient of ``grads``: the replicated
    leaves locally, the sharded ones as ONE scalar SUM all-reduce over the
    plan's group (each block counted by the one rank that
    :meth:`ShardingPlan.owns` it). Without a plan: the local sum."""
    plan = active_plan()
    if plan is None or plan.group.solo:
        return sum(_sq(g) for g in grads.values())
    whole = [g for name, g in grads.items() if not plan.leaf_axes(name)]
    parts = [_sq(g) if plan.owns(name) else torch.zeros((), device=g.device)
             for name, g in grads.items() if plan.leaf_axes(name)]
    total = sum(_sq(g) for g in whole) if whole else None
    if parts:
        shared = torch.stack(parts).sum().reshape(1)
        plan.group.all_reduce_(shared, tag="norm")
        total = shared[0] if total is None else total + shared[0]
    return total


def all_finite(flag: torch.Tensor) -> torch.Tensor:
    """``flag`` (a 0-d bool: this rank's blocks are finite) pmin'd over
    the plan's group, so every rank of a model copy takes the same verdict."""
    plan = active_plan()
    if plan is None or plan.group.solo:
        return flag
    return plan.group.pmin_flag(flag, tag="guard")


def whole_mean_sq(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{name: mean(g²)}`` over the whole of each parameter, from this
    rank's blocks: a leaf split by the plan (and by :func:`split_scope`)
    sums its Σg² over those meshes, in one all-reduce per mesh for all such
    leaves together, and divides by the whole element count. A leaf split
    by nothing computes ``torch.mean(torch.square(g))`` as one device does."""
    plan, extra = active_plan(), _SPLITS.get() or {}
    out: Dict[str, torch.Tensor] = {}
    by_key: Dict[tuple, List[str]] = {}
    meshes: Dict[str, List[DataMesh]] = {}
    for name, g in grads.items():
        ms = [] if plan is None else [plan.mesh.axis(a) for a in plan.leaf_axes(name)]
        ms += [m for m in extra.get(name, ()) if not m.solo]
        if not ms:
            out[name] = torch.mean(torch.square(g))
            continue
        meshes[name] = ms
        by_key.setdefault(tuple(m.axis for m in ms), []).append(name)
    for key in sorted(by_key):
        names = by_key[key]
        sums = torch.stack([_sq(grads[n]) for n in names])
        for m in meshes[names[0]]:
            m.all_reduce_(sums, tag="stats")
        for i, n in enumerate(names):
            count = grads[n].numel()
            for m in meshes[n]:
                count *= m.world
            out[n] = (sums[i] / count).to(grads[n].dtype)
    return {name: out[name] for name in grads}
