"""ZeRO-1: shard the optimizer state over the ``data`` ranks.

The port of ``gradaccum_tpu/parallel/zero.py``. Plain data parallelism
keeps a full copy of the Adam moments (and, under mixed precision, of the
float32 masters) on every rank; ZeRO stage 1 (arXiv 2004.13336) keeps only
this rank's block of each, so the optimizer memory per rank falls by the
world size while the training math is unchanged.

- :func:`shard_dim` is the ONE rule deciding how a leaf splits: its first
  dimension divisible by the world size (None: it stays whole, as scalars
  and indivisible leaves do), read in the JAX package's layout
  (:func:`zero_dim`: a Dense kernel's [in, out]), so each leaf splits as
  JAX's does. The state's layout, the update's slices and the gather all
  read it, so they cannot disagree.
- :func:`zero1_state_specs` / :func:`zero1_shard_state`: every
  ``opt_state/`` leaf, masters included, keeps only this rank's contiguous
  block of its :func:`shard_dim`; the parameters (and streaming mode's
  accumulators) stay whole on every rank. :func:`zero1_gather_state`
  rebuilds the full tree, so checkpoints stay full-tree and a resume stays
  bitwise.
- :func:`zero1_optimizer`: the gradients (already summed over the ranks)
  and the parameters are sliced to this rank's block, the inner update runs
  on the slices against the local moments, and the new parameter blocks are
  all-gathered back into the full parameters in the PARAMETER dtype (bf16
  parameters gather at half the bytes of the float32 state), one collective
  per dtype. A statistic over a whole parameter (Adam-mini's per-tensor
  second moment) sums its blocks' Σg² over the ranks first, where JAX's
  GSPMD placement computes it whole.
- With parameter ``rules`` (tensor and expert parallelism), a moment the
  rules split keeps that split and every rank of the data axis updates its
  model block whole; the rest split over ``data``, as JAX's
  ``_zero1_spec``. :func:`zero1_partition_specs` states the layout in JAX's
  terms.
- :func:`make_zero1_train_step`: the explicit step, ``make_dp_train_step``'s
  cost model (scan: one all-reduce per update) with the sharded update; it
  rejects q8 moments and ``fused_adam``, as JAX does.
- :func:`make_zero1_placement_step`: ``Estimator(zero1=True)``, the
  counterpart of JAX's GSPMD placement: ``make_pjit_dp_train_step`` (each
  micro-batch's gradient averaged over the ranks) with the sharded update;
  under ``fused_adam`` each micro-batch's averaged gradient folds into this
  rank's moment shard.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gradaccum_tpu_torch.memory.quant import QuantTensor
from gradaccum_tpu_torch.ops import accumulation as acc
from gradaccum_tpu_torch.ops.adamw import FusedAccum, Optimizer
from gradaccum_tpu_torch.parallel.dp import make_dp_train_step, make_pjit_dp_train_step
from gradaccum_tpu_torch.parallel.mesh import DATA_AXIS, DataMesh
from gradaccum_tpu_torch.parallel.sharding import (
    P,
    PartitionSpec,
    Rules,
    layout_perm,
    spec_for,
    torch_dims,
)
from gradaccum_tpu_torch.parallel.tp import split_scope
from gradaccum_tpu_torch.utils.tree import map_state

_MOMENT_PREFIX = "opt_state/"


def _map_tree(fn, node, path: str):
    """:func:`~..utils.tree.map_state` with QuantTensor leaves too."""
    return map_state(fn, node, path, leaf_types=(torch.Tensor, QuantTensor))


def _reject_quantized(state) -> None:
    found = []
    _map_tree(lambda path, leaf: found.append(leaf) if isinstance(leaf, QuantTensor)
              else leaf, state, "")
    if found:
        raise ValueError(
            "ZeRO-1 cannot shard q8-quantized optimizer state "
            "(moment_dtype='q8'): the blockwise codec's static shape "
            "does not survive a per-rank slice — use moment_dtype='q8' "
            "OR zero1, not both"
        )


def shard_dim(shape, n: int) -> Optional[int]:
    """The first dimension of ``shape`` divisible by ``n`` (None: none)."""
    for d, size in enumerate(shape):
        if size >= n and size % n == 0:
            return d
    return None


def zero_dim(name: str, shape, n: int) -> Optional[int]:
    """The dimension of the port's tensor ``name`` that ZeRO-1 splits:
    :func:`shard_dim` of the shape in the JAX package's layout (a Dense
    kernel's [in, out]), as the port's dimension, so every leaf splits as
    JAX's does (None: it stays whole)."""
    perm = layout_perm(name, len(shape))
    d = shard_dim([shape[perm.index(j)] for j in range(len(shape))], n)
    return None if d is None else perm.index(d)


def _rule_split(path: str, leaf, rules: Optional[Rules]) -> bool:
    return any(torch_dims(path, spec_for(path, rules), leaf.dim()))


def zero1_state_specs(state, n: int, rules: Optional[Rules] = None) -> Dict[str, Optional[int]]:
    """``{path: split dim}`` for every tensor leaf of a Scan/Streaming
    state: the :func:`zero_dim` of each ``opt_state/`` leaf that the
    parameter ``rules`` leave whole, None for every other leaf (a leaf the
    rules split keeps that split, over its model axes)."""
    _reject_quantized(state)
    specs = {}

    def spec(path, leaf):
        moment = path.startswith(_MOMENT_PREFIX) and not _rule_split(path, leaf, rules)
        specs[path] = zero_dim(path, tuple(leaf.shape), n) if moment else None
        return leaf

    _map_tree(spec, state, "")
    return specs


def zero1_partition_specs(state, n: int, rules: Optional[Rules] = None,
                          axis: str = DATA_AXIS) -> Dict[str, PartitionSpec]:
    """``{path: PartitionSpec}`` of the ZeRO-1 layout in the JAX package's
    terms (its layout, its ``zero1_state_specs``): every leaf follows
    ``rules``, except the rule-replicated ``opt_state/`` leaves, split over
    ``axis`` along their :func:`zero_dim`."""
    _reject_quantized(state)
    specs = {}

    def spec(path, leaf):
        base = spec_for(path, rules)
        if not path.startswith(_MOMENT_PREFIX) or base != P():
            specs[path] = base
            return leaf
        d = zero_dim(path, tuple(leaf.shape), n)
        specs[path] = P() if d is None else P(*([None] * layout_perm(path, leaf.dim())[d]), axis)
        return leaf

    _map_tree(spec, state, "")
    return specs


def _block(x: torch.Tensor, d: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``x`` along ``d`` (a view), or ``x``."""
    if d is None:
        return x
    size = x.shape[d] // n
    return x.narrow(d, rank * size, size)


def zero1_shard_state(state, mesh: DataMesh, rules: Optional[Rules] = None):
    """The state with every sharded ``opt_state/`` leaf cut to this rank's
    block (a copy: the full tensor is freed with the old state)."""
    specs = zero1_state_specs(state, mesh.world, rules)
    return _map_tree(lambda path, leaf: leaf if specs[path] is None else
                     _block(leaf, specs[path], mesh.rank, mesh.world).clone(),
                     state, "")


def zero1_gather_state(state, mesh: DataMesh, specs: Dict[str, Optional[int]]):
    """The full state from the sharded one (every rank must call it):
    each leaf that ``specs`` (of the full state) shards is all-gathered."""
    return _map_tree(lambda path, leaf: leaf if specs[path] is None else
                     mesh.all_gather(leaf, dim=specs[path], tag="state"), state, "")


def _gather_params_(params, dims, mesh: DataMesh) -> None:
    """Write every rank's updated block into the full parameters: one
    all-gather per dtype, in the parameters' dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for name, p in params.items():
        if dims[name] is not None:
            by_dtype.setdefault(p.dtype, []).append(name)
    for names in by_dtype.values():
        blocks = [_block(params[name], dims[name], mesh.rank, mesh.world) for name in names]
        flat = torch.cat([b.reshape(-1) for b in blocks])
        rows = mesh.all_gather(flat, dim=0, tag="params").view(mesh.world, -1)
        offset = 0
        for name, b in zip(names, blocks):
            n = b.numel()
            parts = rows[:, offset:offset + n].reshape(mesh.world, *b.shape)
            params[name].copy_(torch.cat(parts.unbind(0), dim=dims[name]))
            offset += n


def zero1_optimizer(inner: Optimizer, mesh: DataMesh,
                    forward_fused: bool = False, rules: Optional[Rules] = None) -> Optimizer:
    """Wrap ``inner`` so its update runs on this rank's blocks (see the
    module docstring) against a state placed by :func:`zero1_shard_state`.
    ``init`` is the inner, full-size init. A parameter the ``rules`` split
    over model axes is updated whole on its model block (its moments are
    not split over the data ranks). A statistic over a whole parameter
    (Adam-mini's mean square) sums its blocks over the data ranks
    (``parallel/tp.py :: split_scope``).

    The fused-accumulation hooks are forwarded only with
    ``forward_fused=True`` (the placement path, whose micro-batch gradients
    are already averaged over the ranks): the fold slices each one to this
    rank's block of the moments, and the apply gathers the parameters."""

    def dims_of(tree):
        return {name: None if _rule_split(name, t, rules)
                else zero_dim(name, tuple(t.shape), mesh.world) for name, t in tree.items()}

    def local(tree, dims):
        return {name: _block(t, dims[name], mesh.rank, mesh.world) for name, t in tree.items()}

    @torch.no_grad()
    def update(grads, state, params, step):
        dims = dims_of(params)
        with split_scope({name: [mesh] for name, d in dims.items() if d is not None}):
            _, new_state = inner.update(local(grads, dims), state, local(params, dims), step)
        _gather_params_(params, dims, mesh)
        return params, new_state

    fused = None
    if forward_fused and inner.fused is not None:
        hooks = inner.fused

        @torch.no_grad()
        def accumulate(mv, grads, good, first, inv_m, inv_v):
            hooks.accumulate(mv, local(grads, dims_of(grads)), good, first, inv_m, inv_v)

        @torch.no_grad()
        def apply(state, mv, params, step):
            dims = dims_of(params)
            _, new_state = hooks.apply(state, mv, local(params, dims), step)
            _gather_params_(params, dims, mesh)
            return params, new_state

        fused = FusedAccum(hooks.moments, hooks.carry_into, accumulate, apply)
    return Optimizer(init=inner.init, update=update, fused=fused)


def _checked(step):
    """``step`` that rejects a q8 state at its first call."""
    seen = []

    def train_step(state, batch, *rng):
        if not seen:
            _reject_quantized(state)
            seen.append(True)
        return step(state, batch, *rng)

    return train_step


def make_zero1_train_step(loss_fn: acc.LossFn, optimizer: Optimizer,
                          config: acc.GradAccumConfig, mesh: DataMesh,
                          mode: str = "scan", axis: str = DATA_AXIS,
                          needs_rng: bool = False):
    """Explicit-collective ZeRO-1 step: ``make_dp_train_step`` with the
    update sharded by :func:`zero1_optimizer`. The state must be placed
    with :func:`zero1_shard_state` (the Estimator does both)."""
    if config.fused_adam:
        raise ValueError(
            "fused_adam + the explicit zero1 step cannot compose (the fused "
            "window folds into replicated moments per micro-batch); use the "
            "GSPMD placement — Estimator(zero1=True) routes there when "
            "fused_adam is set"
        )
    zopt = zero1_optimizer(optimizer, mesh)
    return _checked(make_dp_train_step(loss_fn, zopt, config, mesh, mode=mode, axis=axis,
                                       needs_rng=needs_rng))


def make_zero1_placement_step(loss_fn: acc.LossFn, optimizer: Optimizer,
                              config: acc.GradAccumConfig, mesh: DataMesh,
                              mode: str = "scan", axis: str = DATA_AXIS,
                              needs_rng: bool = False, rules: Optional[Rules] = None,
                              sparse=None):
    """``Estimator(zero1=True)``'s step: :func:`~.dp.make_pjit_dp_train_step`
    with the sharded update, fused hooks forwarded; ``rules`` as in
    :func:`zero1_optimizer`, ``sparse`` as in ``make_pjit_dp_train_step``."""
    zopt = zero1_optimizer(optimizer, mesh, forward_fused=True, rules=rules)
    return _checked(make_pjit_dp_train_step(loss_fn, zopt, config, mesh, mode=mode,
                                            axis=axis, needs_rng=needs_rng, sparse=sparse))
