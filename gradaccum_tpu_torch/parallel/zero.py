"""ZeRO-1: shard the optimizer state over the ``data`` ranks.

The port of ``gradaccum_tpu/parallel/zero.py``. Plain data parallelism
keeps a full copy of the Adam moments (and, under mixed precision, of the
float32 masters) on every rank; ZeRO stage 1 (arXiv 2004.13336) keeps only
this rank's block of each, so the optimizer memory per rank falls by the
world size while the training math is unchanged.

- :func:`shard_dim` is the ONE rule deciding how a leaf splits: its first
  dimension divisible by the world size (None: it stays whole, as scalars
  and indivisible leaves do). The state's layout, the update's slices and
  the gather all read it, so they cannot disagree.
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
  per dtype. A block cannot compute a statistic over a whole parameter, so
  a state that holds one (Adam-mini's per-tensor second moment) is refused
  where JAX's GSPMD placement would compute it whole.
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

_MOMENT_PREFIX = "opt_state/"


def _map_tree(fn, node, path: str):
    """``node`` rebuilt with every tensor (and QuantTensor) leaf replaced by
    ``fn(path, leaf)``; paths join names with "/" as checkpoints do."""
    if isinstance(node, (torch.Tensor, QuantTensor)):
        return fn(path, node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_tree(fn, child, f"{path}/{key}" if path else key)
                            for key, child in zip(node._fields, node)))
    if isinstance(node, dict):
        return {key: _map_tree(fn, child, f"{path}/{key}" if path else key)
                for key, child in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_map_tree(fn, child, f"{path}/{i}" if path else str(i))
                          for i, child in enumerate(node))
    return node


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


def _reject_whole_tensor_stats(state, n: int) -> None:
    """Refuse an ``opt_state/`` leaf that belongs to a parameter this rank
    updates a block of, but is neither that parameter's shape nor its
    block's (Adam-mini's one second moment per tensor): the sliced update
    would fill it from this rank's block of the gradient alone. Works on
    the full state and on the sharded one."""
    params = state.params
    found = []

    def check(path, leaf):
        parts = path.split("/")
        name = next(("/".join(parts[i:]) for i in range(2, len(parts))
                     if "/".join(parts[i:]) in params), None)
        if name is None:
            return leaf
        shape = tuple(params[name].shape)
        d = shard_dim(shape, n)
        block = None if d is None else shape[:d] + (shape[d] // n,) + shape[d + 1:]
        if d is not None and tuple(leaf.shape) not in (shape, block):
            found.append(f"{path}, shape {tuple(leaf.shape)} for a parameter of {shape}")
        return leaf

    _map_tree(check, state.opt_state, "opt_state")
    if found:
        raise ValueError(
            f"ZeRO-1 cannot shard optimizer state that holds a statistic over a "
            f"whole parameter ({found[0]}; adam_mini's per-tensor second moment is "
            f"one): each rank would compute it from its block of the gradient "
            f"alone — use adam_mini OR zero1, not both"
        )


def shard_dim(shape, n: int) -> Optional[int]:
    """The first dimension of ``shape`` divisible by ``n`` (None: none)."""
    for d, size in enumerate(shape):
        if size >= n and size % n == 0:
            return d
    return None


def zero1_state_specs(state, n: int) -> Dict[str, Optional[int]]:
    """``{path: shard dim}`` for every tensor leaf of a Scan/Streaming
    state: the :func:`shard_dim` of each ``opt_state/`` leaf, None (whole)
    for every other leaf."""
    _reject_quantized(state)
    _reject_whole_tensor_stats(state, n)
    specs = {}

    def spec(path, leaf):
        specs[path] = shard_dim(leaf.shape, n) if path.startswith(_MOMENT_PREFIX) else None
        return leaf

    _map_tree(spec, state, "")
    return specs


def _block(x: torch.Tensor, d: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``x`` along ``d`` (a view), or ``x``."""
    if d is None:
        return x
    size = x.shape[d] // n
    return x.narrow(d, rank * size, size)


def zero1_shard_state(state, mesh: DataMesh):
    """The state with every sharded ``opt_state/`` leaf cut to this rank's
    block (a copy: the full tensor is freed with the old state)."""
    specs = zero1_state_specs(state, mesh.world)
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
                    forward_fused: bool = False) -> Optimizer:
    """Wrap ``inner`` so its update runs on this rank's blocks (see the
    module docstring) against a state placed by :func:`zero1_shard_state`.
    ``init`` is the inner, full-size init.

    The fused-accumulation hooks are forwarded only with
    ``forward_fused=True`` (the placement path, whose micro-batch gradients
    are already averaged over the ranks): the fold slices each one to this
    rank's block of the moments, and the apply gathers the parameters."""

    def dims_of(tree):
        return {name: shard_dim(t.shape, mesh.world) for name, t in tree.items()}

    def local(tree, dims):
        return {name: _block(t, dims[name], mesh.rank, mesh.world) for name, t in tree.items()}

    @torch.no_grad()
    def update(grads, state, params, step):
        dims = dims_of(params)
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


def _checked(step, mesh: DataMesh):
    """``step`` that rejects a q8 state, and a whole-tensor statistic, at
    its first call."""
    seen = []

    def train_step(state, batch, *rng):
        if not seen:
            _reject_quantized(state)
            _reject_whole_tensor_stats(state, mesh.world)
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
                                       needs_rng=needs_rng), mesh)


def make_zero1_placement_step(loss_fn: acc.LossFn, optimizer: Optimizer,
                              config: acc.GradAccumConfig, mesh: DataMesh,
                              mode: str = "scan", axis: str = DATA_AXIS,
                              needs_rng: bool = False):
    """``Estimator(zero1=True)``'s step: :func:`~.dp.make_pjit_dp_train_step`
    with the sharded update, fused hooks forwarded."""
    zopt = zero1_optimizer(optimizer, mesh, forward_fused=True)
    return _checked(make_pjit_dp_train_step(loss_fn, zopt, config, mesh, mode=mode,
                                            axis=axis, needs_rng=needs_rng), mesh)
