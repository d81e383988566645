"""Batch and parameter placement over the port's meshes.

The port of ``gradaccum_tpu/parallel/sharding.py``:

- :func:`host_shard` slices this host's stripe of a global batch, rows
  ``[i*B/H, (i+1)*B/H)`` (the reference's ``InputContext`` sharding), with
  JAX's divisibility error;
- :func:`batch_shard` gives rank r its contiguous block
  ``[r*B/N, (r+1)*B/N)`` of dim 0 (streaming, ``[B, ...]``) or of dim 1 (scan,
  ``[K, B, ...]``, ``leading_unsharded=1``): the rows JAX's
  ``batch_sharding`` lays on device r of the ``data`` axis, so each rank sees
  what JAX's device r sees;
- :func:`replicate_` broadcasts rank 0's parameters to every rank, the
  mirrored-variable placement;
- the regex rules: :func:`spec_for` gives a leaf's :class:`PartitionSpec`
  by first match (no match: replicated), :func:`shard_params` keeps this
  rank's block of every leaf, :func:`gather_params` all-gathers the blocks
  back into the whole leaves (checkpoints, export).

A :class:`PartitionSpec` names one mesh axis (or None) per dimension in
the JAX package's layout, so a rule reads the same in both packages. The
port's Dense kernels are ``Linear.weight`` [out, in] where JAX's are
[in, out] (and a Conv kernel is OIHW where JAX's is HWIO):
:func:`torch_dims` maps a spec onto the port's tensor by the leaf's name.
A 0-d leaf (Adam-mini's per-tensor second moment) stays whole on every
rank. A dimension that its axis does not divide raises, as JAX's
``device_put`` does, and so does q8-quantized state (as under ZeRO-1).
Every rank builds the same whole state (from the seed, a warm start or a
checkpoint) and keeps its block: no bytes move.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gradaccum_tpu_torch.memory.quant import QuantTensor
from gradaccum_tpu_torch.parallel.mesh import DataMesh
from gradaccum_tpu_torch.utils.tree import map_state


class PartitionSpec(tuple):
    """A placement: one mesh axis name, or None, per dimension (JAX's
    ``PartitionSpec``; ``P()`` is replicated). Trailing dimensions not
    named are whole."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec

# rule: (name_regex, PartitionSpec). First match wins; no match -> replicated.
Rules = Sequence[Tuple[str, PartitionSpec]]

_CONV_TO_TORCH = (3, 2, 0, 1)  # torch OIHW dim i holds JAX HWIO dim _CONV_TO_TORCH[i]


def spec_for(name: str, rules: Optional[Rules]) -> PartitionSpec:
    """The placement of the leaf ``name``: the first rule whose regex
    ``re.search``-es it, else replicated."""
    for pattern, spec in rules or ():
        if re.search(pattern, name):
            return PartitionSpec(*spec)
    return P()


def param_shardings(params, rules: Optional[Rules] = None) -> Dict[str, PartitionSpec]:
    """``{name: PartitionSpec}`` for every leaf of the dict ``params``."""
    return {name: spec_for(name, rules) for name in params}


def layout_perm(name: str, ndim: int) -> Tuple[int, ...]:
    """For each dimension of the port's tensor ``name``, the JAX package's
    dimension it holds: a 2-D ``kernel`` is transposed, a 4-D one is
    OIHW for HWIO; every other leaf keeps JAX's layout."""
    if name.endswith("kernel") and ndim == 2:
        return (1, 0)
    if name.endswith("kernel") and ndim == 4:
        return _CONV_TO_TORCH
    return tuple(range(ndim))


def torch_dims(name: str, spec: PartitionSpec, ndim: int) -> Tuple[Optional[str], ...]:
    """``spec`` (JAX's layout) as one axis-or-None per dimension of the
    port's ``ndim``-dimensional tensor ``name``; all None when replicated."""
    if ndim == 0 or not any(spec):
        return (None,) * ndim
    if len(spec) > ndim:
        raise ValueError(f"{name}: the sharding {spec} has more dimensions than the "
                         f"{ndim}-dimensional leaf")
    jax_dims = tuple(spec) + (None,) * (ndim - len(spec))
    for axis in jax_dims:
        if axis is not None and not isinstance(axis, str):
            raise NotImplementedError(f"{name}: a dimension split over several axes "
                                      f"({axis!r}) is not supported")
    return tuple(jax_dims[j] for j in layout_perm(name, ndim))


def _split(x: torch.Tensor, name: str, dims, mesh):
    """``[(dim, axis mesh)]`` of the dimensions of ``x`` that ``dims``
    shards, each checked for divisibility."""
    out = []
    for d, axis in enumerate(dims):
        if axis is None:
            continue
        m = mesh.axis(axis)
        if x.shape[d] % m.world:
            raise ValueError(
                f"{name}: the sharding over '{axis}' implies that the global size of its "
                f"dimension {d} should be divisible by {m.world}, but it is equal to "
                f"{x.shape[d]} (full shape: {tuple(x.shape)})")
        out.append((d, m))
    return out


def block(x: torch.Tensor, name: str, dims, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``dims`` (a view)."""
    for d, m in _split(x, name, dims, mesh):
        size = x.shape[d] // m.world
        x = x.narrow(d, m.rank * size, size)
    return x


def gather_leaf(x: torch.Tensor, dims, mesh, tag: str = "gather") -> torch.Tensor:
    """The whole tensor from this rank's block ``x``: one all-gather per
    sharded dimension, over that dimension's axis (every rank must call)."""
    for d, axis in enumerate(dims):
        if axis is not None:
            x = mesh.axis(axis).all_gather(x, dim=d, tag=tag)
    return x


def placement(param: torch.Tensor) -> Optional[Tuple[Optional[str], ...]]:
    """The torch-layout placement :func:`shard_params` gave a parameter
    (one axis or None per dimension), or None: replicated."""
    return getattr(param, "placement", None)


def mark_invariant(param: torch.Tensor, axis: str) -> torch.Tensor:
    """Mark ``param`` invariant over the mesh axis ``axis``: every use of it
    follows a sum over that axis (the head after the sequence-parallel
    readout), so each rank of the axis computes its whole gradient, where
    the other parameters' gradients are each rank's part (JAX's
    varying-manual-axes typing tells the two apart)."""
    param.invariant_axes = tuple(getattr(param, "invariant_axes", ())) + (axis,)
    return param


def invariant_axes(param: torch.Tensor) -> Tuple[str, ...]:
    """The axes :func:`mark_invariant` marked ``param`` invariant over."""
    return getattr(param, "invariant_axes", ())


def host_shard(batch, num_hosts: Optional[int] = None, host_id: Optional[int] = None):
    """This host's stripe of every value of the dict ``batch`` (numpy
    arrays or tensors), dim 0. Defaults: the process group's world size and
    rank, or one host without a group."""
    initialized = dist.is_available() and dist.is_initialized()
    if num_hosts is None:
        num_hosts = dist.get_world_size() if initialized else 1
    if host_id is None:
        host_id = dist.get_rank() if initialized else 0

    def slice_leaf(x):
        n = x.shape[0]
        if n % num_hosts:
            raise ValueError(f"batch dim {n} not divisible by {num_hosts} hosts")
        per = n // num_hosts
        return x[host_id * per:(host_id + 1) * per]

    return {key: slice_leaf(x) for key, x in batch.items()}


def batch_shard(batch, mesh: DataMesh, leading_unsharded: int = 0):
    """Rank ``mesh.rank``'s block of dim ``leading_unsharded`` of every
    value of the dict ``batch`` (a view: no copy)."""
    d, world, rank = leading_unsharded, mesh.world, mesh.rank

    def slice_leaf(x):
        n = x.shape[d]
        if n % world:
            raise ValueError(f"batch dim {d} of size {n} is not divisible by the "
                             f"{world}-wide '{mesh.axis}' axis")
        per = n // world
        index = (slice(None),) * d + (slice(rank * per, (rank + 1) * per),)
        return x[index]

    return {key: slice_leaf(x) for key, x in batch.items()}


def replicate_(params, mesh: DataMesh):
    """Overwrite every tensor of the dict ``params`` with rank 0's (one
    broadcast per dtype); returns ``params``."""
    mesh.broadcast_tensors_(list(params.values()), src=0, tag="replicate")
    return params


def state_dims(state, rules: Optional[Rules]) -> Dict[str, tuple]:
    """``{path: torch-layout dims}`` for every tensor leaf of a state (or a
    dict of parameters), under ``rules``."""
    dims = {}

    def visit(path, leaf):
        dims[path] = torch_dims(path, spec_for(path, rules), leaf.dim())
        return leaf

    map_state(visit, state)
    return dims


def shard_params(params, mesh, rules: Optional[Rules] = None):
    """Place ``params`` on the mesh. Without rules: replicated, rank 0's
    values broadcast (a :class:`DataMesh`). With rules: every tensor leaf
    of ``params`` (a dict of parameters or a whole train state) cut to this
    rank's block. A ``Parameter`` keeps its identity (its ``data`` becomes
    the block and it records its :func:`placement`), so a module holding
    it runs sharded; other leaves are replaced by copies of their blocks."""
    if not rules:
        return replicate_(params, mesh)
    quantized = []
    map_state(lambda path, leaf: quantized.append(path) if isinstance(leaf, QuantTensor)
              else leaf, params, leaf_types=(torch.Tensor, QuantTensor))
    if quantized:
        raise ValueError(
            f"sharding rules cannot split q8-quantized optimizer state ({quantized[0]}): "
            f"the blockwise codec's static shape does not survive a per-rank block; use "
            f"moment_dtype='q8' OR sharding rules, not both")

    def cut(path, leaf):
        dims = torch_dims(path, spec_for(path, rules), leaf.dim())
        if not any(dims):
            return leaf
        part = block(leaf.detach(), path, dims, mesh).clone()
        if isinstance(leaf, torch.nn.Parameter):
            leaf.data = part
            leaf.placement = dims
            return leaf
        return part

    return map_state(cut, params)


def gather_params(params, mesh, rules: Optional[Rules] = None):
    """The inverse of :func:`shard_params` with rules: every sharded leaf
    all-gathered along its sharded dimensions into a new whole tensor (a
    collective: every rank calls it, in the same order)."""
    if not rules:
        return params

    def whole(path, leaf):
        dims = torch_dims(path, spec_for(path, rules), leaf.dim())
        return gather_leaf(leaf.detach(), dims, mesh) if any(dims) else leaf

    return map_state(whole, params)
