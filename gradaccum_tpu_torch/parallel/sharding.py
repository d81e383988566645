"""Batch and parameter placement over a :class:`~.mesh.DataMesh`.

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
  mirrored-variable placement.

The regex rules (:func:`spec_for`, :func:`shard_params` with rules) shard
parameters over model axes; they wait for tensor and expert parallelism
and raise ``NotImplementedError`` when a rule is given.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gradaccum_tpu_torch.parallel.mesh import DataMesh

Rules = Sequence[Tuple[str, object]]


def _refuse_rules(rules) -> None:
    if rules:
        raise NotImplementedError("parameter sharding rules (tensor and expert "
                                  "parallelism) are not ported yet; see ROADMAP.md")


def spec_for(name: str, rules: Optional[Rules]):
    """The placement of parameter ``name``: replicated (``None``) without
    rules."""
    _refuse_rules(rules)
    return None


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


def shard_params(params, mesh: DataMesh, rules: Optional[Rules] = None):
    """Place ``params`` on the mesh: replicated without rules."""
    _refuse_rules(rules)
    return replicate_(params, mesh)
