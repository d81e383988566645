"""Data-parallel train steps over a :class:`~.mesh.DataMesh`.

The port of ``gradaccum_tpu/parallel/dp.py``: the reference's
``MultiWorkerMirroredStrategy(RING)`` + ``CrossShardOptimizer`` pair, as one
process per rank joined by ``torch.distributed``. Both builders return
``train_step(state, batch[, generator]) -> (state, aux)`` that every rank
calls with the same GLOBAL batch (``[K, B, ...]`` in scan mode, ``[B, ...]``
in streaming mode); each rank trains on its block of the ``B`` rows
(``sharding.batch_shard``, the rows JAX's device r holds).

- :func:`make_dp_train_step`, explicit collectives: in scan mode the
  gradients accumulate locally and ONE all-reduce syncs the window, so an
  optimizer update costs a single collective; streaming mode all-reduces
  each micro-batch's gradients (the reference's mirrored-accumulator cost
  model) and averages its replica-local aux loss here.
- :func:`make_pjit_dp_train_step`, the counterpart of JAX's GSPMD step (the
  single-device code jitted with a sharded batch, where XLA inserts the
  collectives): each micro-batch's loss and gradients are averaged over the
  ranks, so every rank holds the global micro-batch's mean gradient, which
  is what XLA's inserted all-reduce gives. It is the path ``fused_adam``
  takes on a mesh, as JAX's Estimator routes it.

Dropout: every rank seeds its generator with the same step seed and the
flash kernels' keep mask hashes the rank's LOCAL batch row, as JAX's
explicit path draws its masks from the replicated key over each shard's
rows; batches differ per rank, so the noise decorrelates through the data.
Logged aux losses are global means in both paths.
"""

from __future__ import annotations

from gradaccum_tpu_torch.ops import accumulation as acc
from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.parallel.mesh import DATA_AXIS, DataMesh
from gradaccum_tpu_torch.parallel.sharding import batch_shard


def _check_axis(mesh: DataMesh, axis: str) -> None:
    if mesh.axis != axis:
        raise ValueError(f"the mesh binds axis {mesh.axis!r}, the step asks for {axis!r}")


def _on_local_rows(inner, mesh: DataMesh, mode: str):
    """``inner`` called on this rank's rows of the global batch."""
    lead = 1 if mode == "scan" else 0

    def train_step(state, batch, *rng):
        return inner(state, batch_shard(batch, mesh, leading_unsharded=lead), *rng)

    return train_step


def _global_streaming_loss(inner, mesh: DataMesh):
    """Streaming aux loss is replica-local: log the global mean."""

    def train_step(state, batch, *rng):
        new_state, aux = inner(state, batch, *rng)
        return new_state, dict(aux, loss=mesh.pmean(aux["loss"], tag="loss"))

    return train_step


def make_dp_train_step(loss_fn: acc.LossFn, optimizer: Optimizer,
                       config: acc.GradAccumConfig, mesh: DataMesh, mode: str = "scan",
                       axis: str = DATA_AXIS, needs_rng: bool = False, inner_builder=None):
    """Explicit-collective DP step (see the module docstring).

    ``inner_builder(config) -> train_step`` (scan mode only) swaps the inner
    accumulator, e.g. ``ops.sparse_embed.accumulate_scan_sparse_embed``; it
    receives the axis-bound config."""
    _check_axis(mesh, axis)
    config = config._replace(axis_name=axis)
    if inner_builder is not None and mode != "scan":
        raise ValueError("inner_builder requires mode='scan'")
    if mode == "scan":
        if inner_builder is not None:
            inner = inner_builder(config)
        else:
            inner = acc.accumulate_scan(loss_fn, optimizer, config, needs_rng=needs_rng)
        # scan mode already averages its aux loss over the ranks
    elif mode == "streaming":
        inner = _global_streaming_loss(
            acc.streaming_step(loss_fn, optimizer, config, needs_rng=needs_rng), mesh)
    else:
        raise ValueError(f"mode must be 'scan' or 'streaming', got {mode!r}")
    return _on_local_rows(inner, mesh, mode)


def make_pjit_dp_train_step(loss_fn: acc.LossFn, optimizer: Optimizer,
                            config: acc.GradAccumConfig, mesh: DataMesh,
                            mode: str = "scan", axis: str = DATA_AXIS,
                            needs_rng: bool = False, sparse=None):
    """The GSPMD counterpart: the single-device step with every
    micro-batch's loss and gradients averaged over the ranks (one
    all-reduce per micro-batch). Prefer :func:`make_dp_train_step` when
    collectives cost; this path serves ``fused_adam``, ZeRO-1's placement
    (``Estimator(zero1=True)``) and the sharding rules. ``sparse``
    (``ops/sparse_embed.py :: SparseEmbedHooks``, scan mode; ``loss_fn`` is
    then ``(params, rows, batch)``): each rank scatters its own rows and
    the table's gradient is averaged once per update. A one-rank data axis
    of a multi-axis mesh averages nothing."""
    _check_axis(mesh, axis)
    config = config._replace(axis_name=None)
    acc.validate_config(config)
    micro_mean = None if mesh.solo else mesh
    if sparse is not None and mode != "scan":
        raise ValueError("sparse_embed requires mode='scan'")
    if mode == "scan":
        inner = acc._scan_train_step(loss_fn, optimizer, config, needs_rng, sparse=sparse,
                                     micro_mean=micro_mean)
    elif mode == "streaming":
        inner = acc._streaming_train_step(loss_fn, optimizer, config, needs_rng,
                                          micro_mean=micro_mean)
    else:
        raise ValueError(f"mode must be 'scan' or 'streaming', got {mode!r}")
    return _on_local_rows(inner, mesh, mode)
