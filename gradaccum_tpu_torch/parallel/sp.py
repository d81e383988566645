"""Sequence-parallel (data × seq) train steps.

The port of ``gradaccum_tpu/parallel/sp.py``. The batch is split over the
``data`` axis, and its token dimension over the ``seq`` axis, so a sequence
of global length S takes S/n_seq tokens of activation memory per rank. The
model must be sequence-aware (``bert_classifier_bundle(..., seq_axis="seq",
attention_fn=make_ring_attention_fn("seq"))`` or the Ulysses core): global
position ids and a summed [CLS] readout.

The accumulation transform does the rest (``ops/accumulation.py``,
``example_axes``): each seq rank's micro-batch gradient is its part of the
examples' gradient; the parts are summed over ``seq`` inside the window's
one all-reduce over ``data`` and ``seq`` together (the head's whole
gradient, invariant over ``seq``, counted once), and the denominator counts
``K × n_data`` only: seq ranks partition one example's tokens, they do not
replicate examples. Under the guard a micro-batch bad on one seq rank is
skipped on all of them.
"""

from __future__ import annotations

from typing import Sequence

from gradaccum_tpu_torch.ops import accumulation as acc
from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS
from gradaccum_tpu_torch.parallel.ring_attention import SEQ_BATCH_KEYS as DEFAULT_SEQ_KEYS
from gradaccum_tpu_torch.parallel.ring_attention import shard_seq_batch
from gradaccum_tpu_torch.parallel.sharding import batch_shard


def make_dp_sp_train_step(loss_fn: acc.LossFn, optimizer: Optimizer,
                          config: acc.GradAccumConfig, mesh, data_axis: str = DATA_AXIS,
                          seq_axis: str = SEQ_AXIS, seq_keys: Sequence[str] = DEFAULT_SEQ_KEYS,
                          needs_rng: bool = False, zero1: bool = False):
    """Scan-mode accumulation step over a ``(data, seq)`` mesh (a
    :class:`~.mesh.Mesh` from ``make_mesh``).

    The returned ``train_step(state, super_batch[, generator])`` takes the
    GLOBAL dict super-batch stacked ``[K, B, ...]``, as every rank does;
    leaves named in ``seq_keys`` are ``[K, B, S]`` and this rank keeps its
    block of B over ``data_axis`` and of S over ``seq_axis``, every other
    leaf its block of B.

    ``config.skip_nonfinite`` (with ``normalize_by_good_count`` and
    ``loss_scale``) runs as in JAX: ``seq_axis`` is an example axis, so the
    verdict of each micro-batch is pmin'd over the token shards, while the
    ``data`` shards keep their own verdicts and the summed good count keeps
    the denominator honest.

    ``zero1=True`` shards the optimizer state over ``data_axis``
    (``parallel/zero.py :: zero1_optimizer``): the window's one all-reduce
    is followed by the sharded update and an all-gather of the parameters.
    Place the state with ``zero1_shard_state`` (the Estimator does)."""
    config = config._replace(axis_name=data_axis,
                             example_axes=tuple(config.example_axes) + (seq_axis,))
    data = mesh.axis(data_axis)
    if zero1:
        from gradaccum_tpu_torch.parallel.zero import zero1_optimizer

        optimizer = zero1_optimizer(optimizer, data)
    inner = acc.accumulate_scan(loss_fn, optimizer, config, needs_rng=needs_rng)

    def train_step(state, super_batch, *rng):
        if not isinstance(super_batch, dict):
            raise TypeError("dp×sp steps require dict batches (seq_keys routing)")
        local = batch_shard(super_batch, data, leading_unsharded=1)
        local = shard_seq_batch(local, mesh, seq_axis, tuple(seq_keys), dim=2)
        return inner(state, local, *rng)

    return train_step
