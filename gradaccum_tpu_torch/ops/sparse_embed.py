"""Sparse (token-level) embedding-gradient accumulation.

The port of ``gradaccum_tpu/ops/sparse_embed.py``. In scan mode the dense
path forms the word-embedding table's gradient, a [vocab, hidden] float32
array (30522 x 512 x 4 B = 62.5 MB for BERT-Small), on every one of the K
micro-batches and adds it into the accumulator, while the information in
it is only the [micro, seq, hidden] rows the batch's ids touched. Here the
model exposes its loss with the gathered rows as an argument
(``ModelBundle.sparse_embed.loss_with_rows``), each micro-batch
differentiates with respect to those rows (the table stays out of
autograd), and ONE ``index_add_`` per window builds the dense table
gradient, so normalize, clip and AdamW run unchanged. The scatter-add is
the gather's transpose: the result equals the dense path's up to float32
summation order. On the CPU ``index_add_`` adds in index order; on CUDA it
adds float32 with atomics, so the order, and the last bits, vary from run
to run there.

AdamW stays dense over the table: with the reference's semantics
zero-gradient rows still decay their moments and take weight decay, so a
rows-only update would not be the same optimizer.

The non-finite guard and loss scaling behave as in ``accumulate_scan``: a
bad micro-batch's gradients AND its row cotangents are zeroed (its rows
then deposit nothing), an all-bad window skips the update, and
``normalize_by_good_count`` divides by the good count. Scan mode only.
With ``axis_name`` (data parallelism) each rank scatters its own rows, and
the one all-reduce at apply covers the scattered table gradient with the
rest of the accumulator (JAX's ``sparse_embed.py`` psums it the same way).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from gradaccum_tpu_torch.ops.accumulation import (
    GradAccumConfig,
    _scan_train_step,
    validate_config,
)
from gradaccum_tpu_torch.ops.adamw import Optimizer


class SparseEmbedHooks(NamedTuple):
    """What a model exposes for the sparse embedding-gradient path."""

    table_path: str  # the [V, H] table's parameter name (utils/tree.py)
    ids_key: str  # batch key of the [micro, seq] integer token ids
    loss_with_rows: Callable  # (params, rows, batch) -> scalar loss


def accumulate_scan_sparse_embed(hooks: SparseEmbedHooks, optimizer: Optimizer,
                                 config: GradAccumConfig) -> Callable[..., tuple]:
    """Scan-mode train step, a drop-in for ``accumulate_scan`` with
    ``needs_rng=True`` (``train_step(state, super_batch, generator)``,
    the same aux), whose table gradient accumulates as token-level rows.
    ``hooks.loss_with_rows(params, rows, batch)`` must not read the table
    itself."""
    validate_config(config)
    return _scan_train_step(hooks.loss_with_rows, optimizer, config, needs_rng=True,
                            sparse=hooks)
