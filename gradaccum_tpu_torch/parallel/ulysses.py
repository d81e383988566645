"""Sequence parallelism by all-to-all (DeepSpeed-Ulysses), over a ``seq`` axis.

The port of ``gradaccum_tpu/parallel/ulysses.py``, the second of the two
sequence-parallel attention layouts (the first is
``ring_attention.ring_attention``). One all-to-all of q, k and v stacked
re-partitions them from sequence-sharded ``[B, h, S/n, D]`` to
head-sharded ``[B, h/n, S, D]``; each rank runs the plain dense attention
for its heads over the whole sequence, after an all-gather of the key mask;
a second all-to-all restores the sequence sharding. The collectives are
:meth:`~.mesh.DataMesh.all_to_all` (differentiable: its backward is the
inverse all-to-all) and the mask's all-gather (the mask takes no
gradient). Signature-compatible with ``models.bert.dense_attention``;
attention dropout is refused, as in JAX.
"""

from __future__ import annotations

from functools import partial

import torch

from gradaccum_tpu_torch.parallel.mesh import SEQ_AXIS, axis_mesh


def ulysses_attention(q, k, v, mask=None, dropout_fn=None, *, axis: str = SEQ_AXIS):
    """All-to-all sequence-parallel attention core.

    ``q, k, v``: [B, heads, S_local, head_dim] (sequence-sharded over
    ``axis``); ``mask``: additive key mask [B, 1, 1, S_local] or None.
    Returns [B, heads, S_local, head_dim]. ``heads`` must be divisible by
    the ``axis`` size."""
    if dropout_fn is not None:
        raise NotImplementedError(
            "ulysses_attention does not support attention dropout; "
            "set attention_dropout=0.0"
        )
    # function-local import: models.bert imports the parallel package
    from gradaccum_tpu_torch.models.bert import dense_attention

    mesh = axis_mesh(axis)
    n = mesh.world
    heads = q.shape[1]
    if heads % n != 0:
        raise ValueError(
            f"ulysses attention needs heads ({heads}) divisible by the "
            f"'{axis}' axis size ({n}); use ring attention otherwise"
        )
    # one collective for all three: [3, B, h, S/n, D] -> [3, B, h/n, S, D]
    qkv = mesh.all_to_all(torch.stack([q, k, v]), split_dim=2, concat_dim=3, tag="ulysses")
    qg, kg, vg = qkv.unbind(0)
    if mask is not None:
        mask = mesh.all_gather(mask, dim=3, tag="mask")  # [B, 1, 1, S]
    ctx = dense_attention(qg, kg, vg, mask, dropout_fn=None)
    # restore the sequence sharding: [B, h/n, S, D] -> [B, h, S/n, D]
    return mesh.all_to_all(ctx, split_dim=2, concat_dim=1, tag="ulysses")


def make_ulysses_attention_fn(axis: str = SEQ_AXIS):
    """Bind the mesh axis: an ``attention_fn`` for ``BertEncoder``."""
    return partial(ulysses_attention, axis=axis)
