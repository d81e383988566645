"""Blockwise and ring attention: the online-softmax core, on one card and
over a ``seq`` mesh axis.

The port of ``gradaccum_tpu/parallel/ring_attention.py``.
A loop over key/value blocks folds each block into a running row max ``m``,
normalizer ``l`` and unnormalized output ``o``; each new block rescales the
carry by ``exp(m - m_new)``, so the [S, S] score matrix is never held
whole. The block matmuls run in the inputs' dtype and the statistics in
float32, as in JAX. This was XLA code in JAX, not a Pallas kernel, so it is
plain torch ops here, differentiable by autograd: ``flash_attention``'s
``bwd_impl="xla"`` backward is autograd through this function.

Signature-compatible with ``models.bert.dense_attention``: ``(q, k, v,
mask, dropout_fn)`` with ``q, k, v`` [B, heads, S, head_dim] and an additive
key mask [B, 1, 1, S]. Probability dropout cannot apply (the probabilities
are never normalized in one place) and a ``dropout_fn`` is refused.

:func:`ring_attention` runs the same loop with the sequence sharded over
the ranks of a ``seq`` axis (``parallel/mesh.py``): each rank holds its
block ``[B, H, S/n, D]`` of q, k and v and its block ``[B, 1, 1, S/n]`` of
the key mask, folds the block it holds, then passes k, v and the mask on
to the next rank of the ring with :meth:`~.mesh.DataMesh.ppermute` (one
collective per hop: the three are packed into one buffer when they share a
dtype). After n blocks every query has seen the whole sequence; the output
stays sharded. The backward is autograd's: each hop's gradient goes back
along the inverse ring. :func:`make_ring_attention_fn` binds the axis for
``BertEncoder(attention_fn=...)``; :func:`shard_seq_batch` gives this rank
its token block of a batch.
"""

from __future__ import annotations

from functools import partial

import torch

from gradaccum_tpu_torch.parallel.mesh import SEQ_AXIS, axis_mesh

_NEG_INF = -1e30  # finite stand-in for -inf: keeps exp and the corrections NaN-free


def _online_block(carry, q, k_blk, v_blk, mask_blk, scale):
    """Fold one key/value block into the ``(o, m, l)`` carry: ``o``
    [B, H, Sq, D] float32, ``m`` and ``l`` [B, H, Sq, 1] float32."""
    o, m, l = carry  # noqa: E741
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
    scores = scores.float()
    if mask_blk is not None:
        scores = scores + mask_blk.float()
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    l = l * correction + p.sum(dim=-1, keepdim=True)  # noqa: E741
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk)
    o = o * correction + pv.float()
    return o, m_new, l


def _init_carry(q):
    zero = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    return zero, zero[..., :1] + _NEG_INF, zero[..., :1]


def _check_no_dropout(dropout_fn, name):
    if dropout_fn is not None:
        raise NotImplementedError(
            f"{name} does not materialize attention probabilities, so "
            "probability dropout cannot be applied; set attention_dropout=0.0"
        )


def blockwise_attention(q, k, v, mask=None, dropout_fn=None, *,
                        block_size: int = 512, causal: bool = False):
    """Exact attention (up to float reassociation) with O(S·block) memory.

    ``block_size`` is clamped to S and must divide it. ``causal`` adds the
    autoregressive triangle per key block as a [S, block] bias of -1e30,
    in the mask's dtype when there is a mask (as JAX's weakly typed bias
    is), float32 otherwise.
    """
    _check_no_dropout(dropout_fn, "blockwise_attention")
    s, d = q.shape[-2:]
    block = min(block_size, s)
    if s % block:
        raise ValueError(f"seq len {s} not divisible by block_size {block}")
    scale = (1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))).to(q.dtype).to(q.device)
    q_pos = torch.arange(s, device=q.device)[:, None]

    def block_mask(j):
        mask_blk = None if mask is None else mask[..., j * block:(j + 1) * block]
        if not causal:
            return mask_blk
        k_pos = j * block + torch.arange(block, device=q.device)[None, :]
        bias = torch.where(k_pos > q_pos, _NEG_INF, 0.0)[None, None]
        return bias if mask_blk is None else mask_blk + bias.to(mask_blk.dtype)

    carry = _init_carry(q)
    for j in range(s // block):
        blk = slice(j * block, (j + 1) * block)
        carry = _online_block(carry, q, k[:, :, blk], v[:, :, blk], block_mask(j), scale)
    o, _, l = carry  # noqa: E741
    return (o / l).to(q.dtype)



def _rotate(blocks, mesh, perm):
    """Every tensor of ``blocks`` (None kept) passed one hop along ``perm``:
    the tensors of the first one's dtype in one collective, any other in
    one more."""
    live = [t for t in blocks if t is not None]
    groups = {}
    for t in live:
        groups.setdefault(t.dtype, []).append(t)
    moved = {}
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        got = mesh.ppermute(flat, perm, tag="ring")
        offset = 0
        for t in group:
            moved[id(t)] = got[offset:offset + t.numel()].view(t.shape)
            offset += t.numel()
    return tuple(None if t is None else moved[id(t)] for t in blocks)


def ring_attention(q, k, v, mask=None, dropout_fn=None, *, axis: str = SEQ_AXIS):
    """Sequence-sharded exact attention over the ranks of ``axis``.

    ``q, k, v``: this rank's blocks ``[B, H, S/n, D]``; ``mask``: its block
    ``[B, 1, 1, S/n]`` of the additive key mask, or None. Each of the n
    steps folds the key/value block held into the online-softmax carry,
    then (but after the last) rotates k, v and the mask one rank on. The
    output is this rank's block ``[B, H, S/n, D]``."""
    _check_no_dropout(dropout_fn, "ring_attention")
    mesh = axis_mesh(axis)
    n = mesh.world
    d = q.shape[-1]
    scale = (1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))).to(q.dtype).to(q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    carry = _init_carry(q)
    k_blk, v_blk, mask_blk = k, v, mask
    for hop in range(n):
        carry = _online_block(carry, q, k_blk, v_blk, mask_blk, scale)
        if hop < n - 1:  # no rotate after the last block
            k_blk, v_blk, mask_blk = _rotate((k_blk, v_blk, mask_blk), mesh, perm)
    o, _, l = carry  # noqa: E741
    return (o / l).to(q.dtype)


def make_ring_attention_fn(axis: str = SEQ_AXIS):
    """Bind the mesh axis: an ``attention_fn`` for ``BertEncoder``."""
    return partial(ring_attention, axis=axis)


# batch keys holding a [.., B, S] token dimension to shard over seq (shared
# with parallel/sp.py so the two cannot disagree)
SEQ_BATCH_KEYS = ("input_ids", "input_mask", "segment_ids")


def shard_seq_batch(batch, mesh, axis: str = SEQ_AXIS, seq_keys=SEQ_BATCH_KEYS, dim: int = 1):
    """This rank's block of a dict batch: the token dimension ``dim`` (dim 1
    of ``[B, S]`` features) of every leaf in ``seq_keys`` cut over ``axis``
    (rank r holds tokens ``[r*S/n, (r+1)*S/n)``); other leaves whole.
    ``mesh``: a :class:`~.mesh.Mesh` or the axis's ``DataMesh``."""
    m = mesh.axis(axis) if hasattr(mesh, "axis_names") else mesh

    def cut(x):
        s = x.shape[dim]
        if s % m.world:
            raise ValueError(f"seq len {s} not divisible by the '{axis}' axis size {m.world}")
        size = s // m.world
        return x.narrow(dim, m.rank * size, size)

    return {key: cut(x) if key in seq_keys else x for key, x in batch.items()}
