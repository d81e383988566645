"""Blockwise attention: the online-softmax core of ring attention, on one card.

The port of ``gradaccum_tpu/parallel/ring_attention.py :: blockwise_attention``.
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

``ring_attention`` and ``make_ring_attention_fn`` need a ``seq`` mesh axis,
which the port does not have yet (ROADMAP.md), and are not here.
"""

from __future__ import annotations

import torch

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

