"""Attention dropout as the flash kernels draw it, frozen.

A murmur3 finalizer over the uint32 seed, the (batch, head) slice, the
query position and then the key position; an element is kept when its
hash falls under ``round(keep · 2**32)``. Computed here in int64 tensor
math, for the given rows of the kernels' batch and its first ``seq``
positions.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), by 16-bit halves."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def keep_mask(seed: torch.Tensor, rows: torch.Tensor, heads: int, seq: int,
              rate: float) -> torch.Tensor:
    """The [len(rows), heads, seq, seq] bool keep mask of the batch rows
    ``rows`` (int64 indices) over their first ``seq`` query and key
    positions; ``seed`` is the one-element int64 tensor drawn for the
    launch."""
    keep = 1.0 - rate
    threshold = min(round(keep * float(2**32)), 2**32 - 1)
    dev = seed.device
    seed = seed.to(torch.int64).reshape(()) & _MASK32
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    bh = (rows.to(dev)[:, None] * heads + ar(heads)[None, :])[..., None, None]
    slice_seed = _hash_u32((seed + _mul32(bh, _GOLDEN)) & _MASK32)
    row_seed = _hash_u32((ar(seq)[:, None] + _mul32(slice_seed, _GOLDEN)) & _MASK32)
    return _hash_u32((ar(seq) + _mul32(row_seed, _GOLDEN)) & _MASK32) < threshold
