"""JAX's default random numbers in torch integer ops (threefry2x32).

The serving path samples each request's tokens from its own stream:
``categorical(fold_in(PRNGKey(seed), index), logits / T)``, as JAX's
``models/gpt_decode.py :: sample_token`` does. Because the stream is keyed by
the request's seed and the token's index alone, a request samples the same
tokens whatever slot, batch or decode block it runs in; ``torch.multinomial``
with a shared generator cannot keep that property.

This module reproduces, bit for bit, JAX's default implementation
(``threefry2x32`` with ``jax_threefry_partitionable=True``, JAX 0.9.0):

- :func:`PRNGKey` — key data ``[0, seed mod 2**32]``;
- :func:`fold_in` — ``threefry2x32(key, (0, data))``;
- :func:`random_bits` — 32-bit words ``x1 ^ x2`` of
  ``threefry2x32(key, (hi, lo))`` over the flat index of each element
  (``hi`` is 0 below 2**32 elements);
- :func:`uniform` — the top 23 bits as a float32 mantissa in [1, 2), minus
  one, scaled into ``[minval, maxval)`` with XLA's fused multiply-add, and
  clamped below at ``minval``;
- :func:`gumbel` — ``-log(-log(u))``, ``u`` uniform in ``[tiny, 1)`` (mode
  ``"low"``, JAX's default), or JAX's two-draw ``"high"`` mode;
- :func:`categorical` — ``argmax(gumbel + logits)``.

Torch has no usable ``uint32``, so every word is an ``int64`` tensor holding
a value in ``[0, 2**32)``, masked after each add and shift. Keys are
``[..., 2]`` int64 tensors; a key with leading dimensions holds one key per
row (JAX's ``vmap`` over keys), so one call serves every slot of the engine
on the card.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _add(a, b):
    return (a + b) & MASK


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher, 20 rounds: JAX's unrolled lowering
    (``jax/_src/prng.py :: _threefry2x32_lowering``). All four inputs are
    int64 tensors of 32-bit values that broadcast together; returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = _add(x1, ks[0])
    x2 = _add(x2, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = _add(x1, x2)
            x2 = _rotl(x2, r) ^ x1
        x1 = _add(x1, ks[(i + 1) % 3])
        x2 = _add(x2, ks[(i + 2) % 3] + (i + 1))
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)``'s key data as an int64 ``[2]`` tensor.
    Without 64-bit mode JAX keeps the seed's low 32 bits (``[0, seed mod
    2**32]``); a seed outside a C long raises, as JAX's does."""
    seed = int(seed)
    if not -(2 ** 63) <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit a C long")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def key_data(keys: Sequence[int], device=None) -> torch.Tensor:
    """``[n, 2]`` keys for ``n`` seeds (``jnp.stack([PRNGKey(s) ...])``)."""
    return torch.stack([PRNGKey(s) for s in keys]).to(device)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``key`` ``[..., 2]``, ``data`` an
    int or an integer tensor broadcasting against ``key[..., 0]``."""
    if not torch.is_tensor(data):
        data = torch.full((), int(data), dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def _counts(shape, device):
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 2 ** 32:
        raise NotImplementedError("random bits past 2**32 elements")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values; with keys
    ``[..., 2]`` the result is ``[..., *shape]``, each row from its key."""
    shape = tuple(int(d) for d in shape)
    lead = key.shape[:-1]
    counts = _counts(shape, key.device)
    expand = (slice(None),) * len(lead) + (None,) * len(shape)
    k1, k2 = key[..., 0][expand], key[..., 1][expand]
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return o1 ^ o2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    # 23 random mantissa bits under the exponent of 1.0: a float in [1, 2)
    word = (bits >> 9) | 0x3F800000
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)
    floats = word.view(torch.float32) - 1.0
    # XLA contracts floats * (max - min) + min into one fused multiply-add:
    # in float64 the product is exact and the sum rounds once before float32
    lo = torch.tensor(minval, dtype=torch.float32)
    scale = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    fused = (floats.double() * scale + float(lo)).float()
    return torch.clamp(fused, min=float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int], mode: str = "low") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32, mode)``: ``"low"`` (JAX's
    default) draws one uniform in [tiny, 1) per value, ``"high"`` two."""
    shape = tuple(int(d) for d in shape)
    if mode == "low":
        return -torch.log(-torch.log(uniform(key, shape, minval=_TINY, maxval=1.0)))
    if mode != "high":
        raise ValueError(f"gumbel mode must be 'high' or 'low', got {mode!r}")
    lead = len(key.shape) - 1
    u = uniform(key, (2,) + shape)
    high, low = u.select(lead, 0), u.select(lead, 1)
    x = torch.where(high >= 0.5, high, high + 2.0 ** -23 * low + _TINY)
    return -torch.log(-torch.log1p(-x))


def categorical(key: torch.Tensor, logits: torch.Tensor, mode: str = "low") -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``. A ``[2]`` key draws
    the Gumbel noise over the whole of ``logits`` (its flat index counts,
    as JAX's single-key call does); keys ``[..., 2]`` matching the leading
    dims of ``logits`` draw each row from its own key over the last axis
    (``vmap`` over keys and rows)."""
    if key.dim() == 1:
        noise = gumbel(key, logits.shape, mode)
    else:
        if key.shape[:-1] != logits.shape[:-1]:
            raise ValueError(f"keys {tuple(key.shape)} do not match logits "
                             f"{tuple(logits.shape)}")
        noise = gumbel(key, logits.shape[-1:], mode)
    return torch.argmax(noise + logits.to(torch.float32), dim=-1)
