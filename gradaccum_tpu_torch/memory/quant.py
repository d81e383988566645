"""8-bit storage with absmax scales: optimizer moments and the KV pool.

The port of ``gradaccum_tpu/memory/quant.py``, one codec for two block
shapes.

**Optimizer moments** (:class:`QuantTensor`): a tensor is
flattened and cut into runs of :data:`BLOCK` consecutive values (the last
run zero-padded, which never raises an absmax); each run shares one float32
scale ``absmax(run) / 127`` and stores ``round(x / scale)`` as int8, rounded
half to even and clipped to [-127, 127]. A run of zeros gets scale 0 and
decodes to exact zeros. Decoding is ``q * scale``, so the round trip is off
by at most ``absmax(run) / 254`` per value. The storage is 1 byte per value
plus 4 bytes of scale per 256 values, ~1.016 bytes against float32's 4.

Both divisions are tensor by tensor on the data's device (``torch.div``):
CUDA divides a tensor by a Python scalar as a multiply by its reciprocal,
which rounds differently from JAX's division, and would move ``q`` and
``scale`` off JAX's bits.

**KV pools** (:class:`QuantKV`): the block is one head vector, the last
axis (``head_dim``) of the pool layout ``[L, blocks, H, page, hd]``, so the
scale array is the payload's shape without its last axis. A pool write
quantizes and then scatters ``q`` and ``scale`` at the same indices (the
scale one rank lower), so no write reads its neighbours' scales.
:func:`kv_quantize` divides tensor by tensor too, for the scale and for
``x / scale``, and rounds half to even as ``jnp.round`` does;
:func:`kv_dequantize` multiplies in float32 and then casts, in JAX's order.
On the card the codes and scales are bitwise the CPU's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

Q_MAX = 127  # symmetric int8 range [-127, 127]; -128 unused
BLOCK = 256  # values per scale


class QuantKV(NamedTuple):
    """A quantized KV pool array: ``q`` int8 payload and ``scale`` float32,
    one per last-axis vector (``scale.shape == q.shape[:-1]``). ``shape``,
    ``device`` and ``dtype`` read as the payload's, so pool code that only
    asks for sizes needs no branch; :func:`kv_map` maps the two leaves."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        """The logical (payload) shape, what a float pool would have."""
        return tuple(self.q.shape)

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return self.q.numel() + 4 * self.scale.numel()


def is_quantized_kv(x) -> bool:
    return isinstance(x, QuantKV)


def kv_map(fn, *kvs):
    """Apply ``fn`` leafwise across KV arrays that are all :class:`QuantKV`
    or all plain tensors (slicing, copying, host transfer)."""
    if isinstance(kvs[0], QuantKV):
        return QuantKV(fn(*[x.q for x in kvs]), fn(*[x.scale for x in kvs]))
    return fn(*kvs)


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` along its last axis: ``(q int8, scale float32)`` with
    ``scale.shape == x.shape[:-1]``. An all-zero vector gets scale 0 and
    codes 0. Both divisions are tensor by tensor (a scalar divisor on CUDA
    becomes a multiply by its reciprocal, off JAX's bits)."""
    xf = x.to(torch.float32)
    # a fill, not torch.tensor: a host-to-card copy would sync the stream on
    # every pool write
    q_max = torch.full((), float(Q_MAX), dtype=torch.float32, device=x.device)
    scale = torch.div(xf.abs().amax(dim=-1), q_max)
    safe = torch.where(scale > 0, scale, torch.ones((), dtype=torch.float32, device=x.device))
    q = torch.clamp(torch.round(torch.div(xf, safe[..., None])), -Q_MAX, Q_MAX)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Invert :func:`kv_quantize`: ``q * scale`` in float32, then ``dtype``."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


class QuantTensor:
    """A blockwise-quantized tensor: ``q`` int8 [rows, BLOCK], ``scale``
    float32 [rows] and the original ``shape`` (a tuple of ints; checkpoints
    save it and a restore into another shape raises)."""

    __slots__ = ("q", "scale", "shape")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, shape):
        self.q = q
        self.scale = scale
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + \
            self.scale.numel() * self.scale.element_size()

    def copy_(self, other: "QuantTensor") -> "QuantTensor":
        """Take ``other``'s codes and scales in place (the same shape)."""
        if other.shape != self.shape:
            raise ValueError(f"QuantTensor shape {other.shape} into {self.shape}")
        self.q.copy_(other.q)
        self.scale.copy_(other.scale)
        return self

    def __repr__(self) -> str:
        return f"QuantTensor(shape={self.shape}, rows={self.scale.shape[0]})"


def quantize_blockwise(x: torch.Tensor, block: int = BLOCK) -> QuantTensor:
    """Flatten ``x`` and quantize runs of ``block`` values, one absmax scale
    each (the last run zero-padded)."""
    flat = x.reshape(-1).to(torch.float32)
    rows = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    q_max = torch.tensor(float(Q_MAX), dtype=torch.float32, device=x.device)
    scale = torch.div(rows.abs().amax(dim=1), q_max)
    safe = torch.where(scale > 0, scale, torch.ones((), dtype=torch.float32, device=x.device))
    q = torch.clamp(torch.round(torch.div(rows, safe[:, None])), -Q_MAX, Q_MAX)
    return QuantTensor(q.to(torch.int8), scale, x.shape)


def dequantize_blockwise(t: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    """Invert :func:`quantize_blockwise` back to the original shape."""
    n = 1
    for s in t.shape:
        n *= s
    rows = t.q.to(torch.float32) * t.scale[:, None]
    return rows.reshape(-1)[:n].reshape(t.shape).to(dtype)
