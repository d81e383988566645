"""Blockwise int8 storage of optimizer moments.

The port of the flat codec of ``gradaccum_tpu/memory/quant.py``: a tensor is
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

The KV-pool codec of the same JAX module (``kv_quantize``, ``QuantKV``)
serves the serving stack and is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Q_MAX = 127  # symmetric int8 range [-127, 127]; -128 unused
BLOCK = 256  # values per scale


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
