"""Initial weights from the run's seed, made on the device in one draw.

Every leaf the model's ``param_specs`` names ``normal`` is a view into one
flat float32 buffer drawn by a single ``torch.randn`` from a generator on
the device, scaled by the configuration's ``initializer_range``; biases are
zeros and LayerNorm scales ones. The same seed gives the same tensors on
the same device, so the reference can make them again after the window
instead of holding a copy through it.
"""

from __future__ import annotations

from typing import Dict

import torch


def make(specs, std: float, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` in the order of ``specs``."""
    device = torch.device(device)
    sizes = [torch.Size(shape).numel() for _, shape, init in specs if init == "normal"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(std)
    out, offset = {}, 0
    for name, shape, init in specs:
        if init == "normal":
            n = torch.Size(shape).numel()
            out[name] = flat[offset:offset + n].view(shape)
            offset += n
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out
