"""Random initial weights for the port's models, from an explicit generator."""

from __future__ import annotations

import math

import torch
from torch import nn

from gradaccum_tpu_torch.utils.tree import tree_cast_floating


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` (on the CPU, so a seed gives the
    same weights on every device): lecun-normal Dense and Conv kernels
    (standard deviation 1/sqrt(fan_in)), unit-variance rows scaled by
    1/sqrt(width) for embeddings, zero biases, unit LayerNorm scales. A
    module with an ``init_from(generator)`` method (the MoE expert bank)
    draws its own parameters."""
    for mod in model.modules():
        if hasattr(mod, "init_from"):
            mod.init_from(generator)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            std = 1.0 / math.sqrt(mod.weight[0].numel())  # fan_in
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            std = 1.0 / math.sqrt(mod.embedding_dim)
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


@torch.no_grad()
def store_in(model: nn.Module, dtype) -> nn.Module:
    """Store the module's floating parameters in ``dtype`` (a bundle's
    ``compute_dtype``; None leaves them), in place: ``tree_cast_floating``
    over its parameters."""
    named = dict(model.named_parameters())
    cast = tree_cast_floating({name: p.data for name, p in named.items()}, dtype)
    for name, p in named.items():
        p.data = cast[name]
    return model
