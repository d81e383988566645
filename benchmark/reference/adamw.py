"""The update of the reference: the K-average, the global-norm clip and
AdamW as BERT's optimization.py has it (no bias correction, decoupled
weight decay on every weight whose name names no LayerNorm and no bias)."""

from __future__ import annotations

import re

import torch

_NO_DECAY = re.compile("LayerNorm|layer_norm|bias")


def decays(name: str) -> bool:
    return _NO_DECAY.search(name) is None


@torch.no_grad()
def clip_by_global_norm(grads: dict, clip_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = clip_norm / torch.clamp(norm, min=clip_norm)
    return {n: g * scale for n, g in grads.items()}


@torch.no_grad()
def adamw_update(W: dict, grads: dict, m: dict, v: dict, lr: float, weight_decay: float,
                 beta_1: float = 0.9, beta_2: float = 0.999, eps: float = 1e-6) -> None:
    """One AdamW step, in place on ``W``, ``m`` and ``v``."""
    for name, w in W.items():
        g = grads[name]
        m[name].mul_(beta_1).add_(g, alpha=1.0 - beta_1)
        v[name].mul_(beta_2).add_(g * g, alpha=1.0 - beta_2)
        upd = m[name] / (torch.sqrt(v[name]) + eps)
        if weight_decay and decays(name):
            upd = upd + weight_decay * w
        w.sub_(lr * upd)
