"""Gradient clipping by global norm, ``tf.clip_by_global_norm`` semantics:
one scale ``clip_norm / max(global_norm, clip_norm)`` applied to every
gradient. The port of ``gradaccum_tpu/ops/clipping.py``.

Under a sharding plan (``parallel/tp.py :: plan_scope``: tensor or expert
parallelism) the norm is over the whole parameters: each rank holds blocks
of the sharded ones, whose Σg² is summed over the plan's group in one
scalar all-reduce (GSPMD inserts the same reduce in JAX)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gradaccum_tpu_torch.utils.tree import global_norm


def grad_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float32 global norm of ``grads``, over the whole parameters
    under a sharding plan."""
    from gradaccum_tpu_torch.parallel import tp

    if tp.active_plan() is None:
        return global_norm(grads.values())
    return torch.sqrt(tp.sharded_sq_norm(grads))


def clip_by_global_norm(grads: Dict[str, torch.Tensor],
                        clip_norm: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns ``(clipped_grads, global_norm)``."""
    norm = grad_norm(grads)
    clip = torch.tensor(clip_norm, dtype=norm.dtype, device=norm.device)
    scale = torch.div(clip, torch.maximum(norm, clip))
    return {name: g * scale.to(g.dtype) for name, g in grads.items()}, norm
