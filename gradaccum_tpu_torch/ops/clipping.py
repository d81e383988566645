"""Gradient clipping by global norm, ``tf.clip_by_global_norm`` semantics:
one scale ``clip_norm / max(global_norm, clip_norm)`` applied to every
gradient. The port of ``gradaccum_tpu/ops/clipping.py``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gradaccum_tpu_torch.utils.tree import global_norm


def clip_by_global_norm(grads: Dict[str, torch.Tensor],
                        clip_norm: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns ``(clipped_grads, global_norm)``."""
    norm = global_norm(grads.values())
    clip = torch.tensor(clip_norm, dtype=norm.dtype, device=norm.device)
    scale = torch.div(clip, torch.maximum(norm, clip))
    return {name: g * scale.to(g.dtype) for name, g in grads.items()}, norm
