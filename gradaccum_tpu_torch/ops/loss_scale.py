"""Dynamic (automatic) loss scaling.

The port of ``gradaccum_tpu/ops/loss_scale.py``. With
``GradAccumConfig(skip_nonfinite=True, loss_scale=LossScaleConfig(...))``:

- the loss is multiplied by ``scale`` before differentiation;
- the finiteness guard inspects the SCALED loss and gradients, so an
  overflow at the current scale marks the micro-batch bad;
- the accumulated gradient is divided by ``scale`` together with the 1/K
  normalization, before clip and apply;
- at every window boundary, applied or not, a dirty window halves the scale
  (``backoff_factor``, floored at ``min_scale``) and ``growth_interval``
  consecutive clean windows grow it (``growth_factor``, capped at
  ``max_scale``).

The state is two 0-d device tensors (:class:`DynamicLossScale`), checkpointed
with the rest of the train state. The update is branchless
(``torch.where``), so it never reads the verdict back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossScaleConfig(NamedTuple):
    """Static policy for :class:`DynamicLossScale`."""

    init_scale: float = 2.0**15
    growth_interval: int = 200  # clean windows before growing the scale
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    min_scale: float = 1.0
    max_scale: float = 2.0**24


class DynamicLossScale(NamedTuple):
    scale: torch.Tensor  # float32, 0-d
    good_windows: torch.Tensor  # int32, 0-d: consecutive clean windows at this scale


def init_loss_scale(config: LossScaleConfig, device="cpu") -> DynamicLossScale:
    return DynamicLossScale(
        scale=torch.tensor(config.init_scale, dtype=torch.float32, device=device),
        good_windows=torch.zeros((), dtype=torch.int32, device=device),
    )


def update_loss_scale(state: DynamicLossScale, config: LossScaleConfig,
                      window_clean: torch.Tensor) -> DynamicLossScale:
    """One window-boundary update; ``window_clean`` is a 0-d bool tensor."""
    streak = state.good_windows + 1
    grow = streak >= config.growth_interval
    grown = torch.clamp(state.scale * config.growth_factor, max=config.max_scale)
    clean_scale = torch.where(grow, grown, state.scale)
    clean_streak = torch.where(grow, torch.zeros_like(streak), streak)
    dirty_scale = torch.clamp(state.scale * config.backoff_factor, min=config.min_scale)
    return DynamicLossScale(
        scale=torch.where(window_clean, clean_scale, dirty_scale),
        good_windows=torch.where(window_clean, clean_streak, torch.zeros_like(streak)),
    )
