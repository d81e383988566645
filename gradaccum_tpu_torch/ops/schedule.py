"""Learning-rate schedules.

The port of ``gradaccum_tpu/ops/schedule.py``: polynomial decay to 0 over
``num_train_steps`` (power 1.0 is linear), blended with a linear warmup.
A schedule maps the step (an int or an integer tensor) to a float32 scalar
tensor on the CPU, computed with the same float32 operations in the same
order as the JAX package, so the values agree exactly.

The caller owns the step: the flagship path keys the schedule off the
micro-batch count, not the optimizer-update count (see
``ops/accumulation.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

Schedule = Callable[[object], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def constant(value: float) -> Schedule:
    def schedule(step):
        del step
        return torch.tensor(value, dtype=torch.float32)

    return schedule


def polynomial_decay(init_value: float, decay_steps: int, end_value: float = 0.0,
                     power: float = 1.0) -> Schedule:
    """``tf.train.polynomial_decay`` with ``cycle=False``."""

    def schedule(step):
        capped = torch.minimum(_f32(step), torch.tensor(float(decay_steps)))
        frac = capped / float(decay_steps)
        return (init_value - end_value) * (1.0 - frac) ** power + end_value

    return schedule


def warmup_polynomial_decay(init_lr: float, num_train_steps: int,
                            num_warmup_steps: int = 0, end_value: float = 0.0,
                            power: float = 1.0) -> Schedule:
    """Linear warmup blended into polynomial decay: for
    ``step < num_warmup_steps`` the rate is ``init_lr * step /
    num_warmup_steps``, after it the decayed rate."""
    decay = polynomial_decay(init_lr, num_train_steps, end_value, power)
    if not num_warmup_steps:
        return decay

    def schedule(step):
        step = torch.as_tensor(step)
        decayed = decay(step)
        warmup_lr = init_lr * (_f32(step) / float(num_warmup_steps))
        is_warmup = (step < num_warmup_steps).to(torch.float32)
        return (1.0 - is_warmup) * decayed + is_warmup * warmup_lr

    return schedule


def as_schedule(lr) -> Schedule:
    """Lift a float (or a schedule) into a :data:`Schedule`."""
    if callable(lr):
        return lr
    return constant(float(lr))
