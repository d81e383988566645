"""The per-step dropout seed, frozen: ``step_seed(run_seed + 1, step)``
seeds the generator of the host step that starts at micro-batch ``step``."""

from __future__ import annotations

import numpy as np


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed derived from a run seed and a step."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
