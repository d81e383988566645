"""The comparison that decides ``correct``.

Four numbers; the cell's workload file names those it compares, each with
its limit:

- ``loss``: the widest relative gap between the program's loss of a
  micro-batch and the reference's, over every micro-batch of the checked
  updates;
- ``loss_first``: the same over the micro-batches of the first update
  alone, before any weight moves, where the two sides differ least;
- ``grad``: by the worst leaf, the gap between the norm of the program's
  first gradient, as AdamW received it (its first moment after one step
  over 1 − β1) and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``change``: the worst leaf's gap for the norm of each leaf's change over
  the steps, of the parameters the model computes with (under float32
  masters, the working copy). A leaf whose reference gradient is under a
  thousandth of the median leaf's (a key's bias under softmax) moves by
  round-off alone and is left out.

A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

EXCLUDE_BELOW = 1e-3  # of the median leaf's first-gradient norm


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> list:
    """Each leaf's gap, over the larger of its reference norm and the
    median leaf's; a gap that is not finite reads infinite."""
    med = statistics.median(ref[n] for n in names)
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med) for n in names]
    return [g if math.isfinite(g) else math.inf for g in gaps]


NUMBERS = ("loss", "loss_first", "grad", "change")


def _loss_gap(prog: list, ref: list) -> float:
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def gaps(prog: dict, ref: dict, per_update: int) -> Dict[str, float]:
    """Every number of ``NUMBERS`` from the readings of both sides (each
    ``{"losses": [...], "grad": {leaf: norm}, "change": {leaf: norm}}``,
    leaves under the reference's names); ``per_update`` micro-batches make
    an update."""
    if set(prog["grad"]) != set(ref["grad"]) or len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program's readings do not match the reference's leaves or steps")
    names = sorted(ref["grad"])
    med = statistics.median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= EXCLUDE_BELOW * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], names)
    return {"loss": _loss_gap(prog["losses"], ref["losses"]),
            "loss_first": _loss_gap(prog["losses"][:per_update], ref["losses"][:per_update]),
            "grad": max(grad), "change": max(_leaf_gaps(prog["change"], ref["change"], moved))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
