"""CrossShardOptimizer: cross-replica gradient aggregation as an optimizer
wrapper.

The port of ``gradaccum_tpu/parallel/cross_shard.py``. The reference's TPU
path wraps its optimizer in ``tf.contrib.tpu.CrossShardOptimizer``, so
``apply_gradients`` first takes the cross-replica MEAN of the gradients.
The data-parallel steps (``parallel/dp.py``) already fold that reduction
into the accumulation; this wrapper serves a hand-written step and keeps
the reference's API:

    opt = cross_shard_optimizer(adamw(schedule), axis_name="data")
"""

from __future__ import annotations

from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.parallel.mesh import DATA_AXIS, axis_mesh


def cross_shard_optimizer(optimizer: Optimizer, axis_name: str = DATA_AXIS,
                          reduction: str = "mean") -> Optimizer:
    """Wrap ``optimizer`` so ``update`` first averages (``"mean"``, the
    CrossShardOptimizer default) or sums (``"sum"``) the gradients over the
    ranks of the mesh bound to ``axis_name``, in one all-reduce. The
    fused-accumulation hooks are not forwarded."""
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")

    def update(grads, state, params, step):
        m = axis_mesh(axis_name)
        reduced = {name: g.detach().clone() for name, g in grads.items()}
        m.all_reduce_tensors_(list(reduced.values()), tag="grads")
        if reduction == "mean":
            reduced = {name: g / m.world for name, g in reduced.items()}
        return optimizer.update(reduced, state, params, step)

    return Optimizer(init=optimizer.init, update=update)
