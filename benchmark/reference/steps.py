"""The reference's first training steps, in blocks of rows so they fit.

:func:`follow` runs ``steps`` updates of K micro-batches each on the same
host batches, weights and dropout seeds the program was given, and
returns what the comparison reads: each micro-batch's loss, each leaf's
norm of the first (averaged, clipped) gradient, and each leaf's norm of
the change the steps made to the weights the model computes with. Each
micro-batch's rows go through forward and backward ``block_rows`` at a
time, padded rows of like length together and cut to the block's
longest; the gradients of a block add into the leaves' ``.grad``, so the
blocks of the K micro-batches sum to the window's gradient.

Where the cell stores its parameters in a narrower type than its float32
masters (``copy_dtype``), the reference keeps the same two copies: AdamW
updates the float32 masters, and the forward reads the masters rounded to
``copy_dtype`` (to nearest even) after every update, every product still
computed in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.adamw import adamw_update, clip_by_global_norm
from benchmark.reference.seeds import step_seed

def _blocks(micro: dict, block_rows: int):
    """Row indices of each block: rows of like length together (the
    longest first), so each block is cut to little more than its rows'
    real lengths; every row once."""
    if "input_mask" in micro:
        order = torch.argsort(micro["input_mask"].sum(1), descending=True, stable=True)
    else:
        order = torch.arange(len(micro["input_ids"]), device=micro["input_ids"].device)
    return [order[i:i + block_rows] for i in range(0, len(order), block_rows)]


def _stored(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` as a parameter stored in ``dtype`` holds it, in float32 (a
    copy of ``x`` where ``dtype`` is None)."""
    return x.detach().to(dtype).float() if dtype is not None else x.detach().clone()


def follow(model, cfg: dict, weights: Dict[str, torch.Tensor], batches: List[dict],
           run_seed: int, num_micro: int, lr: float, weight_decay: float, clip_norm: float,
           prec: str = "f32", block_rows: int = 8, steps: int = 3,
           copy_dtype: Optional[torch.dtype] = None) -> dict:
    """``{"losses": [steps·K floats], "grad": {leaf: norm}, "change": {leaf:
    norm}}``. ``model`` is the family's reference module (``bert``,
    ``gpt``); ``weights`` the initial float32 leaves (taken over);
    ``batches`` the host batches of the steps; ``run_seed`` the program's
    ``RunConfig.seed``; ``copy_dtype`` the working copy's type, None for
    parameters that are their own masters."""
    dev = next(iter(weights.values())).device
    # the masters start as the stored weights, as the program's do
    M = {n: _stored(w, copy_dtype) for n, w in weights.items()}
    weights.clear()
    start = {n: _stored(w, copy_dtype) for n, w in M.items()}
    m = {n: torch.zeros_like(w) for n, w in M.items()}
    v = {n: torch.zeros_like(w) for n, w in M.items()}
    losses, first_grad = [], None
    for t in range(steps):
        W = {n: _stored(w, copy_dtype).requires_grad_() for n, w in M.items()}
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(run_seed + 1, t * num_micro))
        host = batches[t]
        rows = len(next(iter(host.values()))) // num_micro
        for k in range(num_micro):
            micro = {key: torch.as_tensor(np.asarray(x[k * rows:(k + 1) * rows])).to(dev)
                     for key, x in host.items()}
            seq = micro["input_ids"].shape[1]
            draws = model.draw(cfg, rows, seq, gen)
            total = torch.zeros((), dtype=torch.float64, device=dev)
            for idx in _blocks(micro, block_rows):
                n = int(micro["input_mask"][idx].sum(1).max()) if "input_mask" in micro \
                    else seq
                block = {key: (x[idx, :n] if x.dim() == 2 else x[idx]) for key, x in micro.items()}
                loss = model.block_loss(W, cfg, block, draws, idx, rows, prec)
                loss.backward()
                total += loss.detach().double()
            losses.append(total)
            del draws
        with torch.no_grad():
            grads = {n: w.grad / num_micro for n, w in W.items()}
            grads = clip_by_global_norm(grads, clip_norm)
            if t == 0:
                first_grad = {n: g.double().norm() for n, g in grads.items()}
            adamw_update(M, grads, m, v, lr, weight_decay)
        del W, grads
    with torch.no_grad():
        change = {n: (_stored(M[n], copy_dtype) - start[n]).double().norm() for n in M}
    return {"losses": torch.stack(losses).tolist(),
            "grad": dict(zip(first_grad, torch.stack(list(first_grad.values())).tolist())),
            "change": dict(zip(change, torch.stack(list(change.values())).tolist()))}
