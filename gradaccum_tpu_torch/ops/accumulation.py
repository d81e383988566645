"""Gradient accumulation, scan mode: K micro-batches per optimizer update.

The port of ``accumulate_scan`` in ``gradaccum_tpu/ops/accumulation.py``.
One ``train_step(state, super_batch)`` takes a ``[K, micro_batch, ...]``
stacked super-batch, runs forward and backward on each micro-batch in turn
(a Python loop in place of ``lax.scan``), sums the gradients in float32-or-
wider accumulators, divides by K, clips by global norm after averaging, and
applies one optimizer update. ``state.step`` counts micro-batches and the
schedule sees it at the end of the cycle (``step + K``), as in the
reference's steady-state apply branch.

Not ported yet (ROADMAP.md): streaming mode, ``skip_nonfinite``,
``normalize_by_good_count``, ``loss_scale``, ``fused_adam``, ``axis_name``
and ``example_axes``; setting one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.ops.clipping import clip_by_global_norm
from gradaccum_tpu_torch.utils.tree import global_norm


class GradAccumConfig(NamedTuple):
    """``num_micro_batches`` is the reference's
    ``gradient_accumulation_multiplier``; ``clip_norm`` is 1.0 on the BERT
    path. The other fields name knobs of the JAX package that the port does
    not run yet."""

    num_micro_batches: int
    clip_norm: Optional[float] = None
    axis_name: Optional[str] = None
    skip_nonfinite: bool = False
    normalize_by_good_count: bool = False
    loss_scale: Any = None
    fused_adam: bool = False
    example_axes: Tuple[str, ...] = ()


def validate_config(config: GradAccumConfig) -> None:
    if config.num_micro_batches < 1:
        raise ValueError(f"num_micro_batches must be >= 1, got {config.num_micro_batches}")
    refused = {
        "skip_nonfinite": config.skip_nonfinite,
        "normalize_by_good_count": config.normalize_by_good_count,
        "loss_scale": config.loss_scale is not None,
        "fused_adam": config.fused_adam,
        "axis_name": config.axis_name is not None,
        "example_axes": bool(config.example_axes),
    }
    asked = [name for name, on in refused.items() if on]
    if asked:
        raise NotImplementedError(
            f"GradAccumConfig knob(s) {asked} are not ported yet; see ROADMAP.md"
        )


# loss_fn(params, micro_batch) -> scalar loss (mean over the micro batch).
# Stochastic models read micro_batch["rng"], a torch.Generator.
LossFn = Callable[[Dict[str, torch.Tensor], Dict[str, Any]], torch.Tensor]


class ScanState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: Any
    step: int  # micro-batches consumed so far (the reference's global_step)


def scan_init(params: Dict[str, torch.Tensor], optimizer: Optimizer) -> ScanState:
    return ScanState(params=params, opt_state=optimizer.init(params), step=0)


def _accum_zeros(params):
    """Zeroed accumulators at float32-or-wider: low-precision micro-batch
    gradients sum in float32 so a K-window never rounds away low bits."""
    return {name: torch.zeros(p.shape, dtype=torch.promote_types(p.dtype, torch.float32),
                              device=p.device)
            for name, p in params.items()}


def _finalize(accum, config: GradAccumConfig, denom: int):
    """Normalize the accumulated sum by ``denom``, then clip (if set)."""
    grads = {name: g / denom for name, g in accum.items()}
    if config.clip_norm is not None:
        return clip_by_global_norm(grads, config.clip_norm)
    return grads, global_norm(grads.values())


def accumulate_scan(loss_fn: LossFn, optimizer: Optimizer, config: GradAccumConfig,
                    needs_rng: bool = False) -> Callable[..., tuple]:
    """Build the scan-mode train step.

    ``train_step(state, super_batch)`` expects every value of the dict
    ``super_batch`` stacked to ``[K, micro_batch, ...]`` and returns
    ``(new_state, aux)`` with ``aux = {"loss": mean over K, "grad_norm":
    norm of the averaged gradient before clipping, "lr_step": step + K}``.
    With ``needs_rng=True`` the call is ``train_step(state, super_batch,
    generator)`` and each micro-batch reaches ``loss_fn`` with the generator
    under ``"rng"``; its draws advance from one micro-batch to the next.
    """
    validate_config(config)
    k = config.num_micro_batches

    def train_step(state: ScanState, super_batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        leading = {x.shape[0] for x in super_batch.values()}
        if leading != {k}:
            raise ValueError(
                f"super_batch values must be stacked [K={k}, micro, ...]; got leading "
                f"dims {sorted(leading)}. Use stack_micro_batches(batch, K)."
            )
        if needs_rng and generator is None:
            raise ValueError("needs_rng=True: pass train_step(state, batch, generator)")
        params = state.params
        tensors = list(params.values())
        accum = _accum_zeros(params)
        losses = []
        for i in range(k):
            micro = {key: x[i] for key, x in super_batch.items()}
            if needs_rng:
                micro["rng"] = generator
            loss = loss_fn(params, micro)
            grads = torch.autograd.grad(loss, tensors)
            with torch.no_grad():
                for acc, g in zip(accum.values(), grads):
                    acc.add_(g.to(acc.dtype))
            losses.append(loss.detach())
        apply_step = state.step + k
        with torch.no_grad():
            grads, norm = _finalize(accum, config, k)
        new_params, new_opt_state = optimizer.update(grads, state.opt_state, params,
                                                     apply_step)
        aux = {"loss": torch.stack(losses).mean(), "grad_norm": norm, "lr_step": apply_step}
        return ScanState(new_params, new_opt_state, apply_step), aux

    return train_step


def stack_micro_batches(batch: Dict[str, Any], num_micro_batches: int) -> Dict[str, Any]:
    """Reshape a ``[K*B, ...]`` host batch into the ``[K, B, ...]`` super-batch."""
    return {key: x.reshape((num_micro_batches, -1) + tuple(x.shape[1:]))
            for key, x in batch.items()}
