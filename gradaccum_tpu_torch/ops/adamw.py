"""The optimizers of the reference, for the port.

The port of ``adamw``, ``adam`` and ``sgd`` in ``gradaccum_tpu/ops/adamw.py``,
with their semantics kept exactly. :func:`adamw` is the BERT flavor:

- Adam moments **without bias correction**: raw β-weighted moments, update
  ``m / (sqrt(v) + eps)``.
- **Decoupled weight decay** added to the update after the m/v math, for
  every parameter whose "/"-joined name matches none of the exclusion
  regexes (default ``("LayerNorm", "layer_norm", "bias")``).
- The optimizer never advances the step; the train loop owns it.

An :class:`Optimizer` is an ``(init, update)`` pair over ``{name: tensor}``
dictionaries. ``update(grads, state, params, step)`` writes the new values
into ``params`` and the moments in place (PyTorch idiom: the parameters stay
the tensors the model holds) and returns ``(params, state)``.

:func:`adam` is ``tf.train.AdamOptimizer`` (the MNIST and housing
flavors): bias-corrected, with the update count ``t`` in its state
(:class:`AdamBCState`), so it advances once per apply whatever the caller's
micro-batch step. :func:`sgd` is plain SGD with optional momentum.

Not ported yet (ROADMAP.md): ``master_dtype``, ``moment_dtype`` (including
q8) and the fused-accumulation hooks; asking for one raises
``NotImplementedError``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch

from gradaccum_tpu_torch.ops.schedule import as_schedule
from gradaccum_tpu_torch.utils.tree import tree_map_with_names

DEFAULT_WEIGHT_DECAY_EXCLUSIONS = ("LayerNorm", "layer_norm", "bias")


class Optimizer(NamedTuple):
    init: Callable[[Dict[str, torch.Tensor]], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (params, state)


class AdamState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


class AdamBCState(NamedTuple):
    """Bias-corrected Adam state: ``t`` counts applied updates (int32, 0-d,
    on the parameters' device)."""

    t: torch.Tensor
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def decay_mask(params: Dict[str, torch.Tensor],
               exclusions: Sequence[str]) -> Dict[str, bool]:
    """``{name: apply weight decay?}``: True unless a pattern regex-searches
    the name (the reference's ``_do_use_weight_decay``)."""
    patterns = [re.compile(p) for p in exclusions]
    return tree_map_with_names(
        lambda name, _leaf: not any(p.search(name) for p in patterns), params)


def _cast_grad(grad: torch.Tensor, moment_dtype: torch.dtype) -> torch.Tensor:
    """Upcasts only: silently rounding an f32 gradient into low-precision
    moments is the bug class the JAX package refuses."""
    if grad.dtype == moment_dtype:
        return grad
    if torch.promote_types(grad.dtype, moment_dtype) != moment_dtype:
        raise ValueError(
            f"gradient dtype {grad.dtype} would be silently downcast to moment "
            f"dtype {moment_dtype}"
        )
    return grad.to(moment_dtype)


def _refuse_mixed_precision(master_dtype, moment_dtype):
    if master_dtype is not None or moment_dtype is not None:
        raise NotImplementedError(
            "master_dtype/moment_dtype (mixed-precision and q8 optimizer state) "
            "are not ported yet; see ROADMAP.md"
        )


def _lr_on(schedule, step, params):
    """The schedule's rate at ``step`` on the parameters' device: one
    host-to-device copy per update, not one per tensor."""
    lr = schedule(step)
    return lr.to(next(iter(params.values())).device) if params else lr


def adamw(learning_rate, weight_decay_rate: float = 0.01, beta_1: float = 0.9,
          beta_2: float = 0.999, epsilon: float = 1e-6,
          exclude_from_weight_decay: Optional[Sequence[str]] = DEFAULT_WEIGHT_DECAY_EXCLUSIONS,
          master_dtype: Any = None, moment_dtype: Any = None) -> Optimizer:
    """AdamW exactly per the BERT reference (no bias correction)."""
    _refuse_mixed_precision(master_dtype, moment_dtype)
    schedule = as_schedule(learning_rate)
    exclusions = tuple(exclude_from_weight_decay or ())

    def init(params):
        return AdamState(m={n: torch.zeros_like(p) for n, p in params.items()},
                         v={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _lr_on(schedule, step, params)
        use_decay = decay_mask(params, exclusions)
        for name, param in params.items():
            m, v = state.m[name], state.v[name]
            grad = _cast_grad(grads[name], m.dtype)
            next_m = beta_1 * m + (1.0 - beta_1) * grad
            next_v = beta_2 * v + (1.0 - beta_2) * torch.square(grad)
            upd = next_m / (torch.sqrt(next_v) + epsilon)
            if use_decay[name] and weight_decay_rate:
                upd = upd + weight_decay_rate * param
            param.copy_(param - lr * upd)
            m.copy_(next_m)
            v.copy_(next_v)
        return params, state

    return Optimizer(init=init, update=update)


def adam(learning_rate, beta_1: float = 0.9, beta_2: float = 0.999, epsilon: float = 1e-8,
         master_dtype: Any = None, moment_dtype: Any = None) -> Optimizer:
    """Adam with bias correction, ``tf.train.AdamOptimizer`` semantics:
    ``alpha_t = lr * sqrt(1 - beta_2^t) / (1 - beta_1^t)`` and
    ``param -= alpha_t * m / (sqrt(v) + eps)``, with ``t`` the number of
    updates applied so far plus one. ``alpha_t`` is computed in float32 on
    the device from ``t``, as the JAX package computes it."""
    _refuse_mixed_precision(master_dtype, moment_dtype)
    schedule = as_schedule(learning_rate)

    def init(params):
        device = next(iter(params.values())).device if params else "cpu"
        return AdamBCState(t=torch.zeros((), dtype=torch.int32, device=device),
                           m={n: torch.zeros_like(p) for n, p in params.items()},
                           v={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _lr_on(schedule, step, params)
        t = state.t + 1
        t32 = t.to(torch.float32)
        alpha = lr * torch.sqrt(1.0 - beta_2 ** t32) / (1.0 - beta_1 ** t32)
        for name, param in params.items():
            m, v = state.m[name], state.v[name]
            grad = _cast_grad(grads[name], m.dtype)
            next_m = beta_1 * m + (1.0 - beta_1) * grad
            next_v = beta_2 * v + (1.0 - beta_2) * torch.square(grad)
            param.copy_(param - alpha * next_m / (torch.sqrt(next_v) + epsilon))
            m.copy_(next_m)
            v.copy_(next_v)
        return params, AdamBCState(t=t, m=state.m, v=state.v)

    return Optimizer(init=init, update=update)


def sgd(learning_rate, momentum: float = 0.0) -> Optimizer:
    """Plain SGD, with a momentum buffer per parameter when ``momentum`` is
    set (``b = momentum * b + g``; ``p -= lr * b``). The state is ``()``
    without momentum, else ``{name: buffer}``."""
    schedule = as_schedule(learning_rate)

    def init(params):
        return {n: torch.zeros_like(p) for n, p in params.items()} if momentum else ()

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _lr_on(schedule, step, params)
        for name, param in params.items():
            # the accumulation window hands over float32 gradients: cast back
            # to the storage dtypes, never promote them
            if momentum:
                buf = state[name]
                buf.copy_((momentum * buf + grads[name]).to(buf.dtype))
                param.copy_((param - lr * buf).to(param.dtype))
            else:
                param.copy_((param - lr * grads[name]).to(param.dtype))
        return params, state

    return Optimizer(init=init, update=update)
