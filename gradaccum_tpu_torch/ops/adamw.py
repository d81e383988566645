"""The optimizers of the reference, for the port.

The port of ``gradaccum_tpu/ops/adamw.py``, with its semantics kept exactly.
:func:`adamw` is the BERT flavor:

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

**Mixed precision.** ``master_dtype`` (float32 under bfloat16 parameters)
keeps a master copy of every parameter in the optimizer state
(:class:`MasterAdamState`, :class:`MasterAdamBCState`): the update runs on
the masters, weight decay reads the master, and the working parameter is
the master rounded to its dtype (to nearest even, as JAX's ``astype``), so
updates below a bfloat16 ulp still accumulate. ``moment_dtype`` names the
m/v storage dtype (default: the parameter's, or ``master_dtype``). A
gradient is cast to the moments' dtype only when that loses nothing, unless
``moment_dtype`` was given explicitly. ``moment_dtype="q8"`` stores the
moments blockwise int8 (``memory/quant.py``, v in the sqrt domain); the
update decodes them to float32 and encodes them again, one round trip per
update. :func:`adam_mini` keeps one scalar second moment per parameter.

**Fused accumulation** (AdamA): :class:`FusedAccum` hooks on ``adamw`` and
``adam`` let the accumulation window fold each micro-batch's gradient
straight into m and v, with no gradient accumulator
(``GradAccumConfig.fused_adam`` in ``ops/accumulation.py``). A q8 optimizer
and ``adam_mini`` have none.

With ``master_dtype=None`` and ``moment_dtype=None`` every update runs the
same operations as before the mixed-precision knobs existed.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch

from gradaccum_tpu_torch.memory.quant import (
    QuantTensor,
    dequantize_blockwise,
    quantize_blockwise,
)
from gradaccum_tpu_torch.ops.schedule import as_schedule
from gradaccum_tpu_torch.utils.tree import tree_map_with_names

DEFAULT_WEIGHT_DECAY_EXCLUSIONS = ("LayerNorm", "layer_norm", "bias")


class FusedAccum(NamedTuple):
    """The hooks the fused accumulation window calls instead of summing
    gradients:

    - ``moments(state) -> (m, v)``: the moment dictionaries the window folds
      into (the optimizer's own, written in place);
    - ``carry_into(state, (m, v)) -> state``: the state holding them, with
      no update (the all-bad window);
    - ``accumulate((m, v), grads, good, first, inv_m, inv_v)``: fold one
      micro-batch's ``{name: gradient}`` in place. On ``first`` (a 0-d bool
      tensor: the window's first usable micro-batch) the old moments take
      their β decay in the same operation, then ``m += (1-β1)·g·inv_m`` and
      ``v += (1-β2)·g²·inv_v``, where ``inv_m = 1/(K·scale)`` folds the
      window's normalization and the loss unscale and ``inv_v`` their
      squares. ``v`` thus sums the mean of squares of the micro-batch
      gradients where two-pass Adam squares their mean (equal at K=1).
      With ``good`` (a 0-d bool tensor) a skipped micro-batch leaves the
      moments bit for bit as they were (a select, not a zeroed gradient);
    - ``apply(state, (m, v), params, step) -> (params, state)``: the update
      from the folded moments.
    """

    moments: Callable[[Any], tuple]
    carry_into: Callable[[Any, tuple], Any]
    accumulate: Callable[..., None]
    apply: Callable[..., tuple]


class Optimizer(NamedTuple):
    init: Callable[[Dict[str, torch.Tensor]], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (params, state)
    fused: Optional[FusedAccum] = None  # None: no fused accumulation window


class AdamState(NamedTuple):
    m: Dict[str, Any]
    v: Dict[str, Any]


class MasterAdamState(NamedTuple):
    """:class:`AdamState` plus the ``master_dtype`` copy of the parameters."""

    m: Dict[str, Any]
    v: Dict[str, Any]
    master: Dict[str, torch.Tensor]


class AdamBCState(NamedTuple):
    """Bias-corrected Adam state: ``t`` counts applied updates (int32, 0-d,
    on the parameters' device)."""

    t: torch.Tensor
    m: Dict[str, Any]
    v: Dict[str, Any]


class MasterAdamBCState(NamedTuple):
    """:class:`AdamBCState` plus the ``master_dtype`` copy of the parameters."""

    t: torch.Tensor
    m: Dict[str, Any]
    v: Dict[str, Any]
    master: Dict[str, torch.Tensor]


def decay_mask(params: Dict[str, torch.Tensor],
               exclusions: Sequence[str]) -> Dict[str, bool]:
    """``{name: apply weight decay?}``: True unless a pattern regex-searches
    the name (the reference's ``_do_use_weight_decay``)."""
    patterns = [re.compile(p) for p in exclusions]
    return tree_map_with_names(
        lambda name, _leaf: not any(p.search(name) for p in patterns), params)


def _is_q8(moment_dtype) -> bool:
    return isinstance(moment_dtype, str) and moment_dtype.lower() == "q8"


def _grad_caster(moment_dtype_explicit: bool):
    """Casts a gradient to the moments' dtype. An upcast (bfloat16 into
    float32 moments) always; a cast that loses precision (float32 into
    bfloat16 moments) raises unless ``moment_dtype`` was given explicitly,
    since silently rounding gradients is the bug class this refuses."""

    def cast(grad: torch.Tensor, moment_dtype: torch.dtype) -> torch.Tensor:
        if grad.dtype == moment_dtype:
            return grad
        if not moment_dtype_explicit and \
                torch.promote_types(grad.dtype, moment_dtype) != moment_dtype:
            raise ValueError(
                f"gradient dtype {grad.dtype} would be silently downcast to moment "
                f"dtype {moment_dtype}; pass moment_dtype= (to accept the precision "
                "loss) or master_dtype= (to keep f32 moments and masters under "
                "low-precision params) to the optimizer"
            )
        return grad.to(moment_dtype)

    return cast


def _up(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` promoted as JAX promotes it against the float32 rate: a
    low-precision update meets the rate in float32 (a no-op for float32)."""
    return t.to(torch.promote_types(t.dtype, like.dtype))


def _moment_init(params, master_dtype, moment_dtype):
    """Zeroed m and v: q8 codes, else ``moment_dtype`` (default
    ``master_dtype``, else the parameter's dtype)."""
    if _is_q8(moment_dtype):
        def zeros():
            return {n: quantize_blockwise(torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device))
                    for n, p in params.items()}
        return zeros(), zeros()
    dtype = moment_dtype if moment_dtype is not None else master_dtype
    if dtype is None:
        return ({n: torch.zeros_like(p) for n, p in params.items()},
                {n: torch.zeros_like(p) for n, p in params.items()})
    return ({n: torch.zeros(p.shape, dtype=dtype, device=p.device) for n, p in params.items()},
            {n: torch.zeros(p.shape, dtype=dtype, device=p.device) for n, p in params.items()})


def _master_init(params, master_dtype):
    return {n: p.detach().to(master_dtype, copy=True) for n, p in params.items()}


def _read(t, sqrt_domain: bool = False) -> torch.Tensor:
    """A moment as float math reads it: q8 codes decoded to float32 (v from
    the sqrt domain), any other tensor as it is."""
    if isinstance(t, QuantTensor):
        x = dequantize_blockwise(t, torch.float32)
        return torch.square(x) if sqrt_domain else x
    return t


def _write(t, value: torch.Tensor, sqrt_domain: bool = False) -> None:
    """Store ``value`` into the moment ``t`` in place: q8 re-encodes (v in
    the sqrt domain, where a block survives a 254² range of v instead of
    254), any other tensor copies."""
    if isinstance(t, QuantTensor):
        t.copy_(quantize_blockwise(torch.sqrt(value) if sqrt_domain else value))
    else:
        t.copy_(value)


def _write_param(param, master, new_master, has_master: bool) -> None:
    if has_master:
        master.copy_(new_master)
    param.copy_(new_master)  # rounds to the parameter's dtype


def _lr_on(schedule, step, params):
    """The schedule's rate at ``step`` on the parameters' device: one
    host-to-device copy per update, not one per tensor."""
    lr = schedule(step)
    return lr.to(next(iter(params.values())).device) if params else lr


def _fused_moment_hooks(beta_1: float, beta_2: float, cast_grad):
    """The moments, carry_into and accumulate hooks, the same math for
    :func:`adamw` and :func:`adam` (only their apply differs)."""

    def moments(state):
        return (state.m, state.v)

    def carry_into(state, mv):
        return state._replace(m=mv[0], v=mv[1])

    @torch.no_grad()
    def accumulate(mv, grads, good, first, inv_m, inv_v):
        m_tree, v_tree = mv
        # float32 decay factors, once per micro-batch (1.0 after the first)
        w1 = torch.where(first, beta_1, 1.0)
        w2 = torch.where(first, beta_2, 1.0)
        for name, m in m_tree.items():
            v = v_tree[name]
            g = cast_grad(grads[name], m.dtype)
            # the float32 factors promote the fold; the moments keep their dtype
            next_m = (m * w1.to(m.dtype) + (1.0 - beta_1) * (_up(g, inv_m) * inv_m)).to(m.dtype)
            next_v = (v * w2.to(v.dtype)
                      + (1.0 - beta_2) * (g * (_up(g, inv_v) * inv_v))).to(v.dtype)
            if good is not None:
                next_m = torch.where(good, next_m, m)
                next_v = torch.where(good, next_v, v)
            m.copy_(next_m)
            v.copy_(next_v)

    return moments, carry_into, accumulate


def adamw(learning_rate, weight_decay_rate: float = 0.01, beta_1: float = 0.9,
          beta_2: float = 0.999, epsilon: float = 1e-6,
          exclude_from_weight_decay: Optional[Sequence[str]] = DEFAULT_WEIGHT_DECAY_EXCLUSIONS,
          master_dtype: Any = None, moment_dtype: Any = None) -> Optimizer:
    """AdamW exactly per the BERT reference (no bias correction), with the
    mixed-precision knobs of the module docstring."""
    schedule = as_schedule(learning_rate)
    exclusions = tuple(exclude_from_weight_decay or ())
    q8 = _is_q8(moment_dtype)
    cast_grad = _grad_caster(moment_dtype is not None)

    def init(params):
        m, v = _moment_init(params, master_dtype, moment_dtype)
        if master_dtype is not None:
            return MasterAdamState(m=m, v=v, master=_master_init(params, master_dtype))
        return AdamState(m=m, v=v)

    def _step(master, upd, lr, decay):
        if decay and weight_decay_rate:
            # decay reads the master (the parameter itself without one)
            upd = upd + weight_decay_rate * master
        return master - lr * _up(upd, lr)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _lr_on(schedule, step, params)
        use_decay = decay_mask(params, exclusions)
        has_master = isinstance(state, MasterAdamState)
        masters = state.master if has_master else params
        for name, param in params.items():
            m, v = _read(state.m[name]), _read(state.v[name], sqrt_domain=True)
            grad = cast_grad(grads[name], m.dtype)
            next_m = beta_1 * m + (1.0 - beta_1) * grad
            next_v = beta_2 * v + (1.0 - beta_2) * torch.square(grad)
            upd = next_m / (torch.sqrt(next_v) + epsilon)
            new_master = _step(masters[name], upd, lr, use_decay[name])
            _write_param(param, masters[name], new_master, has_master)
            _write(state.m[name], next_m)
            _write(state.v[name], next_v, sqrt_domain=True)
        return params, state

    moments, carry_into, accumulate = _fused_moment_hooks(beta_1, beta_2, cast_grad)

    @torch.no_grad()
    def fused_apply(state, mv, params, step):
        m_tree, v_tree = mv
        lr = _lr_on(schedule, step, params)
        use_decay = decay_mask(params, exclusions)
        has_master = isinstance(state, MasterAdamState)
        masters = state.master if has_master else params
        for name, param in params.items():
            upd = m_tree[name] / (torch.sqrt(v_tree[name]) + epsilon)
            new_master = _step(masters[name], upd, lr, use_decay[name])
            _write_param(param, masters[name], new_master, has_master)
        return params, carry_into(state, mv)

    # q8 moments would be re-quantized at every micro-batch of a fused
    # window, compounding the one-round-trip-per-update error: no hooks
    fused = None if q8 else FusedAccum(moments, carry_into, accumulate, fused_apply)
    return Optimizer(init=init, update=update, fused=fused)


def _alpha(lr, t, beta_1, beta_2):
    t32 = t.to(torch.float32)
    return lr * torch.sqrt(1.0 - beta_2 ** t32) / (1.0 - beta_1 ** t32)


def adam(learning_rate, beta_1: float = 0.9, beta_2: float = 0.999, epsilon: float = 1e-8,
         master_dtype: Any = None, moment_dtype: Any = None) -> Optimizer:
    """Adam with bias correction, ``tf.train.AdamOptimizer`` semantics:
    ``alpha_t = lr * sqrt(1 - beta_2^t) / (1 - beta_1^t)`` and
    ``param -= alpha_t * m / (sqrt(v) + eps)``, with ``t`` the number of
    updates applied so far plus one. ``alpha_t`` is computed in float32 on
    the device from ``t``, as the JAX package computes it. The
    mixed-precision knobs are :func:`adamw`'s."""
    schedule = as_schedule(learning_rate)
    q8 = _is_q8(moment_dtype)
    cast_grad = _grad_caster(moment_dtype is not None)

    def init(params):
        device = next(iter(params.values())).device if params else "cpu"
        t = torch.zeros((), dtype=torch.int32, device=device)
        m, v = _moment_init(params, master_dtype, moment_dtype)
        if master_dtype is not None:
            return MasterAdamBCState(t=t, m=m, v=v, master=_master_init(params, master_dtype))
        return AdamBCState(t=t, m=m, v=v)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _lr_on(schedule, step, params)
        t = state.t + 1
        alpha = _alpha(lr, t, beta_1, beta_2)
        has_master = isinstance(state, MasterAdamBCState)
        masters = state.master if has_master else params
        for name, param in params.items():
            m, v = _read(state.m[name]), _read(state.v[name], sqrt_domain=True)
            grad = cast_grad(grads[name], m.dtype)
            next_m = beta_1 * m + (1.0 - beta_1) * grad
            next_v = beta_2 * v + (1.0 - beta_2) * torch.square(grad)
            new_master = masters[name] - alpha * _up(next_m, alpha) / (torch.sqrt(next_v)
                                                                        + epsilon)
            _write_param(param, masters[name], new_master, has_master)
            _write(state.m[name], next_m)
            _write(state.v[name], next_v, sqrt_domain=True)
        return params, state._replace(t=t)

    moments, carry_into, accumulate = _fused_moment_hooks(beta_1, beta_2, cast_grad)

    @torch.no_grad()
    def fused_apply(state, mv, params, step):
        # t advances once per window; the all-bad window never gets here
        m_tree, v_tree = mv
        lr = _lr_on(schedule, step, params)
        t = state.t + 1
        alpha = _alpha(lr, t, beta_1, beta_2)
        has_master = isinstance(state, MasterAdamBCState)
        masters = state.master if has_master else params
        for name, param in params.items():
            new_master = masters[name] - alpha * _up(m_tree[name], alpha) / (
                torch.sqrt(v_tree[name]) + epsilon)
            _write_param(param, masters[name], new_master, has_master)
        return params, carry_into(state, mv)._replace(t=t)

    fused = None if q8 else FusedAccum(moments, carry_into, accumulate, fused_apply)
    return Optimizer(init=init, update=update, fused=fused)


def adam_mini(learning_rate, beta_1: float = 0.9, beta_2: float = 0.999,
              epsilon: float = 1e-8, master_dtype: Any = None,
              moment_dtype: Any = None) -> Optimizer:
    """Adam-mini (arXiv 2406.16793): one second moment per parameter
    tensor, ``v = β2·v + (1-β2)·mean(g²)`` (a float32 scalar), the whole
    tensor divided by ``sqrt(v) + eps``. Bias correction and the state
    schema are :func:`adam`'s (:class:`AdamBCState` /
    :class:`MasterAdamBCState`). With ``moment_dtype="q8"`` the first moment
    is stored blockwise int8. No fused hooks: the fused window carries the
    per-parameter v this optimizer deletes. Where a rank holds a block of a
    parameter (tensor parallelism, ZeRO-1), the mean square is the whole
    tensor's: the blocks' Σg² are all-reduced over the ranks that hold the
    other blocks and divided by the whole element count
    (``parallel/tp.py :: whole_mean_sq``)."""
    schedule = as_schedule(learning_rate)
    cast_grad = _grad_caster(moment_dtype is not None)

    def init(params):
        device = next(iter(params.values())).device if params else "cpu"
        t = torch.zeros((), dtype=torch.int32, device=device)
        # moments default to the parameter's dtype here, as in JAX: the
        # master dtype does not set them
        m, _ = _moment_init(params, None, moment_dtype)
        v = {n: torch.zeros((), dtype=torch.float32, device=p.device) for n, p in params.items()}
        if master_dtype is not None:
            return MasterAdamBCState(t=t, m=m, v=v, master=_master_init(params, master_dtype))
        return AdamBCState(t=t, m=m, v=v)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = _lr_on(schedule, step, params)
        t = state.t + 1
        alpha = _alpha(lr, t, beta_1, beta_2)
        has_master = isinstance(state, MasterAdamBCState)
        masters = state.master if has_master else params
        ms = {name: _read(state.m[name]) for name in params}
        cast = {name: cast_grad(grads[name], ms[name].dtype) for name in params}
        # over the whole tensor, also where this rank holds a block of it
        from gradaccum_tpu_torch.parallel.tp import whole_mean_sq

        mean_sq = whole_mean_sq(cast)
        for name, param in params.items():
            m, v, grad = ms[name], state.v[name], cast[name]
            next_m = beta_1 * m + (1.0 - beta_1) * grad
            next_v = beta_2 * v + (1.0 - beta_2) * mean_sq[name]
            new_master = masters[name] - alpha * _up(next_m, alpha) / (torch.sqrt(next_v)
                                                                        + epsilon)
            _write_param(param, masters[name], new_master, has_master)
            _write(state.m[name], next_m)
            v.copy_(next_v)
        return params, state._replace(t=t)

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
