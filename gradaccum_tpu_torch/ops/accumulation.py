"""Gradient accumulation: K micro-batches per optimizer update, two modes.

The port of ``gradaccum_tpu/ops/accumulation.py``.

**Scan mode** (:func:`accumulate_scan`): one ``train_step(state,
super_batch)`` takes a ``[K, micro_batch, ...]`` stacked super-batch, runs
forward and backward on each micro-batch in turn (a Python loop in place of
``lax.scan``), sums the gradients in float32-or-wider accumulators, divides
by K, clips by global norm after averaging, and applies one optimizer
update. ``state.step`` counts micro-batches and the schedule sees it at the
end of the cycle (``step + K``).

**Streaming mode** (:func:`streaming_step`): the reference's ``tf.cond``
accumulate/apply ``train_op``. The accumulators are persistent state, each
call consumes ONE micro-batch, and the apply branch runs when
``step % K == phase``:

- ``step`` counts micro-batches and is bumped unconditionally;
- the apply branch first re-accumulates the current gradient, then
  normalizes by K, clips, applies, and zeroes the accumulators;
- with ``first_step_quirk=True`` (the reference) the phase is 0, so step 0
  applies one micro-batch still normalized by 1/K: a K×-under-scaled first
  update; ``False`` moves the phase to K-1, so every update sees K
  micro-batches, and the schedule then reads ``step + 1``, exactly scan
  mode's ``step + K`` values.

``step`` is a Python int in the port, so the branch is chosen on the host
without reading the card. The accumulators are added to in place, as the
optimizers write parameters and moments in place.

**The non-finite guard** (``skip_nonfinite``, both modes): a micro-batch
whose loss or any gradient is not finite contributes zeros to the
accumulators, chosen on the card with ``torch.where``; the denominator
stays K unless ``normalize_by_good_count`` divides by the window's good
count instead. A window with no good micro-batch must not apply at all
(AdamW would still decay and advance its moments on a zero gradient). The
optimizers update in place, so apply-or-skip is decided on the host from
ONE read of the window's good count per window, never per micro-batch.
With ``loss_scale`` the loss is scaled before differentiation, the guard
inspects the scaled values, the unscale folds into the apply-time
denominator before the clip, and the scale updates at every window
boundary (``ops/loss_scale.py``).

**Fused Adam-accumulation** (``fused_adam``, AdamA, both modes): each
micro-batch's gradient folds straight into the optimizer's m and v through
its ``FusedAccum`` hooks (``ops/adamw.py``), so no gradient accumulator
exists (``streaming_init(fused=True)`` carries none). The window's first
usable micro-batch applies the moments' β decay, so an all-bad window leaves
them untouched; ``first`` is a bool on the card (scan: no good micro-batch
yet; streaming: the window's ``good_count`` is 0), chosen with
``torch.where``, never read on the host. ``1/K`` and the loss unscale fold
into each micro-batch. It refuses ``clip_norm`` (no summed gradient to
clip), ``normalize_by_good_count`` (the denominator is folded before the
count is known) and ``axis_name``, and reports no ``grad_norm``.

**Data parallelism** (``axis_name``): the step runs on every rank of the
:class:`~gradaccum_tpu_torch.parallel.mesh.DataMesh` bound to that axis
name (``parallel/mesh.py :: data_parallel_mesh``), each rank on its own
rows, with JAX's semantics:

- scan mode: the K micro-batch gradients accumulate locally, and ONE SUM
  all-reduce per update covers the whole accumulator (flattened into one
  buffer per dtype, the window's loss statistic and, under the guard, its
  good count riding in the same buffer); the denominator is ``K·N``. Under
  the guard each rank's micro-batches skip on their own and the good count
  is summed over the ranks; the logged loss is the global mean (under the
  guard the summed ``loss_sum / n_good``); ``apply_step = step + K``,
  counted in local micro-batches;
- streaming mode: a SUM all-reduce of each micro-batch's gradients (the
  reference's mirrored accumulators), the 1/N folded into the apply-time
  denominator; under the guard the finite-loss verdict is pmin'd over the
  ranks, so all skip together; the aux loss stays this rank's (the DP
  wrapper, ``parallel/dp.py``, averages it).

``fused_adam`` with ``axis_name`` is refused, as in JAX: the fused window
folds each micro-batch into the moments before any window-level
collective exists.

**Example axes** (``example_axes``, the ``seq`` axis of sequence
parallelism): mesh axes whose ranks hold shards of the SAME examples.
Each rank's micro-batch gradient is its part of the example's gradient,
and the parts sum (the denominator counts ``K·N`` over ``axis_name``
only). A parameter marked invariant over such an axis
(``parallel/sharding.py :: invariant_axes``: the head after a summed
readout) has its whole gradient on every rank, so only the rank at
coordinate 0 of that axis counts it in the sum, as JAX's varying-axes
typing sums only the varying ones; the window's loss statistic and good
count, equal on every such rank, count once the same way. Scan mode sums
the parts once per update, inside the window's one all-reduce (over
``axis_name`` and the example axes together), where JAX sums each
micro-batch's: the same sum in another order, K-fold fewer collectives.
Streaming mode sums each micro-batch's over the same group. Under the
guard each micro-batch's verdict is pmin'd over the example axes: a
micro-batch bad on one shard of its examples is skipped on all of them
(finite parts sum to a finite gradient, so the verdict on the parts is
the verdict on the sum, overflow of the sum aside).

**Spans** (``obs/trace.py :: UpdateSpans``, resolved once per call of a
train step; each carries the update's ``step`` at entry, the
per-micro-batch ones ``micro`` too): ``train/forward`` and
``train/backward`` around ``loss_fn`` and ``torch.autograd.grad``,
``train/accumulate`` around each micro-batch's guard and fold into the
accumulators (or the moments) and once around the window's zeroed
buffers, ``train/clip`` around the normalization and the clip, and
``train/optimizer`` around the optimizer's update. They time the host
only: no sync, no read, no tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gradaccum_tpu_torch.obs import trace as obs_trace
from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.parallel import tp as tp_lib
from gradaccum_tpu_torch.parallel.sharding import invariant_axes
from gradaccum_tpu_torch.ops.clipping import clip_by_global_norm, grad_norm
from gradaccum_tpu_torch.ops.loss_scale import (
    LossScaleConfig,
    init_loss_scale,
    update_loss_scale,
)


class GradAccumConfig(NamedTuple):
    """``num_micro_batches`` is the reference's
    ``gradient_accumulation_multiplier``; ``clip_norm`` is 1.0 on the BERT
    path, None on MNIST and housing. ``axis_name`` names the data-parallel
    axis the step reduces over; ``example_axes`` the mesh axes that shard
    each example (the module docstring)."""

    num_micro_batches: int
    clip_norm: Optional[float] = None
    axis_name: Optional[str] = None
    first_step_quirk: bool = True  # streaming mode only
    skip_nonfinite: bool = False
    normalize_by_good_count: bool = False  # requires skip_nonfinite
    loss_scale: Optional[LossScaleConfig] = None  # requires skip_nonfinite
    fused_adam: bool = False
    example_axes: Tuple[str, ...] = ()


def validate_config(config: GradAccumConfig) -> None:
    """The JAX package's refusals (same errors, same order)."""
    if config.num_micro_batches < 1:
        raise ValueError(f"num_micro_batches must be >= 1, got {config.num_micro_batches}")
    if config.normalize_by_good_count and not config.skip_nonfinite:
        raise ValueError(
            "normalize_by_good_count divides by the guard's good count; it "
            "requires skip_nonfinite=True"
        )
    if config.loss_scale is not None and not config.skip_nonfinite:
        raise ValueError(
            "dynamic loss scaling detects overflow through the non-finite "
            "guard; it requires skip_nonfinite=True"
        )
    if config.fused_adam:
        if config.clip_norm is not None:
            raise ValueError(
                "fused_adam never materializes the accumulated gradient, so "
                "there is nothing for clip_norm to clip; disable one of them"
            )
        if config.normalize_by_good_count:
            raise ValueError(
                "fused_adam folds the 1/K normalization into each "
                "micro-batch before the window's good count is known; "
                "normalize_by_good_count cannot compose with it"
            )
        if config.axis_name is not None:
            raise ValueError(
                "fused_adam folds micro-batch gradients straight into the "
                "replicated optimizer moments; under the explicit shard_map "
                "DP path (axis_name) that would need a collective per "
                "micro-batch. Run fused accumulation on the GSPMD path "
                "(sharding_rules / zero1) instead"
            )


# loss_fn(params, micro_batch) -> scalar loss (mean over the micro batch).
# Stochastic models read micro_batch["rng"], a torch.Generator.
LossFn = Callable[[Dict[str, torch.Tensor], Dict[str, Any]], torch.Tensor]


def _device(params) -> torch.device:
    return next(iter(params.values())).device if params else torch.device("cpu")


def _accum_zeros(params):
    """Zeroed accumulators at float32-or-wider: low-precision micro-batch
    gradients sum in float32 so a K-window never rounds away low bits."""
    return {name: torch.zeros(p.shape, dtype=torch.promote_types(p.dtype, torch.float32),
                              device=p.device)
            for name, p in params.items()}


def _window_accum(params, n_stats: int = 0):
    """The scan window's zeroed accumulators, as :func:`_accum_zeros`'s but
    each a view into one flat buffer per dtype, so that a mesh all-reduces
    the whole window in place: one call per dtype and no copy. ``n_stats``
    float32 slots close the float32 buffer (the window's loss statistic and
    good count ride the same call). Returns ``(accum, buffers, stats)``."""
    groups: Dict[torch.dtype, list] = {}
    for name, p in params.items():
        groups.setdefault(torch.promote_types(p.dtype, torch.float32), []).append(name)
    if n_stats:
        groups.setdefault(torch.float32, [])
    accum, buffers, stats = {}, [], None
    for dtype, names in groups.items():
        extra = n_stats if dtype == torch.float32 else 0
        flat = torch.zeros(sum(params[n].numel() for n in names) + extra, dtype=dtype,
                           device=_device(params))
        offset = 0
        for n in names:
            size = params[n].numel()
            accum[n] = flat[offset:offset + size].view(params[n].shape)
            offset += size
        if extra:
            stats = flat[offset:]
        buffers.append(flat)
    return {n: accum[n] for n in params}, buffers, stats


def _accum_add_(slots, grads) -> None:
    for acc, g in zip(slots, grads):
        acc.add_(g.to(acc.dtype))


def _grad_call(loss_fn: LossFn, params, micro_batch, scale, wrt=None,
               spans=obs_trace.NO_SPANS, micro: int = 0):
    """One micro-batch's ``(loss, check_loss, grads)``, the gradients with
    respect to ``wrt`` (default: every parameter). ``check_loss`` is what
    the guard inspects: the SCALED loss when scaling is on, so an overflow
    at the current scale is caught even when the raw loss is representable;
    ``grads`` are then scaled too (the unscale folds into the apply-time
    denominator). ``micro`` labels its spans."""
    with spans("train/forward", micro=micro):
        loss = loss_fn(params, micro_batch)
        check_loss = loss if scale is None else loss * scale
    with spans("train/backward", micro=micro):
        grads = torch.autograd.grad(check_loss,
                                    list(params.values()) if wrt is None else wrt)
    return loss.detach(), check_loss.detach(), grads


def _all_finite(check_loss, grads) -> torch.Tensor:
    """0-d bool on the card: the loss and every gradient are finite. Under
    a sharding plan the verdict is pmin'd over the ranks that hold the
    gradients' other blocks, so no rank skips what another applies."""
    return tp_lib.all_finite(torch.stack([torch.isfinite(check_loss)]
                                         + [torch.isfinite(g).all() for g in grads]).all())


def _zero_if_bad(grads, good):
    """Every gradient replaced by zeros when ``good`` is False: a NaN or an
    Inf never reaches the accumulators."""
    return [torch.where(good, g, torch.zeros((), dtype=g.dtype, device=g.device))
            for g in grads]


def _fused_inv_factors(k: int, scale, device):
    """The fold factors of one micro-batch under ``fused_adam``: ``inv_m =
    1/(K·scale)`` folds the window's normalization and the loss unscale into
    the first moment, ``inv_v = 1/(K·scale²)`` into the second (0-d float32
    tensors; the division is tensor by tensor, as JAX's)."""
    if scale is None:
        inv = torch.tensor(1.0 / k, dtype=torch.float32, device=device)
        return inv, inv
    one = torch.ones((), dtype=torch.float32, device=device)
    return torch.div(one, k * scale), torch.div(one, k * scale * scale)


def _require_fused_hooks(optimizer: Optimizer) -> None:
    if optimizer.fused is None:
        raise ValueError(
            "GradAccumConfig.fused_adam requires an optimizer exposing FusedAccum "
            "hooks (ops.adamw.adamw / ops.adamw.adam); "
            f"{optimizer} has none"
        )


def _finalize(accum, config: GradAccumConfig, denom, spans=obs_trace.NO_SPANS):
    """Normalize the accumulated sum by ``denom`` (an int, or a 0-d tensor
    when it holds the good count or the loss scale), then clip (if set)."""
    with spans("train/clip"):
        grads = {name: g / denom for name, g in accum.items()}
        if config.clip_norm is not None:
            return clip_by_global_norm(grads, config.clip_norm)
        return grads, grad_norm(grads)


def _scale_of(state, config: GradAccumConfig, init_fn: str):
    if config.loss_scale is None:
        return None
    if state.loss_scale is None:
        raise ValueError(
            "GradAccumConfig.loss_scale is set but the state carries no "
            f"DynamicLossScale: build it with {init_fn}(params, opt, "
            "loss_scale=config.loss_scale)"
        )
    return state.loss_scale.scale


def _axis_mesh(config: GradAccumConfig):
    """The ``DataMesh`` bound to ``config.axis_name``, or None without one
    (an unbound name raises JAX's ``NameError``)."""
    if config.axis_name is None:
        return None
    from gradaccum_tpu_torch.parallel.mesh import axis_mesh

    return axis_mesh(config.axis_name)


class _Reduce(NamedTuple):
    """Where a window's gradient sums: ``mesh`` over ``axis_name`` and the
    example axes together, ``examples`` over the example axes (the guard's
    pmin), ``replicas`` the ``axis_name`` width (the denominator's N), and
    ``once`` whether this rank counts the values its example shards share
    (coordinate 0 on every example axis)."""

    mesh: Any
    examples: Any
    replicas: int
    once: bool


def _reduction(config: GradAccumConfig) -> Optional[_Reduce]:
    """The :class:`_Reduce` of ``config``, or None with neither
    ``axis_name`` nor ``example_axes``."""
    data = _axis_mesh(config)
    axes = tuple(config.example_axes)
    if not axes:
        return None if data is None else _Reduce(data, None, data.world, True)
    from gradaccum_tpu_torch.parallel.mesh import axis_mesh, current_mesh

    shards = [axis_mesh(a) for a in axes]  # an unbound name raises JAX's NameError
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("example_axes need the multi-axis mesh of parallel.mesh.make_mesh")
    names = axes + ((config.axis_name,) if config.axis_name is not None else ())
    return _Reduce(mesh.over(names), mesh.over(axes), 1 if data is None else data.world,
                   all(m.rank == 0 for m in shards))


def _shared_names(params, config: GradAccumConfig):
    """The parameters invariant over an example axis: each rank of it holds
    their whole gradient, counted once in the sum."""
    axes = set(config.example_axes)
    return [name for name, p in params.items() if axes & set(invariant_axes(p))]


def _sum_parts(grads, params, config: GradAccumConfig, red: _Reduce):
    """One micro-batch's gradients summed over ``red.mesh``, the whole
    gradients of the parameters shared by the example shards counted once."""
    if not red.once:
        shared = set(_shared_names(params, config))
        grads = [torch.zeros_like(g) if name in shared else g
                 for name, g in zip(params, grads)]
    grads = list(grads)
    red.mesh.all_reduce_tensors_(grads, tag="grads")
    return grads


def _global_mean(mesh, loss, check_loss, grads):
    """One micro-batch's loss, checked loss and gradients averaged over the
    ranks of ``mesh``: the gradient of the mean loss over the global
    micro-batch, which the JAX package's GSPMD step (``jit`` with a sharded
    batch) gets from the all-reduce XLA inserts. One collective: the values
    are summed in a float32-or-wider buffer, divided by N and cast back to
    their dtypes (at one rank, bit for bit the input)."""
    wide = [g.to(torch.promote_types(g.dtype, torch.float32)) for g in grads]
    stats = torch.stack([loss, check_loss]).to(torch.float32)
    mesh.all_reduce_tensors_(wide + [stats], tag="grads")
    grads = tuple((w / mesh.world).to(g.dtype) for w, g in zip(wide, grads))
    stats = stats / mesh.world
    return stats[0].to(loss.dtype), stats[1].to(check_loss.dtype), grads


# --------------------------------------------------------------------------
# Scan mode
# --------------------------------------------------------------------------


class ScanState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: Any
    step: int  # micro-batches consumed so far (the reference's global_step)
    loss_scale: Any = None  # DynamicLossScale when GradAccumConfig.loss_scale is set


def scan_init(params: Dict[str, torch.Tensor], optimizer: Optimizer,
              loss_scale: Optional[LossScaleConfig] = None) -> ScanState:
    return ScanState(params=params, opt_state=optimizer.init(params), step=0,
                     loss_scale=None if loss_scale is None
                     else init_loss_scale(loss_scale, _device(params)))


def accumulate_scan(loss_fn: LossFn, optimizer: Optimizer, config: GradAccumConfig,
                    needs_rng: bool = False) -> Callable[..., tuple]:
    """Build the scan-mode train step.

    ``train_step(state, super_batch)`` expects every value of the dict
    ``super_batch`` stacked to ``[K, micro_batch, ...]`` and returns
    ``(new_state, aux)`` with ``aux = {"loss": mean over K, "grad_norm":
    norm of the averaged gradient before clipping, "lr_step": step + K}``,
    plus ``"skipped"`` and ``"good_count"`` under the guard and
    ``"loss_scale"`` with scaling. With ``needs_rng=True`` the call is
    ``train_step(state, super_batch, generator)`` and each micro-batch
    reaches ``loss_fn`` with the generator under ``"rng"``; its draws
    advance from one micro-batch to the next.
    """
    validate_config(config)
    return _scan_train_step(loss_fn, optimizer, config, needs_rng)


def _scan_train_step(loss_fn, optimizer: Optimizer, config: GradAccumConfig,
                     needs_rng: bool, sparse=None, micro_mean=None):
    """The scan-mode train step. With ``sparse`` (``SparseEmbedHooks``,
    ``ops/sparse_embed.py``) ``loss_fn`` is ``(params, rows, batch)``: each
    micro-batch differentiates with respect to its gathered [micro, S, H]
    table rows instead of the table, and one ``index_add_`` builds the
    table's dense gradient after the loop. With ``micro_mean`` (a
    ``DataMesh``; ``parallel/dp.py :: make_pjit_dp_train_step``) every
    micro-batch's loss and gradients are averaged over its ranks before the
    guard and the accumulator see them; the row cotangents stay this
    rank's (its rows), scaled by 1/N, and the table's gradient is summed
    over the ranks once after the scatter. A vocab-sharded table (tensor
    parallelism) gathers its rows across the model ranks and each rank
    scatters only the rows of its own vocabulary range."""
    k = config.num_micro_batches
    skip = config.skip_nonfinite
    fused = config.fused_adam
    if fused:
        if sparse is not None:
            raise ValueError("fused_adam and sparse_embed both replace the "
                             "accumulator; pick one")
        _require_fused_hooks(optimizer)

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
        scale = _scale_of(state, config, "scan_init")
        spans = obs_trace.UpdateSpans(obs_trace.get_tracer(), state.step)
        red = _reduction(config)
        mesh = None if red is None else red.mesh
        params = state.params
        dense = params
        vocab_mesh = None
        if sparse is not None:
            table = params[sparse.table_path]
            dense = {name: p for name, p in params.items() if name != sparse.table_path}
            vocab_axis = tp_lib.axis_of(table, 0)
            if vocab_axis is not None:
                from gradaccum_tpu_torch.parallel.mesh import axis_mesh

                vocab_mesh = axis_mesh(vocab_axis)
        device = _device(params)
        if fused:
            # the moments carry the window: no accumulator
            mv = optimizer.fused.moments(state.opt_state)
            inv_m, inv_v = _fused_inv_factors(k, scale, device)
        else:
            # under sparse_embed the table's gradient takes its slot when
            # it sums at its own dtype (one scatter-add, below)
            in_window = sparse is not None and \
                torch.promote_types(table.dtype, torch.float32) == table.dtype
            with spans("train/accumulate"):
                accum, buffers, stats = _window_accum(
                    params if in_window else dense,
                    0 if mesh is None else 2 if skip else 1)
            dense_slots = [accum[name] for name in dense]
        # fused mode counts the window position even unguarded: `first`
        n_good = torch.zeros((), dtype=torch.int32, device=device) \
            if skip or fused else None
        losses, rows_ct = [], []
        for i in range(k):
            micro = {key: x[i] for key, x in super_batch.items()}
            if needs_rng:
                micro["rng"] = generator
            if sparse is None:
                loss, check_loss, grads = _grad_call(loss_fn, params, micro, scale,
                                                     spans=spans, micro=i)
            else:
                # the gather stays outside autograd: the table takes no
                # cotangent, the rows do
                ids = micro[sparse.ids_key]
                if vocab_mesh is None:
                    rows = F.embedding(ids.long(), table.detach())
                else:
                    rows = tp_lib.vocab_parallel_embed(ids, table.detach(), vocab_mesh)
                rows = rows.requires_grad_()
                loss, check_loss, grads = _grad_call(
                    lambda p, b, r=rows: loss_fn(p, r, b), params, micro, scale,
                    wrt=list(dense.values()) + [rows], spans=spans, micro=i)
            with torch.no_grad(), spans("train/accumulate", micro=i):
                if micro_mean is not None and sparse is not None:
                    # this rank's rows: their share of the global mean
                    loss, check_loss, dense_g = _global_mean(micro_mean, loss, check_loss,
                                                             grads[:-1])
                    grads = dense_g + (grads[-1] / micro_mean.world,)
                elif micro_mean is not None:
                    loss, check_loss, grads = _global_mean(micro_mean, loss, check_loss, grads)
                good = None
                if skip:
                    # the verdict covers the row cotangents too
                    good = _all_finite(check_loss, grads)
                    if micro_mean is not None and sparse is not None:
                        good = micro_mean.pmin_flag(good, tag="guard")
                    if red is not None and red.examples is not None:
                        # shards of one example agree: bad on one, skipped on all
                        good = red.examples.pmin_flag(good, tag="guard")
                    grads = _zero_if_bad(grads, good)
                    loss = torch.where(good, loss, torch.zeros_like(loss))  # out of the mean
                if sparse is not None:
                    rows_ct.append(grads[-1])
                    grads = grads[:-1]
                if fused and red is not None:
                    # the moments fold each micro-batch: its example shards'
                    # parts sum first (fused forbids axis_name: this is the
                    # example axes alone)
                    grads = _sum_parts(grads, params, config, red)
                if fused:
                    # the first usable micro-batch carries the moments' decay
                    first = n_good == 0 if good is None else (n_good == 0) & good
                    optimizer.fused.accumulate(mv, dict(zip(params, grads)), good, first,
                                               inv_m, inv_v)
                else:
                    _accum_add_(dense_slots, grads)
                if skip:
                    n_good = n_good + good.to(torch.int32)
                elif fused:
                    n_good = n_good + 1
            losses.append(loss)
        if sparse is not None:
            with torch.no_grad():
                # ONE scatter-add for the window; a skipped micro-batch's
                # rows were zeroed above, so it deposits nothing
                ids = super_batch[sparse.ids_key].reshape(-1).long()
                ct = torch.cat([g.reshape(-1, g.shape[-1]) for g in rows_ct]).to(table.dtype)
                if in_window:
                    table_grad = accum[sparse.table_path]
                else:
                    table_grad = torch.zeros_like(table)
                    buffers.append(table_grad)
                    accum = {name: table_grad if name == sparse.table_path else accum[name]
                             for name in params}
                if vocab_mesh is None:
                    table_grad.index_add_(0, ids, ct)
                else:
                    tp_lib.vocab_rows_(table_grad, ids, ct, vocab_mesh)
                if micro_mean is not None:
                    micro_mean.all_reduce_(table_grad, tag="grads")
        stacked = torch.stack(losses)
        # the window's loss statistic: the sum of the usable micro-batches'
        # losses under the guard, else their mean
        loss_stat = stacked.sum() if skip else stacked.mean()
        total = k
        if mesh is not None and not fused:
            with torch.no_grad():
                # the one collective per update: the accumulator, the loss
                # statistic and the good count in one buffer, reduced in place
                stats[0] = loss_stat
                if skip:
                    stats[1] = n_good
                if not red.once:
                    # what every shard of these examples holds whole counts once
                    stats.zero_()
                    for name in _shared_names(params, config):
                        accum[name].zero_()
                for buf in buffers:
                    mesh.all_reduce_(buf, tag="grads")
                loss_stat = stats[0].to(stacked.dtype)
                if skip:
                    n_good = stats[1].to(torch.int32)
            total = k * red.replicas
        apply_step = state.step + k
        norm = None
        if fused:
            # the moments hold the normalized, unscaled window; the all-bad
            # window's moments are the old ones bit for bit
            if skip and int(n_good) == 0:  # the window's one host read
                new_params = params
                new_opt_state = optimizer.fused.carry_into(state.opt_state, mv)
            else:
                with spans("train/optimizer"):
                    new_params, new_opt_state = optimizer.fused.apply(
                        state.opt_state, mv, params, apply_step)
        else:
            new_params, new_opt_state, norm = _scan_apply(
                optimizer, config, state, accum, n_good, scale, apply_step, total, spans)
        new_ls = state.loss_scale
        if config.loss_scale is not None:
            new_ls = update_loss_scale(state.loss_scale, config.loss_scale, n_good >= total)
        if skip:
            # mean over the usable micro-batches (of every rank); NaN when the
            # whole window was bad
            loss = torch.where(n_good > 0,
                               loss_stat / torch.clamp(n_good.to(stacked.dtype), min=1.0),
                               torch.full_like(stacked[0], float("nan")))
        else:
            loss = loss_stat if mesh is None else loss_stat / red.replicas
        aux = {"loss": loss, "lr_step": apply_step}
        if norm is not None:  # fused mode never sums the window's gradient
            aux["grad_norm"] = norm
        if skip:
            aux["skipped"] = total - n_good  # window-global count
            aux["good_count"] = n_good
        if config.loss_scale is not None:
            aux["loss_scale"] = new_ls.scale
        return ScanState(new_params, new_opt_state, apply_step, new_ls), aux

    return train_step


def _scan_apply(optimizer, config, state, accum, n_good, scale, apply_step, total,
                spans=obs_trace.NO_SPANS):
    """The two-pass apply: normalize (by ``total`` = K·N, or the good
    count), unscale, clip, update (none for an all-bad window). Returns
    ``(params, opt_state, grad_norm)``."""
    with torch.no_grad():
        if config.skip_nonfinite and config.normalize_by_good_count:
            # rescale over the survivors instead of shrinking the update
            denom = torch.clamp(n_good, min=1).to(torch.float32)
        else:
            denom = total  # a skipped micro-batch adds zero: the update shrinks
        if scale is not None:
            denom = denom * scale  # unscale BEFORE clip and apply
        grads, norm = _finalize(accum, config, denom, spans)
    if config.skip_nonfinite and int(n_good) == 0:  # the window's one host read
        return state.params, state.opt_state, norm
    with spans("train/optimizer"):
        new_params, new_opt_state = optimizer.update(grads, state.opt_state, state.params,
                                                     apply_step)
    return new_params, new_opt_state, norm


def stack_micro_batches(batch: Dict[str, Any], num_micro_batches: int) -> Dict[str, Any]:
    """Reshape a ``[K*B, ...]`` host batch into the ``[K, B, ...]`` super-batch."""
    return {key: x.reshape((num_micro_batches, -1) + tuple(x.shape[1:]))
            for key, x in batch.items()}


# --------------------------------------------------------------------------
# Streaming mode (the reference's tf.cond semantics)
# --------------------------------------------------------------------------


class StreamingState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: Any
    # the reference's accum_grads variables; () under fused_adam
    accum_grads: Any
    step: int  # micro-batch counter == the reference's global_step
    # good micro-batches in the current window (int32, 0-d, on the card):
    # persistent like the accumulators, since a window spans host steps.
    # Under fused_adam it counts the window's position even unguarded.
    good_count: torch.Tensor
    loss_scale: Any = None  # DynamicLossScale when GradAccumConfig.loss_scale is set


def streaming_init(params: Dict[str, torch.Tensor], optimizer: Optimizer,
                   loss_scale: Optional[LossScaleConfig] = None,
                   fused: bool = False) -> StreamingState:
    """``fused=True`` (``GradAccumConfig.fused_adam``): no gradient
    accumulators, ``accum_grads`` is ``()``; the moments carry the window."""
    device = _device(params)
    return StreamingState(params=params, opt_state=optimizer.init(params),
                          accum_grads=() if fused else _accum_zeros(params), step=0,
                          good_count=torch.zeros((), dtype=torch.int32, device=device),
                          loss_scale=None if loss_scale is None
                          else init_loss_scale(loss_scale, device))


def streaming_step(loss_fn: LossFn, optimizer: Optimizer, config: GradAccumConfig,
                   needs_rng: bool = False) -> Callable[..., tuple]:
    """Build the streaming-mode train step (one micro-batch per call).

    ``train_step(state, micro_batch)`` returns ``(new_state, aux)`` with
    ``aux = {"loss": this micro-batch's raw loss, "applied": 1.0 on apply
    steps, else 0.0}``, plus ``"skipped"`` and ``"good_count"`` (this
    micro-batch's) under the guard and ``"loss_scale"`` with scaling. With
    ``needs_rng=True`` the call is ``train_step(state, micro_batch,
    generator)``.
    """
    validate_config(config)
    return _streaming_train_step(loss_fn, optimizer, config, needs_rng)


def _streaming_train_step(loss_fn, optimizer: Optimizer, config: GradAccumConfig,
                          needs_rng: bool, micro_mean=None):
    """The streaming-mode train step; ``micro_mean`` as in
    :func:`_scan_train_step`."""
    k = config.num_micro_batches
    skip = config.skip_nonfinite
    fused = config.fused_adam
    if fused:
        _require_fused_hooks(optimizer)
    # the reference applies when step % K == 0 (quirk included); quirk-free
    # applies once K gradients have accumulated
    phase = 0 if config.first_step_quirk else k - 1
    # the schedule's step at an apply: the pre-increment count with the
    # quirk (the reference's global_step), the post-increment count without
    # it (= micro-batches consumed, scan mode's step + K)
    step_offset = 0 if config.first_step_quirk else 1

    def train_step(state: StreamingState, micro_batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        if needs_rng:
            if generator is None:
                raise ValueError("needs_rng=True: pass train_step(state, batch, generator)")
            micro_batch = dict(micro_batch, rng=generator)
        scale = _scale_of(state, config, "streaming_init")
        spans = obs_trace.UpdateSpans(obs_trace.get_tracer(), state.step)
        micro = state.step % k  # the micro-batch's place in its window
        red = _reduction(config)
        data = _axis_mesh(config)
        n_replicas = 1 if red is None else red.replicas
        params = state.params
        loss, check_loss, grads = _grad_call(loss_fn, params, micro_batch, scale,
                                             spans=spans, micro=micro)
        applied = state.step % k == phase
        new_params, new_opt_state = params, state.opt_state
        new_good, new_ls = state.good_count, state.loss_scale
        accum = state.accum_grads
        with torch.no_grad():
            with spans("train/accumulate", micro=micro):
                if micro_mean is not None:
                    loss, check_loss, grads = _global_mean(micro_mean, loss, check_loss,
                                                           grads)
                if red is not None:
                    # the reference's SUM-aggregated mirrored accumulators: one
                    # all-reduce of this micro-batch's gradients (and of the
                    # example shards' parts; a whole one counts once)
                    grads = _sum_parts(grads, params, config, red)
                good = None
                if skip:
                    if data is None:
                        good = _all_finite(check_loss, grads)
                    else:
                        # the loss is this rank's: any rank's non-finite loss
                        # skips the micro-batch on every rank, or the zeroed
                        # accumulators would diverge
                        finite_loss = data.pmin_flag(torch.isfinite(check_loss), tag="guard")
                        good = finite_loss & _all_finite(check_loss, grads)
                    if red is not None and red.examples is not None:
                        good = red.examples.pmin_flag(good, tag="guard")
                    grads = _zero_if_bad(grads, good)
                    good_inc = good.to(torch.int32)
                else:
                    good_inc = 1  # fused mode's window position
                window_good = state.good_count + good_inc if skip or fused else None
                if fused:
                    # fold this micro-batch before the branch: the apply branch
                    # re-accumulates the current gradient first, as the reference
                    inv_m, inv_v = _fused_inv_factors(k, scale, _device(params))
                    first = state.good_count == 0
                    if skip:
                        first = first & good
                    mv = optimizer.fused.moments(state.opt_state)
                    optimizer.fused.accumulate(mv, dict(zip(params, grads)), good, first,
                                               inv_m, inv_v)
                else:
                    # both branches accumulate: the apply branch re-accumulates
                    # the current gradient first (optimization.py:81)
                    _accum_add_(accum.values(), grads)
            if applied:
                sched_step = state.step + step_offset
                # an all-bad window must not apply: the window's one host read
                run = not skip or int(window_good) > 0
                if fused:
                    if run:
                        with spans("train/optimizer"):
                            new_params, new_opt_state = optimizer.fused.apply(
                                state.opt_state, mv, params, sched_step)
                    else:
                        new_opt_state = optimizer.fused.carry_into(state.opt_state, mv)
                else:
                    # each good call added a sum over the ranks: x N stays
                    if skip and config.normalize_by_good_count:
                        denom = torch.clamp(window_good, min=1).to(torch.float32) * n_replicas
                    else:
                        denom = k * n_replicas
                    if scale is not None:
                        denom = denom * scale  # unscale BEFORE clip and apply
                    avg, _ = _finalize(accum, config, denom, spans)
                    if run:
                        with spans("train/optimizer"):
                            new_params, new_opt_state = optimizer.update(
                                avg, state.opt_state, params, sched_step)
                    with spans("train/accumulate"):
                        for acc in accum.values():
                            acc.zero_()
                if config.loss_scale is not None:
                    # window boundary: the scale adjusts, applied or not
                    new_ls = update_loss_scale(state.loss_scale, config.loss_scale,
                                               window_good >= k)
                new_good = torch.zeros_like(state.good_count)
            elif skip or fused:
                new_good = window_good
        aux = {"loss": loss, "applied": 1.0 if applied else 0.0}
        if skip:
            aux["skipped"] = 1 - good_inc
            aux["good_count"] = good_inc
        if config.loss_scale is not None:
            aux["loss_scale"] = new_ls.scale
        new_state = StreamingState(new_params, new_opt_state, accum, state.step + 1,
                                   new_good, new_ls)
        return new_state, aux

    return train_step
