"""Pipeline parallelism (the GPipe schedule) over the ``pipe`` mesh axis.

The port of ``gradaccum_tpu/parallel/pp.py``. The K accumulation
micro-batches are the pipeline's micro-batches: P stages, one per rank of
the ``pipe`` axis, each rank holding its own stage's parameters and
optimizer state.

- Stage parameters are stacked ``[P, ...]`` per leaf (:func:`pp_init`
  builds the whole state, as every rank does); :func:`pp_local_state`
  keeps rank r's ``[1, ...]`` slice of every stage-stacked leaf, parameters
  and moments alike, and :func:`pp_global_state` gathers them back
  (checkpoints hold the whole ``[P, ...]`` state).
- :func:`pipeline_apply` runs the skewed schedule: for ``T = K + P - 1``
  ticks every rank applies its stage to the activation it holds and passes
  the result one rank down the pipe (:meth:`~.mesh.DataMesh.ppermute`, no
  send after the last tick); rank 0 feeds micro-batch t at tick t and the
  last rank emits outputs from tick P-1 on. Every rank builds the same
  autograd graph: the choices by rank are tensor selects on the rank index
  (``torch.where``), never a Python branch, so each rank's backward issues
  the inverse permutations in the same order and the ranks meet.
- The loss is differentiated on every rank as ``where(last rank, loss,
  0)``: the backward leaves each rank exactly its own stage's gradient, the
  last rank the head's (``post``) and rank 0 the embeddings' (``pre``);
  the ``pre``/``post`` gradients are then summed over ``pipe``, and every
  gradient averaged over ``data``.
- Each rank updates its stage's optimizer state; the step counter advances
  by K.

Collectives per update (P stages, K micro-batches): ``2 (K + P - 2)``
ppermutes on ``pipe`` (T - 1 sends forward, their inverses backward); one
SUM all-reduce on ``pipe`` (the ``pre``/``post`` gradients, the stages'
squared norm for the clip, the logged loss); with a ``data`` axis one SUM
all-reduce on ``data`` (every gradient and the loss); under the guard two
MIN all-reduces over ``pipe`` and ``data`` together (the micro-batch
verdicts, and the final net on the gradients).

Requirements: homogeneous stages (``stage_fn(stage_params, x) -> y``, y
shaped as x); ``stage_params`` is the dict of this rank's stage with the
leading stage dimension removed. Embedding and head layers sit outside
the pipelined region as :class:`PipelineParams` ``pre`` / ``post``, with
``pre_fn`` and a 3-argument ``loss_fn``; per-micro-batch side inputs every
stage needs (the attention mask) ride along as ``ctx_keys``. See
``models/bert_pp.py`` for BERT.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.ops.loss_scale import (
    LossScaleConfig,
    init_loss_scale,
    update_loss_scale,
)
from gradaccum_tpu_torch.parallel.mesh import PIPE_AXIS, DataMesh
from gradaccum_tpu_torch.utils.tree import map_state

# stage_fn(stage_params, x[, ctx]) -> y, same shape (homogeneous stages)
StageFn = Callable[..., torch.Tensor]
# loss_fn(final_activations, micro_batch) -> scalar mean loss
PPLossFn = Callable[..., torch.Tensor]

_PARTS = ("pre", "stages", "post")


class PPState(NamedTuple):
    params: Any  # stage-stacked {name: [P or 1, ...]}, or a PipelineParams
    opt_state: Any  # over flat_params(params)
    step: int  # micro-batches consumed
    loss_scale: Any = None  # DynamicLossScale with a loss_scale config


class PipelineParams(NamedTuple):
    """Stage-stacked pipeline body plus the pipe-replicated ``pre`` and
    ``post`` dictionaries (embeddings, head); either may be None."""

    pre: Any
    stages: Any  # {name: [P, ...]}
    post: Any


class PipelineSpec(NamedTuple):
    """What the Estimator needs to run a model on the pipeline: how to
    split the dense parameter dictionary into the :class:`PipelineParams`
    layout (``partition``), how to merge it back for evaluate and predict
    (``merge``), and the three step functions (``models/bert_pp.py ::
    bert_pipeline_spec``)."""

    n_stages: int
    partition: Callable[[Any, int], Tuple[Any, list, Any]]
    merge: Callable[[PipelineParams], Any]
    pre_fn: Callable
    stage_fn: StageFn
    loss_fn: Callable  # (post_params, final_acts, labels) -> scalar
    input_key: str = "x"
    ctx_keys: Sequence[str] = ()


def stack_stage_params(stage_params_list) -> Dict[str, torch.Tensor]:
    """Stack per-stage parameter dictionaries into the ``[P, ...]`` layout."""
    names = list(stage_params_list[0])
    return {name: torch.stack([torch.as_tensor(sp[name]).detach() for sp in stage_params_list])
            for name in names}


def _stages(params):
    return params.stages if isinstance(params, PipelineParams) else params


def flat_params(params) -> Dict[str, torch.Tensor]:
    """The optimizer's view of pipeline parameters: one dictionary, the
    ``pre``/``stages``/``post`` names prefixed by their part (the same
    tensors). Stage-stacked parameters without a :class:`PipelineParams`
    are their own dictionary."""
    if not isinstance(params, PipelineParams):
        return params
    return {f"{part}/{name}": t for part in _PARTS
            for name, t in (getattr(params, part) or {}).items()}


def _trainable(tree):
    return None if tree is None else {name: torch.as_tensor(t).detach().clone().requires_grad_()
                                      for name, t in tree.items()}


def pp_init(stage_params_list, optimizer: Optimizer, pre_params: Any = None,
            post_params: Any = None, loss_scale: Optional[LossScaleConfig] = None) -> PPState:
    """The whole pipeline state: the stages stacked ``[P, ...]``, ``pre`` and
    ``post`` whole, the optimizer state over all of them (every rank builds
    it; :func:`pp_local_state` keeps a rank's stage)."""
    params = _trainable(stack_stage_params(stage_params_list))
    if pre_params is not None or post_params is not None:
        params = PipelineParams(pre=_trainable(pre_params), stages=params,
                                post=_trainable(post_params))
    device = next(iter(_stages(params).values())).device
    return PPState(params=params, opt_state=optimizer.init(flat_params(params)), step=0,
                   loss_scale=None if loss_scale is None else init_loss_scale(loss_scale, device))


def _stacked_paths(state: PPState):
    """``{path: True}`` for every stage-stacked leaf of ``state``: the stage
    parameters and each optimizer leaf shaped as the stage parameter its
    path ends with (a moment, a master); a leaf of another shape (Adam-mini's
    scalar, a counter) is whole, as JAX's structural rule has it."""
    stage_shapes = {}
    prefix = "stages/" if isinstance(state.params, PipelineParams) else ""
    for name, p in _stages(state.params).items():
        stage_shapes[prefix + name] = tuple(p.shape)
    out = {}

    def visit(path, leaf):
        if path.startswith("params/"):
            out[path] = path[len("params/"):] in stage_shapes
        elif path.startswith("opt_state/"):
            out[path] = any(path.endswith("/" + n) and tuple(leaf.shape) == shape
                            for n, shape in stage_shapes.items())
        else:
            out[path] = False
        return leaf

    map_state(visit, state)
    return out


def pp_local_state(state: PPState, pipe: DataMesh) -> PPState:
    """``state`` (whole) with every stage-stacked leaf cut to this rank's
    ``[1, ...]`` slice (a copy; the parameters stay trainable leaves)."""
    stacked = _stacked_paths(state)

    def cut(path, leaf):
        if not stacked[path]:
            return leaf
        piece = leaf.detach().narrow(0, pipe.rank, 1).clone()
        return piece.requires_grad_() if leaf.requires_grad else piece

    return map_state(cut, state)


def pp_global_state(state: PPState, pipe: DataMesh) -> PPState:
    """The whole ``[P, ...]`` state from every rank's slice (a collective:
    every rank of ``pipe`` calls it)."""
    stacked = _stacked_paths(state)
    return map_state(lambda path, leaf: pipe.all_gather(leaf, dim=0, tag="state")
                     if stacked[path] else leaf.detach(), state)


def _micro_batch_guard(batch, k: int):
    """Per-micro-batch finiteness verdict over a ``[K, ...]``-stacked dict
    batch, and the batch with each bad micro-batch's float leaves zeroed
    (so the stages compute on finite inputs and their backward stays
    clean). Returns ``(good [K] int32, clean batch)``; integer leaves pass."""
    device = next(iter(batch.values())).device
    good = torch.ones((k,), dtype=torch.int32, device=device)
    clean = {}
    for name, leaf in batch.items():
        if leaf.is_floating_point():
            ok = torch.isfinite(leaf).reshape(k, -1).all(dim=1)
            good = torch.minimum(good, ok.to(torch.int32))
            clean[name] = torch.where(ok.reshape((k,) + (1,) * (leaf.dim() - 1)), leaf,
                                      torch.zeros_like(leaf))
        else:
            clean[name] = leaf
    return good, clean


def pipeline_apply(stage_fn: StageFn, local_params, micro_inputs: torch.Tensor,
                   pipe: DataMesh, micro_ctx=None, guard: bool = False):
    """Run the skewed GPipe schedule on this rank of ``pipe``.

    ``micro_inputs``: ``[K, B, ...]`` (every rank passes its own; rank 0's
    is fed); returns ``[K, B, ...]`` final-stage outputs, valid on the last
    rank (zeros elsewhere). ``micro_ctx``: a dict of ``[K, ...]`` side
    inputs; at tick t rank r holds micro-batch ``t - r`` and ``stage_fn`` is
    called as ``stage_fn(params, x, ctx)`` with that entry (bubble ticks
    clamp the index; their outputs are discarded).

    ``guard=True`` checks each tick's incoming activation before the stage
    consumes it: a non-finite ``x`` is zeroed (its cotangent too, so the
    skip never lets a NaN into this stage's gradients) and its micro-batch
    flagged. Returns ``(outs, good)`` with ``good`` an ``[K]`` int32 vector
    of THIS rank's verdicts."""
    n, idx = pipe.world, pipe.rank
    k = micro_inputs.shape[0]
    ticks = k + n - 1
    perm = [(i, i + 1) for i in range(n - 1)]
    device = micro_inputs.device
    first = torch.tensor(idx == 0, device=device)
    last = torch.tensor(idx == n - 1, device=device)
    good = torch.ones((k,), dtype=torch.int32, device=device)
    buf = torch.zeros_like(micro_inputs[0])
    outs = []
    for t in range(ticks):  # unrolled: T is small (K + P - 1)
        feed = micro_inputs[t] if t < k else torch.zeros_like(buf)
        x = torch.where(first, feed, buf)
        j = min(max(t - idx, 0), k - 1)
        if guard:
            ok = torch.isfinite(x).all()
            x = torch.where(ok, x, torch.zeros_like(x))
            if 0 <= t - idx <= k - 1:  # bookkeeping only: bubble ticks do not vote
                good[j] = torch.minimum(good[j], ok.to(torch.int32))
        if micro_ctx is None:
            y = stage_fn(local_params, x)
        else:
            y = stage_fn(local_params, x, {key: v[j] for key, v in micro_ctx.items()})
        if t >= n - 1:
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if n > 1 and t < ticks - 1:  # nothing reads a send after the last tick
            buf = pipe.ppermute(y, perm, tag="pipe")
    outs = torch.stack(outs)
    return (outs, good) if guard else outs


def _sq(tensors):
    """Σ g² over ``tensors`` in float32, summed leaf by leaf in order (0
    for none, as JAX's sum over an empty tree)."""
    return sum(torch.sum(torch.square(g.float())) for g in tensors)


def _finite(tensors) -> torch.Tensor:
    return torch.stack([torch.isfinite(g).all() for g in tensors]).all()


def make_pp_train_step(stage_fn: StageFn, loss_fn: PPLossFn, optimizer: Optimizer,
                       num_micro_batches: int, mesh, axis: str = PIPE_AXIS,
                       data_axis: Optional[str] = None, input_key: str = "x", pre_fn=None,
                       ctx_keys=(), clip_norm: Optional[float] = None,
                       skip_nonfinite: bool = False, normalize_by_good_count: bool = False,
                       loss_scale: Optional[LossScaleConfig] = None):
    """Build ``train_step(state, batch) -> (state, aux)`` on ``mesh`` (a
    :class:`~.mesh.Mesh` with a ``pipe`` axis, and ``data`` when
    ``data_axis`` is set), JAX's step with its errors word for word.

    ``batch`` is the GLOBAL dict batch, every rank passing the same; its
    ``input_key`` leaf is stacked ``[K, B, ...]`` and the other leaves
    (labels) go to ``loss_fn`` per micro-batch. With ``data_axis`` each
    data rank pipelines its block of B (leaves of rank >= 2; rank-1 ``[K]``
    leaves are whole) and the gradients are averaged over ``data``.
    ``state`` holds this rank's stage (:func:`pp_local_state`).

    For a :class:`PipelineParams` state, ``pre_fn(pre, micro_batch)`` maps
    each raw micro-batch to the pipeline's input (embeddings; it runs on
    every rank, rank 0's is fed), ``loss_fn(post, final_acts, labels)``
    runs the head inside the last rank's loss, and ``ctx_keys`` name the
    ``[K, ...]`` leaves every stage needs per micro-batch.

    ``clip_norm``: global-norm clip of the averaged gradients, the stages'
    squared norm summed over ``pipe`` and ``pre``/``post`` counted once.

    ``skip_nonfinite``: the guard at three levels, its verdicts MIN-ed over
    ``pipe`` and ``data`` so every rank skips the same micro-batches: (1)
    raw float batch leaves per micro-batch before ``pre_fn``; (2) each
    tick's activation before a stage consumes it; (3) the per-micro-batch
    losses on the last rank. Flagged micro-batches leave the loss mean
    (exactly zero gradient); ``normalize_by_good_count`` divides by the
    survivors instead of K. A final net checks the assembled gradients and
    skips the whole update (parameters and moments carry over unchanged).

    ``loss_scale``: the last rank's loss is multiplied by the live scale
    before differentiation, the guard sees scaled values, the gradients are
    unscaled before clip and apply, and the scale halves on a dirty window
    and regrows after ``growth_interval`` clean ones. Requires
    ``skip_nonfinite=True``."""
    k = num_micro_batches
    skip = skip_nonfinite
    if normalize_by_good_count and not skip:
        raise ValueError("normalize_by_good_count requires skip_nonfinite=True")
    if loss_scale is not None and not skip:
        raise ValueError(
            "dynamic loss scaling detects overflow through the non-finite "
            "guard; it requires skip_nonfinite=True"
        )
    pipe = mesh.axis(axis)
    data = mesh.axis(data_axis) if data_axis is not None else None
    both = mesh.over((axis, data_axis) if data_axis is not None else (axis,))
    n, idx = pipe.world, pipe.rank

    def check_batch(batch):
        kk = batch[input_key].shape[0]
        if kk != k:
            raise ValueError(
                f"batch[{input_key!r}] is stacked [{kk}, ...] but the step was "
                f"built with num_micro_batches={k}; the step counter and LR "
                "schedule would silently desync"
            )
        if data_axis is not None:
            b = batch[input_key].shape[1]
            for name, leaf in batch.items():
                if leaf.dim() >= 2 and leaf.shape[1] != b:
                    raise ValueError(
                        f"batch[{name!r}] has dim-1 {leaf.shape[1]} but the "
                        f"{input_key!r} micro-batch dim is {b}; rank>=2 leaves "
                        "must be [K, B, ...] batch-major to shard over "
                        f"{data_axis!r} (pass per-micro scalars as rank-1 [K])"
                    )

    def local_batch(batch):
        if data is None or data.world == 1:
            return batch

        def cut(leaf):
            if leaf.dim() < 2:
                return leaf
            size = leaf.shape[1] // data.world
            return leaf.narrow(1, data.rank * size, size)

        return {key: cut(leaf) for key, leaf in batch.items()}

    def train_step(state: PPState, batch):
        check_batch(batch)
        batch = local_batch(batch)
        has_prepost = isinstance(state.params, PipelineParams)
        stages = _stages(state.params)
        local = {name: p[0] for name, p in stages.items()}
        pre = state.params.pre if has_prepost else None
        post = state.params.post if has_prepost else None
        if loss_scale is not None and state.loss_scale is None:
            raise ValueError(
                "the step was built with loss_scale but the PPState carries "
                "no DynamicLossScale — build it with pp_init(..., "
                "loss_scale=...)"
            )
        scale = state.loss_scale.scale if loss_scale is not None else None
        # (1) the batch guard, outside autograd (batches carry no gradient)
        good_in, batch_c = _micro_batch_guard(batch, k) if skip else (None, batch)
        device = next(iter(stages.values())).device
        last = torch.tensor(idx == n - 1, device=device)

        def micro(i):
            return {key: v[i] for key, v in batch_c.items()}

        if pre_fn is not None:
            micro_inputs = torch.stack([pre_fn(pre, micro(i)) for i in range(k)])
        else:
            micro_inputs = batch_c[input_key]
        ctx = {key: batch_c[key] for key in ctx_keys} if ctx_keys else None
        if skip:
            # (2) per-stage activation checks ride the schedule
            outs, stage_good = pipeline_apply(stage_fn, local, micro_inputs, pipe, ctx,
                                              guard=True)
        else:
            outs = pipeline_apply(stage_fn, local, micro_inputs, pipe, ctx)

        def labels(i):
            return {key: v[i] for key, v in batch_c.items() if key != input_key}

        if has_prepost:
            losses = torch.stack([loss_fn(post, outs[i], labels(i)) for i in range(k)])
        else:
            losses = torch.stack([loss_fn(outs[i], labels(i)) for i in range(k)])
        n_good = None
        if skip:
            # (3) the loss check means something on the last rank only (the
            # others ran on zeros): they vote 1, and the MIN carries the
            # last rank's verdict; the SCALED loss is what overflows
            check = losses if scale is None else losses * scale
            loss_ok = torch.where(last, torch.isfinite(check.detach()).to(torch.int32),
                                  torch.ones((k,), dtype=torch.int32, device=device))
            g = torch.minimum(torch.minimum(stage_good, loss_ok), good_in)
            # every rank agrees: bad on one stage or data shard, skipped on all
            both.pmin_(g, tag="guard")
            n_good = g.sum()
            losses = torch.where(g > 0, losses, torch.zeros_like(losses))
            if normalize_by_good_count:
                denom = torch.clamp(n_good, min=1).to(losses.dtype)
            else:
                denom = k
            local_loss = losses.sum() / denom
            logged = torch.where(last, losses.detach().sum(), torch.zeros((), device=device))
        else:
            local_loss = losses.mean()
            logged = torch.where(last, local_loss.detach(), torch.zeros((), device=device))
        # only the last rank's loss is real: differentiated as where(last,
        # loss, 0) on every rank, the backward leaves each rank its own
        # stage's gradient (and pre's on rank 0, post's on the last)
        pipe_loss = torch.where(last, local_loss, torch.zeros_like(local_loss))
        if scale is not None:
            pipe_loss = pipe_loss * scale  # unscaled below, before clip and apply
        params = flat_params(state.params)
        grads = torch.autograd.grad(pipe_loss, list(params.values()), allow_unused=True)
        with torch.no_grad():
            grads = {name: torch.zeros_like(p) if g is None else g
                     for (name, p), g in zip(params.items(), grads)}
            stats = logged.float().reshape(1)
            if data is not None and data.world > 1:
                # the mean over the data ranks: one all-reduce of everything
                wide = [g.to(torch.promote_types(g.dtype, torch.float32))
                        for g in grads.values()]
                data.all_reduce_tensors_(wide + [stats], tag="grads")
                grads = {name: (w / data.world).to(g.dtype)
                         for (name, g), w in zip(grads.items(), wide)}
                stats = stats / data.world
            if scale is not None:
                # the optimizer only ever sees true-magnitude gradients; a
                # non-finite value survives for the final net below
                grads = {name: (g.float() / scale).to(g.dtype) for name, g in grads.items()}
            shared = [name for name in grads if not name.startswith("stages/")] \
                if has_prepost else []
            stage_names = [name for name in grads if name not in shared]
            # pre and post sum over pipe (one rank computed each); the
            # stages' squared norm and the logged loss ride the same call
            stage_sq = _sq(grads[name] for name in stage_names).reshape(1) \
                if clip_norm is not None else torch.zeros((1,), device=device)
            wide = [grads[name].to(torch.promote_types(grads[name].dtype, torch.float32))
                    for name in shared]
            pipe.all_reduce_tensors_(wide + [stage_sq, stats], tag="grads")
            for name, w in zip(shared, wide):
                grads[name] = w.to(grads[name].dtype)
            if clip_norm is not None:
                total_sq = stage_sq[0] + _sq(grads[name] for name in shared if
                                             name.startswith("pre/")) + \
                    _sq(grads[name] for name in shared if name.startswith("post/"))
                norm = torch.sqrt(total_sq)
                clip_scale = torch.div(torch.tensor(clip_norm, dtype=torch.float32,
                                                    device=device),
                                       torch.maximum(norm, torch.tensor(clip_norm,
                                                                        device=device)))
                grads = {name: (g.float() * clip_scale).to(g.dtype) for name, g in grads.items()}
            loss_value = stats[0]
        apply_step = state.step + k
        if skip:
            # the final net: an overflow inside a stage can pollute its
            # backward with the loss masked (0 × NaN); a window whose
            # gradients are not finite EVERYWHERE does not apply
            ok = _finite(list(grads.values())).to(torch.int32).reshape(1)
            both.pmin_(ok, tag="guard")
            n_good = torch.where(ok[0] > 0, n_good, torch.zeros_like(n_good))
            if int(n_good) > 0:  # the window's one host read
                _, new_opt_state = optimizer.update(grads, state.opt_state, params, apply_step)
            else:
                new_opt_state = state.opt_state
            # the mean over the usable micro-batches (NaN when the whole
            # window was skipped: the log should show it)
            loss = torch.where(n_good > 0,
                               loss_value / torch.clamp(n_good.to(loss_value.dtype), min=1.0),
                               torch.full_like(loss_value, float("nan")))
            aux = {"loss": loss, "skipped": k - n_good, "good_count": n_good}
        else:
            _, new_opt_state = optimizer.update(grads, state.opt_state, params, apply_step)
            aux = {"loss": loss_value}
        new_ls = state.loss_scale
        if loss_scale is not None:
            # the window boundary: the scale adjusts, applied or not
            new_ls = update_loss_scale(state.loss_scale, loss_scale, n_good >= k)
            aux["loss_scale"] = new_ls.scale
        # the optimizer wrote the parameters in place
        return PPState(state.params, new_opt_state, apply_step, loss_scale=new_ls), aux

    return train_step
