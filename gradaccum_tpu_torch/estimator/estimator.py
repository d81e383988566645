"""The training harness: ``Estimator(model, optimizer, accum, config)``.

The port of ``gradaccum_tpu/estimator/estimator.py``, single device, in
both of its modes:

- ``mode="streaming"`` (the default, as in JAX): the reference's
  ``tf.cond`` semantics, one micro-batch per host step through
  ``streaming_step``;
- ``mode="scan"``: every host step stacks a ``[K*micro, ...]`` batch into K
  micro-batches and runs one ``accumulate_scan`` update.

``train`` resumes from the newest checkpoint in ``model_dir`` (in the
middle of an accumulation window too: the accumulators checkpoint with the
weights), logs loss, examples/sec and MFU, saves on the
``save_checkpoints_steps`` cadence and appends every step's loss to
``model_dir/loss_vs_step.csv``; ``evaluate`` runs streaming metrics and
``predict`` yields one output dict per example, both over the weights of
an explicit ``state``, else of ``checkpoint_path`` or the newest checkpoint
in ``model_dir``, else the in-memory state, else a fresh init (the
reference re-reads ``model_dir`` before every evaluation);
``train_and_evaluate`` alternates the two (``tf.estimator`` semantics:
the first evaluation after the first chunk, then at most every
``throttle_secs``, and once at the end).

Under ``skip_nonfinite`` the micro-batches skipped since ``train`` began
are counted in ``nonfinite_skips`` (read from the card at log flushes, not
per step); with loss scaling, ``loss_scale_series`` holds ``(step, scale)``
per host step.

Randomness: weights come from ``RunConfig.seed``; the dropout generator of
each host step is seeded from ``RunConfig.seed + 1`` and the micro-batch
step, so a resumed run draws exactly what the uninterrupted one would.

``GradAccumConfig(fused_adam=True)`` needs an optimizer with fused hooks
(``adamw``, ``adam``) and refuses ``sparse_embed``, as JAX's Estimator
does; its streaming state carries no accumulator.

``warm_start`` (``{name: tensor}`` in the port's parameter names, e.g.
``models/bert_checkpoint.py :: load_hf_checkpoint``) replaces the random
init of a fresh run; a checkpoint in ``model_dir`` still wins, as in JAX
and ``tf.estimator``. ``sparse_embed=True`` (scan mode only) accumulates
the model's embedding-table gradient as token-level rows
(``ops/sparse_embed.py``).

The Estimator runs on the card unless the caller passes ``device="cpu"``;
asking for CUDA without a card raises.

**Data parallelism** (``mesh=``, a ``parallel/mesh.py :: DataMesh``): every
rank runs this Estimator in its own process on the mesh's device, reads the
same global host batch and trains on its block of the rows. The step is
chosen as JAX's Estimator chooses it: the explicit DP step
(``parallel/dp.py :: make_dp_train_step``; one all-reduce per update in
scan mode) by default; ``sharding_rules=()`` takes the GSPMD counterpart
(``make_pjit_dp_train_step``, each micro-batch's gradient averaged over the
ranks), which ``fused_adam`` needs; ``zero1=True`` shards the optimizer
state over the ranks on that path, ``zero1="collective"`` on the explicit
one (``parallel/zero.py``). Rank 0's parameters are broadcast at the start.
Evaluation splits each eval batch over the ranks and sums the metric
partials; a batch whose rows do not divide runs whole on every rank. Rank
0 alone prints, writes ``loss_vs_step.csv`` and writes checkpoints; a
ZeRO-1 state is gathered to the full tree before a save (every rank takes
part) and cut again after a restore, so checkpoints stay full-tree and a
resume is bitwise.

**Tensor and expert parallelism** (``mesh=`` a multi-axis
``parallel/mesh.py :: Mesh``, ``sharding_rules=`` e.g. ``bert_tp_rules()``,
``bert_tp_ep_rules()``, ``moe_ep_rules()``, ``gpt_tp_rules()``): the state
is placed as JAX's ``_place_state`` places it. Every rank builds the whole
state, then keeps its block of every leaf the rules split (parameters,
accumulators, moments and masters: they share the names), and the model
runs on its blocks with the collectives of ``parallel/tp.py``. The step is
the GSPMD counterpart over the ``data`` axis (each micro-batch's gradient
averaged over the data ranks; nothing with one), run under the
placement's ``ShardingPlan`` (the global norm, the guard's verdict and
Adam-mini's statistic over the whole parameters). ZeRO-1 then splits the
rule-replicated moments over ``data``. Checkpoints hold the GLOBAL state:
every rank gathers at the save point (``gather_params``, a collective on
the main thread; the asynchronous writer only writes), rank 0 writes, and
a restore reads the whole state and cuts it again, so a checkpoint written
at one width restores at another. Evaluation and ``predict`` run the
sharded forward; ``export_model`` gathers the parameters (every rank calls
it) and rank 0 traces the unsharded model.

**Sequence parallelism** (a ``Mesh`` with a ``seq`` axis wider than 1,
scan mode): the step is ``parallel/sp.py :: make_dp_sp_train_step`` over
``data`` × ``seq`` (ZeRO-1 over ``data`` with ``zero1``). The model must be
sequence-aware (``bert_classifier_bundle(..., seq_axis="seq",
attention_fn=make_ring_attention_fn("seq"))``); pass its dense twin (the
same parameters, no axis) as ``eval_model``, which serves evaluate,
predict and export.

**Pipeline parallelism** (``pipeline=``, a ``parallel/pp.py ::
PipelineSpec`` such as ``models/bert_pp.py :: bert_pipeline_spec``, on a
``Mesh`` with a ``pipe`` axis, and ``data``): the dense parameters of
``model.init`` are partitioned into stages, each rank keeps its own
stage's parameters and optimizer state, and the K micro-batches run the
GPipe schedule (``make_pp_train_step``; ``clip_norm``, the guard and loss
scaling as the scan path has them). Checkpoints hold the whole ``[P, ...]``
state (every rank gathers, rank 0 writes); evaluate, predict and export
merge the stages back into the dense model. It needs
``GradAccumConfig(first_step_quirk=False)``, as in JAX.

**Resilience and observability** (JAX's train-loop hooks): seeded fault
points before and after every step (``resilience/faults.py``; the data
kinds poison the host batch), checkpoints through the manifest, quarantine
and retries of ``checkpoint.py`` and, with ``RunConfig.async_checkpoint``,
its asynchronous writer; a SIGTERM (``resilience/preemption.py``) stops
the loop at the next step boundary, with an agreed target step across
ranks under ``RunConfig.drain_consensus``, and lands a final checkpoint;
a ``train/step`` span per host step labelled ``scan-cycle``, ``apply`` or
``accumulate`` (``obs/trace.py``), inside it a ``train/upload`` span
around ``_prep_batch`` and the train step's own spans
(``ops/accumulation.py``), after it a ``flash`` counter event (the flash
wrapper's launches and host ns so far, ``ops/flash_attention.py``), the
run's scalars in a metrics registry streamed to TensorBoard event files when the backend imports
(``registry``, ``events``), a flight-recorder dump under
``model_dir/flightrec`` on a crash or a drain, and a profiler window
(``RunConfig.profile_dir``). ``export_model`` writes a ``torch.export``
serving artifact (``estimator/export.py``); ``EvalSpec.export_best_dir``
refreshes one at every improving evaluation (BestExporter).
"""

from __future__ import annotations

import itertools
import json
import os
import time
import weakref
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
from gradaccum_tpu_torch.estimator.metrics import Metric
from gradaccum_tpu_torch.obs import trace as obs_trace
from gradaccum_tpu_torch.ops import accumulation as acc
from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.ops.sparse_embed import accumulate_scan_sparse_embed
from gradaccum_tpu_torch.parallel import dp as dp_lib
from gradaccum_tpu_torch.parallel import pp as pp_lib
from gradaccum_tpu_torch.parallel import zero as zero_lib
from gradaccum_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh
from gradaccum_tpu_torch.parallel.sharding import (
    batch_shard,
    gather_params,
    placement,
    replicate_,
    shard_params,
)
from gradaccum_tpu_torch.parallel.tp import ShardingPlan, plan_scope
from gradaccum_tpu_torch.resilience import faults, preemption
from gradaccum_tpu_torch.utils.flops import peak_flops_for
from gradaccum_tpu_torch.utils.platform import device_name, resolve_device, synchronize
from gradaccum_tpu_torch.utils.tree import named_parameters

_ROW_CAP = 4096  # device scalars held between flushes, at most


class _Resources:
    """Background resources (async checkpoint writer, event writer) in a
    holder the atexit-safe finalizer can close without a reference back to
    the Estimator (``weakref.finalize`` runs at GC or interpreter exit)."""

    __slots__ = ("async_ckpt", "events")

    def __init__(self):
        self.async_ckpt = None
        self.events = None


def _close_resources(res: _Resources) -> None:
    """Drain and close both resources; raises the checkpoint error (the one
    that can lose data) after the event writer is down too."""
    ckpt, res.async_ckpt = res.async_ckpt, None
    ev, res.events = res.events, None
    try:
        if ckpt is not None:
            ckpt.close()
    finally:
        if ev is not None:
            ev.close()


def _finalize_quietly(res: _Resources) -> None:
    try:
        _close_resources(res)
    except Exception:
        pass  # interpreter shutdown / GC: best-effort only


class ModelBundle(NamedTuple):
    """Everything the harness needs to know about a model."""

    init: Callable[[int, torch.device], torch.nn.Module]  # (seed, device) -> model
    loss: Callable[[torch.nn.Module, Dict[str, Any]], torch.Tensor]  # scalar
    predict: Callable[[torch.nn.Module, Dict[str, Any]], Dict[str, torch.Tensor]]
    eval_metrics: Dict[str, Metric]
    needs_rng: bool = False  # if True, micro-batches get an "rng" generator
    # batch keys ``predict`` never reads (the reference's ``labels``):
    # stripped when an eval batch becomes the default export signature
    label_keys: tuple = ("label",)
    # optional ops.sparse_embed.SparseEmbedHooks: lets the scan step carry
    # token-level embedding cotangents instead of a dense [vocab, hidden]
    # gradient per micro-batch
    sparse_embed: Any = None
    # batch keys whose [.., B, S] token dimension a 'seq' mesh axis splits
    # (None: parallel.ring_attention.SEQ_BATCH_KEYS)
    seq_keys: Any = None


def _copy_strict(params: Dict[str, torch.nn.Parameter], tensors) -> None:
    """Copy ``tensors`` into ``params`` by name; a missing or unexpected
    name, or a shape that differs, raises before anything is copied."""
    missing = sorted(params.keys() - tensors.keys())
    unexpected = sorted(tensors.keys() - params.keys())
    if missing or unexpected:
        raise ValueError(f"warm_start does not match the model: missing {missing}, "
                         f"unexpected {unexpected}")
    wrong = [f"{name}: {tuple(tensors[name].shape)} for {tuple(p.shape)}"
             for name, p in params.items() if tuple(tensors[name].shape) != tuple(p.shape)]
    if wrong:
        raise ValueError(f"warm_start shapes differ from the model's: {wrong}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.as_tensor(tensors[name]))


def _under_plan(step, plan):
    """``step`` run under the sharding ``plan`` (``parallel/tp.py``)."""

    def train_step(*args):
        with plan_scope(plan):
            return step(*args)

    return train_step


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed derived from a run seed and a step."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


class Estimator:
    def __init__(self, model: ModelBundle, optimizer: Optimizer,
                 accum: acc.GradAccumConfig, config: Optional[RunConfig] = None,
                 mode: str = "streaming", device="cuda", mesh=None,
                 warm_start: Optional[Dict[str, torch.Tensor]] = None,
                 sparse_embed: bool = False, zero1=False, sharding_rules=None,
                 eval_model: Optional[ModelBundle] = None, pipeline=None):
        if mode not in ("streaming", "scan"):
            raise ValueError(f"mode must be 'streaming' or 'scan', got {mode!r}")
        if sharding_rules is not None and mesh is None:
            raise ValueError("sharding_rules requires a mesh")
        if sharding_rules and not isinstance(mesh, Mesh):
            raise ValueError("sharding_rules name mesh axes: build the mesh with "
                             "parallel.mesh.make_mesh")
        axes = mesh.shape if mesh is not None else {}
        self._sp_active = axes.get(SEQ_AXIS, 1) > 1
        if self._sp_active:
            if mode != "scan":
                raise ValueError("a 'seq' mesh axis requires mode='scan'")
            if sharding_rules is not None:
                raise ValueError(
                    "sharding_rules cannot combine with a 'seq' mesh axis "
                    "(sequence parallelism runs on the shard_map path)"
                )
        if pipeline is not None:
            if axes.get(PIPE_AXIS, 1) < 2:
                raise ValueError("pipeline requires a mesh with a 'pipe' axis")
            if mode != "scan":
                raise ValueError("pipeline requires mode='scan' (K pipeline "
                                 "micro-batches per host step)")
            if sharding_rules is not None or self._sp_active:
                raise ValueError(
                    "pipeline composes with the 'data' axis only (no "
                    "sharding_rules / 'seq' axis)"
                )
            if accum.first_step_quirk:
                raise ValueError(
                    "pipeline runs on the scan path, which has no "
                    "first-step quirk (the reference's step-0 apply, "
                    "optimization.py:91, is a streaming-mode semantic); "
                    "pass GradAccumConfig(first_step_quirk=False) to "
                    "acknowledge the schedule starts at a full K-cycle"
                )
        if zero1:
            if zero1 not in (True, "collective"):
                raise ValueError(
                    f"zero1 must be True (GSPMD placement) or 'collective' "
                    f"(explicit shard_map path), got {zero1!r}")
            if axes.get(DATA_AXIS, 1) < 2:
                raise ValueError("zero1 requires a mesh with a 'data' axis")
            if pipeline is not None:
                raise ValueError(
                    "zero1 does not compose with pipeline (stage-sharded "
                    "optimizer state is already partitioned over 'pipe')"
                )
            if zero1 == "collective" and not self._sp_active:
                if sharding_rules is not None:
                    raise ValueError(
                        "zero1='collective' runs on shard_map and cannot compose with "
                        "sharding_rules; use zero1=True (GSPMD placement)")
                if accum.fused_adam or sparse_embed:
                    raise ValueError(
                        "zero1='collective' cannot compose with fused_adam or "
                        "sparse_embed; use zero1=True (GSPMD placement)")
        if sparse_embed:
            if mode != "scan":
                raise ValueError("sparse_embed requires mode='scan'")
            if model.sparse_embed is None:
                raise ValueError("sparse_embed requires a model with ModelBundle."
                                 "sparse_embed hooks (see models/bert.py)")
            if self._sp_active or pipeline is not None:
                raise ValueError(
                    "sparse_embed composes with the scan/DP/GSPMD paths, "
                    "not 'seq' axis or pipeline"
                )
        acc.validate_config(accum)
        if accum.fused_adam:
            if pipeline is not None:
                raise ValueError(
                    "fused_adam is not implemented for the pipeline step "
                    "(stage gradients assemble once per window, there is "
                    "no accumulation loop to fuse into)"
                )
            if self._sp_active:
                raise ValueError(
                    "fused_adam does not compose with the 'seq'-axis "
                    "shard_map path (it would need a collective per "
                    "micro-batch); drop fused_adam or the seq axis"
                )
            if sparse_embed:
                raise ValueError("fused_adam and sparse_embed both replace the "
                                 "accumulator; pick one")
            if mesh is not None and sharding_rules is None and not zero1:
                raise ValueError(
                    "fused_adam on a mesh needs the GSPMD path (per-micro-batch "
                    "global-mean gradients): pass sharding_rules=() or zero1=True "
                    "instead of the explicit-collective DP path")
            if getattr(optimizer, "fused", None) is None:
                raise ValueError("fused_adam requires an optimizer exposing FusedAccum "
                                 "hooks (ops.adamw.adamw / ops.adamw.adam)")
        # a rank runs on its mesh device
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        # the data axis the batch splits over (one rank without one)
        self._data = mesh.axis(DATA_AXIS) if isinstance(mesh, Mesh) else mesh
        self.zero1 = zero1
        self.sharding_rules = sharding_rules
        self._rules = sharding_rules or None  # non-empty rules: a sharded placement
        self._plan = None  # the ShardingPlan of the placed parameters
        self._chief = mesh is None or mesh.rank == 0  # prints, logs, checkpoints
        self._zero1_specs = None  # {path: shard dim} of the full state, under zero1
        self.model = model
        # evaluate, predict and export run this bundle (the dense twin of a
        # sequence-parallel model)
        self.eval_model = eval_model if eval_model is not None else model
        self.pipeline = pipeline
        self._pipe = mesh.axis(PIPE_AXIS) if pipeline is not None else None
        self.optimizer = optimizer
        self.accum = accum
        self.config = config or RunConfig()
        self.mode = mode
        self.warm_start = warm_start
        self.sparse_embed = sparse_embed
        self.module: Optional[torch.nn.Module] = None
        self._state = None  # the newest ScanState / StreamingState
        self._train_step = None
        self._infer_module: Optional[torch.nn.Module] = None  # holds restored weights
        # throughput over every host step after the process's first (which
        # pays for kernel builds and allocator warm-up), card-synchronized
        self.train_stats = {"host_steps": 0, "examples": 0, "seconds": 0.0}
        self._warm = False
        self.first_loss: Optional[torch.Tensor] = None  # aux["loss"] of the first host step
        self.last_loss: Optional[torch.Tensor] = None  # and of the newest
        self.apply_steps = []  # streaming: the micro-batch steps whose call applied
        self.nonfinite_skips = 0  # micro-batches skipped in the last train() call
        self.loss_scale_series = []  # [(step, scale)] from aux["loss_scale"]
        self.good_count_series = []  # [(step, good)] from aux["good_count"]
        # the step a preemption drain stopped the last train() call at
        self.drained_at_step = None
        # the async checkpoint writer and the event writer, closed by
        # close(), on a crash out of train(), and at GC or exit
        self._res = _Resources()
        self._finalizer = weakref.finalize(self, _finalize_quietly, self._res)
        self._registry = None
        self._flight = None

    # -- state ----------------------------------------------------------

    def _k(self) -> int:
        """Micro-batches per host step."""
        return self.accum.num_micro_batches if self.mode == "scan" else 1

    def _pipeline_state(self, params):
        """The whole pipeline state from the dense ``params``."""
        spec = self.pipeline
        pre, stages, post = spec.partition(params, spec.n_stages)
        return pp_lib.pp_init(stages, self.optimizer, pre_params=pre, post_params=post,
                              loss_scale=self.accum.loss_scale)

    def _init_state(self):
        self.module = self.model.init(self.config.seed, self.device)
        params = named_parameters(self.module)
        if self.warm_start is not None:
            _copy_strict(params, self.warm_start)
        if self.pipeline is not None:
            # every rank builds the whole state (and restores the whole
            # checkpoint), then keeps its own stage
            state = self._pipeline_state(params)
            d = self.config.model_dir
            self._ckpt_sync()
            if d and ckpt_lib.latest_checkpoint(d):
                state = ckpt_lib.restore(d, state)
            return pp_lib.pp_local_state(state, self._pipe)
        if self.mode == "scan":
            state = acc.scan_init(params, self.optimizer, loss_scale=self.accum.loss_scale)
        else:
            state = acc.streaming_init(params, self.optimizer, loss_scale=self.accum.loss_scale,
                                       fused=self.accum.fused_adam)
        d = self.config.model_dir
        self._ckpt_sync()
        if d and ckpt_lib.latest_checkpoint(d):
            state = ckpt_lib.restore(d, state)  # the global state
        if self.mesh is not None:
            replicate_(state.params, self._data)
        if self._rules:
            state = shard_params(state, self.mesh, self._rules)
            self._plan = ShardingPlan(self.mesh, {
                name: placement(p) or (None,) * p.dim() for name, p in state.params.items()})
        if self.zero1:
            self._zero1_specs = zero_lib.zero1_state_specs(state, self._data.world, self._rules)
            state = zero_lib.zero1_shard_state(state, self._data, self._rules)
        return state

    def _step_fn(self):
        if self._train_step is None:
            module, loss = self.module, self.model.loss
            loss_fn = lambda params, batch: loss(module, batch)  # noqa: E731
            needs_rng, mesh, mode = self.model.needs_rng, self._data, self.mode
            sparse = bound = None
            if self.pipeline is not None:
                spec = self.pipeline
                data = self.mesh.shape.get(DATA_AXIS, 1) > 1
                self._train_step = pp_lib.make_pp_train_step(
                    spec.stage_fn, spec.loss_fn, self.optimizer, self.accum.num_micro_batches,
                    self.mesh, data_axis=DATA_AXIS if data else None,
                    input_key=spec.input_key, pre_fn=spec.pre_fn,
                    ctx_keys=tuple(spec.ctx_keys), clip_norm=self.accum.clip_norm,
                    skip_nonfinite=self.accum.skip_nonfinite,
                    normalize_by_good_count=self.accum.normalize_by_good_count,
                    loss_scale=self.accum.loss_scale)
                return self._train_step
            if self._sp_active:
                from gradaccum_tpu_torch.parallel.sp import make_dp_sp_train_step

                keys = {} if self.model.seq_keys is None else \
                    {"seq_keys": tuple(self.model.seq_keys)}
                self._train_step = make_dp_sp_train_step(
                    loss_fn, self.optimizer, self.accum, self.mesh, needs_rng=needs_rng,
                    zero1=bool(self.zero1), **keys)
                return self._train_step
            if self.sparse_embed:
                hooks = self.model.sparse_embed
                bound = hooks._replace(loss_with_rows=lambda params, rows, batch:
                                       hooks.loss_with_rows(module, rows, batch))
                sparse = lambda cfg: accumulate_scan_sparse_embed(  # noqa: E731
                    bound, self.optimizer, cfg)
                if mesh is not None and (self.zero1 is True or self.sharding_rules is not None):
                    loss_fn = bound.loss_with_rows  # the GSPMD counterpart's sparse step
            if self.zero1 == "collective":
                # local accumulation, one all-reduce per window, the sharded
                # update, an all-gather of the updated parameters
                step = zero_lib.make_zero1_train_step(loss_fn, self.optimizer, self.accum,
                                                      mesh, mode=mode, needs_rng=needs_rng)
            elif self.zero1:
                step = zero_lib.make_zero1_placement_step(
                    loss_fn, self.optimizer, self.accum, mesh, mode=mode,
                    needs_rng=needs_rng, rules=self._rules, sparse=bound)
            elif mesh is not None and self.sharding_rules is None:
                step = dp_lib.make_dp_train_step(loss_fn, self.optimizer, self.accum, mesh,
                                                 mode=mode, needs_rng=needs_rng,
                                                 inner_builder=sparse)
            elif mesh is not None:
                step = dp_lib.make_pjit_dp_train_step(loss_fn, self.optimizer, self.accum,
                                                      mesh, mode=mode, needs_rng=needs_rng,
                                                      sparse=bound)
            elif sparse is not None:
                step = sparse(self.accum)
            else:
                build = acc.accumulate_scan if mode == "scan" else acc.streaming_step
                step = build(loss_fn, self.optimizer, self.accum, needs_rng=needs_rng)
            if self._plan is not None:
                step = _under_plan(step, self._plan)
            self._train_step = step
        return self._train_step

    def _to_device(self, batch):
        return {key: torch.as_tensor(np.asarray(x)).to(self.device) for key, x in batch.items()}

    def _prep_batch(self, batch, step_no: int, spans=obs_trace.NO_SPANS):
        """The positional arguments after ``state`` for the train step,
        under a ``train/upload`` span that carries the bytes copied."""
        if not spans.timed:
            return self._prep(batch, step_no)
        with spans("train/upload") as span:
            args = self._prep(batch, step_no)
            span.set(bytes=sum(t.nbytes for t in args[0].values()))
        return args

    def _prep(self, batch, step_no: int):
        batch = self._to_device(batch)
        if self.mode == "scan":
            batch = acc.stack_micro_batches(batch, self.accum.num_micro_batches)
        if self.pipeline is not None:
            return (batch,)  # the stages run deterministically: no generator
        if self.model.needs_rng:
            g = torch.Generator(device=self.device)
            g.manual_seed(step_seed(self.config.seed + 1, step_no))
            return batch, g
        return (batch,)

    def _save(self, state):
        """Rank 0 writes the full-tree state (under ZeRO-1 every rank first
        takes part in gathering it), through the async writer when
        configured."""
        cfg = self.config
        state = self._global_state(state)
        if not self._chief:
            return
        if cfg.async_checkpoint:
            if self._res.async_ckpt is None:
                self._res.async_ckpt = ckpt_lib.AsyncCheckpointer()
            self._res.async_ckpt.save(cfg.model_dir, state, state.step, cfg.keep_checkpoint_max)
        else:
            ckpt_lib.save(cfg.model_dir, state, state.step, keep=cfg.keep_checkpoint_max)

    def _global_state(self, state):
        """The whole state from this rank's blocks (a collective under
        ZeRO-1 or sharding rules: every rank calls it, on the main thread)."""
        if self.zero1:
            state = zero_lib.zero1_gather_state(state, self._data, self._zero1_specs)
        if self._rules:
            state = gather_params(state, self.mesh, self._rules)
        if self.pipeline is not None:
            state = pp_lib.pp_global_state(state, self._pipe)
        return state

    def _ckpt_sync(self):
        """Wait for any in-flight async write (before reading the newest
        checkpoint and before trusting durability at exit)."""
        if self._res.async_ckpt is not None:
            self._res.async_ckpt.wait()

    def close(self):
        """Release the background resources: drain and stop the async
        checkpoint writer (its last checkpoint lands) and close the event
        files. Safe to call repeatedly; later calls recreate both lazily.
        Runs on any exception out of ``train`` and, best effort, at GC or
        interpreter exit."""
        _close_resources(self._res)

    @property
    def events(self):
        """TensorBoard writer rooted at model_dir (a no-op without a
        backend, without a model_dir, or on a rank other than 0)."""
        if self._res.events is None:
            from gradaccum_tpu_torch.estimator.events import EventWriter

            self._res.events = EventWriter(self.config.model_dir if self._chief else None)
        return self._res.events

    @property
    def registry(self):
        """The run's ``obs.metrics.MetricsRegistry``: every scalar the
        harness publishes (loss, guard skips, loss scale, good counts, eval
        metrics) is recorded here and streamed to the EventWriter."""
        if self._registry is None:
            from gradaccum_tpu_torch.obs.metrics import MetricsRegistry

            self._registry = MetricsRegistry(event_writer=self.events)
        else:
            # close() and a resume recreate the EventWriter: re-bind so the
            # bridge streams into the live one
            self._registry.bind_writer(self.events)
        return self._registry

    def _flight_dump(self, reason: str):
        """Dump the obs ring under ``model_dir/flightrec`` (rank r > 0:
        ``flightrec/rank<r>``); a no-op without a model_dir or with obs
        disabled. Never raises: failure paths call it while an exception is
        already the story."""
        if not self.config.model_dir:
            return None
        try:
            if self._flight is None:
                from gradaccum_tpu_torch.obs.flight import FlightRecorder

                sub = "flightrec" if self._chief else f"flightrec/rank{self.mesh.rank}"
                self._flight = FlightRecorder(self.config.model_dir, registry=self.registry,
                                              subdir=sub)
            return self._flight.dump(reason)
        except Exception:  # noqa: BLE001 — postmortem is best-effort
            return None

    # -- public API -------------------------------------------------------

    def train(self, input_fn, max_steps: Optional[int] = None, final_save: bool = True):
        """Train until ``max_steps`` micro-batches (or the input runs out,
        or a preemption drain); in scan mode, stop at the last whole
        K-cycle that fits."""
        from gradaccum_tpu_torch.ops import flash_attention
        from gradaccum_tpu_torch.utils.profiling import StepWindowProfiler

        cfg = self.config
        if cfg.model_dir and self._chief:
            os.makedirs(cfg.model_dir, exist_ok=True)
            # the registry and its event writer (whose backend import takes
            # seconds) exist before the first step, outside the timed steps
            self.registry  # noqa: B018
        it = iter(input_fn() if callable(input_fn) else input_fn)
        state = self._state if self._state is not None else self._init_state()
        step_fn = self._step_fn()
        k = self._k()
        log_every = max(cfg.log_step_count_steps, 1)
        step_no = state.step
        last_bucket = step_no // log_every
        t_log, steps_at_log = time.perf_counter(), step_no
        # device scalars until a flush
        loss_rows, skip_rows, scale_rows, good_rows = [], [], [], []
        self.nonfinite_skips = 0
        self.drained_at_step = None
        # under RunConfig.drain_consensus the drain decision and its target
        # step are agreed across ranks instead of read from the local flag
        consensus = cfg.drain_consensus
        drain_target = None
        last_saved = None
        # the live ops plane: the SLO evaluator runs on the step clock (no
        # wall time), pulls registry objectives each step and receives the
        # nonfinite-skip rate at flushes; the sentinel watches the
        # loss-scale stream for halving storms
        slos = cfg.slos
        if slos is not None:
            slos.bind_registry(self.registry)
        sentinel = cfg.sentinel
        profiler = StepWindowProfiler(cfg.profile_dir, cfg.profile_start_step,
                                      cfg.profile_num_steps)
        tracer = obs_trace.get_tracer()
        # streaming mode applies when step % K == phase (the reference's
        # condition, quirk included); scan mode fuses a whole K-cycle into
        # every host step
        k_accum = self.accum.num_micro_batches
        apply_phase = 0 if self.accum.first_step_quirk else k_accum - 1

        def flush_rows():
            # one read of the card per kind of row, at log and save cadence only
            if loss_rows:
                values = torch.stack([v for _, v in loss_rows]).tolist()
                self._append_loss_csv(zip((s for s, _ in loss_rows), values))
                loss_rows.clear()
            if skip_rows:
                n_skip_rows = len(skip_rows)
                flushed = int(torch.stack(skip_rows).sum())
                self.nonfinite_skips += flushed
                skip_rows.clear()
                if slos is not None and "train/nonfinite_skip_rate" in slos.trackers:
                    # skipped micro-batches per host step over this flush
                    # window: the training side's burn-rate indicator
                    slos.observe("train/nonfinite_skip_rate", flushed / n_skip_rows,
                                 now=float(step_no))
                if flushed and tracer.enabled:
                    tracer.event("train/nonfinite_skip", cat="train", step=step_no,
                                 skipped=flushed, total=self.nonfinite_skips)
                if cfg.model_dir and self._chief:
                    # cumulative count: a flat line means a healthy run
                    self.registry.publish({"nonfinite_skips": self.nonfinite_skips}, step_no)
            if scale_rows:
                rows = list(zip((s for s, _ in scale_rows),
                                torch.stack([v for _, v in scale_rows]).tolist()))
                scale_rows.clear()
                self.loss_scale_series.extend(rows)
                if sentinel is not None:
                    for s, v in rows:
                        sentinel.observe_scale(v, now=float(s))
                if tracer.enabled:
                    for s, v in rows:
                        tracer.event("train/loss_scale", cat="train", step=s, scale=v)
                if cfg.model_dir and self._chief:
                    for s, v in rows:
                        self.registry.publish({"loss_scale": v}, s)
            if good_rows:
                rows = list(zip((s for s, _ in good_rows),
                                (int(v) for v in torch.stack(
                                    [torch.as_tensor(v) for _, v in good_rows]).tolist())))
                good_rows.clear()
                self.good_count_series.extend(rows)
                if tracer.enabled:
                    for s, v in rows:
                        if v < k_accum:  # a clean window is not an event
                            tracer.event("train/guard_verdict", cat="train", step=s,
                                         good=v, window=k_accum)
                if cfg.model_dir and self._chief:
                    for s, v in rows:
                        self.registry.publish({"good_count": v}, s)

        synchronize(self.device)
        t_window, counted, examples = time.perf_counter(), 0, 0
        try:
            while True:
                # scan mode consumes whole K-cycles: stop before overshooting
                if max_steps is not None and step_no + k > max_steps:
                    break
                if drain_target is None:
                    req = preemption.requested()
                    if consensus is not None:
                        # collective: every rank calls decide() at the same
                        # cadence until a drain is agreed, then it latches
                        drain, target = consensus.decide(req, step_no)
                        if drain:
                            drain_target = max(int(target), step_no)
                            if self._chief:
                                print(f"[train] drain consensus: common target "
                                      f"step={drain_target}")
                    elif req:
                        drain_target = step_no  # one process: stop here
                if drain_target is not None and step_no >= drain_target:
                    # break to the final-save path below: it writes a
                    # checkpoint at this micro-step and drains the async
                    # writer. Acknowledge only when this call owns the
                    # final save; train_and_evaluate still needs the flag
                    if final_save:
                        preemption.acknowledge()
                    self.drained_at_step = step_no
                    if tracer.enabled:
                        tracer.event("preemption/drain", cat="resilience", step=step_no,
                                     target=drain_target)
                    self._flight_dump("sigterm-drain")
                    if self._chief:
                        print(f"[train] preemption requested; stopping at step={step_no}"
                              + (" after final checkpoint" if final_save else ""))
                    break
                batch = next(it, None)
                if batch is None:
                    break
                micro = len(next(iter(batch.values()))) // k
                # seeded fault points (no-ops unless an injector is
                # installed): PRE may also poison the host batch
                kind = faults.fire(faults.PRE_TRAIN_STEP, step_no)
                if kind in faults.DATA_KINDS:
                    batch = faults.corrupt_batch(batch, kind)
                profiler.observe(step_no)  # before dispatch: the window traces >= 1 step
                if tracer.enabled:
                    branch = ("scan-cycle" if self.mode == "scan" else
                              "apply" if step_no % k_accum == apply_phase else "accumulate")
                    step_span = tracer.span("train/step", cat="train", step=step_no,
                                            branch=branch)
                else:
                    step_span = obs_trace.NULL.span("")
                with step_span:
                    state, aux = step_fn(state, *self._prep_batch(
                        batch, step_no, obs_trace.UpdateSpans(tracer, step_no)))
                if tracer.timed:
                    # the flash wrapper's launches and host time so far
                    tracer.counter("flash", cat="train",
                                   launches=sum(flash_attention.launch_counts().values()),
                                   host_ns=sum(flash_attention.launch_host_ns().values()))
                step_no = state.step
                self._state = state
                faults.fire(faults.POST_TRAIN_STEP, step_no)
                if slos is not None:
                    slos.tick(now=float(step_no))
                if self._warm:
                    counted += 1
                    examples += micro * k
                else:
                    synchronize(self.device)
                    t_window, self._warm = time.perf_counter(), True
                if self.first_loss is None:
                    self.first_loss = aux["loss"]
                self.last_loss = aux["loss"]
                if aux.get("applied"):
                    self.apply_steps.append(step_no - 1)
                if "skipped" in aux:
                    skip_rows.append(aux["skipped"])
                if "loss_scale" in aux:
                    scale_rows.append((step_no, aux["loss_scale"]))
                if "good_count" in aux:
                    good_rows.append((step_no, aux["good_count"]))
                if cfg.model_dir and self._chief:
                    loss_rows.append((step_no, aux["loss"]))
                if max(len(loss_rows), len(skip_rows), len(scale_rows),
                       len(good_rows)) >= _ROW_CAP:
                    flush_rows()
                if step_no // log_every != last_bucket:
                    last_bucket = step_no // log_every
                    rate = (step_no - steps_at_log) / max(time.perf_counter() - t_log, 1e-9)
                    line = (f"[train] step={step_no} loss={aux['loss'].item():.5f} "
                            f"steps/sec={rate:.2f} examples/sec={rate * micro:.1f}")
                    mfu = self._mfu(rate * micro)
                    if mfu is not None:
                        line += f" mfu={mfu:.4f}"
                    if self._chief:
                        print(line)
                    flush_rows()
                    t_log, steps_at_log = time.perf_counter(), step_no
                if cfg.model_dir and cfg.save_checkpoints_steps and \
                        step_no % cfg.save_checkpoints_steps < k:
                    self._save(state)
                    last_saved = step_no
                    flush_rows()
        except BaseException:
            # a crash mid-train still lands the last checkpoint: the flight
            # recorder dumps first, then the async writer drains and closes
            # (and the event files); later calls recreate both lazily. The
            # in-memory state was updated in place up to the crash, so the
            # next call rebuilds from the newest checkpoint, as a restarted
            # process would
            self._state, self._train_step = None, None
            self._flight_dump("crash")
            try:
                self.close()
            except Exception:
                pass  # the original exception is the story
            raise
        finally:
            # an exception mid-window must still stop the profiler
            profiler.close()
        synchronize(self.device)
        self.train_stats["seconds"] += time.perf_counter() - t_window
        self.train_stats["host_steps"] += counted
        self.train_stats["examples"] += examples
        if final_save and cfg.model_dir and last_saved != step_no:
            self._save(state)
        flush_rows()
        if final_save:
            self._ckpt_sync()  # durability: the newest file is on disk
        self._state = state
        return state

    def examples_per_sec(self) -> Optional[float]:
        s = self.train_stats
        return s["examples"] / s["seconds"] if s["host_steps"] and s["seconds"] > 0 else None

    def _mfu(self, examples_per_sec):
        if self.config.flops_per_example is None or examples_per_sec is None:
            return None
        peak = peak_flops_for(device_name(self.device))
        if peak is None:
            return None
        world = self.mesh.world if self.mesh is not None else 1  # the mesh-wide peak
        return examples_per_sec * self.config.flops_per_example / (peak * world)

    def mfu(self) -> Optional[float]:
        """Model FLOPs utilization of :meth:`examples_per_sec` against the
        card's bf16 peak; None on the CPU or an unknown card."""
        return self._mfu(self.examples_per_sec())

    def _module_with(self, params):
        """A module holding ``params``: the training module when they are its
        own tensors, else the inference module with them copied in. A
        pipeline's parameters are gathered (a collective) and merged into
        the dense names first."""
        if self.pipeline is not None:
            whole = pp_lib.pp_global_state(pp_lib.PPState(params, None, 0), self._pipe)
            params = self.pipeline.merge(whole.params)
        elif self.module is not None and self.eval_model is self.model:
            own = named_parameters(self.module)
            if own.keys() == params.keys() and all(
                    own[name] is params[name] for name in own):
                return self.module
        module = self._inference_module()
        with torch.no_grad():
            for name, t in named_parameters(module).items():
                t.copy_(params[name])
        return module

    def _inference_module(self):
        if self._infer_module is None:
            self._infer_module = self._placed(self.eval_model.init(self.config.seed,
                                                                   self.device))
        return self._infer_module

    def _placed(self, module):
        """``module`` cut to this rank's blocks under the sharding rules."""
        if self._rules:
            shard_params(named_parameters(module), self.mesh, self._rules)
        return module

    def _module_for_inference(self, state, checkpoint_path):
        """``(module, step)`` for evaluate and predict, as JAX picks the
        weights: an explicit ``state``, then ``checkpoint_path`` or the newest
        checkpoint in ``model_dir``, then the in-memory state, then a fresh
        init. Under a pipeline every rank takes the same branch: the ranks
        meet once rank 0's checkpoint is on disk."""
        if self._sp_active and self.eval_model is self.model:
            raise ValueError("evaluate, predict and export on a 'seq' mesh run whole "
                             "sequences: pass the model's dense twin as eval_model")
        self._ckpt_sync()
        if self.pipeline is not None:
            self.mesh.barrier()
        if state is not None:
            return self._module_with(state.params), state.step
        d = self.config.model_dir
        if checkpoint_path or (d and ckpt_lib.latest_checkpoint(d)):
            if self.pipeline is not None:  # the whole pipeline state: merge it
                template = self._pipeline_state(named_parameters(
                    self.eval_model.init(self.config.seed, self.device)))
                step = ckpt_lib.restore_params(checkpoint_path or d,
                                               pp_lib.flat_params(template.params))
                module = self._inference_module()
                merged = self.pipeline.merge(template.params)
                with torch.no_grad():
                    for name, t in named_parameters(module).items():
                        t.copy_(merged[name])
                return module, step
            if self._rules:  # the checkpoint is global: restore whole, then cut
                module = self.model.init(self.config.seed, self.device)
                step = ckpt_lib.restore_params(checkpoint_path or d, named_parameters(module))
                return self._placed(module), step
            module = self._inference_module()
            step = ckpt_lib.restore_params(checkpoint_path or d, named_parameters(module))
            return module, step
        if self._state is None:
            self._state = self._init_state()
        if self.pipeline is not None or self.eval_model is not self.model:
            return self._module_with(self._state.params), self._state.step
        return self.module, self._state.step

    @torch.no_grad()
    def evaluate(self, input_fn, steps: Optional[int] = None, state=None,
                 checkpoint_path: Optional[str] = None, name: str = "eval"):
        """Streaming metrics over the eval input (``Estimator.evaluate``)."""
        module, at_step = self._module_for_inference(state, checkpoint_path)
        totals: Dict[str, list] = {}
        n_batches = 0
        for batch in (input_fn() if callable(input_fn) else input_fn):
            if steps is not None and n_batches >= steps:
                break
            for key, (total, count) in self._eval_partials(module, self._to_device(batch)):
                t = totals.setdefault(key, [0.0, 0.0])
                t[0] += total
                t[1] += count
            n_batches += 1
        if not n_batches:
            raise ValueError("eval input_fn yielded no batches")
        results = {key: self.eval_model.eval_metrics[key].finalize(t, c)
                   for key, (t, c) in totals.items()}
        if self._chief:
            print(f"[{name}] " + " ".join(f"{k}={v:.5f}" for k, v in results.items()))
        if self.config.model_dir and self._chief:
            # registry gauges under "<name>/<metric>", and the eval
            # EventWriter subdir
            for key, value in results.items():
                self.registry.gauge(f"{name}/{key}").set(value, step=at_step)
            self.events.scalars(results, at_step, subdir=name)
            self.events.flush()
        results["_num_batches"] = n_batches
        return results

    def _eval_partials(self, module, batch):
        """``[(metric, (total, count))]`` of one eval batch. On a mesh whose
        world divides the batch, each rank evaluates its rows and the
        partials are summed over the ranks in one all-reduce; otherwise the
        whole batch runs on every rank (JAX's ``_mesh_dispatch``)."""
        mesh = self._data
        rows = {x.shape[0] for x in batch.values() if x.dim() >= 1}
        split = mesh is not None and mesh.world > 1 and len(rows) == 1 \
            and next(iter(rows)) % mesh.world == 0
        if split:
            batch = batch_shard(batch, mesh)
        outputs = self.eval_model.predict(module, batch)
        out = [(key, metric.update(outputs, batch))
               for key, metric in self.eval_model.eval_metrics.items()]
        if not split:
            return out
        flat = torch.tensor([v for _, pair in out for v in pair], dtype=torch.float64,
                            device=self.device)
        mesh.all_reduce_(flat, tag="eval")
        values = flat.tolist()
        return [(key, (values[2 * i], values[2 * i + 1])) for i, (key, _) in enumerate(out)]

    def predict(self, input_fn, state=None,
                checkpoint_path: Optional[str] = None) -> Iterator[Dict[str, Any]]:
        """Yield one dict of numpy outputs per example (``Estimator.predict``)."""
        it = iter(input_fn() if callable(input_fn) else input_fn)
        first = next(it, None)
        if first is None:
            return
        module, _ = self._module_for_inference(state, checkpoint_path)
        for batch in itertools.chain([first], it):
            with torch.no_grad():
                outputs = self.eval_model.predict(module, self._to_device(batch))
            host = {key: v.cpu().numpy() for key, v in outputs.items()}
            for i in range(len(next(iter(host.values())))):
                yield {key: v[i] for key, v in host.items()}

    def export_model(self, export_dir: str, sample_batch, state=None,
                     checkpoint_path: Optional[str] = None,
                     batch_polymorphic: bool = True) -> str:
        """Write the predict function and the trained weights as one
        ``torch.export`` serving artifact (tf.estimator's
        ``export_savedmodel`` slot), with the same weight resolution as
        evaluate and predict. Load it back, without the model code, with
        ``estimator/export.py :: load_exported``. Under sharding rules every
        rank calls it (the parameters are gathered) and rank 0 alone traces
        the unsharded model and writes; the others return None."""
        module, _ = self._module_for_inference(state, checkpoint_path)
        return self._export(self._whole_module(module), export_dir, sample_batch,
                            batch_polymorphic)

    def _whole_module(self, module):
        """``module``, or under sharding rules a fresh unsharded module
        holding its gathered parameters (a collective), None off rank 0."""
        if not self._rules:
            return module
        params = gather_params(named_parameters(module), self.mesh, self._rules)
        if not self._chief:
            return None
        whole = self.model.init(self.config.seed, self.device)
        with torch.no_grad():
            for name, t in named_parameters(whole).items():
                t.copy_(params[name])
        return whole

    def _export(self, module, export_dir, sample_batch, batch_polymorphic=True):
        from gradaccum_tpu_torch.estimator.export import export_predict

        if module is None:
            return None
        return export_predict(self.eval_model.predict, module, sample_batch, export_dir,
                              batch_polymorphic=batch_polymorphic)

    def _maybe_export_best(self, eval_spec: EvalSpec, results, state):
        """tf.estimator.BestExporter: export the serving artifact when
        ``eval_spec.best_metric`` improves; ``best_metric.json`` keeps the
        high-water mark (so a resume does not regress it). Rank 0 decides
        and writes; under sharding rules every rank first takes part in
        gathering the parameters."""
        if eval_spec.export_best_dir is None:
            return
        whole = None
        if self._rules:
            whole = self._whole_module(self._module_with(state.params))
        if not self._chief:
            return
        if eval_spec.best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got {eval_spec.best_mode!r}")
        metric = eval_spec.best_metric
        if metric not in results:
            raise KeyError(f"best_metric {metric!r} not in eval results {sorted(results)}")
        value = float(results[metric])
        marker = os.path.join(eval_spec.export_best_dir, "best_metric.json")
        best = None
        if os.path.exists(marker):
            with open(marker) as f:
                best = json.load(f).get("value")
        improved = best is None or (value > best if eval_spec.best_mode == "max"
                                    else value < best)
        if not improved:
            return
        sample = eval_spec.export_sample
        if sample is None:
            sample = next(iter(eval_spec.input_fn()))
            stripped = [k for k in sample if k in self.eval_model.label_keys]
            sample = {k: v for k, v in sample.items() if k not in stripped}
            if stripped:
                print(f"[best] export signature from first eval batch, label key(s) "
                      f"{stripped} stripped; set EvalSpec.export_sample to control it")
        if whole is not None:
            self._export(whole, eval_spec.export_best_dir, sample)
        else:
            self.export_model(eval_spec.export_best_dir, sample, state=state)
        with open(marker, "w") as f:
            json.dump({"metric": metric, "value": value, "step": int(state.step)}, f)
        print(f"[best] exported {metric}={value:.5f} to {eval_spec.export_best_dir}")

    def train_and_evaluate(self, train_spec: TrainSpec, eval_spec: EvalSpec):
        """Train in chunks of ``log_step_count_steps`` micro-batches,
        evaluating after the first chunk, then at most every
        ``throttle_secs``, and once at the end; each improving evaluation
        refreshes ``eval_spec.export_best_dir`` when set. A preemption
        drain saves and stops at once, without a last evaluation."""
        k = self._k()
        chunk = max(self.config.log_step_count_steps, k)
        reachable = None
        if train_spec.max_steps is not None:
            reachable = (train_spec.max_steps // k) * k
        it = iter(train_spec.input_fn())
        last_eval = 0.0
        results = None
        while True:
            state = self.train(itertools.islice(it, max(chunk // k, 1)),
                               max_steps=train_spec.max_steps, final_save=False)
            if preemption.requested() or self.drained_at_step is not None:
                # the chunked train() left the flag (final_save was False,
                # so no checkpoint landed there): save now, drain, and stop
                preemption.acknowledge()
                if self.config.model_dir:
                    self._save(state)
                    self._ckpt_sync()
                if self._chief:
                    print(f"[train_and_evaluate] preemption: final checkpoint at "
                          f"step={state.step}; stopping")
                return state, results
            peeked = next(it, None)
            if peeked is not None:
                it = itertools.chain([peeked], it)
            if peeked is None or (reachable is not None and state.step >= reachable):
                if self.config.model_dir:
                    self._save(state)
                    self._ckpt_sync()
                results = self.evaluate(eval_spec.input_fn, eval_spec.steps,
                                        state=state, name=eval_spec.name)
                self._maybe_export_best(eval_spec, results, state)
                return state, results
            if time.time() - last_eval >= eval_spec.throttle_secs:
                results = self.evaluate(eval_spec.input_fn, eval_spec.steps, state=state,
                                        name=eval_spec.name)
                self._maybe_export_best(eval_spec, results, state)
                last_eval = time.time()

    def _append_loss_csv(self, rows):
        """``model_dir/loss_vs_step.csv``: the data behind the reference's
        loss-vs-step curves."""
        if not self._chief:
            return
        path = os.path.join(self.config.model_dir, "loss_vs_step.csv")
        new = not os.path.exists(path)
        os.makedirs(self.config.model_dir, exist_ok=True)
        rows = list(rows)
        with open(path, "a") as f:
            if new:
                f.write("step,loss\n")
            for step, loss in rows:
                f.write(f"{step},{loss}\n")
        for step, loss in rows:  # the same scalars as TensorBoard events
            self.registry.publish({"loss": loss}, step)
        self.events.flush()
