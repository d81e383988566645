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
resume is bitwise. Non-empty ``sharding_rules`` (tensor and expert
parallelism) are not ported yet and raise ``NotImplementedError``, as do
export, events and the resilience and observability hooks (ROADMAP.md).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
from gradaccum_tpu_torch.estimator.metrics import Metric
from gradaccum_tpu_torch.ops import accumulation as acc
from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.ops.sparse_embed import accumulate_scan_sparse_embed
from gradaccum_tpu_torch.parallel import dp as dp_lib
from gradaccum_tpu_torch.parallel import zero as zero_lib
from gradaccum_tpu_torch.parallel.mesh import DATA_AXIS
from gradaccum_tpu_torch.parallel.sharding import batch_shard, replicate_
from gradaccum_tpu_torch.utils.flops import peak_flops_for
from gradaccum_tpu_torch.utils.platform import device_name, resolve_device, synchronize
from gradaccum_tpu_torch.utils.tree import named_parameters

_ROW_CAP = 4096  # device scalars held between flushes, at most


class ModelBundle(NamedTuple):
    """Everything the harness needs to know about a model."""

    init: Callable[[int, torch.device], torch.nn.Module]  # (seed, device) -> model
    loss: Callable[[torch.nn.Module, Dict[str, Any]], torch.Tensor]  # scalar
    predict: Callable[[torch.nn.Module, Dict[str, Any]], Dict[str, torch.Tensor]]
    eval_metrics: Dict[str, Metric]
    needs_rng: bool = False  # if True, micro-batches get an "rng" generator
    # optional ops.sparse_embed.SparseEmbedHooks: lets the scan step carry
    # token-level embedding cotangents instead of a dense [vocab, hidden]
    # gradient per micro-batch
    sparse_embed: Any = None


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


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed derived from a run seed and a step."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


class Estimator:
    def __init__(self, model: ModelBundle, optimizer: Optimizer,
                 accum: acc.GradAccumConfig, config: Optional[RunConfig] = None,
                 mode: str = "streaming", device="cuda", mesh=None,
                 warm_start: Optional[Dict[str, torch.Tensor]] = None,
                 sparse_embed: bool = False, zero1=False, sharding_rules=None):
        if mode not in ("streaming", "scan"):
            raise ValueError(f"mode must be 'streaming' or 'scan', got {mode!r}")
        if sharding_rules is not None and mesh is None:
            raise ValueError("sharding_rules requires a mesh")
        if sharding_rules:
            raise NotImplementedError("parameter sharding rules (tensor and expert "
                                      "parallelism) are not ported yet; see ROADMAP.md")
        axes = mesh.shape if mesh is not None else {}
        if zero1:
            if zero1 not in (True, "collective"):
                raise ValueError(
                    f"zero1 must be True (GSPMD placement) or 'collective' "
                    f"(explicit shard_map path), got {zero1!r}")
            if axes.get(DATA_AXIS, 1) < 2:
                raise ValueError("zero1 requires a mesh with a 'data' axis")
            if zero1 == "collective":
                if sharding_rules is not None:
                    raise ValueError(
                        "zero1='collective' runs on shard_map and cannot compose with "
                        "sharding_rules; use zero1=True (GSPMD placement)")
                if accum.fused_adam or sparse_embed:
                    raise ValueError(
                        "zero1='collective' cannot compose with fused_adam or "
                        "sparse_embed; use zero1=True (GSPMD placement)")
        if sparse_embed and mesh is not None and (zero1 or sharding_rules is not None):
            raise NotImplementedError("sparse_embed on the GSPMD counterpart (zero1=True or "
                                      "sharding_rules=()) is not ported yet; it runs on "
                                      "the explicit DP path")
        if sparse_embed:
            if mode != "scan":
                raise ValueError("sparse_embed requires mode='scan'")
            if model.sparse_embed is None:
                raise ValueError("sparse_embed requires a model with ModelBundle."
                                 "sparse_embed hooks (see models/bert.py)")
        acc.validate_config(accum)
        if accum.fused_adam:
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
        self.zero1 = zero1
        self.sharding_rules = sharding_rules
        self._chief = mesh is None or mesh.rank == 0  # prints, logs, checkpoints
        self._zero1_specs = None  # {path: shard dim} of the full state, under zero1
        self.model = model
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

    # -- state ----------------------------------------------------------

    def _k(self) -> int:
        """Micro-batches per host step."""
        return self.accum.num_micro_batches if self.mode == "scan" else 1

    def _init_state(self):
        self.module = self.model.init(self.config.seed, self.device)
        params = named_parameters(self.module)
        if self.warm_start is not None:
            _copy_strict(params, self.warm_start)
        if self.mode == "scan":
            state = acc.scan_init(params, self.optimizer, loss_scale=self.accum.loss_scale)
        else:
            state = acc.streaming_init(params, self.optimizer, loss_scale=self.accum.loss_scale,
                                       fused=self.accum.fused_adam)
        d = self.config.model_dir
        if d and ckpt_lib.latest_checkpoint(d):
            state = ckpt_lib.restore(d, state)
        if self.mesh is not None:
            replicate_(state.params, self.mesh)
        if self.zero1:
            self._zero1_specs = zero_lib.zero1_state_specs(state, self.mesh.world)
            state = zero_lib.zero1_shard_state(state, self.mesh)
        return state

    def _step_fn(self):
        if self._train_step is None:
            module, loss = self.module, self.model.loss
            loss_fn = lambda params, batch: loss(module, batch)  # noqa: E731
            needs_rng, mesh, mode = self.model.needs_rng, self.mesh, self.mode
            sparse = None
            if self.sparse_embed:
                hooks = self.model.sparse_embed
                bound = hooks._replace(loss_with_rows=lambda params, rows, batch:
                                       hooks.loss_with_rows(module, rows, batch))
                sparse = lambda cfg: accumulate_scan_sparse_embed(  # noqa: E731
                    bound, self.optimizer, cfg)
            if self.zero1 == "collective":
                # local accumulation, one all-reduce per window, the sharded
                # update, an all-gather of the updated parameters
                step = zero_lib.make_zero1_train_step(loss_fn, self.optimizer, self.accum,
                                                      mesh, mode=mode, needs_rng=needs_rng)
            elif self.zero1:
                step = zero_lib.make_zero1_placement_step(loss_fn, self.optimizer, self.accum,
                                                          mesh, mode=mode, needs_rng=needs_rng)
            elif mesh is not None and self.sharding_rules is None:
                step = dp_lib.make_dp_train_step(loss_fn, self.optimizer, self.accum, mesh,
                                                 mode=mode, needs_rng=needs_rng,
                                                 inner_builder=sparse)
            elif mesh is not None:
                step = dp_lib.make_pjit_dp_train_step(loss_fn, self.optimizer, self.accum,
                                                      mesh, mode=mode, needs_rng=needs_rng)
            elif sparse is not None:
                step = sparse(self.accum)
            else:
                build = acc.accumulate_scan if mode == "scan" else acc.streaming_step
                step = build(loss_fn, self.optimizer, self.accum, needs_rng=needs_rng)
            self._train_step = step
        return self._train_step

    def _to_device(self, batch):
        return {key: torch.as_tensor(np.asarray(x)).to(self.device) for key, x in batch.items()}

    def _prep_batch(self, batch, step_no: int):
        """The positional arguments after ``state`` for the train step."""
        batch = self._to_device(batch)
        if self.mode == "scan":
            batch = acc.stack_micro_batches(batch, self.accum.num_micro_batches)
        if self.model.needs_rng:
            g = torch.Generator(device=self.device)
            g.manual_seed(step_seed(self.config.seed + 1, step_no))
            return batch, g
        return (batch,)

    def _save(self, state):
        """Rank 0 writes the full-tree state (under ZeRO-1 every rank first
        takes part in gathering it)."""
        cfg = self.config
        if self.zero1:
            state = zero_lib.zero1_gather_state(state, self.mesh, self._zero1_specs)
        if self._chief:
            ckpt_lib.save(cfg.model_dir, state, state.step, keep=cfg.keep_checkpoint_max)

    # -- public API -------------------------------------------------------

    def train(self, input_fn, max_steps: Optional[int] = None, final_save: bool = True):
        """Train until ``max_steps`` micro-batches (or the input runs out);
        in scan mode, stop at the last whole K-cycle that fits."""
        cfg = self.config
        it = iter(input_fn() if callable(input_fn) else input_fn)
        state = self._state if self._state is not None else self._init_state()
        step_fn = self._step_fn()
        k = self._k()
        log_every = max(cfg.log_step_count_steps, 1)
        step_no = state.step
        last_bucket = step_no // log_every
        t_log, steps_at_log = time.perf_counter(), step_no
        loss_rows, skip_rows, scale_rows = [], [], []  # device scalars until a flush
        self.nonfinite_skips = 0
        last_saved = None

        def flush_rows():
            # one read of the card per kind of row, at log and save cadence only
            if loss_rows:
                values = torch.stack([v for _, v in loss_rows]).tolist()
                self._append_loss_csv(zip((s for s, _ in loss_rows), values))
                loss_rows.clear()
            if skip_rows:
                self.nonfinite_skips += int(torch.stack(skip_rows).sum())
                skip_rows.clear()
            if scale_rows:
                values = torch.stack([v for _, v in scale_rows]).tolist()
                self.loss_scale_series.extend(zip((s for s, _ in scale_rows), values))
                scale_rows.clear()

        synchronize(self.device)
        t_window, counted, examples = time.perf_counter(), 0, 0
        while max_steps is None or step_no + k <= max_steps:
            batch = next(it, None)
            if batch is None:
                break
            micro = len(next(iter(batch.values()))) // k
            state, aux = step_fn(state, *self._prep_batch(batch, step_no))
            step_no = state.step
            self._state = state
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
            if cfg.model_dir and self._chief:
                loss_rows.append((step_no, aux["loss"]))
            if max(len(loss_rows), len(skip_rows), len(scale_rows)) >= _ROW_CAP:
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
        synchronize(self.device)
        self.train_stats["seconds"] += time.perf_counter() - t_window
        self.train_stats["host_steps"] += counted
        self.train_stats["examples"] += examples
        if final_save and cfg.model_dir and last_saved != step_no:
            self._save(state)
        flush_rows()
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
        own tensors, else the inference module with them copied in."""
        if self.module is not None:
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
            self._infer_module = self.model.init(self.config.seed, self.device)
        return self._infer_module

    def _module_for_inference(self, state, checkpoint_path):
        """``(module, step)`` for evaluate and predict, as JAX picks the
        weights: an explicit ``state``, then ``checkpoint_path`` or the newest
        checkpoint in ``model_dir``, then the in-memory state, then a fresh
        init."""
        if state is not None:
            return self._module_with(state.params), state.step
        d = self.config.model_dir
        if checkpoint_path or (d and ckpt_lib.latest_checkpoint(d)):
            module = self._inference_module()
            step = ckpt_lib.restore_params(checkpoint_path or d, named_parameters(module))
            return module, step
        if self._state is None:
            self._state = self._init_state()
        return self.module, self._state.step

    @torch.no_grad()
    def evaluate(self, input_fn, steps: Optional[int] = None, state=None,
                 checkpoint_path: Optional[str] = None, name: str = "eval"):
        """Streaming metrics over the eval input (``Estimator.evaluate``)."""
        module, _ = self._module_for_inference(state, checkpoint_path)
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
        results = {key: self.model.eval_metrics[key].finalize(t, c)
                   for key, (t, c) in totals.items()}
        if self._chief:
            print(f"[{name}] " + " ".join(f"{k}={v:.5f}" for k, v in results.items()))
        results["_num_batches"] = n_batches
        return results

    def _eval_partials(self, module, batch):
        """``[(metric, (total, count))]`` of one eval batch. On a mesh whose
        world divides the batch, each rank evaluates its rows and the
        partials are summed over the ranks in one all-reduce; otherwise the
        whole batch runs on every rank (JAX's ``_mesh_dispatch``)."""
        mesh = self.mesh
        rows = {x.shape[0] for x in batch.values() if x.dim() >= 1}
        split = mesh is not None and mesh.world > 1 and len(rows) == 1 \
            and next(iter(rows)) % mesh.world == 0
        if split:
            batch = batch_shard(batch, mesh)
        outputs = self.model.predict(module, batch)
        out = [(key, metric.update(outputs, batch))
               for key, metric in self.model.eval_metrics.items()]
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
                outputs = self.model.predict(module, self._to_device(batch))
            host = {key: v.cpu().numpy() for key, v in outputs.items()}
            for i in range(len(next(iter(host.values())))):
                yield {key: v[i] for key, v in host.items()}

    def train_and_evaluate(self, train_spec: TrainSpec, eval_spec: EvalSpec):
        """Train in chunks of ``log_step_count_steps`` micro-batches,
        evaluating after the first chunk, then at most every
        ``throttle_secs``, and once at the end."""
        k = self._k()
        chunk = max(self.config.log_step_count_steps, k)
        reachable = None
        if train_spec.max_steps is not None:
            reachable = (train_spec.max_steps // k) * k
        it = iter(train_spec.input_fn())
        last_eval = 0.0
        while True:
            state = self.train(itertools.islice(it, max(chunk // k, 1)),
                               max_steps=train_spec.max_steps, final_save=False)
            peeked = next(it, None)
            if peeked is not None:
                it = itertools.chain([peeked], it)
            if peeked is None or (reachable is not None and state.step >= reachable):
                if self.config.model_dir:
                    self._save(state)
                return state, self.evaluate(eval_spec.input_fn, eval_spec.steps,
                                            state=state, name=eval_spec.name)
            if time.time() - last_eval >= eval_spec.throttle_secs:
                self.evaluate(eval_spec.input_fn, eval_spec.steps, state=state,
                              name=eval_spec.name)
                last_eval = time.time()

    def _append_loss_csv(self, rows):
        """``model_dir/loss_vs_step.csv``: the data behind the reference's
        loss-vs-step curves."""
        if not self._chief:
            return
        path = os.path.join(self.config.model_dir, "loss_vs_step.csv")
        new = not os.path.exists(path)
        os.makedirs(self.config.model_dir, exist_ok=True)
        with open(path, "a") as f:
            if new:
                f.write("step,loss\n")
            for step, loss in rows:
                f.write(f"{step},{loss}\n")
