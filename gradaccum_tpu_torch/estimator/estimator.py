"""The training harness: ``Estimator(model, optimizer, accum, config)``.

The port of ``gradaccum_tpu/estimator/estimator.py``, single device, scan
mode: every host step stacks a ``[K*micro, ...]`` batch into K micro-batches
and runs one ``accumulate_scan`` update. ``train`` resumes from the newest
checkpoint in ``model_dir``, logs loss, examples/sec and MFU, and saves on
the ``save_checkpoints_steps`` cadence; ``evaluate`` runs streaming metrics;
``train_and_evaluate`` alternates the two (``tf.estimator`` semantics).

Randomness: weights come from ``RunConfig.seed``; the dropout generator of
each update is seeded from ``RunConfig.seed + 1`` and the micro-batch step,
so a resumed run draws exactly what the uninterrupted one would.

The Estimator runs on the card unless the caller passes ``device="cpu"``;
asking for CUDA without a card raises. Not ported yet (ROADMAP.md):
streaming mode, meshes and every parallel mode, warm start, export,
predict, events and the resilience and observability hooks; asking for a
mode or a mesh raises ``NotImplementedError``.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
from gradaccum_tpu_torch.estimator.metrics import Metric
from gradaccum_tpu_torch.ops import accumulation as acc
from gradaccum_tpu_torch.ops.adamw import Optimizer
from gradaccum_tpu_torch.utils.flops import peak_flops_for
from gradaccum_tpu_torch.utils.platform import device_name, resolve_device, synchronize
from gradaccum_tpu_torch.utils.tree import named_parameters


class ModelBundle(NamedTuple):
    """Everything the harness needs to know about a model."""

    init: Callable[[int, torch.device], torch.nn.Module]  # (seed, device) -> model
    loss: Callable[[torch.nn.Module, Dict[str, Any]], torch.Tensor]  # scalar
    predict: Callable[[torch.nn.Module, Dict[str, Any]], Dict[str, torch.Tensor]]
    eval_metrics: Dict[str, Metric]
    needs_rng: bool = False  # if True, micro-batches get an "rng" generator


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed derived from a run seed and a step."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


class Estimator:
    def __init__(self, model: ModelBundle, optimizer: Optimizer,
                 accum: acc.GradAccumConfig, config: Optional[RunConfig] = None,
                 mode: str = "scan", device="cuda", mesh=None):
        if mode != "scan":
            raise NotImplementedError(f"mode={mode!r}: only 'scan' is ported yet")
        if mesh is not None:
            raise NotImplementedError("meshes and parallel modes are not ported yet")
        acc.validate_config(accum)
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.accum = accum
        self.config = config or RunConfig()
        self.module: Optional[torch.nn.Module] = None
        self._state: Optional[acc.ScanState] = None
        self._train_step = None
        # throughput over every update after the process's first (which
        # pays for kernel builds and allocator warm-up), card-synchronized
        self.train_stats = {"updates": 0, "examples": 0, "seconds": 0.0}
        self._warm = False
        self.last_loss: Optional[torch.Tensor] = None  # the newest update's aux["loss"]

    # -- state ----------------------------------------------------------

    def _init_state(self) -> acc.ScanState:
        self.module = self.model.init(self.config.seed, self.device)
        state = acc.scan_init(named_parameters(self.module), self.optimizer)
        d = self.config.model_dir
        if d and ckpt_lib.latest_checkpoint(d):
            state = ckpt_lib.restore(d, state)
        return state

    def _step_fn(self):
        if self._train_step is None:
            module, loss = self.module, self.model.loss
            self._train_step = acc.accumulate_scan(
                lambda params, batch: loss(module, batch), self.optimizer, self.accum,
                needs_rng=self.model.needs_rng)
        return self._train_step

    def _to_device(self, batch):
        return {key: torch.as_tensor(np.asarray(x)).to(self.device) for key, x in batch.items()}

    def _prep_batch(self, batch, step_no: int):
        """The positional arguments after ``state`` for the train step."""
        batch = acc.stack_micro_batches(self._to_device(batch), self.accum.num_micro_batches)
        if self.model.needs_rng:
            g = torch.Generator(device=self.device)
            g.manual_seed(step_seed(self.config.seed + 1, step_no))
            return batch, g
        return (batch,)

    def _save(self, state):
        cfg = self.config
        ckpt_lib.save(cfg.model_dir, state, state.step, keep=cfg.keep_checkpoint_max)

    # -- public API -------------------------------------------------------

    def train(self, input_fn, max_steps: Optional[int] = None, final_save: bool = True):
        """Train until ``max_steps`` micro-batches (or the input runs out),
        stopping at the last whole K-cycle that fits."""
        cfg = self.config
        it = iter(input_fn() if callable(input_fn) else input_fn)
        state = self._state if self._state is not None else self._init_state()
        step_fn = self._step_fn()
        k = self.accum.num_micro_batches
        log_every = max(cfg.log_step_count_steps, 1)
        step_no = state.step
        last_bucket = step_no // log_every
        t_log, steps_at_log = time.perf_counter(), step_no
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
            self.last_loss = aux["loss"]
            if step_no // log_every != last_bucket:
                last_bucket = step_no // log_every
                rate = (step_no - steps_at_log) / max(time.perf_counter() - t_log, 1e-9)
                line = (f"[train] step={step_no} loss={aux['loss'].item():.5f} "
                        f"steps/sec={rate:.2f} examples/sec={rate * micro:.1f}")
                mfu = self._mfu(rate * micro)
                if mfu is not None:
                    line += f" mfu={mfu:.4f}"
                print(line)
                t_log, steps_at_log = time.perf_counter(), step_no
            if cfg.model_dir and cfg.save_checkpoints_steps and \
                    step_no % cfg.save_checkpoints_steps < k:
                self._save(state)
        synchronize(self.device)
        self.train_stats["seconds"] += time.perf_counter() - t_window
        self.train_stats["updates"] += counted
        self.train_stats["examples"] += examples
        if final_save and cfg.model_dir:
            self._save(state)
        self._state = state
        return state

    def examples_per_sec(self) -> Optional[float]:
        s = self.train_stats
        return s["examples"] / s["seconds"] if s["updates"] and s["seconds"] > 0 else None

    def _mfu(self, examples_per_sec):
        if self.config.flops_per_example is None or examples_per_sec is None:
            return None
        peak = peak_flops_for(device_name(self.device))
        if peak is None:
            return None
        return examples_per_sec * self.config.flops_per_example / peak

    def mfu(self) -> Optional[float]:
        """Model FLOPs utilization of :meth:`examples_per_sec` against the
        card's bf16 peak; None on the CPU or an unknown card."""
        return self._mfu(self.examples_per_sec())

    @torch.no_grad()
    def evaluate(self, input_fn, steps: Optional[int] = None, name: str = "eval"):
        """Streaming metrics over the eval input with the current weights
        (restored from ``model_dir`` when the Estimator has not trained)."""
        if self._state is None:
            self._state = self._init_state()
        totals: Dict[str, list] = {}
        n_batches = 0
        for batch in (input_fn() if callable(input_fn) else input_fn):
            if steps is not None and n_batches >= steps:
                break
            tb = self._to_device(batch)
            outputs = self.model.predict(self.module, tb)
            for key, metric in self.model.eval_metrics.items():
                total, count = metric.update(outputs, tb)
                t = totals.setdefault(key, [0.0, 0.0])
                t[0] += total
                t[1] += count
            n_batches += 1
        if not n_batches:
            raise ValueError("eval input_fn yielded no batches")
        results = {key: self.model.eval_metrics[key].finalize(t, c)
                   for key, (t, c) in totals.items()}
        print(f"[{name}] " + " ".join(f"{k}={v:.5f}" for k, v in results.items()))
        results["_num_batches"] = n_batches
        return results

    def train_and_evaluate(self, train_spec: TrainSpec, eval_spec: EvalSpec):
        """Train in chunks of ``log_step_count_steps``, evaluating at most
        every ``throttle_secs`` and once at the end."""
        k = self.accum.num_micro_batches
        chunk = max(self.config.log_step_count_steps // k, 1)
        reachable = None
        if train_spec.max_steps is not None:
            reachable = (train_spec.max_steps // k) * k
        it = iter(train_spec.input_fn())
        last_eval = time.time()
        while True:
            state = self.train(itertools.islice(it, chunk), max_steps=train_spec.max_steps,
                               final_save=False)
            peeked = next(it, None)
            if peeked is not None:
                it = itertools.chain([peeked], it)
            if peeked is None or (reachable is not None and state.step >= reachable):
                if self.config.model_dir:
                    self._save(state)
                return state, self.evaluate(eval_spec.input_fn, eval_spec.steps,
                                            eval_spec.name)
            if time.time() - last_eval >= eval_spec.throttle_secs:
                self.evaluate(eval_spec.input_fn, eval_spec.steps, eval_spec.name)
                last_eval = time.time()
