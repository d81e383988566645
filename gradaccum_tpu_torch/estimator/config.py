"""Run configuration and train/eval specs (the port of
``gradaccum_tpu/estimator/config.py``): the ``tf.estimator`` knobs the
single-device scan path reads."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass
class RunConfig:
    model_dir: Optional[str] = None
    seed: int = 19830610  # the reference's tf_random_seed
    log_step_count_steps: int = 100  # logging cadence, in micro-batches
    save_checkpoints_steps: Optional[int] = 1000
    keep_checkpoint_max: int = 5
    # analytic fwd+bwd FLOPs per training example (utils/flops.py): with a
    # known device peak, train logging reports MFU beside examples/sec
    flops_per_example: Optional[float] = None


@dataclass
class TrainSpec:
    input_fn: Callable[[], Any]  # () -> iterable of dict batches of numpy arrays
    max_steps: Optional[int] = None  # counted in MICRO-batches (reference semantics)


@dataclass
class EvalSpec:
    input_fn: Callable[[], Any]
    steps: Optional[int] = None  # None = run the iterable out
    throttle_secs: int = 30  # least seconds between evaluations during training
    name: str = "eval"
