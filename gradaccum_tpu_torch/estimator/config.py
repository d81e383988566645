"""Run configuration and train/eval specs (the port of
``gradaccum_tpu/estimator/config.py``): the ``tf.estimator`` knobs, the
resilience and observability hooks, and the BestExporter slot."""

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
    # overlap checkpoint serialization and the disk write with training;
    # train blocks only on queueing the copy to host. Restores and exit
    # wait for the write first
    async_checkpoint: bool = False
    # a torch.profiler trace of a window of train steps (Chrome trace JSON)
    profile_dir: Optional[str] = None
    profile_start_step: int = 10  # skip the kernel builds and warm-up
    profile_num_steps: int = 5
    # analytic fwd+bwd FLOPs per training example (utils/flops.py): with a
    # known device peak, train logging reports MFU beside examples/sec
    flops_per_example: Optional[float] = None
    # resilience/preemption.py DrainConsensus: when set, the train loop's
    # preemption poll becomes an agreement across ranks — a SIGTERM on any
    # rank drains every rank to one common target step, so all land the
    # same final checkpoint. None keeps the per-process flag
    drain_consensus: Optional[Any] = None
    # JAX's obs/slo.py SLOEvaluator and obs/sentinel.py Sentinel belong to
    # the serving stack, not ported yet: setting either raises
    slos: Optional[Any] = None
    sentinel: Optional[Any] = None

    def __post_init__(self):
        for name in ("slos", "sentinel"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"RunConfig.{name} (obs/{'slo' if name == 'slos' else name}.py) "
                    f"comes with the serving stack and is not ported yet; see ROADMAP.md")


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
    # tf.estimator.BestExporter slot: after every evaluation in
    # train_and_evaluate, if `best_metric` improved (per `best_mode`), the
    # weights are exported as a serving artifact (estimator/export.py)
    # into `export_best_dir`, beside best_metric.json ({metric, value,
    # step}), which also keeps the high-water mark across resumes
    export_best_dir: Optional[str] = None
    best_metric: str = "accuracy"
    best_mode: str = "max"  # or "min" (e.g. rmse)
    # dict batch fixing the serving signature; defaults to the first eval
    # batch without the model's label keys
    export_sample: Optional[Any] = None
