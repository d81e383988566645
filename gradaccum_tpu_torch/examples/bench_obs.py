"""Measure observability overhead: obs enabled vs disabled, train + serve.

The port of ``tools/bench_obs.py``, by its method, on the port's two hot
paths:

- **serve**: a seeded simulation trace through a tiny GPT engine, timed
  per tick, once with a :class:`NullTracer` (disabled) and once with a
  recording :class:`Tracer`;
- **train**: a tiny-GPT streaming-mode Estimator (K-way gradient
  accumulation), timed per step, with the global tracer swapped the same
  way.

ONE engine and ONE estimator serve every leg: the tracer is the only thing
swapped. The serve warm-up replays the same-shaped trace first (replays
rebase arrival ticks onto the engine's growing tick counter). The train
legs continue from one another's state (JAX's restart from a copy of the
warmed state only sidesteps its donated buffers; a streaming step does the
same work from any state).

The gating ratio is a DIRECT measurement: a traced leg captures the exact
event stream the workload emits, a tight loop re-emits that stream into a
fresh tracer (min over repeats), and the per-op emission cost is divided
by the uncontended (min-over-repeats) baseline op time. Paired wall-clock
A/B ratios are recorded (``ab_wall``) as a cross-check and do not gate.
The acceptance block gates at <= 5 % overhead, as JAX's does.

Usage: python -m gradaccum_tpu_torch.examples.bench_obs [--json PATH]
[--repeats N] [--device cpu]. It runs on the card unless ``--device cpu``,
and writes the artifact only to ``--json``.
"""

import argparse
import dataclasses
import json
import sys
import time

GATE = 1.05
REQUIRED = ("obs enabled vs disabled: <= 5% overhead per serving tick "
            "and per train step (measured emission cost of the workload's "
            "event stream over the uncontended baseline op time)")


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _serve_setup(seed: int, n_requests: int, device):
    """One warmed engine + driver + reusable trace shared by every leg."""
    import torch

    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.obs.trace import NullTracer
    from gradaccum_tpu_torch.serving import Engine, SimulationDriver

    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    with torch.no_grad():
        params = params_tree(gpt_lm_bundle(cfg).init(0, device))
    engine = Engine(params, cfg, num_slots=4, max_len=32, tracer=NullTracer(), device=device)
    driver = SimulationDriver(engine, seed=seed)
    trace = driver.make_trace(n_requests, arrival_rate=0.6, prompt_len=(1, 12),
                              max_new=(4, 12))
    # the warm-up replays the SAME trace, so every shape the timed legs hit
    # has run once before any timer starts
    driver.run(_rebased(trace, engine.tick_count))
    return engine, driver, trace


def _rebased(trace, base: int):
    """The trace's arrival pattern, shifted onto the engine's current tick."""
    return [dataclasses.replace(it, arrival_tick=it.arrival_tick + base) for it in trace]


def _serve_leg(engine, driver, trace, tracer):
    """Seconds per tick replaying ``trace`` with ``tracer`` installed."""
    engine.tracer = tracer
    engine.scheduler.tracer = tracer
    t0_ticks = engine.tick_count
    _sync(engine.device)
    t0 = time.perf_counter()
    driver.run(_rebased(trace, engine.tick_count))
    _sync(engine.device)
    dt = time.perf_counter() - t0
    ticks = engine.tick_count - t0_ticks
    return dt / max(ticks, 1), ticks


def _train_setup(n_steps: int, device):
    """One warmed tiny-GPT streaming Estimator and its batches."""
    import numpy as np

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import sgd

    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    rng = np.random.default_rng(7)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)}
    batches = [batch] * n_steps
    est = Estimator(gpt_lm_bundle(cfg), sgd(0.01), GradAccumConfig(num_micro_batches=4),
                    RunConfig(model_dir=None, log_step_count_steps=10_000),
                    mode="streaming", device=device)
    est.train(batches[:8], final_save=False)  # warm-up, outside any window
    return est, batches


def _train_leg(est, batches, tracer):
    """Seconds per streaming train step under ``tracer`` (global slot)."""
    from gradaccum_tpu_torch.obs import trace as obs_trace

    with obs_trace.installed(tracer):
        _sync(est.device)
        t0 = time.perf_counter()
        est.train(batches, final_save=False)
        _sync(est.device)
        dt = time.perf_counter() - t0
    return dt / len(batches)


def _workload(tracer):
    """The emission workload a traced leg produced: one ``(ph, name, cat,
    args)`` tuple per event, args without the injected ``seq``."""
    out = []
    for ev in tracer.snapshot():
        args = {k: v for k, v in ev["args"].items() if k != "seq"}
        out.append((ev["ph"], ev["name"], ev["cat"], args))
    return out


def _emission_cost(workload, repeats: int) -> float:
    """Seconds to re-emit ``workload`` into a fresh recording tracer:
    tight loop, min over repeats. Spans replay as enter+exit back to back,
    exactly the tracer work the traced leg paid."""
    from gradaccum_tpu_torch.obs.trace import Tracer

    best = float("inf")
    for _ in range(max(repeats, 3)):
        tr = Tracer(capacity=None)
        span = tr.span
        event = tr.event
        t0 = time.perf_counter()
        for ph, name, cat, args in workload:
            if ph == "X":
                with span(name, cat, **args):
                    pass
            else:
                event(name, cat, **args)
        best = min(best, time.perf_counter() - t0)
    return best


def run(repeats: int = 5, requests: int = 96, train_steps: int = 200, device="cuda",
        log=print) -> dict:
    """Both hot paths, A/B and by emission cost; returns the artifact."""
    from gradaccum_tpu_torch.obs.trace import NullTracer, Tracer
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    makers = {"off": NullTracer, "on": lambda: Tracer(capacity=None)}
    engine, driver, s_trace = _serve_setup(100, requests, device)
    est, batches = _train_setup(train_steps, device)

    # A/B wall-clock samples (cross-check only): each repeat runs both legs
    # back to back, the order flipping every repeat; the last "on" tracer
    # of each hot path doubles as the emission-workload capture
    serve = {k: {"samples": []} for k in makers}
    train = {k: {"samples": []} for k in makers}
    serve_tracer = train_tracer = None
    for rep in range(repeats):
        order = list(makers.items())
        if rep % 2:
            order.reverse()
        for label, mk in order:
            tracer = mk()
            per_tick, ticks = _serve_leg(engine, driver, s_trace, tracer)
            serve[label]["samples"].append(per_tick)
            serve[label]["ticks"] = ticks
            if label == "on":
                serve_tracer = tracer
        for label, mk in order:
            tracer = mk()
            train[label]["samples"].append(_train_leg(est, batches, tracer))
            if label == "on":
                train_tracer = tracer
    for label in makers:
        serve[label]["s_per_tick"] = min(serve[label]["samples"])
        train[label]["s_per_step"] = min(train[label]["samples"])
        log(f"[obs-bench] serve {label}: {serve[label]['s_per_tick'] * 1e3:.3f} ms/tick, "
            f"train {label}: {train[label]['s_per_step'] * 1e3:.4f} ms/step")

    serve_events = _workload(serve_tracer)
    train_events = _workload(train_tracer)
    serve_ticks = serve["on"]["ticks"]
    serve_cost = _emission_cost(serve_events, repeats) / serve_ticks
    train_cost = _emission_cost(train_events, repeats) / len(batches)
    serve_ratio = 1.0 + serve_cost / serve["off"]["s_per_tick"]
    train_ratio = 1.0 + train_cost / train["off"]["s_per_step"]
    log(f"[obs-bench] serve: {len(serve_events)} events over {serve_ticks} ticks, "
        f"{serve_cost * 1e6:.1f} us/tick emission; train: {len(train_events)} events over "
        f"{len(batches)} steps, {train_cost * 1e6:.1f} us/step emission")

    def ab_ratio(d):
        return min(d["on"]["samples"]) / min(d["off"]["samples"])

    passed = serve_ratio <= GATE and train_ratio <= GATE
    headline = f"obs overhead: serve {serve_ratio:.3f}x, train {train_ratio:.3f}x"
    log(f"[obs-bench] {headline} (A/B wall cross-check: serve {ab_ratio(serve):.3f}x, "
        f"train {ab_ratio(train):.3f}x) -> {'PASS' if passed else 'FAIL'}")
    return {
        "bench": f"observability overhead (spans+metrics on vs off, {device.type})",
        "headline": headline,
        "device": str(device),
        "serve": {
            "events": len(serve_events),
            "ticks": serve_ticks,
            "emission_s_per_tick": serve_cost,
            "baseline_s_per_tick": serve["off"]["s_per_tick"],
            "overhead_ratio": serve_ratio,
            "ab_wall": serve,
        },
        "train": {
            "events": len(train_events),
            "steps": len(batches),
            "emission_s_per_step": train_cost,
            "baseline_s_per_step": train["off"]["s_per_step"],
            "overhead_ratio": train_ratio,
            "ab_wall": train,
        },
        "repeats": repeats,
        "acceptance": {"required": REQUIRED, "passed": passed},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, help="artifact path (none written without it)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    artifact = run(args.repeats, args.requests, args.train_steps, args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
        print(f"[obs-bench] wrote {args.json}")
    return 0 if artifact["acceptance"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
