"""The live ops plane's cost per serving tick (endpoints off).

The port of ``tools/bench_slo.py``. A serving loop that carries a sentinel
and an SLO evaluator pays host-side dict and deque work per tick: the
heartbeat, the tick-duration baseline, the lease check and one SLO pull.
JAX's gate: that stays within 2 % of the baseline tick.

Method (JAX's): one warmed engine replays a seeded simulation trace for the
uncontended baseline seconds per tick (the least over repeats); the ops
plane's cost is measured DIRECTLY by re-running the exact per-tick call set
the ``ServingServer`` loop adds (``heartbeat`` + ``observe_tick`` +
``check`` + ``SLOEvaluator.tick`` against the engine's live registry, the
percentile pulls throttled to every 4th tick) in a tight loop, the least
over repeats. The gating ratio is ``1 + cost / baseline``: an A/B of two
wall-clock runs cannot resolve a signal of a few per cent on a shared host.

``--model tiny`` (the default) is GPT's ``tiny_for_tests`` config, JAX's
bench model: the shortest tick the engine runs, so the largest ratio.
``--model small`` is GPT-Small in float32 (vocab 50257, L-4 H-512 A-8, 512
positions), the width the serving smoke phases serve at. Weights are random
from ``--seed``. One JSON line; ``--out FILE`` writes the result (no
default file, so JAX's ``BENCH_slo.json`` is never overwritten). Exits 1
when the gate fails. Runs on the card unless ``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_slo [--fast] [--out FILE]
        [--device cpu] [--model tiny|small] [--repeats N] [--requests N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

GATE = 1.02
REQUIRED = ("ops plane attached but endpoints off: <= 2% overhead per serving tick "
            "(measured cost of the per-tick sentinel + SLO call set over the "
            "uncontended baseline tick)")


def _rebased(trace, base: int):
    return [dataclasses.replace(it, arrival_tick=it.arrival_tick + base) for it in trace]


def setup(device, seed: int, n_requests: int, model: str = "tiny"):
    """A warmed engine (windowed latency series, as a live-SLO server would
    run) with its simulation driver and trace."""
    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.obs.trace import NullTracer
    from gradaccum_tpu_torch.serving import Engine, SimulationDriver
    from gradaccum_tpu_torch.serving.metrics import ServingMetrics

    cfg = (GPTConfig.small(dropout=0.0) if model == "small"
           else GPTConfig.tiny_for_tests(dropout=0.0))
    params = params_tree(gpt_lm_bundle(cfg).init(seed, device))
    engine = Engine(params, cfg, num_slots=4, max_len=32, tracer=NullTracer(),
                    metrics=ServingMetrics(latency_window=256), device=device)
    driver = SimulationDriver(engine, seed=seed)
    trace = driver.make_trace(n_requests, arrival_rate=0.6, prompt_len=(1, 12),
                              max_new=(4, 12))
    driver.run(_rebased(trace, engine.tick_count))  # warm-up
    return engine, driver, trace


def baseline_leg(engine, driver, trace) -> float:
    """Wall seconds per tick of one replay of ``trace``."""
    from gradaccum_tpu_torch.utils.platform import synchronize

    t0_ticks = engine.tick_count
    synchronize(engine.device)
    t0 = time.perf_counter()
    driver.run(_rebased(trace, engine.tick_count))
    synchronize(engine.device)
    return (time.perf_counter() - t0) / max(engine.tick_count - t0_ticks, 1)


def ops_plane_cost(engine, ticks: int, repeats: int, slo_interval: int = 4) -> float:
    """Seconds per tick of the exact call set the serving loop adds when a
    sentinel and an SLO evaluator are attached with the endpoints off."""
    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.obs.slo import SLOEvaluator, default_serving_objectives

    best = float("inf")
    for _ in range(max(repeats, 3)):
        clock = [0.0]
        snt = Sentinel(clock=lambda: clock[0])
        slo = SLOEvaluator(default_serving_objectives(), registry=engine.metrics.registry,
                           clock=lambda: clock[0], interval=slo_interval)
        # a plausible tick-duration stream (baseline noise)
        durs = [1e-3 + (i % 7) * 1e-5 for i in range(ticks)]
        t0 = time.perf_counter()
        for i in range(ticks):
            clock[0] = float(i)
            snt.heartbeat(tick=i, busy=True)
            snt.observe_tick(durs[i])
            snt.check()
            slo.tick()
        best = min(best, time.perf_counter() - t0)
    return best / ticks


def measure(engine, driver, trace, repeats: int) -> dict:
    """The baseline, the ops plane's cost and their ratio, for a warmed
    engine and its trace."""
    samples = [baseline_leg(engine, driver, trace) for _ in range(max(repeats, 3))]
    baseline = min(samples)
    ticks = max(engine.tick_count, 256)
    cost = ops_plane_cost(engine, ticks, repeats)
    ratio = 1.0 + cost / baseline
    return {"baseline_s_per_tick": baseline, "baseline_samples": samples,
            "ops_plane_s_per_tick": cost, "overhead_ratio": ratio, "ticks_measured": ticks,
            "config": "latency_window=256, SLOEvaluator(interval=4)"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="fewer requests and repeats")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--out", default=None, help="write the result here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=("tiny", "small"), default="tiny")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    repeats, n_requests = (3, 24) if args.fast else (args.repeats, args.requests)
    engine, driver, trace = setup(device, args.seed, n_requests, args.model)
    serve = measure(engine, driver, trace, repeats)
    ratio = serve["overhead_ratio"]
    passed = ratio <= GATE
    result = {
        "bench": "live ops plane serve overhead (sentinel + SLO burn-rate evaluation per "
                 "tick, endpoints off)",
        "device": str(device),
        "model": args.model,
        "headline": f"ops plane (sentinel+SLO, endpoints off): {ratio:.4f}x per serving tick",
        "overhead": {"serve": ratio},
        "serve": serve,
        "repeats": repeats,
        "acceptance": {"required": REQUIRED, "passed": passed},
    }
    print(json.dumps({"baseline_ms_per_tick": serve["baseline_s_per_tick"] * 1e3,
                      "ops_plane_us_per_tick": serve["ops_plane_s_per_tick"] * 1e6,
                      "ratio": ratio, "passed": passed}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
