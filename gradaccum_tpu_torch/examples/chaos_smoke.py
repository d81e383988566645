"""One-command seeded chaos run over train + serve.

The port of ``tools/chaos_smoke.py``. Draws ONE fault schedule from
``--seed`` (a single rng stream decides every phase's fault parameters), then
runs seven phases through their faults and asserts the end state is healthy:

- **train**: a small streaming job with an injected kill, an overflow storm
  and a flaky checkpoint disk, resumed from the newest checkpoint after
  every kill as an operator would; it reaches ``max_steps`` with a
  restorable final checkpoint and finite weights, the loss scale halves and
  regrows, and every fired fault is in a flight dump or the trace ring with
  training after it;
- **serve**: a decode-tick crash and a slow tick; every request finishes
  with its solo ``generate_cached`` stream;
- **paged**: a corrupted page-table row faults structured and heals through
  recover/requeue, a swap-IO error degrades to re-prefill;
- **reconfig**: a seeded ``MID_RECONFIG`` kill on a pool shrink under load,
  the retry, a checkpoint swap, and a two-host lease leg where the survivor
  resolves a gone host's round without the barrier timeout;
- **ops**: each fault class raises its matching alert (tick crash ->
  ``engine_fault``, slow ticks -> ``latency_cliff``, overflow storm ->
  ``scale_storm``), the sentinel's remediations run through the
  recover/requeue and drain contracts, and a seeded simulation's alert
  streams are byte-identical across two runs;
- **healer**: the escalation ladder ENABLED (``resilience/healer.py``): a
  healable persistent degradation heals through recover/requeue, an
  unhealable one escalates through a healer-tagged pool grow and freezes
  terminally (``healer_frozen``, severity page) instead of thrashing;
- **fleet**: a seeded ``replica_kill`` resolves DEAD through the lease
  ladder, the excision is proof-gated, the displaced streams finish on the
  survivor and a live ``replica_add`` restores full strength.

The healer phase runs its sentinels on the engine's tick clock (windows and
cooldowns in ticks) and sizes its degradation from the warm-up's median
tick, so the cliff cannot be missed on a fast card or a loaded host.

Everything is deterministic under the seed. ``--seed-range N`` replays the
whole schedule for N consecutive seeds. The artifact goes to ``--json FILE``,
else to a fresh file in the temporary directory (JAX's ``BENCH_chaos.json``
is never written). The models are GPT's ``tiny_for_tests`` config with
random weights (seed 0) and a three-weight linear regression. Runs on the
card unless ``--device cpu``.

    python -m gradaccum_tpu_torch.examples.chaos_smoke [--seed N] [--seed-range N]
        [--json FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

DEGRADE_FACTOR = 25.0  # the healer phase's degraded tick against the warm-up median
DEGRADE_FLOOR = 0.02   # ... and never below this many seconds


class ChaosFailure(AssertionError):
    """A phase's gate failed."""


def _check(cond, msg) -> None:
    if not cond:
        raise ChaosFailure(msg)


def draw_plan(seed: int) -> dict:
    """ONE seeded schedule for every phase: a single rng stream decides the
    train, serve, paged, reconfig, healer and fleet fault parameters up
    front, in JAX's order, so one number replays the whole run."""
    import numpy as np

    rng = np.random.default_rng(seed)
    K = 4
    return {
        "train_crash_at": int(rng.integers(10, 30)),
        "storm_start": int(rng.integers(30, 36)),
        "storm_len": int(rng.integers(K, 2 * K)),
        "serve_crash_tick": int(rng.integers(1, 5)),
        "serve_slow_offset": 3,
        "paged_table_tick": int(rng.integers(2, 6)),
        "reconfig_shrink_blocks": int(rng.integers(10, 15)),
        "reconfig_crash_index": int(rng.integers(0, 2)),
        "healer_degrade_tick": int(rng.integers(8, 14)),
        "healer_pool_blocks": int(rng.integers(18, 25)),
        "fleet_kill_target": int(rng.integers(0, 2)),
        "fleet_kill_poll": int(rng.integers(2, 6)),
    }


def _model(device):
    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle

    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    return cfg, params_tree(gpt_lm_bundle(cfg).init(0, device))


def _solo(params, cfg, prompt, n):
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    return generate_cached(params, cfg, prompt, n)[0, prompt.size:].tolist()


def _check_parity(tag, params, cfg, prompts, results, n):
    for i, (prompt, (tokens, reason)) in enumerate(zip(prompts, results)):
        _check(reason in ("eos", "length"), f"[chaos/{tag}] request {i} ended {reason}")
        _check([int(t) for t in tokens] == _solo(params, cfg, prompt, n),
               f"[chaos/{tag}] request {i} differs from generate_cached")


def _linear_bundle(bias=True):
    import torch

    from gradaccum_tpu_torch.estimator.estimator import ModelBundle
    from gradaccum_tpu_torch.estimator.metrics import mean_absolute_error

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3, 1))
            if bias:
                self.b = torch.nn.Parameter(torch.zeros(1))

    def predict(m, batch):
        out = batch["x"] @ m.w
        return {"predictions": out + m.b if bias else out}

    def loss(m, batch):
        return torch.mean((predict(m, batch)["predictions"] - batch["y"]) ** 2)

    return ModelBundle(init=lambda seed, device: Linear().to(device), loss=loss,
                       predict=torch.no_grad()(predict),
                       eval_metrics={"mae": mean_absolute_error(label_key="y")},
                       label_keys=("y",))


def _after_each_fault(fired, events, after) -> None:
    """Every fired fault has an event ``after(e)`` later on the timeline."""
    for point, index, kind in fired:
        seq = next(e["args"]["seq"] for e in events
                   if e["name"] == "fault/injected"
                   and (e["args"]["point"], e["args"]["index"], e["args"]["kind"])
                   == (point, index, kind))
        _check(any(e["args"].get("seq", -1) > seq and after(e) for e in events),
               f"no activity after the fault {(point, index, kind)}")


def _train_chaos(seed: int, work_dir: str, log, plan, device):
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.obs import flight as obs_flight
    from gradaccum_tpu_torch.obs import trace as obs_trace
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.ops.adamw import sgd
    from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig
    from gradaccum_tpu_torch.resilience import faults

    K, n_steps = 4, 48
    data_rng = np.random.default_rng(seed + 1)
    data = []
    for _ in range(n_steps):
        x = data_rng.normal(size=(8, 3)).astype(np.float32)
        data.append({"x": x, "y": (x @ np.asarray([[1.0], [-2.0], [0.5]], np.float32))
                     .astype(np.float32)})

    # this phase's slice of the ONE seeded plan: a kill, a storm, a flaky
    # disk, all at once
    crash_at = plan["train_crash_at"]
    storm = faults.FaultSpec(faults.PRE_TRAIN_STEP, at=plan["storm_start"],
                             kind=faults.KIND_OVERFLOW_STORM, span=plan["storm_len"])
    specs = [faults.FaultSpec(faults.POST_TRAIN_STEP, at=crash_at), storm,
             faults.FaultSpec(faults.MID_CKPT_WRITE, at=None, kind=faults.KIND_IO_ERROR,
                              count=2)]
    log(f"[chaos/train] plan: kill@{crash_at}, storm@{storm.at}x{storm.span}, "
        "2 ckpt IO errors")

    def estimator():
        return Estimator(
            _linear_bundle(), sgd(0.05),
            acc.GradAccumConfig(num_micro_batches=K, first_step_quirk=False,
                                skip_nonfinite=True, normalize_by_good_count=True,
                                loss_scale=LossScaleConfig(init_scale=16.0, growth_interval=2)),
            RunConfig(model_dir=work_dir, save_checkpoints_steps=6, log_step_count_steps=1000),
            mode="streaming", device=device)

    injector = faults.FaultInjector(faults.FaultSchedule(specs))
    scale_series, crashes, offset = [], 0, 0
    with faults.installed(injector):
        for _ in range(6):
            est = estimator()
            try:
                state = est.train(data[offset:], max_steps=n_steps)
                scale_series += [v for _, v in est.loss_scale_series]
                est.close()
                break
            except faults.InjectedCrash as e:
                crashes += 1
                scale_series += [v for _, v in est.loss_scale_series]
                est.close()
                latest = ckpt_lib.latest_checkpoint(work_dir)
                _check(latest is not None, "[chaos/train] crash before any checkpoint")
                offset = latest[0]
                log(f"[chaos/train] injected kill ({e}); resuming from checkpoint "
                    f"step={offset}")
        else:
            raise ChaosFailure("[chaos/train] did not finish within the attempt budget")

    _check(crashes >= 1, "[chaos/train] the seeded kill never fired")
    _check(state.step == n_steps, f"[chaos/train] stopped at {state.step}")
    ckpt_step, ckpt_path = ckpt_lib.latest_checkpoint(work_dir)
    _check(ckpt_step == n_steps and os.path.getsize(ckpt_path) > 0,
           "[chaos/train] final checkpoint missing or empty")
    restored = ckpt_lib.restore(work_dir, state)
    for name, leaf in ckpt_lib.flatten(restored).items():
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            _check(bool(torch.isfinite(leaf).all()), f"[chaos/train] non-finite {name}")
    halves = [i for i in range(1, len(scale_series)) if scale_series[i] < scale_series[i - 1]]
    grows = [i for i in range(1, len(scale_series)) if scale_series[i] > scale_series[i - 1]]
    _check(halves and grows, f"[chaos/train] loss scale never cycled: {scale_series}")
    fired = [(p, i, k) for p, i, k in injector.fired]

    # flight-recorder postmortems: every kill dumped the obs ring under
    # model_dir/flightrec, and every fired fault is on the timeline with
    # training after it (the resume is the effect)
    dumps = obs_flight.list_dumps(work_dir)
    _check(len(dumps) >= crashes, f"[chaos/train] {len(dumps)} flight dump(s) for "
                                  f"{crashes} kill(s)")
    dumped = set()
    for p in dumps:
        dumped |= set(obs_flight.fault_events(obs_flight.load_dump(p)["events"]))
    events = obs_trace.get_tracer().snapshot()
    ring = set(obs_flight.fault_events(events))
    missing = [f for f in fired if f not in (dumped | ring)]
    _check(not missing, f"[chaos/train] faults missing from the obs ring: {missing}")
    _check((faults.POST_TRAIN_STEP, crash_at, faults.KIND_CRASH) in dumped,
           "[chaos/train] the kill is absent from its own postmortem")
    _after_each_fault(fired, events, lambda e: e["name"] == "train/step")
    log(f"[chaos/train] PASS: {crashes} kill(s) survived, {len(fired)} faults fired "
        f"({len(dumps)} flight dumps), final ckpt step={ckpt_step}")
    return {"crashes": crashes, "faults_fired": fired, "flight_dumps": len(dumps),
            "final_step": state.step}


def _serve_chaos(seed: int, log, plan, device):
    import numpy as np

    from gradaccum_tpu_torch.obs import flight as obs_flight
    from gradaccum_tpu_torch.obs import trace as obs_trace
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import Engine, ServingServer

    rng = np.random.default_rng(seed + 2)
    cfg, params = _model(device)
    engine = Engine(params, cfg, num_slots=3, max_len=32, device=device)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(1, 8)),)).astype(np.int32)
               for _ in range(6)]
    crash_tick = plan["serve_crash_tick"]
    slow_tick = crash_tick + plan["serve_slow_offset"]
    specs = [faults.FaultSpec(faults.MID_DECODE_TICK, at=crash_tick),
             faults.FaultSpec(faults.MID_DECODE_TICK, at=slow_tick, kind=faults.KIND_SLOW_TICK,
                              delay=0.05)]
    log(f"[chaos/serve] plan: tick crash@{crash_tick}, slow tick@{slow_tick}")
    injector = faults.FaultInjector(faults.FaultSchedule(specs))
    with tempfile.TemporaryDirectory() as flight_dir, faults.installed(injector):
        recorder = obs_flight.FlightRecorder(flight_dir, registry=engine.metrics.registry)
        server = ServingServer(engine, max_requeues=2, flight=recorder).start()
        handles = [server.submit(p, 5) for p in prompts]
        results = [h.result(timeout=120) for h in handles]
        server.stop()  # must not raise: the engine recovered
        # the recovered tick crash shipped its own postmortem
        dumps = obs_flight.list_dumps(flight_dir)
        _check(dumps, "[chaos/serve] engine fault produced no flight dump")
        dumped = set()
        for p in dumps:
            dumped |= set(obs_flight.fault_events(obs_flight.load_dump(p)["events"]))
        _check((faults.MID_DECODE_TICK, crash_tick, faults.KIND_CRASH) in dumped,
               "[chaos/serve] tick crash absent from its flight dump")
        events = obs_trace.get_tracer().snapshot()
        ring = set(obs_flight.fault_events(events))
        missing = [f for f in injector.fired if f not in (dumped | ring)]
        _check(not missing, f"[chaos/serve] faults missing from the obs ring: {missing}")
        _after_each_fault(injector.fired, events, lambda e: e["cat"] == "serving")
        n_dumps = len(dumps)
    _check(any(k == faults.KIND_CRASH for _, _, k in injector.fired),
           "[chaos/serve] the seeded tick crash never fired")
    _check_parity("serve", params, cfg, prompts, results, 5)
    _check(engine.idle, "[chaos/serve] engine not idle")
    log(f"[chaos/serve] PASS: {len(results)} requests completed with greedy parity through "
        f"{len(injector.fired)} fault(s), {n_dumps} flight dump(s)")
    return {"requests": len(results), "flight_dumps": n_dumps,
            "faults_fired": list(injector.fired)}


def _paged_chaos(seed: int, log, plan, device):
    """The admission plane's fault kinds: a corrupted page-table row faults
    STRUCTURED at upload and heals through recover/requeue, and a swap-IO
    error during preemption degrades to re-prefill, both with every stream
    equal to its solo decode."""
    import numpy as np

    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import Engine, ServingServer

    rng = np.random.default_rng(seed + 7)
    cfg, params = _model(device)
    sys_prompt = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, cfg.vocab_size, 3).astype(np.int32)])
               for _ in range(5)]
    # a tight pool and optimistic admission so preemption (and with it the
    # swap path the IO fault targets) happens
    engine = Engine(params, cfg, num_slots=5, max_len=32, page_size=4, num_blocks=14,
                    prefix_cache=True, admission="optimistic", swap="host", device=device)
    table_tick = plan["paged_table_tick"]
    specs = [faults.FaultSpec(faults.POOL_PAGE_TABLE, at=table_tick, kind=faults.KIND_CORRUPT),
             faults.FaultSpec(faults.MID_SWAP_IO, at=None, kind=faults.KIND_IO_ERROR, count=1)]
    log(f"[chaos/paged] plan: page-table corrupt@{table_tick}, swap-IO error on the first swap")
    injector = faults.FaultInjector(faults.FaultSchedule(specs))
    with faults.installed(injector):
        server = ServingServer(engine, max_requeues=3).start()
        handles = [server.submit(p, 12) for p in prompts]
        results = [h.result(timeout=180) for h in handles]
        server.stop()  # must not raise: both faults were absorbed
    kinds = {(p, k) for p, _, k in injector.fired}
    _check((faults.POOL_PAGE_TABLE, faults.KIND_CORRUPT) in kinds,
           "[chaos/paged] the page-table corruption never fired")
    m = engine.metrics
    if (faults.MID_SWAP_IO, faults.KIND_IO_ERROR) in kinds:
        _check(m.swap_fallbacks >= 1, "[chaos/paged] swap-IO error fired but no fallback "
                                      "was counted")
    _check_parity("paged", params, cfg, prompts, results, 12)
    _check(engine.idle and engine.pool.allocated_blocks == 0,
           "[chaos/paged] blocks left allocated")
    log(f"[chaos/paged] PASS: {len(results)} requests parity-clean through "
        f"{len(injector.fired)} fault(s); preemptions={m.preemptions}, "
        f"swap_fallbacks={m.swap_fallbacks}, reprefills={m.reprefills}")
    return {"requests": len(results), "faults_fired": list(injector.fired),
            "preemptions": m.preemptions, "swap_fallbacks": m.swap_fallbacks,
            "reprefills": m.reprefills}


def _reconfig_chaos(seed: int, log, plan, device):
    """A pool SHRINK under live traffic with a seeded MID_RECONFIG kill, the
    retry, then a checkpoint swap from a manifested directory (no request
    dropped, parity throughout), and a two-host lease leg: the survivor
    tells a gone host from a slow one without the barrier timeout."""
    import numpy as np

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.resilience.preemption import LocalDrainBus
    from gradaccum_tpu_torch.serving import Engine, ServingServer, checkpoint_swap, pool_resize

    rng = np.random.default_rng(seed + 9)
    cfg, params = _model(device)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(3, 8)),)).astype(np.int32)
               for _ in range(6)]
    nb2 = plan["reconfig_shrink_blocks"]
    crash_idx = plan["reconfig_crash_index"]
    log(f"[chaos/reconfig] plan: shrink 24->{nb2} blocks under load with a kill at "
        f"MID_RECONFIG index {crash_idx}, then a checkpoint swap")
    engine = Engine(params, cfg, num_slots=4, max_len=32, page_size=4, num_blocks=24,
                    admission="optimistic", swap="host", device=device)
    injector = faults.FaultInjector(faults.FaultSchedule([
        faults.FaultSpec(faults.MID_RECONFIG, at=crash_idx)]))
    with tempfile.TemporaryDirectory() as ckpt_dir, faults.installed(injector):
        ckpt_lib.save(ckpt_dir, {"params": params, "step": 1}, step=1)
        server = ServingServer(engine, max_requeues=3).start()
        try:
            handles = [server.submit(p, 12) for p in prompts]
            # the first attempt eats the seeded kill; the engine lands in a
            # clean old or new configuration with everything parked
            fut = server.request_reconfig(pool_resize(nb2))
            try:
                fut.result(timeout=120)
                crashed = False
            except faults.InjectedCrash:
                crashed = True
            # the retry applies cleanly (the fault budget is spent)
            result = server.reconfigure(pool_resize(nb2), timeout=120)
            _check(result.ok, f"[chaos/reconfig] retry refused: {result.reason}")
            _check(engine.num_blocks == nb2, f"[chaos/reconfig] {engine.num_blocks} blocks")
            swap_res = server.reconfigure(checkpoint_swap(checkpoint=ckpt_dir), timeout=120)
            _check(swap_res.ok and swap_res.detail["weights_unchanged"],
                   f"[chaos/reconfig] checkpoint swap {swap_res.to_dict()}")
            results = [h.result(timeout=180) for h in handles]
        finally:
            server.stop()
    _check(crashed, "[chaos/reconfig] the seeded MID_RECONFIG kill never fired")
    _check_parity("reconfig", params, cfg, prompts, results, 12)
    m = engine.metrics
    _check(m.reconfigs.get("pool_resize", 0) >= 1
           and m.reconfigs.get("checkpoint_swap", 0) == 1,
           f"[chaos/reconfig] reconfigs {dict(m.reconfigs)}")

    # the host-lease leg: gone resolves fast, slow is waited for
    clk = [0.0]
    bus = LocalDrainBus(2, timeout=60.0, lease_ttl=1.0, clock=lambda: clk[0])
    bus.renew(1, now=0.0)
    clk[0] = 10.0  # host 1's lease long expired: it is GONE
    t0 = time.monotonic()
    drain, step = bus.exchange(0, True, 5)
    waited = time.monotonic() - t0
    _check((drain, step) == (True, 5), f"[chaos/reconfig] exchange {(drain, step)}")
    _check(waited < 10.0, f"[chaos/reconfig] the survivor waited {waited} s for a dead host")
    _check(bus.partial_rounds == 1 and bus.last_partial() == (1,),
           "[chaos/reconfig] the gone host's round was not partial")
    log(f"[chaos/reconfig] PASS: {len(results)} requests parity-clean through kill+shrink+"
        f"swap (preemptions={m.preemptions}, reconfigs={dict(m.reconfigs)}); gone-host round "
        f"resolved in {waited * 1000:.0f} ms without the barrier timeout")
    return {"requests": len(results), "reconfig_kill_fired": crashed, "shrink_blocks": nb2,
            "reconfigs": dict(m.reconfigs), "preemptions": m.preemptions,
            "lease_partial_rounds": bus.partial_rounds}


def _ops_chaos(seed: int, log, device):
    """The live ops plane: every injected fault class raises its MATCHING
    alert, the sentinel's remediation runs through the recover/requeue and
    drain contracts, the remediated streams stay exact, and a seeded
    simulation's alert streams are byte-identical across two runs."""
    import numpy as np

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.obs import sentinel as obs_sentinel
    from gradaccum_tpu_torch.obs import trace as obs_trace
    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.obs.slo import Objective, SLOEvaluator
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.ops.adamw import sgd
    from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig
    from gradaccum_tpu_torch.resilience import faults, remediation
    from gradaccum_tpu_torch.resilience.preemption import DrainConsensus
    from gradaccum_tpu_torch.serving import Engine, ServingServer, SimulationDriver
    from gradaccum_tpu_torch.serving.scheduler import QueueFull, Scheduler

    detail = {}
    rng = np.random.default_rng(seed + 3)
    cfg, params = _model(device)

    # -- leg A: serve. crash -> engine_fault, slow ticks -> latency_cliff
    # whose remediation routes through recover + requeue, parity clean
    engine = Engine(params, cfg, num_slots=2, max_len=64, device=device)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(2, 8)),)).astype(np.int32)
               for _ in range(4)]
    # warm every program OUTSIDE the watched window, so first-call spikes
    # never feed the baselines
    for p in prompts[:2]:
        engine.submit(p, 3)
    engine.run_until_idle()
    for rid in list(engine.results):
        engine.pop_result(rid)
    t0 = engine.tick_count
    crash_at, slow_at = t0 + 2, t0 + 12  # >= cliff_warmup clean ticks after the recovery
    specs = [faults.FaultSpec(faults.MID_DECODE_TICK, at=crash_at),
             faults.FaultSpec(faults.MID_DECODE_TICK, at=slow_at, kind=faults.KIND_SLOW_TICK,
                              delay=1.0),
             faults.FaultSpec(faults.MID_DECODE_TICK, at=slow_at + 1,
                              kind=faults.KIND_SLOW_TICK, delay=1.0)]
    log(f"[chaos/ops] serve plan: tick crash@{crash_at}, slow ticks@{slow_at},{slow_at + 1}")
    # a slow tick of 1 s scores hundreds of deviations over a tiny model's
    # healthy tick; 50 keeps a host hiccup of tens of ms (which would requeue
    # every stream again) below the line
    snt = Sentinel(clock=lambda: float(engine.tick_count), cliff_warmup=6,
                   cliff_consecutive=2, cliff_score=50.0)
    server = ServingServer(engine, max_requeues=3, sentinel=snt)
    remediation.bind_default_remediations(snt, server=server)
    with faults.installed(faults.FaultInjector(faults.FaultSchedule(specs))):
        server.start()
        try:
            handles = [server.submit(p, 24) for p in prompts]
            results = [h.result(timeout=180) for h in handles]
        finally:
            server.stop()
    kinds_fired = {a.kind for a in snt.anomalies if a.state == "fire"}
    _check(obs_sentinel.ENGINE_FAULT in kinds_fired,
           f"[chaos/ops] tick crash raised no engine_fault anomaly ({kinds_fired})")
    _check(obs_sentinel.LATENCY_CLIFF in kinds_fired,
           f"[chaos/ops] slow ticks raised no latency_cliff anomaly ({kinds_fired})")
    # the remediation went THROUGH the server's recover/requeue contract: on
    # the shared timeline a sentinel/remediation precedes a serve/recover
    seqs = {}
    for ev in obs_trace.get_tracer().snapshot():
        if ev["name"] in ("sentinel/remediation", "serve/recover", "req/requeue"):
            seqs.setdefault(ev["name"], []).append(ev["args"]["seq"])
    _check(seqs.get("sentinel/remediation"), "[chaos/ops] remediation never fired")
    first = min(seqs["sentinel/remediation"])
    _check(any(s > first for s in seqs.get("serve/recover", [])),
           "[chaos/ops] no serve/recover after the sentinel remediation")
    _check_parity("ops", params, cfg, prompts, results, 24)
    cliff = next(a.detail["score"] for a in snt.anomalies
                 if a.kind == obs_sentinel.LATENCY_CLIFF and a.state == "fire")
    detail["serve"] = {"anomalies": [a.to_dict() for a in snt.anomalies],
                       "fault_to_alert": {"crash": "engine_fault", "slow_tick": "latency_cliff"},
                       "requeues": len(seqs.get("req/requeue", [])),
                       "cliff_score": {"fired": cliff, "threshold": snt.cliff_score}}
    log(f"[chaos/ops] serve PASS: crash->engine_fault, slow_tick->latency_cliff "
        f"(score {cliff} against {snt.cliff_score}), "
        f"remediation->recover ({len(seqs.get('req/requeue', []))} requeue(s)), parity clean")

    # -- leg B: train. overflow storm -> scale_storm whose remediation asks
    # for a drain through the consensus contract (the SIGTERM path)
    K, n_steps = 4, 64
    data_rng = np.random.default_rng(seed + 4)
    data = [{"x": data_rng.normal(size=(8, 3)).astype(np.float32),
             "y": data_rng.normal(size=(8, 1)).astype(np.float32)} for _ in range(n_steps)]
    storm = faults.FaultSchedule.overflow_storm(seed + 5, start_range=(16, 20),
                                                length_range=(3 * K, 4 * K)).specs[0]
    log(f"[chaos/ops] train plan: overflow storm@{storm.at}x{storm.span}")
    train_snt = Sentinel(storm_halvings=2, storm_window=float(8 * K))
    consensus = DrainConsensus(multiprocess=False)
    remediation.bind_default_remediations(train_snt, consensus=consensus)
    est = Estimator(
        _linear_bundle(bias=False), sgd(0.05),
        acc.GradAccumConfig(num_micro_batches=K, first_step_quirk=False, skip_nonfinite=True,
                            loss_scale=LossScaleConfig(init_scale=16.0, growth_interval=1)),
        RunConfig(model_dir=None, log_step_count_steps=1, drain_consensus=consensus,
                  sentinel=train_snt),
        mode="streaming", device=device)
    with faults.installed(faults.FaultInjector(faults.FaultSchedule([storm]))):
        state = est.train(data, max_steps=n_steps)
    est.close()
    storm_fires = [a for a in train_snt.anomalies
                   if a.kind == obs_sentinel.SCALE_STORM and a.state == "fire"]
    _check(storm_fires, "[chaos/ops] the overflow storm raised no scale_storm anomaly")
    _check(est.drained_at_step is not None,
           "[chaos/ops] the scale_storm remediation never drained through the consensus")
    _check(state.step == est.drained_at_step < n_steps,
           f"[chaos/ops] stopped at {state.step}, drained at {est.drained_at_step}")
    detail["train"] = {"fault_to_alert": {"overflow_storm": "scale_storm"},
                       "storm_at": [storm.at, storm.span],
                       "drained_at_step": est.drained_at_step}
    log(f"[chaos/ops] train PASS: overflow_storm->scale_storm, remediation->drain consensus "
        f"(stopped at step={est.drained_at_step}/{n_steps})")

    # -- leg C: seeded simulation alert streams are byte-identical
    def sim_alert_streams():
        eng = Engine(params, cfg, num_slots=2, max_len=32, tracer=obs_trace.NullTracer(),
                     scheduler=Scheduler(max_queue=2), device=device)
        driver = SimulationDriver(eng, seed=seed + 6)
        trace = driver.make_trace(24, arrival_rate=0.9, prompt_len=(1, 6), max_new=(4, 10))
        clock = lambda: float(eng.tick_count)  # noqa: E731
        slo = SLOEvaluator(
            [Objective("sim/queue_wait_p99", "serving/queue_wait", threshold=2.0, target=0.5,
                       windows=((16.0, 1.0), (8.0, 1.0))),
             Objective("sim/rejected_rate", "serving/rejected_total", threshold=0.2,
                       target=0.5, windows=((16.0, 1.0), (8.0, 1.0)))],
            registry=eng.metrics.registry, clock=clock, tracer=obs_trace.NULL)
        sim_snt = Sentinel(clock=clock, tracer=obs_trace.NULL, lease=8.0)
        pending = sorted(enumerate(trace), key=lambda it: it[1].arrival_tick)
        while pending or not eng.idle:
            still = []
            for idx, item in pending:
                if item.arrival_tick > eng.tick_count:
                    still.append((idx, item))
                    continue
                try:
                    eng.submit(item.prompt, item.max_new_tokens, rng_seed=item.rng_seed)
                except QueueFull:
                    still.append((idx, item))
            pending = still
            eng.step()
            sim_snt.heartbeat(tick=eng.tick_count, busy=not eng.idle)
            sim_snt.check()
            slo.tick()
        return slo.alerts_bytes(), sim_snt.anomalies_bytes(), len(slo.alerts)

    a1, s1, n_alerts = sim_alert_streams()
    a2, s2, _ = sim_alert_streams()
    _check(n_alerts > 0, "[chaos/ops] the overload sim never fired an alert")
    _check(a1 == a2, "[chaos/ops] seeded sim SLO alert streams differ between runs")
    _check(s1 == s2, "[chaos/ops] seeded sim anomaly logs differ between runs")
    detail["sim_determinism"] = {"alerts": n_alerts, "byte_identical": True}
    log(f"[chaos/ops] sim PASS: {n_alerts} alert transition(s), byte-identical across two "
        "seeded runs")
    return detail


def tick_median(engine, prompts, n=8) -> float:
    """Warm every program on ``prompts[:2]`` (``n`` tokens each) outside any
    watched window; returns the median seconds of those healthy ticks."""
    import numpy as np

    for p in prompts[:2]:
        engine.submit(p, n)
    ticks = []
    while not engine.idle:
        t0 = time.perf_counter()
        engine.step()
        ticks.append(time.perf_counter() - t0)
    for rid in list(engine.results):
        engine.pop_result(rid)
    return float(np.median(ticks))


def degrade(engine, arm_at, delay, healable=True):
    """From tick ``arm_at`` on, every step of ``engine`` sleeps ``delay``
    seconds until ``recover()`` runs (with ``healable``; else nothing clears
    it). Arming on the tick clock, inside ``step``, keeps the schedule the
    same whatever the host's speed. Returns the state dict: ``on``, and
    ``recovers`` (calls of recover)."""
    state = {"on": False, "armed": False, "recovers": 0}
    orig_step, orig_recover = engine.step, engine.recover

    def step():
        if not state["armed"] and engine.tick_count >= arm_at:
            state["armed"] = state["on"] = True
        if state["on"]:
            time.sleep(delay)
        return orig_step()

    def recover():
        state["recovers"] += 1
        if healable:
            state["on"] = False
        return orig_recover()

    engine.step = step
    engine.recover = recover
    return state


def _healer_chaos(seed: int, log, plan, device):
    """The escalation ladder ENABLED over the seeded schedule, both legs on
    the engine's tick clock. (a) HEALABLE: a persistent degradation arms
    mid-traffic; the latency_cliff ladder heals it through recover/requeue
    with parity. (b) UNHEALABLE: recover does NOT clear it; the ladder
    escalates through a healer-tagged pool grow (initiator "healer" on the
    result and the metrics) and then freezes TERMINALLY (``healer_frozen``,
    severity page) instead of thrashing, every stream parity-clean."""
    import numpy as np

    from gradaccum_tpu_torch.obs import sentinel as obs_sentinel
    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.resilience import remediation
    from gradaccum_tpu_torch.resilience.healer import Healer
    from gradaccum_tpu_torch.serving import Engine, ServingServer

    cfg, params = _model(device)
    detail = {}
    arm_offset = plan["healer_degrade_tick"]
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(2, 7)),)).astype(np.int32)
               for _ in range(4)]

    def sentinel(engine):
        return Sentinel(clock=lambda: float(engine.tick_count), cliff_warmup=4,
                        cliff_consecutive=2, cliff_score=6.0, lease=60.0)

    # -- leg A: healable, the cliff heals through recover + requeue
    engine = Engine(params, cfg, num_slots=2, max_len=64, device=device)
    delay = max(DEGRADE_FACTOR * tick_median(engine, prompts), DEGRADE_FLOOR)
    wedge = degrade(engine, engine.tick_count + arm_offset, delay, healable=True)
    snt = sentinel(engine)
    server = ServingServer(engine, max_requeues=6, max_engine_faults=6, sentinel=snt)
    healer = Healer(snt, {obs_sentinel.LATENCY_CLIFF: [remediation.recover_rung(server)]},
                    verify_window=20.0, cooldown=0.5)
    server.attach_healer(healer)
    log(f"[chaos/healer] healable leg: degradation of {delay * 1e3:.1f} ms a tick arms "
        f"{arm_offset} ticks in")
    with server:
        results = [h.result(timeout=300) for h in [server.submit(p, 24) for p in prompts]]
    _check(healer.healed_total >= 1,
           f"[chaos/healer] the ladder never healed the cliff ({snt.status()})")
    _check(wedge["armed"] and not wedge["on"],
           "[chaos/healer] recover never reached the degraded engine")
    _check(not healer.frozen(), f"[chaos/healer] frozen: {healer.frozen()}")
    _check_parity("healer", params, cfg, prompts, results, 24)
    detail["healable"] = {"healed": healer.healed_total,
                          "mttr": [round(h["mttr"], 3) for h in healer.heal_log],
                          "actions": healer.actions_total, "delay_s": delay}
    log(f"[chaos/healer] healable PASS: {healer.healed_total} heal(s) via recover_requeue "
        f"(MTTR {detail['healable']['mttr']} ticks), parity clean")

    # -- leg B: unhealable, escalate to a healer-tagged reconfiguration, then
    # freeze terminally
    nb = plan["healer_pool_blocks"]
    engine = Engine(params, cfg, num_slots=2, max_len=64, page_size=4, num_blocks=nb,
                    device=device)
    delay = max(DEGRADE_FACTOR * tick_median(engine, prompts), DEGRADE_FLOOR)
    wedge = degrade(engine, engine.tick_count + arm_offset, delay, healable=False)
    snt = sentinel(engine)
    server = ServingServer(engine, max_requeues=8, max_engine_faults=8, sentinel=snt)
    healer = Healer(snt, {obs_sentinel.LATENCY_CLIFF: [
        remediation.recover_rung(server), remediation.pool_grow_rung(server, factor=1.5)]},
        verify_window=1.0, cooldown=0.5, flap_limit=32)
    server.attach_healer(healer)
    log(f"[chaos/healer] unhealable leg: {nb} blocks, ladder recover -> pool_grow -> frozen")
    with server:
        handles = [server.submit(p, 24) for p in prompts]
        deadline = time.monotonic() + 120
        while not healer.frozen() and not all(h.done for h in handles) \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        actions_at_freeze = healer.actions_total
        results = [h.result(timeout=300) for h in handles]
        stats = server.stats()
    frozen = healer.frozen()
    _check(frozen and frozen[0]["why"] == "exhausted",
           f"[chaos/healer] ladder did not freeze terminally: {frozen}")
    _check(healer.actions_total == actions_at_freeze, "[chaos/healer] the frozen ladder "
                                                      "kept acting")
    _check(engine.num_blocks > nb, "[chaos/healer] the pool_grow rung never applied its "
                                   "reconfiguration")
    by_init = engine.metrics.reconfigs_by_initiator
    _check(by_init.get("healer", 0) >= 1 and engine.last_reconfig.initiator == "healer",
           f"[chaos/healer] reconfigs by initiator {by_init}")
    frozen_fires = [a for a in snt.anomalies
                    if a.kind == obs_sentinel.HEALER_FROZEN and a.state == "fire"]
    _check(len(frozen_fires) == 1 and frozen_fires[0].severity == "page",
           f"[chaos/healer] healer_frozen fires {[a.to_dict() for a in frozen_fires]}")
    _check(stats["healer"]["frozen_total"] == 1, f"[chaos/healer] {stats['healer']}")
    _check_parity("healer", params, cfg, prompts, results, 24)
    detail["unhealable"] = {"escalations": healer.actions_total,
                            "pool_blocks": [nb, engine.num_blocks],
                            "reconfigs_by_initiator": dict(by_init),
                            "frozen_reason": frozen[0]["why"],
                            "healer_frozen_severity": frozen_fires[0].severity}
    log(f"[chaos/healer] unhealable PASS: escalated through a healer-tagged pool grow "
        f"({nb}->{engine.num_blocks} blocks), froze terminally, parity clean")
    return detail


def _fleet_chaos(seed: int, log, plan, device):
    """A seeded ``replica_kill`` at a ``FLEET_STEP`` poll resolves DEAD through
    the membership ladder, the excision is proof-gated (partial consensus
    WITHOUT the corpse's vote), every displaced stream finishes token for
    token on a survivor, and a live ``replica_add`` restores full strength
    and serves a fresh batch over the widened id lattice."""
    import numpy as np

    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import ReplicatedEngine, replica_add, replica_excise
    from gradaccum_tpu_torch.serving import fleet as fleet_lib

    rng = np.random.default_rng(seed + 13)
    cfg, params = _model(device)
    target, kill_poll = plan["fleet_kill_target"], plan["fleet_kill_poll"]
    fleet = ReplicatedEngine(params, cfg, replicas=2, tp=None, num_slots=3, max_len=48,
                             fleet_lease_ttl=5.0, fleet_suspect_after=2.0, device=device)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(2, 8)),)).astype(np.int32)
               for _ in range(6)]
    reqs = {fleet.submit(p, 12): p for p in prompts}
    log(f"[chaos/fleet] plan: replica_kill target={target} at FLEET_STEP {kill_poll}")
    injector = faults.FaultInjector(faults.FaultSchedule([
        faults.FaultSpec(faults.FLEET_STEP, at=kill_poll, kind=faults.KIND_REPLICA_KILL,
                         target=target)]))
    with faults.installed(injector):
        for _ in range(80):
            fleet.step()
            if fleet.fleet.state(target) == fleet_lib.DEAD:
                break
    _check(injector.fired, "[chaos/fleet] the seeded replica_kill never fired")
    _check(fleet.fleet.state(target) == fleet_lib.DEAD,
           f"[chaos/fleet] kill never resolved DEAD: {fleet.fleet.states()}")
    dead_t = next(t for t in fleet.fleet.log if t.new == fleet_lib.DEAD)
    res = fleet.reconfigure(replica_excise(target))
    _check(res.ok, f"[chaos/fleet] excision refused: {res.reason}")
    proof = res.detail["excise_proof"]
    _check(proof["valid"] and target in proof["absent"] and target not in proof["voters"],
           f"[chaos/fleet] proof {proof}")
    moved = dict(res.detail["resubmitted"])
    fleet.run_until_idle()
    for rid, p in reqs.items():
        toks, status = fleet.pop_result(moved.get(rid, rid))
        _check(status == "done" and [int(t) for t in toks] == _solo(params, cfg, p, 12),
               f"[chaos/fleet] request {rid} ended {status} or differs")
    _check(fleet.replicas[target].idle, "[chaos/fleet] work landed on the corpse")
    add = fleet.reconfigure(replica_add())
    _check(add.ok and len(fleet.active_replicas) == 2,
           f"[chaos/fleet] replica_add {add.to_dict()}, active {fleet.active_replicas}")
    fresh = {fleet.submit(p, 8): p for p in
             [rng.integers(0, cfg.vocab_size, 4).astype(np.int32) for _ in range(4)]}
    fleet.run_until_idle()
    for rid, p in fresh.items():
        toks, status = fleet.pop_result(rid)
        _check(status == "done" and [int(t) for t in toks] == _solo(params, cfg, p, 8),
               f"[chaos/fleet] fresh request {rid} ended {status} or differs")
    fleet.close()
    log(f"[chaos/fleet] PASS: kill@{kill_poll} -> DEAD ({dead_t.reason}) -> proof-gated excise "
        f"({len(moved)} stream(s) rebound) -> replica_add restored "
        f"{len(fleet.active_replicas)} active, parity clean")
    return {"kill": {"target": target, "poll": kill_poll}, "dead_reason": dead_t.reason,
            "excise_proof": proof, "displaced_resubmitted": len(moved),
            "added_replica": add.detail["replica"], "requests": len(reqs) + len(fresh)}


def run_one(seed: int, log=print, device="cuda") -> dict:
    """Every chaos phase under ONE seeded plan; returns the detail dict
    (raises ChaosFailure, an AssertionError, on any gate failure)."""
    from gradaccum_tpu_torch.obs.trace import Tracer
    from gradaccum_tpu_torch.obs.trace import installed as tracer_installed

    detail = {}
    plan = draw_plan(seed)
    detail["plan"] = dict(plan)
    log(f"[chaos] unified plan (seed {seed}): {plan}")

    def train():
        with tempfile.TemporaryDirectory() as work:
            return _train_chaos(seed, work, log, plan, device)

    phases = {
        "train": train,
        "serve": lambda: _serve_chaos(seed, log, plan, device),
        "paged": lambda: _paged_chaos(seed, log, plan, device),
        "reconfig": lambda: _reconfig_chaos(seed, log, plan, device),
        "ops": lambda: _ops_chaos(seed, log, device),
        "healer": lambda: _healer_chaos(seed, log, plan, device),
        "fleet": lambda: _fleet_chaos(seed, log, plan, device),
    }
    # one unbounded tracer across all phases: every fault, recover, resume
    # and request lands on one correlated timeline, and nothing is evicted
    # before the assertions read it back
    with tracer_installed(Tracer(capacity=None)):
        for name, phase in phases.items():
            t0 = time.perf_counter()
            detail[name] = phase()
            detail[name]["seconds"] = round(time.perf_counter() - t0, 3)
    return detail


REQUIRED = ("ONE seeded schedule across train+serve (kill+storm+ckpt IO, serve tick crash+slow "
            "tick, paged page-table corruption+swap-IO error, reconfig kill+pool-shrink+"
            "checkpoint-swap under load + host-lease expiry): clean resume, non-empty final "
            "checkpoint, greedy serving parity, every injected fault in a flight-recorder dump "
            "with downstream activity; the paged admission plane heals table corruption via "
            "recover/requeue and degrades swap-IO to re-prefill, parity-clean; the reconfig "
            "plane survives a MID_RECONFIG kill, completes shrink+swap with zero drops and "
            "greedy parity, and a 2-host consensus resolves a gone host's round without the "
            "barrier timeout; ops plane: each fault class raises its matching alert "
            "(crash->engine_fault, slow_tick->latency_cliff, overflow_storm->scale_storm), "
            "sentinel remediation fires through the recover/requeue/drain contract with the "
            "post-remediation stream token-parity clean, and seeded simulation alert streams "
            "are byte-identical; healer phase (ladder ENABLED): a healable persistent "
            "degradation heals autonomously through recover/requeue with parity, an unhealable "
            "one escalates through a healer-tagged pool-grow reconfig (initiator=healer) and "
            "freezes TERMINALLY (healer_frozen, severity page, zero actions after the freeze); "
            "fleet phase: a seeded replica_kill at a FLEET_STEP resolves DEAD through the "
            "membership lease ladder, the excision is proof-gated (partial consensus without "
            "the corpse's vote), displaced streams finish token-for-token on survivors, and a "
            "live replica_add restores full strength with parity over the widened id lattice")


def run(seeds, device="cuda", log=print) -> dict:
    """Every seed of ``seeds``; the artifact (a failed seed is recorded, not
    raised)."""
    passed, per_seed = True, {}
    for seed in seeds:
        try:
            per_seed[seed] = run_one(seed, log, device)
        except AssertionError as e:
            log(f"[chaos] FAIL (seed {seed}): {e}")
            per_seed[seed] = {"failed": str(e)}
            passed = False
    # one seed keeps JAX's artifact shape (detail.train, detail.serve, ...);
    # a sweep nests every seed under per_seed beside the first seed's phases
    detail = dict(per_seed[seeds[0]])
    if len(seeds) > 1:
        detail["per_seed"] = {str(s): d for s, d in per_seed.items()}
    return {"bench": "seeded chaos smoke (train + serve)", "device": str(device),
            "seed": seeds[0], "seeds": list(seeds), "detail": detail,
            "acceptance": {"required": REQUIRED, "passed": passed}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0xC8A05)
    ap.add_argument("--seed-range", type=int, default=1,
                    help="run the whole schedule for N consecutive seeds")
    ap.add_argument("--json", default=None,
                    help="write the artifact here (default: a new file in the temporary "
                         "directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    seeds = list(range(args.seed, args.seed + max(1, args.seed_range)))
    artifact = run(seeds, device)
    out = args.json
    if out is None:
        fd, out = tempfile.mkstemp(prefix="chaos_smoke_", suffix=".json")
        os.close(fd)
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1, default=str)
        f.write("\n")
    artifact["path"] = out
    print(f"[chaos] {'PASS' if artifact['acceptance']['passed'] else 'FAIL'}; wrote {out}")
    return artifact


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
