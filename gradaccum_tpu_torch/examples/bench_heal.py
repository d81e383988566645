"""MTTR bench: the self-healing ladder against an operator stub.

The port of ``tools/bench_heal.py``. When a replica degrades persistently
(every tick slow until SOMETHING runs the recovery), how much faster does
the autonomous escalation ladder (``resilience/healer.py``) restore service
than a human watching the same sentinel would, with every healed stream
equal to its solo ``generate_cached`` stream token for token?

One seeded schedule drives both legs. A wedgeable engine arms a persistent
degradation at scheduled ticks (every later ``step()`` sleeps ``delay``
seconds) that ONLY ``recover()`` clears: the fault class where MTTR depends
on who notices and acts. Both legs run the same engine, traffic, sentinel
thresholds and anomaly clock: the sentinel's clock is the engine's tick
count, so MTTR (the ticks from an anomaly's fire to its resolve) comes out
in ticks, the device's own unit, whatever the host's speed.

- **healer leg**: ``Sentinel`` + ``Healer`` with the stock
  ``latency_cliff -> recover+requeue`` rung, polled by the serving loop;
- **operator-stub leg**: the same sentinel, no healer; a stub thread watches
  ``sentinel.anomalies`` and requests the SAME recovery once an anomaly has
  been firing for ``--op-delay-ticks`` ticks (the optimistic floor for a
  paged human).

Availability = the share of ticks NOT spent degraded. JAX's acceptance:
healer MTTR >= 1.5x better than the operator stub's, parity on every stream
in both legs, and the flap leg (an adversarial schedule that re-degrades
after every heal) TERMINAL: the ladder frozen, ``healer_frozen`` fired once
at severity page, no action after the freeze.

The model is GPT's ``tiny_for_tests`` config with random weights (seed 0).
``--json FILE`` writes the whole result; nothing is written without it (JAX's
``BENCH_heal.json`` is never touched). Runs on the card unless
``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_heal [--seed N] [--fast] [--delay S]
        [--op-delay-ticks N] [--json FILE] [--flight-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

GATE = 1.5  # JAX's acceptance on the MTTR ratio
MAX_NEW = 48  # tokens per stream


def _make_wedgeable(engine, degrade_at, delay):
    """Instrument one engine with a seeded persistent degradation: from each
    scheduled tick on, every step sleeps ``delay`` until recover() runs.
    Returns a state object with ``degraded_ticks``/``total_ticks`` counters
    and the armed ``intervals``."""

    class State:
        degraded = False
        degraded_ticks = 0
        total_ticks = 0
        intervals = []  # [arm_tick, recover_tick or None] per episode

    st = State()  # a class per call: no list is shared between legs
    schedule = sorted(degrade_at)
    idx = [0]
    orig_step, orig_recover = engine.step, engine.recover

    def step():
        if idx[0] < len(schedule) and engine.tick_count >= schedule[idx[0]]:
            if not st.degraded:
                st.degraded = True
                st.intervals.append([engine.tick_count, None])
            idx[0] += 1
        st.total_ticks += 1
        if st.degraded:
            st.degraded_ticks += 1
            time.sleep(delay)
        return orig_step()

    def recover():
        if st.degraded:
            st.degraded = False
            st.intervals[-1][1] = engine.tick_count
        return orig_recover()

    engine.step = step
    engine.recover = recover
    return st


def _mttr_pairs(anomalies, kind, intervals=None):
    """Fire->resolve tick pairs for ``kind`` from the anomaly log. With
    ``intervals`` (the degrader's armed windows) only fires raised WHILE
    degraded count as episodes: the recovery itself costs a slow tick or
    two, and those jitter cliffs must not dilute the real episodes' MTTR in
    either leg. Returns (real_pairs, jitter_pairs)."""
    pairs, fire_at = [], None
    for a in anomalies:
        if a.kind != kind:
            continue
        if a.state == "fire" and fire_at is None:
            fire_at = a.at
        elif a.state == "resolve" and fire_at is not None:
            pairs.append((fire_at, a.at))
            fire_at = None
    if intervals is None:
        return pairs, []
    real, jitter = [], []
    for f, r in pairs:
        armed = any(lo <= f and (hi is None or f <= hi) for lo, hi in intervals)
        (real if armed else jitter).append((f, r))
    return real, jitter


def _model(device):
    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle

    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    return cfg, params_tree(gpt_lm_bundle(cfg).init(0, device))


def _warm_engine(params, cfg, prompts, device):
    """A two-slot engine whose programs ran once outside the watched window
    (a first-call spike must not anchor the baseline)."""
    from gradaccum_tpu_torch.serving import Engine

    engine = Engine(params, cfg, num_slots=2, max_len=64, device=device)
    for p in prompts[:2]:
        engine.submit(p, 3)
    engine.run_until_idle()
    for rid in list(engine.results):
        engine.pop_result(rid)
    return engine


def _parity(params, cfg, prompts, results):
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    for prompt, (tokens, reason) in zip(prompts, results):
        want = generate_cached(params, cfg, prompt, MAX_NEW)[0, prompt.size:].tolist()
        if reason not in ("eos", "length") or [int(t) for t in tokens] != want:
            return False
    return True


def _prompts(rng, cfg, n):
    return [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(2, 6)),)).astype("int32")
            for _ in range(n)]


def _run_leg(params, cfg, seed, episodes, delay, op_delay_ticks, healer_on, device, log,
             flight=None):
    import numpy as np

    from gradaccum_tpu_torch.obs import sentinel as obs_sentinel
    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.resilience import remediation
    from gradaccum_tpu_torch.resilience.healer import Healer
    from gradaccum_tpu_torch.serving import ServingServer

    rng = np.random.default_rng(seed)
    prompts = _prompts(rng, cfg, 8)
    engine = _warm_engine(params, cfg, prompts, device)
    # the ONE seeded schedule: episode starts spaced far enough that even the
    # slow leg heals one episode before the next arms
    gaps = rng.integers(34, 46, size=episodes)
    starts = list(np.cumsum(gaps) - gaps[0] + 12)
    wedge = _make_wedgeable(engine, starts, delay)

    snt = Sentinel(clock=lambda: float(engine.tick_count), cliff_warmup=4,
                   cliff_consecutive=3, cliff_score=12.0, lease=1e9, flight=flight)
    server = ServingServer(engine, max_requeues=4 * episodes + 4,
                           max_engine_faults=4 * episodes + 4, sentinel=snt)
    healer = None
    if healer_on:
        healer = Healer(snt, {obs_sentinel.LATENCY_CLIFF: [remediation.recover_rung(server)]},
                        verify_window=30.0, cooldown=2.0, flap_limit=4 * episodes + 4,
                        budget_limit=4 * episodes + 4, budget_window=1e9)
        server.attach_healer(healer)

    stop_op = threading.Event()
    op_thread = None
    if not healer_on:
        acted = set()  # one action per fire record

        def operator():
            # the stub human: polls the same sentinel, runs the same
            # remediation, but only op_delay_ticks ticks after the page
            while not stop_op.is_set():
                for a in list(snt.anomalies):
                    if (a.kind == obs_sentinel.LATENCY_CLIFF and a.state == "fire"
                            and id(a) not in acted
                            and engine.tick_count - a.at >= op_delay_ticks
                            and snt.is_firing(a.kind, a.replica)):
                        acted.add(id(a))
                        server.request_recover("operator", replica=a.replica)
                stop_op.wait(0.005)

        op_thread = threading.Thread(target=operator, daemon=True)
        op_thread.start()

    t0 = time.monotonic()
    with server:
        handles = [server.submit(p, MAX_NEW) for p in prompts]
        results = [h.result(timeout=600) for h in handles]
    wall = time.monotonic() - t0
    stop_op.set()
    if op_thread is not None:
        op_thread.join(timeout=5)

    parity = _parity(params, cfg, prompts, results)
    pairs, jitter = _mttr_pairs(snt.anomalies, obs_sentinel.LATENCY_CLIFF, wedge.intervals)
    mttrs = [r - f for f, r in pairs]
    leg = {
        "episodes_armed": len(starts),
        "episode_starts": [int(s) for s in starts],
        "anomaly_episodes": len(pairs),
        "jitter_cliffs": len(jitter),
        "mttr_ticks": [round(m, 1) for m in mttrs],
        "mean_mttr_ticks": round(float(np.mean(mttrs)), 2) if mttrs else None,
        "degraded_ticks": wedge.degraded_ticks,
        "total_ticks": wedge.total_ticks,
        "availability": round(1.0 - wedge.degraded_ticks / max(wedge.total_ticks, 1), 4),
        "requests": len(results),
        "parity": parity,
        "wall_s": round(wall, 2),
    }
    if healer_on:
        leg["healed"] = healer.healed_total
        leg["actions"] = healer.actions_total
        leg["frozen"] = healer.frozen()
    name = "healer" if healer_on else "operator-stub"
    log(f"[heal/{name}] {len(pairs)} episode(s), mean MTTR {leg['mean_mttr_ticks']} ticks, "
        f"availability {leg['availability']}, parity={parity}, wall {wall:.1f} s")
    return leg


def _run_flap_leg(params, cfg, seed, delay, device, log):
    """The adversarial seed: the degradation re-arms a few ticks after every
    heal, so the ladder oscillates apply -> heal -> refire until the flap
    detector freezes it, and the freeze must be TERMINAL."""
    import numpy as np

    from gradaccum_tpu_torch.obs import sentinel as obs_sentinel
    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.resilience import remediation
    from gradaccum_tpu_torch.resilience.healer import Healer
    from gradaccum_tpu_torch.serving import ServingServer

    rng = np.random.default_rng(seed + 17)
    prompts = _prompts(rng, cfg, 6)
    engine = _warm_engine(params, cfg, prompts, device)
    # re-arm every 14 ticks: heal at t, refire near t+14; 3 heals inside the
    # flap window, then the 4th fire must freeze
    starts = [12 + 14 * i for i in range(12)]
    _make_wedgeable(engine, starts, delay)
    snt = Sentinel(clock=lambda: float(engine.tick_count), cliff_warmup=4,
                   cliff_consecutive=2, cliff_score=5.0, lease=1e9)
    server = ServingServer(engine, max_requeues=32, max_engine_faults=32, sentinel=snt)
    healer = Healer(snt, {obs_sentinel.LATENCY_CLIFF: [remediation.recover_rung(server)]},
                    verify_window=30.0, cooldown=1.0, flap_limit=3, flap_window=1e9,
                    budget_limit=64, budget_window=1e9)
    server.attach_healer(healer)
    with server:
        handles = [server.submit(p, MAX_NEW) for p in prompts]
        deadline = time.monotonic() + 300
        while (not healer.frozen() and not all(h.done for h in handles)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        actions_at_freeze = healer.actions_total
        results = [h.result(timeout=600) for h in handles]
    parity = _parity(params, cfg, prompts, results)
    frozen = healer.frozen()
    frozen_fires = [a for a in snt.anomalies
                    if a.kind == obs_sentinel.HEALER_FROZEN and a.state == "fire"]
    leg = {
        "frozen": bool(frozen),
        "frozen_reason": frozen[0]["why"] if frozen else None,
        "healer_frozen_fires": len(frozen_fires),
        "severity": frozen_fires[0].severity if frozen_fires else None,
        "heals_before_freeze": healer.healed_total,
        "actions_at_freeze": actions_at_freeze,
        "actions_final": healer.actions_total,
        "terminal": (bool(frozen) and healer.actions_total == actions_at_freeze
                     and len(frozen_fires) == 1),
        "requests": len(results),
        "parity": parity,
    }
    log(f"[heal/flap] frozen={leg['frozen']} ({leg['frozen_reason']}), "
        f"heals={leg['heals_before_freeze']}, actions {leg['actions_at_freeze']}->"
        f"{leg['actions_final']}, terminal={leg['terminal']}, parity={parity}")
    return leg


def run(params, cfg, fast=False, seed=0x4EA1, delay=0.06, op_delay_ticks=15, device="cuda",
        flight_dir=None, log=print):
    """The three legs from one seed; the artifact."""
    episodes = 2 if fast else 3
    flight = None
    if flight_dir:
        from gradaccum_tpu_torch.obs.flight import FlightRecorder

        os.makedirs(flight_dir, exist_ok=True)
        flight = FlightRecorder(flight_dir)
    log(f"[heal] seed {seed}: {episodes} persistent-degradation episode(s), delay {delay} s "
        f"a tick, operator stub acts after {op_delay_ticks} ticks")
    healer_leg = _run_leg(params, cfg, seed, episodes, delay, op_delay_ticks, True, device,
                          log, flight=flight)
    operator_leg = _run_leg(params, cfg, seed, episodes, delay, op_delay_ticks, False, device,
                            log)
    flap_leg = _run_flap_leg(params, cfg, seed, max(delay * 0.7, 0.03), device, log)

    ratio = None
    if healer_leg["mean_mttr_ticks"] and operator_leg["mean_mttr_ticks"]:
        ratio = round(operator_leg["mean_mttr_ticks"] / healer_leg["mean_mttr_ticks"], 2)
    passed = bool(
        ratio is not None and ratio >= GATE
        and healer_leg["anomaly_episodes"] >= 1 and operator_leg["anomaly_episodes"] >= 1
        and healer_leg["parity"] and operator_leg["parity"]
        and healer_leg.get("healed", 0) >= 1
        and flap_leg["terminal"] and flap_leg["parity"] and flap_leg["severity"] == "page")
    log(f"[heal] {'PASS' if passed else 'FAIL'}: MTTR ratio {ratio} (healer "
        f"{healer_leg['mean_mttr_ticks']} against operator {operator_leg['mean_mttr_ticks']} "
        f"ticks)")
    return {
        "bench": "self-healing MTTR against an operator stub under seeded persistent "
                 "degradation (tick clock)",
        "device": str(device),
        "seed": seed,
        "config": {"episodes": episodes, "delay_s": delay, "op_delay_ticks": op_delay_ticks,
                   "ladder": {"latency_cliff": ["recover_requeue"]}},
        "healer": healer_leg,
        "operator_stub": operator_leg,
        "mttr_ratio": ratio,
        "availability_delta": (
            None if not (healer_leg["availability"] and operator_leg["availability"])
            else round(healer_leg["availability"] - operator_leg["availability"], 4)),
        "flap": flap_leg,
        "acceptance": {
            "required": f"healer-on mean MTTR (anomaly-fire -> anomaly-resolve ticks) >= "
                        f"{GATE}x better than the operator stub's over ONE seeded "
                        "persistent-degradation schedule, both legs >= 1 healed episode with "
                        "greedy token parity on every stream, and the adversarial flap leg "
                        "TERMINAL: ladder frozen (flap), healer_frozen fired exactly once at "
                        "severity page, no ladder action after the freeze, parity intact",
            "passed": passed,
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0x4EA1)
    ap.add_argument("--fast", action="store_true", help="2 episodes instead of 3")
    ap.add_argument("--delay", type=float, default=0.06,
                    help="seconds each degraded tick sleeps")
    ap.add_argument("--op-delay-ticks", type=int, default=15,
                    help="ticks the operator stub takes to notice and act")
    ap.add_argument("--json", default=None, help="write the whole result here")
    ap.add_argument("--flight-dir", default=None,
                    help="a directory for the sentinel's flight dumps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg, params = _model(device)
    artifact = run(params, cfg, args.fast, args.seed, args.delay, args.op_delay_ticks, device,
                   args.flight_dir)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1, default=str)
            f.write("\n")
    return artifact


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
