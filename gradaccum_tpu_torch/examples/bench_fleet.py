"""Fleet availability through a seeded replica kill: excision against none.

The port of ``tools/bench_fleet.py``. When a replica dies mid-traffic (a
seeded ``replica_kill`` at a ``FLEET_STEP``), how much of the offered work
does a SUPERVISED fleet finish within a tick budget (lease ladder -> DEAD ->
proof-gated excision -> displaced streams replayed on the survivors),
against the same fleet with a lease that never expires (the corpse is never
declared, its streams stall)?

One seeded schedule drives both legs: the same prompts, dispatch and kill.
Availability = finished streams / offered streams at the shared budget.
JAX's acceptance: supervised availability >= 1.5x the baseline's, the
supervised leg finishing every stream with its solo ``generate_cached``
stream (greedy, token for token), parity on every finished stream in both
legs, a valid partial-consensus excise proof, and a live ``replica_add``
after the excision restoring full strength with parity on a fresh batch.
Leases and budgets count fleet ticks, so the ratio is the device's own.

Every replica shares the one card. The model is GPT's ``tiny_for_tests``
config with random weights (seed 0); ``--json FILE`` writes the whole
result (no default file, so JAX's ``BENCH_fleet.json`` is never
overwritten). Runs on the card unless ``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_fleet [--fast] [--json FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

KILL_AT = 3          # the FLEET_STEP poll index the kill lands on
KILL_TARGET = 1      # the member that dies
MAX_NEW = 16         # tokens per stream
GATE = 1.5           # JAX's acceptance on the availability ratio


def _solo(params, cfg, prompt, n):
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    return [int(t) for t in generate_cached(params, cfg, prompt, n)[0, prompt.size:]]


def _run_leg(params, cfg, seed, supervised, streams, budget_ticks, device, log=print):
    import numpy as np

    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import (
        ReplicatedEngine,
        fleet as fleet_lib,
        replica_add,
        replica_excise,
    )

    rng = np.random.default_rng(seed)
    # the baseline keeps the engine and dispatch but a lease that never
    # expires: the kill still halts the member's ticks, no verdict is reached
    ttl, suspect = (5.0, 2.0) if supervised else (1e9, 0.5e9)
    fleet = ReplicatedEngine(params, cfg, replicas=2, tp=None, num_slots=3, max_len=48,
                             fleet_lease_ttl=ttl, fleet_suspect_after=suspect, device=device)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(2, 8)),)).astype(np.int32)
               for _ in range(streams)]
    reqs = {fleet.submit(p, MAX_NEW): p for p in prompts}
    plan = faults.FaultSchedule([faults.FaultSpec(faults.FLEET_STEP, at=KILL_AT,
                                                  kind=faults.KIND_REPLICA_KILL,
                                                  target=KILL_TARGET)])
    finish_tick = {}
    kill_tick = dead_tick = excise_tick = None
    moved, proof = {}, None
    t0 = time.monotonic()
    with faults.installed(faults.FaultInjector(plan)):
        for tick in range(budget_ticks):
            for rid, _ in fleet.step().finished:
                finish_tick.setdefault(rid, tick)
            sup = fleet.fleet
            if kill_tick is None and sup.halted(KILL_TARGET):
                kill_tick = tick
            if supervised:
                if dead_tick is None and sup.state(KILL_TARGET) == fleet_lib.DEAD:
                    dead_tick = tick
                if dead_tick is not None and excise_tick is None:
                    res = fleet.reconfigure(replica_excise(KILL_TARGET))
                    if res.ok:
                        excise_tick = tick
                        proof = res.detail["excise_proof"]
                        moved = dict(res.detail["resubmitted"])
            if len(finish_tick) == streams:
                break
    wall = time.monotonic() - t0
    parity, finished = True, 0
    for rid, p in reqs.items():
        rid = moved.get(rid, rid)
        if rid not in finish_tick:  # stranded on the corpse
            continue
        finished += 1
        tokens, status = fleet.pop_result(rid)
        if status != "done" or [int(t) for t in tokens] != _solo(params, cfg, p, MAX_NEW):
            parity = False
    leg = {
        "streams": streams,
        "finished": finished,
        "availability": round(finished / streams, 4),
        "budget_ticks": budget_ticks,
        "kill_tick": kill_tick,
        "dead_tick": dead_tick,
        "excise_tick": excise_tick,
        "mttr_ticks": (excise_tick - kill_tick
                       if excise_tick is not None and kill_tick is not None else None),
        "excise_proof": proof,
        "displaced_resubmitted": len(moved),
        "parity": parity,
        "wall_s": round(wall, 2),
    }
    if supervised and excise_tick is not None:
        # a live ADD after the excision: full strength again, fresh traffic
        # served token for token over the widened id lattice
        res = fleet.reconfigure(replica_add())
        add_parity = False
        if res.ok:
            fresh = {fleet.submit(p, 8): p for p in
                     [rng.integers(0, cfg.vocab_size, size=(4,)).astype(np.int32)
                      for _ in range(4)]}
            fleet.run_until_idle()
            add_parity = True
            for rid, p in fresh.items():
                tokens, status = fleet.pop_result(rid)
                if status != "done" or [int(t) for t in tokens] != _solo(params, cfg, p, 8):
                    add_parity = False
        leg["add_after_excise"] = {"ok": bool(res.ok),
                                   "active_replicas": len(fleet.active_replicas),
                                   "parity": add_parity}
    name = "supervised" if supervised else "no-excision"
    log(f"[fleet/{name}] {finished}/{streams} finished (availability {leg['availability']}), "
        f"kill@{kill_tick} dead@{dead_tick} excise@{excise_tick}, parity={parity}, "
        f"wall {wall:.2f} s")
    fleet.close()
    return leg


def run(params, cfg, fast=False, seed=0xF1EE7, budget_ticks=200, device="cuda", log=print):
    """Both legs from one seed; the artifact."""
    streams = 6 if fast else 9
    log(f"[fleet] seed {seed}: {streams} streams, replica_kill target={KILL_TARGET} at "
        f"FLEET_STEP {KILL_AT}, budget {budget_ticks} ticks")
    sup = _run_leg(params, cfg, seed, True, streams, budget_ticks, device, log)
    base = _run_leg(params, cfg, seed, False, streams, budget_ticks, device, log)
    ratio = round(sup["availability"] / base["availability"], 2) if base["availability"] \
        else None
    proof = sup.get("excise_proof") or {}
    restored = sup.get("add_after_excise") or {}
    passed = bool(ratio is not None and ratio >= GATE and sup["finished"] == streams
                  and sup["parity"] and base["parity"] and sup["mttr_ticks"] is not None
                  and proof.get("valid") and restored.get("ok") and restored.get("parity")
                  and restored.get("active_replicas") == 2)
    log(f"[fleet] {'PASS' if passed else 'FAIL'}: availability ratio {ratio} (supervised "
        f"{sup['availability']} vs no-excision {base['availability']})")
    return {
        "bench": "fleet availability through a seeded replica kill: "
                 "lease->DEAD->excise->rebind vs no supervision (tick clock)",
        "device": str(device),
        "seed": seed,
        "config": {"streams": streams, "replicas": 2,
                   "kill": {"at": KILL_AT, "target": KILL_TARGET},
                   "budget_ticks": budget_ticks, "max_new_tokens": MAX_NEW},
        "supervised": sup,
        "no_excision": base,
        "availability_ratio": ratio,
        "acceptance": {
            "required": f"supervised availability >= {GATE}x the no-excision baseline over "
                        "one seeded replica_kill schedule, the supervised leg finishing EVERY "
                        "stream with greedy token parity, parity in both legs, a valid partial "
                        "excise proof, and replica_add after the excision restoring full "
                        "strength with parity on a fresh batch",
            "passed": passed,
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0xF1EE7)
    ap.add_argument("--fast", action="store_true", help="6 streams instead of 9")
    ap.add_argument("--budget-ticks", type=int, default=200,
                    help="the shared tick budget both legs are measured at")
    ap.add_argument("--json", default=None, help="write the whole result here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    artifact = run(params_tree(gpt_lm_bundle(cfg).init(0, device)), cfg, args.fast, args.seed,
                   args.budget_ticks, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1, default=str)
            f.write("\n")
    return artifact


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
