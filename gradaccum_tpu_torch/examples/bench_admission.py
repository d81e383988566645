"""Admission-policy benchmark: reserve, quantile and optimistic at equal memory.

The port of ``tools/bench_admission.py``. A long-tail workload (every
request declares a long ``max_new_tokens``; most stop early at an eos picked
from the request's own solo greedy stream, every ``long_every``-th runs its
whole budget) goes through three engines that differ only in the admission
gate, at the same pool memory:

- ``reserve``: worst-case reservations, concurrency capped by budgets that
  mostly never fill;
- ``quantile``: reserve at the observed length quantile (q 0.75), preempt
  when wrong;
- ``optimistic``: reserve the prompt and one page, preempt on pressure.

Per leg, on the tick clock: completed requests per 1k ticks, peak
concurrency, preemptions, swap-ins, re-prefills, swap bytes, the parked
peak, and each stream against its solo ``generate_cached`` greedy stream;
wall tokens/s beside them. JAX's acceptance: the best overcommitting leg
clears 1.5x reserve on requests per 1k ticks or on peak concurrency, parity
on every leg, and at least one real preemption in the optimistic leg.

The model is GPT's ``tiny_for_tests`` config with random weights from
``--seed``. One JSON line per leg on standard output and the acceptance;
``--out FILE`` writes the whole result (no default file, so JAX's
``BENCH_admission.json`` is never overwritten). Runs on the card unless
``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_admission [--fast] [--out FILE]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

DECLARED_NEW = 20


def shapes(fast: bool) -> dict:
    """The pool every leg gets: ``--fast`` shrinks it with the workload, or
    the optimistic leg would never come under pressure."""
    return dict(num_slots=8, page_size=4, num_blocks=10 if fast else 16,
                declared_new=DECLARED_NEW, max_len=32)


def make_workload(params, cfg, n_requests: int, declared_new: int, seed: int,
                  long_every: int = 5):
    """Long-tail traffic: each request declares ``declared_new`` tokens and
    stops at an eos chosen from its own solo greedy stream near a geometric
    target length; every ``long_every``-th request has no eos."""
    import numpy as np

    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_requests):
        prompt = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
        solo = generate_cached(params, cfg, prompt, declared_new)[0, prompt.size:].tolist()
        if i % long_every == long_every - 1:
            items.append({"prompt": prompt, "eos": None, "want": list(solo)})
            continue
        target = min(int(rng.geometric(0.25)) + 2, declared_new - 1)
        # candidate stops: positions whose token first occurs there
        stops = [k for k in range(1, len(solo)) if solo[k] not in solo[:k]]
        eos, want = None, list(solo)
        if stops:
            k = min(stops, key=lambda s: abs(s - (target - 1)))
            eos, want = int(solo[k]), list(solo[:k + 1])
        items.append({"prompt": prompt, "eos": eos, "want": want})
    return items


def run_leg(params, cfg, items, admission, *, num_slots, page_size, num_blocks, declared_new,
            max_len, device="cuda"):
    """One engine over the workload until it drains. Returns the leg's
    numbers and its streams (the parity check is ``parity_ok``)."""
    import torch

    from gradaccum_tpu_torch.serving import AdmissionPolicy, Engine, Scheduler

    name = (admission.mode if isinstance(admission, AdmissionPolicy)
            else (admission or "reserve"))
    engine = Engine(params, cfg, num_slots=num_slots, max_len=max_len, page_size=page_size,
                    num_blocks=num_blocks, admission=admission,
                    scheduler=Scheduler(max_queue=len(items)), device=device)
    rids = [engine.submit(it["prompt"], declared_new, eos_id=it["eos"]) for it in items]
    peak = ticks = 0
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    while not engine.idle:
        engine.step()
        ticks += 1
        peak = max(peak, engine.pool.active_count)
        if ticks > 100_000:
            raise RuntimeError("leg did not drain")
    wall = time.perf_counter() - t0
    streams = [list(engine.results[r]) for r in rids]
    parity = all(s == it["want"] and engine.status[r] == "done"
                 for r, s, it in zip(rids, streams, items))
    m = engine.metrics
    leg = {
        "admission": name,
        "ticks_to_drain": ticks,
        "requests_per_1k_ticks": round(len(items) / ticks * 1000, 2),
        "peak_concurrency": peak,
        "preemptions": m.preemptions,
        "swap_outs": m.swap_outs,
        "swap_ins": m.swap_ins,
        "reprefills": m.reprefills,
        "swap_bytes_out": m.swap_bytes_out,
        "parked_peak": m.parked_peak,
        "parity_ok": bool(parity),
        "wall_s": wall,
        "tokens_per_s": sum(len(s) for s in streams) / wall,
    }
    return leg, streams


def policies():
    """The three gates, reserve first (the baseline)."""
    from gradaccum_tpu_torch.serving import AdmissionPolicy

    # q below the long-tail fraction: the estimate tracks the p50 crowd
    return [None, AdmissionPolicy(mode="quantile", q=0.75, min_samples=6), "optimistic"]


def acceptance(legs) -> dict:
    """JAX's rule over the legs (reserve first)."""
    base = legs[0]
    rate_x = max(leg["requests_per_1k_ticks"] for leg in legs[1:]) / \
        base["requests_per_1k_ticks"]
    peak_x = max(leg["peak_concurrency"] for leg in legs[1:]) / base["peak_concurrency"]
    opt = next(leg for leg in legs if leg["admission"] == "optimistic")
    parity = all(leg["parity_ok"] for leg in legs)
    return {
        "admitted_rate_x": round(rate_x, 3),
        "peak_concurrency_x": round(peak_x, 3),
        "required": ">= 1.5x admitted-requests/s or peak concurrency vs the reserve "
                    "baseline at equal pool memory, greedy token parity on every leg, and "
                    ">= 1 forced preemption in the optimistic leg",
        "passed": bool(max(rate_x, peak_x) >= 1.5 and parity and opt["preemptions"] >= 1),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="fewer requests, a smaller pool")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None, help="write the whole result here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    params = params_tree(gpt_lm_bundle(cfg).init(args.seed, device))
    n_requests = 10 if args.fast else 28
    shape = shapes(args.fast)
    items = make_workload(params, cfg, n_requests, DECLARED_NEW, args.seed,
                          long_every=4 if args.fast else 5)
    actual = sorted(len(it["want"]) for it in items)
    legs = []
    for admission in policies():
        leg, _ = run_leg(params, cfg, items, admission, device=device, **shape)
        legs.append(leg)
        print(json.dumps(leg))
    acc = acceptance(legs)
    result = {
        "bench": "admission policy: reserve vs quantile vs optimistic (tick clock)",
        "device": str(device),
        "seed": args.seed,
        "workload": {"requests": n_requests, "declared_max_new": DECLARED_NEW,
                     "actual_p50": actual[len(actual) // 2], "actual_max": actual[-1],
                     **shape},
        "legs": legs,
        "admitted_rate_x": acc["admitted_rate_x"],
        "peak_concurrency_x": acc["peak_concurrency_x"],
        "acceptance": {"required": acc["required"], "passed": acc["passed"]},
    }
    print(json.dumps({"acceptance": result["acceptance"],
                      "admitted_rate_x": acc["admitted_rate_x"],
                      "peak_concurrency_x": acc["peak_concurrency_x"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
