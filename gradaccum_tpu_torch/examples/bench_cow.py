"""Copy-on-write partial pages: closing the ``len % page_size`` gap.

The port of ``tools/bench_cow.py``. Two experiments on the tick clock, at
equal pool memory:

1. **Capacity ladder.** A shared-system-prompt workload whose prompt ends
   mid-page runs through three engines that differ only in sharing:
   ``paged`` (quantile admission, no prefix cache: every stream stores its
   whole prompt), ``prefix`` (full pages shared, ``cow_tails=False``: the
   ``len % page_size`` tail recomputed and stored per stream) and ``cow``
   (partial tails shared copy-on-write, forked on write). Per leg: peak
   concurrency, requests per 1k ticks, mean KV bytes per stream in flight,
   the prefill bill, fork counts, and every request's greedy stream against
   its solo ``generate_cached``.
2. **Prefix-aware resume.** A preemption-heavy overcommitted trace with
   ``swap="recompute"``: without sharing every resume re-prefills prompt +
   generated; the COW engine re-adopts the live shared chunks and recomputes
   only the suffix. Per leg: re-prefill tokens per resume.

JAX's acceptance: >= 1.15x peak concurrency or >= 15 % fewer KV bytes per
stream for ``cow`` against ``paged``; prefix-aware resume cutting re-prefill
tokens >= 2x; greedy parity on the fixed, paged, prefix and cow legs.

The model is GPT's ``tiny_for_tests`` config with random weights (seed 0);
:func:`run` takes any decode tree (the tests pass JAX's weights).
``--out FILE`` writes the whole result (no default file, so JAX's
``BENCH_cow.json`` is never overwritten). Runs on the card unless
``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_cow [--fast] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _solo(params, cfg, prompt, n):
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    return [int(t) for t in generate_cached(params, cfg, prompt, n)[0, prompt.size:]]


def _make_workload(params, cfg, n_requests, sys_len, declared_new, seed):
    """Shared-system-prompt traffic with a SUB-PAGE prompt tail: every
    request is sys_prompt + a short unique tail, declares a long budget,
    and most stop early at an eos drawn from its own solo stream."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, cfg.vocab_size, sys_len).astype(np.int32)
    items = []
    for i in range(n_requests):
        tail = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(1, 4))).astype(np.int32)
        prompt = np.concatenate([sys_p, tail])
        solo = _solo(params, cfg, prompt, declared_new)
        eos = None
        want = solo
        if i % 4 != 3:  # 3 of 4 finish early; the rest are the long tail
            target = min(int(rng.geometric(0.3)) + 2, declared_new - 1)
            stops = [k for k in range(1, len(solo))
                     if solo[k] not in solo[:k]]
            if stops:
                k = min(stops, key=lambda s: abs(s - (target - 1)))
                eos = int(solo[k])
                want = solo[:k + 1]
        items.append({"prompt": prompt, "eos": eos, "want": want})
    return items


def _run_capacity_leg(params, cfg, items, name, *, num_slots, page_size,
                      num_blocks, declared_new, max_len, prefix, cow, device):
    from gradaccum_tpu_torch.serving import AdmissionPolicy, Engine, Scheduler

    engine = Engine(params, cfg, num_slots=num_slots, max_len=max_len,
                    page_size=page_size, num_blocks=num_blocks,
                    # quick-warming quantile (the bench_admission recipe):
                    # the capacity question is how far SHARING stretches a
                    # warmed gate, not how long warmup takes
                    admission=AdmissionPolicy(mode="quantile", q=0.75,
                                              min_samples=4),
                    prefix_cache=prefix, cow_tails=cow,
                    scheduler=Scheduler(max_queue=len(items)), device=device)
    rids = [engine.submit(it["prompt"], declared_new, eos_id=it["eos"])
            for it in items]
    peak = ticks = 0
    bytes_per_stream = []
    while not engine.idle:
        engine.step()
        ticks += 1
        active = engine.pool.active_count
        peak = max(peak, active)
        if active:
            bytes_per_stream.append(
                engine.pool.allocated_blocks * page_size
                * engine._token_bytes / active)
        if ticks > 100_000:
            raise RuntimeError(f"{name} leg did not drain")
    parity = all([int(t) for t in engine.results[r]] == it["want"]
                 and engine.status[r] == "done"
                 for r, it in zip(rids, items))
    m = engine.metrics
    return {
        "leg": name,
        "ticks_to_drain": ticks,
        "requests_per_1k_ticks": round(len(items) / ticks * 1000, 2),
        "peak_concurrency": peak,
        "kv_bytes_per_stream": round(sum(bytes_per_stream)
                                     / len(bytes_per_stream), 1),
        "prefill_tokens_computed": m.prefill_tokens_computed,
        "prefill_tokens_skipped": m.prefill_tokens_skipped,
        "cow_adoptions": m.cow_adoptions,
        "cow_forks": m.cow_forks,
        "preemptions": m.preemptions,
        "decode_programs": engine.decode_compile_count(),
        "parity_ok": bool(parity),
    }


def _run_resume_leg(params, cfg, items, name, *, num_slots, page_size,
                    num_blocks, declared_new, max_len, prefix, cow, device):
    """The preemption-heavy trace: optimistic admission on a pool too
    small for everyone forces real preempt->park->re-prefill cycles
    (swap='recompute' prices every resume in recomputed tokens)."""
    from gradaccum_tpu_torch.serving import Engine, Scheduler

    engine = Engine(params, cfg, num_slots=num_slots, max_len=max_len,
                    page_size=page_size, num_blocks=num_blocks,
                    admission="optimistic", swap="recompute",
                    prefix_cache=prefix, cow_tails=cow,
                    scheduler=Scheduler(max_queue=len(items)), device=device)
    rids = [engine.submit(it["prompt"], declared_new, eos_id=it["eos"])
            for it in items]
    ticks = 0
    while not engine.idle:
        engine.step()
        ticks += 1
        if ticks > 100_000:
            raise RuntimeError(f"{name} resume leg did not drain")
    parity = all([int(t) for t in engine.results[r]] == it["want"]
                 and engine.status[r] == "done"
                 for r, it in zip(rids, items))
    m = engine.metrics
    return {
        "leg": name,
        "reprefills": m.reprefills,
        "resume_prefill_tokens": m.resume_prefill_tokens,
        "resume_prefill_tokens_saved": m.resume_prefill_tokens_saved,
        "tokens_per_resume": (round(m.resume_prefill_tokens
                                    / m.reprefills, 2)
                              if m.reprefills else None),
        "parity_ok": bool(parity),
    }


def run(params, cfg, fast: bool = False, seed: int = 11, device="cpu") -> dict:
    """Both experiments on the decode tree ``params``; returns the result."""
    import numpy as np

    n_requests = 8 if fast else 20
    declared_new = 16
    # sys_len deliberately mid-page: 2 full pages + a 3-token tail at
    # page_size 4 — the len % page_size waste this bench prices
    # --fast shrinks the pool with the workload: a full-size pool under 8
    # requests never runs tight enough for sharing to show in admission
    shapes = dict(num_slots=6, page_size=4,
                  num_blocks=10 if fast else 14,
                  declared_new=declared_new, max_len=32)
    sys_len = 11
    print(f"[bench_cow] workload: {n_requests} requests behind a "
          f"{sys_len}-token system prompt (page_size "
          f"{shapes['page_size']}: {sys_len % shapes['page_size']}-token "
          f"partial tail), pool {shapes['num_blocks']} blocks, equal "
          "across legs")
    items = _make_workload(params, cfg, n_requests, sys_len, declared_new,
                           seed)

    legs = []
    for name, prefix, cow in (("paged", False, False),
                              ("prefix", True, False),
                              ("cow", True, True)):
        leg = _run_capacity_leg(params, cfg, items, name,
                                prefix=prefix, cow=cow, device=device, **shapes)
        legs.append(leg)
        print(f"[bench_cow] {name:>6}: peak {leg['peak_concurrency']}, "
              f"{leg['requests_per_1k_ticks']} req/1k ticks, "
              f"{leg['kv_bytes_per_stream']} KV B/stream, prefill "
              f"{leg['prefill_tokens_computed']} computed / "
              f"{leg['prefill_tokens_skipped']} skipped, "
              f"{leg['cow_forks']} forks, parity "
              f"{'OK' if leg['parity_ok'] else 'BROKEN'}")

    base, pfx, cow = legs
    peak_x = cow["peak_concurrency"] / base["peak_concurrency"]
    bytes_reduction = 1 - cow["kv_bytes_per_stream"] / \
        base["kv_bytes_per_stream"]

    # the resume experiment: every stream runs its FULL budget (no early
    # eos — overlap persists, so resumes happen amid live sharers) behind
    # a LONG mid-page system prompt, on a pool tight enough to thrash
    r_sys = sys_len
    r_new = 12
    resume_items = []
    r_rng = np.random.default_rng(seed + 1)
    r_sysp = r_rng.integers(0, cfg.vocab_size, r_sys).astype(np.int32)
    for i in range(6 if fast else 12):
        tail = r_rng.integers(0, cfg.vocab_size,
                              int(r_rng.integers(1, 4))).astype(np.int32)
        prompt = np.concatenate([r_sysp, tail])
        resume_items.append({"prompt": prompt, "eos": None,
                             "want": _solo(params, cfg, prompt, r_new)})
    resume_shapes = dict(shapes, declared_new=r_new, num_blocks=12)
    resume_legs = []
    for name, prefix, cow_on in (("paged", False, False),
                                 ("cow", True, True)):
        leg = _run_resume_leg(params, cfg, resume_items, name,
                              prefix=prefix, cow=cow_on, device=device,
                              **resume_shapes)
        resume_legs.append(leg)
        print(f"[bench_cow] resume {name:>6}: {leg['reprefills']} "
              f"re-prefills, {leg['resume_prefill_tokens']} tokens "
              f"recomputed ({leg['resume_prefill_tokens_saved']} saved), "
              f"parity {'OK' if leg['parity_ok'] else 'BROKEN'}")
    r_base, r_cow = resume_legs
    if r_cow["reprefills"] and r_base["reprefills"]:
        resume_x = (r_base["tokens_per_resume"]
                    / max(r_cow["tokens_per_resume"], 1e-9))
    else:
        resume_x = None

    # the fixed-pool parity leg (the acceptance's third decode surface)
    from gradaccum_tpu_torch.serving import Engine, Scheduler

    fixed = Engine(params, cfg, num_slots=shapes["num_slots"],
                   max_len=shapes["max_len"],
                   scheduler=Scheduler(max_queue=len(items)), device=device)
    rids = [fixed.submit(it["prompt"], declared_new, eos_id=it["eos"])
            for it in items]
    fixed.run_until_idle()
    fixed_parity = all([int(t) for t in fixed.results[r]] == it["want"]
                       for r, it in zip(rids, items))

    parity = (all(leg["parity_ok"] for leg in legs + resume_legs)
              and fixed_parity)
    passed = ((peak_x >= 1.15 or bytes_reduction >= 0.15)
              and resume_x is not None and resume_x >= 2.0
              and parity)
    headline = (f"{peak_x:.2f}x peak concurrency, "
                f"{bytes_reduction * 100:.0f}% KV bytes/stream reduction "
                f"vs paging without sharing at equal pool memory; prefix-aware "
                f"resume cuts re-prefill tokens "
                f"{resume_x:.1f}x" if resume_x is not None else
                "resume leg never preempted")
    print(f"[bench_cow] {headline}")

    artifact = {
        "bench": "copy-on-write partial pages: sub-page prefix sharing + "
                 "prefix-aware resume (tick clock)",
        "device": str(device),
        "headline": headline,
        "seed": seed,
        "workload": {"requests": n_requests, "sys_len": sys_len,
                     "declared_max_new": declared_new, **shapes},
        "cow_legs": legs,
        "resume_legs": resume_legs,
        "fixed_parity_ok": bool(fixed_parity),
        "peak_concurrency_x": round(peak_x, 3),
        "kv_bytes_per_stream_reduction": round(bytes_reduction, 3),
        "resume_tokens_x": (None if resume_x is None
                            else round(resume_x, 2)),
        "acceptance": {
            "required": ">= 1.15x peak concurrency or >= 15% "
                        "KV-bytes-per-stream reduction vs paging without "
                        "sharing at "
                        "equal pool memory, prefix-aware resume cutting "
                        "re-prefill tokens >= 2x on a preemption-heavy "
                        "trace, and greedy token parity on the fixed, "
                        "paged, prefix, and cow legs",
            "passed": bool(passed),
        },
    }
    print(f"[bench_cow] {'PASS' if passed else 'FAIL'}")
    return artifact


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="tiny shapes")
    ap.add_argument("--seed", type=int, default=11, help="the workload's seed")
    ap.add_argument("--out", default=None, help="write the whole result here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    artifact = run(params_tree(gpt_lm_bundle(cfg).init(0, device)), cfg, args.fast,
                   args.seed, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
    return artifact


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
