"""Availability through a LIVE reconfiguration against a stop-the-world restart.

The port of ``tools/bench_reconfig.py``. When the pool must change shape (or
the checkpoint must roll) under traffic, what does the transition cost the
streams already running? Two legs per transition kind, one seeded workload,
on the tick clock:

- **live**: ``Engine.reconfigure(...)`` at tick ``TRANSITION_AT``: every
  in-flight stream parks, the pool rebuilds, and the parked work resumes
  where it stopped;
- **stop-the-world**: the engine is discarded at the same tick, a fresh one
  built at the new shape, and every unfinished request resubmitted from
  scratch. Restart time is not charged, which favours this leg.

The metric is forward progress: tokens a request had not produced before (a
replay re-emitting a 10-token prefix makes no progress until token 11).
Availability is the mean forward tokens per tick from the transition until
every request in flight at it has finished; also the dip over the first
``WINDOW`` ticks and the ticks to recover. Both legs must finish every
request with its solo ``generate_cached`` stream, token for token.

JAX's acceptance: live availability through the pool shrink >= 1.5x
stop-the-world's. The ratio is in ticks, so it is the device's own.

The model is GPT's ``tiny_for_tests`` config with random weights (seed 0);
:func:`run` takes any decode tree. ``--json FILE`` writes the whole result
(no default file, so JAX's ``BENCH_reconfig.json`` is never overwritten).
Runs on the card unless ``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_reconfig [--fast] [--json FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

WINDOW = 10         # availability window (ticks) after the transition
TRANSITION_AT = 10  # the tick the transition happens at
GATE = 1.5          # JAX's acceptance on the resize ratio


def _workload(cfg, seed, n):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, size=(int(rng.integers(4, 10)),)).astype(np.int32),
             16) for _ in range(n)]


def _engine(params, cfg, num_blocks, device):
    from gradaccum_tpu_torch.serving import Engine

    return Engine(params, cfg, num_slots=6, max_len=48, page_size=4, num_blocks=num_blocks,
                  device=device)


def run_leg(params, cfg, work, wants, kind, mode, nb1, nb2, device, log=print):
    """One leg: the workload, the transition at TRANSITION_AT, the drain, the
    parity check. Returns the forward-progress timeline and the metrics."""
    from gradaccum_tpu_torch.serving import checkpoint_swap, pool_resize

    engine = _engine(params, cfg, nb1, device)
    rid_of = {i: engine.submit(p, n, rng_seed=i) for i, (p, n) in enumerate(work)}
    best = [0] * len(work)      # the forward-progress watermark per request
    finished = [False] * len(work)
    timeline = []
    in_flight = None
    recover_tick = None
    tick = 0
    while not engine.idle:
        if tick == TRANSITION_AT:
            in_flight = [i for i in range(len(work)) if not finished[i]]
            if mode == "live":
                engine.reconfigure(pool_resize(nb2) if kind == "resize"
                                   else checkpoint_swap(params=params))
            else:
                # stop-the-world: a fresh engine at the new shape, every
                # unfinished request replayed from scratch
                engine.close()
                engine = _engine(params, cfg, nb2 if kind == "resize" else nb1, device)
                for i in in_flight:
                    prompt, max_new = work[i]
                    rid_of[i] = engine.submit(prompt, max_new, rng_seed=i)
        events = engine.step()
        done = {rid for rid, _ in events.finished}
        fwd = 0
        for i in range(len(work)):
            if finished[i]:
                continue
            out = engine.results.get(rid_of[i])
            if out is None:
                continue
            if len(out) > best[i]:
                fwd += len(out) - best[i]
                best[i] = len(out)
            if rid_of[i] in done:
                finished[i] = True
        timeline.append(fwd)
        if recover_tick is None and in_flight is not None \
                and all(finished[i] for i in in_flight):
            recover_tick = tick
        tick += 1
    # availability means nothing if the tokens are wrong
    mismatches = []
    for i in range(len(work)):
        tokens, status = engine.pop_result(rid_of[i])
        if status != "done" or [int(t) for t in tokens] != wants[i]:
            mismatches.append(i)
    end = recover_tick + 1 if recover_tick is not None else len(timeline)
    span = timeline[TRANSITION_AT:end]
    window = timeline[TRANSITION_AT:TRANSITION_AT + WINDOW]
    leg = {
        "mode": mode,
        "total_ticks": len(timeline),
        "availability_tokens_per_tick": round(sum(span) / max(len(span), 1), 3),
        "dip_depth": min(window) if window else 0,
        "time_to_recover_ticks": None if recover_tick is None else recover_tick - TRANSITION_AT,
        "parity": not mismatches,
        "mismatched_requests": mismatches,
        "timeline": timeline,
    }
    log(f"[reconfig/{kind}] {mode}: availability {leg['availability_tokens_per_tick']} tok/tick "
        f"through the transition, recover in {leg['time_to_recover_ticks']} tick(s), "
        f"{leg['total_ticks']} ticks total, parity {'clean' if not mismatches else mismatches}")
    return leg


def run(params, cfg, fast=False, seed=7, device="cuda", log=print):
    """Both transitions, live and stop-the-world; the artifact."""
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    n = 6 if fast else 10
    work = _workload(cfg, seed, n)
    wants = [[int(t) for t in generate_cached(params, cfg, p, m)[0, p.size:]] for p, m in work]
    nb1, nb2 = 48, 24  # shrink under load: the hard direction
    transitions = {}
    for kind in ("resize", "ckpt_swap"):
        live = run_leg(params, cfg, work, wants, kind, "live", nb1, nb2, device, log)
        stw = run_leg(params, cfg, work, wants, kind, "stw", nb1, nb2, device, log)
        ratio = (live["availability_tokens_per_tick"]
                 / max(stw["availability_tokens_per_tick"], 1e-9))
        transitions[kind] = {
            "live": {k: v for k, v in live.items() if k != "timeline"},
            "stw": {k: v for k, v in stw.items() if k != "timeline"},
            "availability_ratio": round(ratio, 3),
            "timeline_live": live["timeline"],
            "timeline_stw": stw["timeline"],
        }
        log(f"[reconfig/{kind}] availability ratio live/stw = {ratio:.2f}x")
    resize_ratio = transitions["resize"]["availability_ratio"]
    parity = all(t[leg]["parity"] for t in transitions.values() for leg in ("live", "stw"))
    passed = parity and resize_ratio >= GATE
    return {
        "bench": "live reconfiguration vs stop-the-world restart (tick clock)",
        "device": str(device),
        "seed": seed,
        "workload": {"requests": n, "max_new": 16, "num_blocks": [nb1, nb2],
                     "transition_at_tick": TRANSITION_AT, "window_ticks": WINDOW},
        "transition": {k: {kk: vv for kk, vv in v.items() if not kk.startswith("timeline")}
                       for k, v in transitions.items()},
        "detail": transitions,
        "acceptance": {
            "required": "pool resize + checkpoint swap under live traffic complete with zero "
                        "dropped requests and token-for-token greedy parity in BOTH legs; "
                        "forward-progress availability through the live resize transition "
                        f">= {GATE}x the stop-the-world restart's",
            "availability_ratio_resize": resize_ratio,
            "availability_ratio_ckpt_swap": transitions["ckpt_swap"]["availability_ratio"],
            "parity": parity,
            "passed": bool(passed),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the whole result here")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--fast", action="store_true", help="6 requests instead of 10")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    artifact = run(params_tree(gpt_lm_bundle(cfg).init(0, device)), cfg, args.fast,
                   args.seed, device)
    acc = artifact["acceptance"]
    print(f"[reconfig] {'PASS' if acc['passed'] else 'FAIL'} (resize ratio "
          f"{acc['availability_ratio_resize']:.2f}x >= {GATE}x, parity {acc['parity']})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1, default=str)
            f.write("\n")
    return artifact


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
