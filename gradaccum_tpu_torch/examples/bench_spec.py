"""Speculative decoding and overlapped prefill against the plain tick.

The port of ``tools/bench_spec.py``. Two questions, one result:

1. **tokens/s at high accept.** A shallow draft proposes ``k`` tokens a
   cycle and the target scores all ``k + 1`` positions in one verify, so
   the engine pays one readback for what the plain tick spreads over
   ``k + 1`` ticks. The high-accept workload is constructed: the target's
   layers past the draft's depth have their residual contributions
   (attention output and ffn_output) scaled by ``eps``, so at ``eps -> 0``
   the truncated draft agrees with the target almost everywhere while the
   target still pays its full depth per verify. The accept sweep scales
   ``eps`` back up to honest disagreement (``eps = 1`` is the unmodified
   random target) so the result shows how the gain decays with the accept
   rate.
2. **TTFT p99 under admission load.** A prefill-heavy closed queue (long
   prompts, short outputs): the speculative engine with
   ``overlap_prefill=True`` against the plain lockstep engine at equal pool
   memory, and the overlap alone, trials interleaved.

Every engine is warmed on the whole workload first, then measured on fresh
metrics (the best of the repeats). JAX's acceptance: speculation >= 1.4x
tokens/s on the high-accept workload, spec + overlap TTFT p99 under the
lockstep baseline, one decode input-shape signature per leg. Every leg's
greedy streams are also held against the plain engine's (``parity_ok``).

The models are random, from ``--seed``. One JSON line with the headline;
``--out FILE`` writes the whole result (no default file, so JAX's
``BENCH_spec.json`` is never overwritten). Runs on the card unless
``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_spec [--fast] [--out FILE]
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

import numpy as np

NUM_LAYERS, DRAFT_LAYERS, SPEC_K = 4, 1, 4


def build_model(num_layers: int, draft_layers: int, eps: float, seed: int, device):
    """A random target (decode tree) whose layers past ``draft_layers``
    contribute residuals scaled by ``eps``."""
    import torch

    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle

    cfg = GPTConfig(vocab_size=96, hidden_size=32, num_layers=num_layers, num_heads=2,
                    intermediate_size=64, max_position_embeddings=128, dropout=0.0)
    tree = params_tree(gpt_lm_bundle(cfg).init(seed, device))
    if eps != 1.0:
        with torch.no_grad():
            for i in range(draft_layers, num_layers):
                lp = tree["params"][f"layer_{i}"]
                for leaf in (lp["attention"]["output"], lp["ffn_output"]):
                    leaf["kernel"].mul_(eps)
                    leaf["bias"].mul_(eps)
    return cfg, tree


def closed_run(engine, prompts, max_new: int):
    """One closed-load pass: submit everything the queue takes, drain.
    Returns the wall seconds and the streams in prompt order."""
    from gradaccum_tpu_torch.serving import QueueFull
    from gradaccum_tpu_torch.utils.platform import synchronize

    pending = list(enumerate(prompts))
    rids = {}
    synchronize(engine.device)
    t0 = time.perf_counter()
    while pending or not engine.idle:
        while pending:
            try:
                rids[pending[0][0]] = engine.submit(pending[0][1], max_new)
            except QueueFull:
                break
            pending.pop(0)
        engine.step()
    synchronize(engine.device)
    dt = time.perf_counter() - t0
    streams = [[int(t) for t in engine.pop_result(rids[i])[0]] for i in range(len(prompts))]
    return dt, streams


def measure(engine, prompts, max_new: int, repeats: int = 2):
    """Warm on the whole workload, then the best of ``repeats`` passes on
    fresh metrics. Returns the leg and its streams."""
    from gradaccum_tpu_torch.serving import ServingMetrics

    _, streams = closed_run(engine, prompts, max_new)
    best = None
    for _ in range(repeats):
        engine.metrics = ServingMetrics()
        dt, streams = closed_run(engine, prompts, max_new)
        tps = engine.metrics.tokens_emitted / dt
        if best is None or tps > best["tokens_per_s"]:
            s = engine.metrics.ttft.summary()
            best = {"tokens_per_s": round(tps, 1),
                    "tokens_emitted": engine.metrics.tokens_emitted,
                    "wall_s": round(dt, 4), "ttft_p50_s": s["p50"], "ttft_p99_s": s["p99"],
                    "accept_rate": engine.metrics.spec_accept_rate()}
    best["decode_programs"] = engine.decode_compile_count()
    return best, streams


def run(fast: bool = False, device="cuda", seed: int = 0) -> dict:
    from gradaccum_tpu_torch.models.gpt_decode import truncate_draft_params
    from gradaccum_tpu_torch.serving import Engine, ServingMetrics

    num_slots, max_len, page_size = 4, 64, 8
    num_blocks = num_slots * max_len // page_size
    pool_kw = dict(num_slots=num_slots, max_len=max_len, page_size=page_size,
                   num_blocks=num_blocks, device=device)
    n_req = 12 if fast else 32
    max_new = 16 if fast else 24
    repeats = 2 if fast else 3
    rng = np.random.default_rng(seed)

    def make_prompts(n, lo, hi):
        return [rng.integers(0, 96, int(rng.integers(lo, hi + 1))).astype(np.int32)
                for _ in range(n)]

    # tokens/s: plain against speculative at equal pool memory
    cfg, params = build_model(NUM_LAYERS, DRAFT_LAYERS, 0.02, seed, device)
    dparams, dcfg = truncate_draft_params(params, cfg, DRAFT_LAYERS)
    spec_kw = dict(speculate_k=SPEC_K, draft_params=dparams, draft_cfg=dcfg)
    prompts = make_prompts(n_req, 6, 16)
    base_leg, base_streams = measure(Engine(params, cfg, **pool_kw), prompts, max_new,
                                     repeats)
    spec_engine = Engine(params, cfg, **spec_kw, **pool_kw)
    spec_leg, spec_streams = measure(spec_engine, prompts, max_new, repeats)
    parity = spec_streams == base_streams
    speedup = spec_leg["tokens_per_s"] / base_leg["tokens_per_s"]
    k = spec_engine._draft_k
    draft_cache_bytes = k.numel() * 2 * k.element_size()
    import torch

    bf16 = Engine(params, cfg, cache_dtype=torch.bfloat16, **spec_kw, **pool_kw)
    draft_cache_bytes_bf16 = bf16._draft_k.numel() * 2 * bf16._draft_k.element_size()

    # the accept-rate sweep: the gain as the draft's agreement decays
    sweep = []
    for eps in ([0.02, 1.0] if fast else [0.02, 0.2, 0.5, 1.0]):
        cfg_e, params_e = build_model(NUM_LAYERS, DRAFT_LAYERS, eps, seed, device)
        dparams_e, dcfg_e = truncate_draft_params(params_e, cfg_e, DRAFT_LAYERS)
        sp = make_prompts(max(8, n_req // 2), 6, 16)
        reps = 1 if fast else 2
        b, b_streams = measure(Engine(params_e, cfg_e, **pool_kw), sp, max_new, reps)
        s, s_streams = measure(Engine(params_e, cfg_e, speculate_k=SPEC_K,
                                      draft_params=dparams_e, draft_cfg=dcfg_e, **pool_kw),
                               sp, max_new, reps)
        parity = parity and s_streams == b_streams
        sweep.append({"eps": eps,
                      "accept_rate": (None if s["accept_rate"] is None
                                      else round(s["accept_rate"], 4)),
                      "tokens_per_s": s["tokens_per_s"],
                      "speedup_vs_baseline": round(s["tokens_per_s"] / b["tokens_per_s"], 3)})

    # TTFT p99 under load: lockstep plain against spec + overlap, trials
    # interleaved so the host's noise hits every leg alike
    tt_prompts = make_prompts(24 if fast else 48, 40, 56)
    tt_new = 8
    legs = {"baseline": Engine(params, cfg, **pool_kw),
            "overlap_only": Engine(params, cfg, overlap_prefill=True, **pool_kw),
            "spec_overlap": Engine(params, cfg, overlap_prefill=True, **spec_kw, **pool_kw)}
    tt = {name: [] for name in legs}
    ref = None
    for name, eng in legs.items():
        _, streams = closed_run(eng, tt_prompts, tt_new)  # warm
        ref = streams if ref is None else ref
        parity = parity and streams == ref
    for _ in range(repeats):
        for name, eng in legs.items():
            eng.metrics = ServingMetrics()
            closed_run(eng, tt_prompts, tt_new)
            tt[name].append(eng.metrics.ttft.summary()["p99"])
    p99 = {name: min(vals) for name, vals in tt.items()}

    passed = (speedup >= 1.4 and p99["spec_overlap"] < p99["baseline"]
              and base_leg["decode_programs"] == 1 and spec_leg["decode_programs"] == 1
              and parity)
    return {
        "bench": "speculative decoding (draft k + one verify) + overlapped prefill, equal "
                 "pool memory",
        "device": str(device),
        "model": {"num_layers": NUM_LAYERS, "hidden": cfg.hidden_size,
                  "heads": cfg.num_heads, "vocab": cfg.vocab_size,
                  "draft_layers": DRAFT_LAYERS, "eps": 0.02},
        "workload": {"requests": n_req, "max_new": max_new, "num_slots": num_slots,
                     "max_len": max_len, "page_size": page_size, "num_blocks": num_blocks,
                     "speculate_k": SPEC_K, "fast": fast},
        "baseline": base_leg,
        "speculative": spec_leg,
        "speedup": round(speedup, 3),
        "parity_ok": bool(parity),
        "accept_sweep": sweep,
        "ttft_under_load": {
            "workload": {"requests": len(tt_prompts), "prompt_len": "40-56",
                         "max_new": tt_new},
            "p99_s": {k: round(v, 5) for k, v in p99.items()},
            "spec_overlap_vs_baseline": round(p99["spec_overlap"] / p99["baseline"], 3),
            "overlap_only_vs_baseline": round(p99["overlap_only"] / p99["baseline"], 3),
            "trials": {k: [round(v, 5) for v in vals] for k, vals in tt.items()},
        },
        "draft_cache_bytes": int(draft_cache_bytes),
        "draft_cache_bytes_bf16": int(draft_cache_bytes_bf16),
        "headline": (f"spec {speedup:.2f}x tokens/s at accept "
                     f"{spec_leg['accept_rate']:.2f}; TTFT p99 under load "
                     f"{p99['spec_overlap'] / p99['baseline']:.2f}x of baseline"),
        "acceptance": {
            "required": "spec >= 1.4x tokens/s on the high-accept workload, spec+overlap "
                        "TTFT p99 < lockstep baseline under load, decode_programs == 1 "
                        "both legs, every leg's greedy streams equal the plain engine's",
            "passed": bool(passed),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="small shapes (structure, not headline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the whole result here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gradaccum_tpu_torch.utils.platform import resolve_device

    result = run(fast=args.fast, device=resolve_device(args.device), seed=args.seed)
    print(json.dumps({"headline": result["headline"], "parity_ok": result["parity_ok"],
                      "acceptance": result["acceptance"]["passed"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
            f.write("\n")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["acceptance"]["passed"] else 1)
