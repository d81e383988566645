"""Continuous-batching serving benchmark, on the card.

The port of ``examples/bench_serving.py``'s default and ``--paged`` legs,
at its configurations (``--fast``: vocab 512, H 64, L 2; else vocab 8192,
H 256, L 4, A 4, FFN 1024), random weights from seed 0:

1. **serial** — one request at a time through ``generate_cached``: one
   weight pass per token per request;
2. **engine closed-load** — all requests offered at once to the slot
   engine; JAX's acceptance asks for tokens/s >= 3x serial;
3. **offered-load sweep** — open-loop arrivals at 0.25, 0.5 and 1.5 of the
   measured capacity: tokens/s, TTFT p50/p99 in wall seconds and on the
   tick clock (ticks from submit to the first token), occupancy, queue
   depth.

``--paged`` runs the paged comparison instead: a fixed pool and a paged
pool of EQUAL device memory (the paged engine spends it on blocks shared
by 4x the slots) serve a long-tail workload; per pool: peak concurrent
requests, tokens/s, KV bytes per token in flight, the block waterline.

Every engine leg reports the pool's KV bytes per token in flight. The
engine is warmed at the leg's shapes before each timed window. One JSON
line per leg on standard output; ``--out FILE`` also writes the whole
result (JAX's keys). ``--prefix`` and ``--mesh`` wait for ROADMAP.md items
5i (and 5b, 5g). Runs on the card unless ``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_serving [--fast] [--paged]
        [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

LATER_ITEM = "ROADMAP.md item 5i (after prefix sharing, 5b, and the serving mesh, 5g)"


def _build(fast, device):
    import numpy as np

    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle

    if fast:
        cfg = GPTConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                        intermediate_size=128, max_position_embeddings=128, dropout=0.0)
        knobs = dict(n_requests=8, prompt_len=8, new_tokens=16, max_len=48, num_slots=4,
                     decode_block=4)
    else:
        # big enough that decode is weight-bound (where batching pays)
        cfg = GPTConfig(vocab_size=8192, hidden_size=256, num_layers=4, num_heads=4,
                        intermediate_size=1024, max_position_embeddings=128, dropout=0.0)
        knobs = dict(n_requests=16, prompt_len=16, new_tokens=64, max_len=96, num_slots=8,
                     decode_block=16)
    params = params_tree(gpt_lm_bundle(cfg).init(0, device))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, knobs["prompt_len"]).astype(np.int32)
               for _ in range(knobs["n_requests"])]
    return cfg, params, prompts, knobs


def bench_serial(cfg, params, prompts, knobs):
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    new, max_len = knobs["new_tokens"], knobs["max_len"]
    generate_cached(params, cfg, prompts[0], new, max_len=max_len).cpu()
    t0 = time.perf_counter()
    for p in prompts:
        generate_cached(params, cfg, p, new, max_len=max_len).cpu()
    return len(prompts) * new / (time.perf_counter() - t0)


def _fresh_engine(cfg, params, knobs, prompts, device):
    """An engine warmed at the bench's admission and tick shapes."""
    from gradaccum_tpu_torch.serving import Engine, Scheduler, ServingMetrics

    eng = Engine(params, cfg, num_slots=knobs["num_slots"], max_len=knobs["max_len"],
                 decode_block=knobs["decode_block"],
                 scheduler=Scheduler(max_queue=4 * knobs["n_requests"]), device=device)
    for i, p in enumerate(prompts[:knobs["num_slots"]]):
        eng.submit(p, knobs["new_tokens"], rng_seed=i)
    eng.run_until_idle()
    eng.metrics = ServingMetrics()  # drop the warm-up samples
    return eng


def bench_engine_closed(cfg, params, prompts, knobs, device):
    eng = _fresh_engine(cfg, params, knobs, prompts, device)
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(p, knobs["new_tokens"], rng_seed=i)
    eng.run_until_idle()
    dt = time.perf_counter() - t0
    m = eng.metrics.summary()
    return {
        "tokens_per_s": len(prompts) * knobs["new_tokens"] / dt,
        "decode_programs": eng.decode_compile_count(),
        "prefill_programs": eng.prefill_compile_count(),
        "occupancy_mean": m["occupancy"]["mean"],
        "kv_bytes_per_token_in_flight": m["kv_bytes_per_token_in_flight"],
        "ticks": m["ticks"],
        "ms_per_tick": 1e3 * dt / max(m["ticks"], 1),
    }


def bench_open_loop(cfg, params, prompts, knobs, rate_rps, device):
    """Open-loop arrivals at ``rate_rps`` requests/s: wall-clock metrics,
    and TTFT on the tick clock from the engine's events."""
    from gradaccum_tpu_torch.serving import QueueFull
    from gradaccum_tpu_torch.utils.timing import LatencySeries

    eng = _fresh_engine(cfg, params, knobs, prompts, device)
    new = knobs["new_tokens"]
    arrivals = [i / rate_rps for i in range(len(prompts))]
    submit_tick, ttft_ticks = {}, LatencySeries()
    t0 = time.perf_counter()
    i = 0
    while i < len(prompts) or not eng.idle:
        now = time.perf_counter() - t0
        while i < len(prompts) and arrivals[i] <= now:
            try:
                rid = eng.submit(prompts[i], new, rng_seed=i)
            except QueueFull:
                break  # backpressure: retry after the next tick
            submit_tick[rid] = eng.tick_count
            i += 1
        if eng.idle:
            time.sleep(min(1e-3, max(0.0, arrivals[i] - now)))
            continue
        events = eng.step()
        for rid in events.admitted:  # the first token comes with the admission
            ttft_ticks.add(events.tick - submit_tick.pop(rid))
    dt = time.perf_counter() - t0
    m = eng.metrics.summary()
    return {
        "offered_rps": rate_rps,
        "tokens_per_s": len(prompts) * new / dt,
        "ttft_s": m["ttft"],
        "ttft_ticks": ttft_ticks.summary(),
        "token_latency_s": m["token_latency"],
        "occupancy_mean": m["occupancy"]["mean"],
        "queue_depth_p99": m["queue_depth"]["p99"],
        "kv_bytes_per_token_in_flight": m["kv_bytes_per_token_in_flight"],
    }


def _longtail_workload(cfg, fast, rng):
    """Many short requests, a few near-max ones (JAX's shapes)."""
    if fast:
        shape = dict(max_len=48, short=(8, 8), long=(8, 32), n_short=6, n_long=2,
                     fixed_slots=2, paged_slots=8, page_size=8, decode_block=4)
    else:
        shape = dict(max_len=96, short=(8, 8), long=(16, 72), n_short=20, n_long=4,
                     fixed_slots=4, paged_slots=16, page_size=8, decode_block=8)
    work = []
    for kind in ["short"] * shape["n_short"] + ["long"] * shape["n_long"]:
        plen, new = shape[kind]
        work.append((rng.integers(0, cfg.vocab_size, plen).astype("int32"), new))
    rng.shuffle(work)
    return shape, work


def _run_closed(eng, work):
    """Closed load until the engine is idle: ``(elapsed_s, peak concurrent)``."""
    from gradaccum_tpu_torch.serving import QueueFull

    pending = list(enumerate(work))
    peak = 0
    t0 = time.perf_counter()
    while pending or not eng.idle:
        still = []
        for i, (p, n) in pending:
            try:
                eng.submit(p, n, rng_seed=i)
            except QueueFull:
                still.append((i, (p, n)))
        pending = still
        ev = eng.step()
        peak = max(peak, eng.pool.active_count + len(ev.finished))
    return time.perf_counter() - t0, peak


def bench_paged(cfg, params, fast, device):
    """Fixed against paged pools at EQUAL device memory, long-tail trace."""
    import numpy as np

    from gradaccum_tpu_torch.serving import Engine, Scheduler, ServingMetrics

    shape, work = _longtail_workload(cfg, fast, np.random.default_rng(7))
    capacity_tokens = shape["fixed_slots"] * shape["max_len"]
    num_blocks = capacity_tokens // shape["page_size"]

    def leg(paged):
        kw = dict(page_size=shape["page_size"], num_blocks=num_blocks) if paged else {}
        eng = Engine(params, cfg, num_slots=shape["paged_slots" if paged else "fixed_slots"],
                     max_len=shape["max_len"], decode_block=shape["decode_block"],
                     scheduler=Scheduler(max_queue=4 * len(work)), device=device, **kw)
        _run_closed(eng, work)  # warm pass
        eng.metrics = ServingMetrics()
        eng.scheduler.stalls.clear()
        elapsed, peak = _run_closed(eng, work)
        m = eng.metrics.summary()
        out = {
            "tokens_per_s": sum(n for _, n in work) / elapsed,
            "peak_concurrent_requests": peak,
            "kv_bytes_per_token_in_flight": m["kv_bytes_per_token_in_flight"],
            "kv_pool_bytes": eng.kv_pool_bytes,
            "token_occupancy_mean": m["token_occupancy"]["mean"],
            "decode_programs": eng.decode_compile_count(),
            "num_slots": eng.pool.num_slots,
            "ms_per_tick": 1e3 * elapsed / max(m["ticks"], 1),
        }
        if paged:
            out.update(block_pool_waterline=m["block_waterline"], num_blocks=num_blocks,
                       admission_stalls=dict(eng.scheduler.stalls))
        return out

    fixed = leg(paged=False)
    _emit({"leg": "fixed", **fixed})
    paged = leg(paged=True)
    _emit({"leg": "paged", **paged})
    gain = paged["peak_concurrent_requests"] / fixed["peak_concurrent_requests"]
    kv_ratio = paged["kv_bytes_per_token_in_flight"] / fixed["kv_bytes_per_token_in_flight"]
    return {
        "bench": "paged vs fixed KV pool at equal memory",
        "workload": {**shape, "n_requests": len(work),
                     "total_new_tokens": sum(n for _, n in work)},
        "fixed": fixed,
        "paged": paged,
        "concurrency_gain": gain,
        "paged_speedup": paged["tokens_per_s"] / fixed["tokens_per_s"],
        "kv_bytes_per_token_ratio": kv_ratio,
        "acceptance": {"required": "concurrency_gain >= 2.0 or kv ratio <= 0.7",
                       "passed": gain >= 2.0 or kv_ratio <= 0.7},
    }


def _emit(record):
    print(json.dumps(record), flush=True)


def _finalize(result, cfg, out, device):
    """The platform and model blocks every result carries; write ``out``."""
    import torch

    from gradaccum_tpu_torch.utils.platform import device_name

    result["platform"] = {"backend": device.type, "device": device_name(device),
                          "cpu_count": os.cpu_count(), "torch": torch.__version__}
    result["model"] = {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                       "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
                       "intermediate_size": cfg.intermediate_size}
    if out is not None:
        with open(out, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
            f.write("\n")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the whole result here")
    ap.add_argument("--fast", action="store_true", help="small shapes")
    ap.add_argument("--paged", action="store_true",
                    help="fixed-vs-paged pool comparison at equal memory")
    ap.add_argument("--prefix", action="store_true", help=f"waits for {LATER_ITEM}")
    ap.add_argument("--mesh", action="store_true", help=f"waits for {LATER_ITEM}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if sum((args.paged, args.prefix, args.mesh)) > 1:
        ap.error("--paged / --prefix / --mesh are separate comparisons")
    if args.prefix or args.mesh:
        raise NotImplementedError(
            f"bench_serving --{'prefix' if args.prefix else 'mesh'} waits for {LATER_ITEM}")

    import torch

    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    with torch.no_grad():
        cfg, params, prompts, knobs = _build(args.fast, device)
        if args.paged:
            return _finalize(bench_paged(cfg, params, args.fast, device), cfg, args.out,
                             device)
        serial_tps = bench_serial(cfg, params, prompts, knobs)
        _emit({"leg": "serial", "tokens_per_s": serial_tps})
        engine_leg = bench_engine_closed(cfg, params, prompts, knobs, device)
        speedup = engine_leg["tokens_per_s"] / serial_tps
        _emit({"leg": "engine", **engine_leg, "speedup_vs_serial": speedup})
        capacity_rps = engine_leg["tokens_per_s"] / knobs["new_tokens"]
        sweep = []
        for frac in (0.25, 0.5, 1.5):
            leg = bench_open_loop(cfg, params, prompts, knobs,
                                  max(frac * capacity_rps, 0.1), device)
            leg["load_fraction"] = frac
            sweep.append(leg)
            _emit({"leg": "sweep", **leg})
    result = {
        "bench": "continuous-batching serving engine",
        "workload": knobs,
        "serial_tokens_per_s": serial_tps,
        "engine": engine_leg,
        "speedup_vs_serial": speedup,
        "sweep": sweep,
        "acceptance": {"required_speedup": 3.0, "passed": speedup >= 3.0},
    }
    return _finalize(result, cfg, args.out, device)


if __name__ == "__main__":
    main()
