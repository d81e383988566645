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

``--prefix`` runs the shared-prefix comparison: one system prompt with
short unique tails (a leader one tick ahead, then the flood) through the
paged engine with the prefix cache off and on, at equal pool memory; per
leg: prefill tokens computed and skipped, the hit rate, blocks saved, KV
bytes per token in flight, tokens/s, TTFT. JAX's acceptance: prefill
tokens cut by 2x or more, KV bytes per token at 0.7x or less, one decode
program per leg, and at most two more admission programs with the cache on.

``--mesh`` runs JAX's multi-chip comparison (``BENCH_serving_mp.json``'s
keys): a data-parallel curve, ``ReplicatedEngine(tp=1)`` at 1 and 2
replicas (and 4 without ``--fast``) draining one saturating closed workload
with free-running replica threads (interleaved rounds, best of each, one
core per replica), then a tensor-parallel leg in two ranks it spawns
(``examples/common.py :: spawn_ranks``, gloo, both on this device):
``Engine(mesh=serving_mesh(2))`` against ``generate_cached`` on four
requests (``tp.parity``), its tick signatures (``tp.decode_programs``) and
tokens/s at closed load. The acceptance is JAX's: ``dp_speedup_at_2 >= 1.5``,
parity, one decode program per replica. Its 1.5x term measured chips in
JAX; here every replica is a host thread on the ONE card (or CPU), so it
reads how far one device's host threads overlap, not chips, and ``passed``
reports what it reads.

Every engine leg reports the pool's KV bytes per token in flight. The
engine is warmed at the leg's shapes before each timed window. One JSON
line per leg on standard output; ``--out FILE`` also writes the whole
result (JAX's keys). Runs on the card unless ``--device cpu``.

    python -m gradaccum_tpu_torch.examples.bench_serving [--fast]
        [--paged | --prefix | --mesh] [--out FILE] [--device cpu]
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

MESH_TP = 2  # the tensor-parallel leg's ranks


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


def _run_closed(eng, work, rng_seed_base=0):
    """Closed load until the engine is idle (requests already in flight,
    the ``--prefix`` leader, included): ``(elapsed_s, peak concurrent)``."""
    from gradaccum_tpu_torch.serving import QueueFull

    pending = list(enumerate(work))
    peak = 0
    t0 = time.perf_counter()
    while pending or not eng.idle:
        still = []
        for i, (p, n) in pending:
            try:
                eng.submit(p, n, rng_seed=rng_seed_base + i)
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


def _prefix_workload(cfg, fast, rng):
    """One shared system prompt and short unique tails (JAX's shapes)."""
    import numpy as np

    if fast:
        shape = dict(max_len=64, sys_len=24, tail=(2, 6), new=(4, 8), n=8, num_slots=8,
                     page_size=4, decode_block=2)
    else:
        shape = dict(max_len=128, sys_len=64, tail=(4, 12), new=(8, 16), n=24, num_slots=16,
                     page_size=8, decode_block=8)
    sys_prompt = rng.integers(0, cfg.vocab_size, shape["sys_len"]).astype(np.int32)
    work = []
    for _ in range(shape["n"]):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(*shape["tail"]) + 1))
        work.append((np.concatenate([sys_prompt, tail.astype(np.int32)]),
                     int(rng.integers(*shape["new"]) + 1)))
    return shape, work


def _run_leader_flood(eng, work):
    """The leader one tick ahead (its pages are indexed before anyone else
    is admitted), then the flood: ``(tokens_per_s, peak concurrent)``, the
    head-start tick timed too."""
    t0 = time.perf_counter()
    eng.submit(work[0][0], work[0][1], rng_seed=0)
    eng.step()
    _, peak = _run_closed(eng, work[1:], rng_seed_base=1)
    return sum(n for _, n in work) / (time.perf_counter() - t0), peak


def bench_prefix(cfg, params, fast, device):
    """The prefix cache off against on, one paged engine shape, equal pool
    memory, the shared-system-prompt workload."""
    import numpy as np

    from gradaccum_tpu_torch.serving import Engine, Scheduler, ServingMetrics

    shape, work = _prefix_workload(cfg, fast, np.random.default_rng(11))
    num_blocks = shape["num_slots"] * shape["max_len"] // shape["page_size"]

    def leg(prefix):
        eng = Engine(params, cfg, num_slots=shape["num_slots"], max_len=shape["max_len"],
                     page_size=shape["page_size"], num_blocks=num_blocks,
                     decode_block=shape["decode_block"], prefix_cache=prefix,
                     scheduler=Scheduler(max_queue=4 * len(work)), device=device)
        _run_leader_flood(eng, work)  # warm pass
        eng.metrics = ServingMetrics()
        eng.scheduler.stalls.clear()
        tps, peak = _run_leader_flood(eng, work)
        m = eng.metrics.summary()
        return {
            "tokens_per_s": tps,
            "peak_concurrent_requests": peak,
            "prefill_tokens_computed": m["prefill_tokens_computed"],
            "prefill_tokens_skipped": m["prefill_tokens_skipped"],
            "prefix_hit_rate": m["prefix_hit_rate"],
            "blocks_saved": m["blocks_saved"],
            "shared_blocks_peak": m["shared_blocks_peak"],
            "kv_bytes_per_token_in_flight": m["kv_bytes_per_token_in_flight"],
            "kv_pool_bytes": eng.kv_pool_bytes,
            "ttft_s_p50": m["ttft"]["p50"],
            "ttft_s_p99": m["ttft"]["p99"],
            "decode_programs": eng.decode_compile_count(),
            "prefill_programs": eng.prefill_compile_count(),
            "num_slots": eng.pool.num_slots,
            "num_blocks": num_blocks,
        }

    off = leg(prefix=False)
    _emit({"leg": "prefix off", **off})
    on = leg(prefix=True)
    _emit({"leg": "prefix on", **on})
    reduction = off["prefill_tokens_computed"] / on["prefill_tokens_computed"]
    kv_ratio = on["kv_bytes_per_token_in_flight"] / off["kv_bytes_per_token_in_flight"]
    # admission may add its second family's programs, never traffic's
    compile_once = (off["decode_programs"] == 1 and on["decode_programs"] == 1
                    and on["prefill_programs"] <= off["prefill_programs"] + 2)
    return {
        "bench": "shared-prefix KV blocks: prefix cache off vs on at equal pool memory",
        "workload": {**shape, "n_requests": len(work),
                     "total_new_tokens": sum(n for _, n in work),
                     "shared_fraction_mean": float(np.mean([shape["sys_len"] / p.size
                                                            for p, _ in work]))},
        "off": off,
        "on": on,
        "prefill_reduction": reduction,
        "kv_bytes_per_token_ratio": kv_ratio,
        "prefix_speedup": on["tokens_per_s"] / off["tokens_per_s"],
        "acceptance": {
            "required": "prefill_reduction >= 2.0 and kv ratio <= 0.7 and decode_programs "
                        "== 1 both legs and prefix admit programs bounded (off + <= 2)",
            "passed": reduction >= 2.0 and kv_ratio <= 0.7 and compile_once},
    }


def _mesh_workload(cfg, fast, rng):
    """Saturating closed load (JAX's shapes): enough same-shape requests
    that every replica's slots stay full until the tail."""
    if fast:
        shape = dict(max_len=48, prompt=8, new=12, n=24, num_slots=4, page_size=8,
                     decode_block=4, rounds=2)
    else:
        shape = dict(max_len=96, prompt=16, new=32, n=48, num_slots=8, page_size=8,
                     decode_block=32, rounds=3)
    work = [(rng.integers(0, cfg.vocab_size, shape["prompt"]).astype("int32"), shape["new"])
            for _ in range(shape["n"])]
    return shape, work


class _core_budget:
    """Pin the process to ``n`` cores for one timed leg (Linux; elsewhere
    nothing), one core per replica thread, as JAX's bench does."""

    def __init__(self, n: int):
        self.n = min(max(n, 1), os.cpu_count() or 1)

    def __enter__(self):
        if hasattr(os, "sched_setaffinity"):
            self._prior = os.sched_getaffinity(0)
            os.sched_setaffinity(0, set(sorted(self._prior)[:self.n]))
        return self

    def __exit__(self, *exc):
        if hasattr(os, "sched_setaffinity"):
            os.sched_setaffinity(0, self._prior)


def _tp_leg(cfg, params, fast, device):
    """One rank's TP leg (every rank runs it, under the engine's SPMD
    contract): parity on four requests one at a time, then the whole
    workload at closed load."""
    import numpy as np

    from gradaccum_tpu_torch.models.gpt_decode import generate_cached
    from gradaccum_tpu_torch.parallel.mesh import serving_mesh
    from gradaccum_tpu_torch.serving import Engine, QueueFull, Scheduler

    shape, work = _mesh_workload(cfg, fast, np.random.default_rng(13))
    eng = Engine(params, cfg, num_slots=shape["num_slots"], max_len=shape["max_len"],
                 page_size=shape["page_size"], decode_block=shape["decode_block"],
                 scheduler=Scheduler(max_queue=4 * len(work)), mesh=serving_mesh(MESH_TP),
                 device=device)
    parity = True
    for i, (p, n) in enumerate(work[:4]):
        rid = eng.submit(p, n, rng_seed=i)
        eng.run_until_idle()
        want = generate_cached(params, cfg, p, n, max_len=shape["max_len"])
        got, _ = eng.pop_result(rid)
        parity &= list(got) == want[0, p.size:].tolist()
    pending = list(enumerate(work))
    t0 = time.perf_counter()
    while pending or not eng.idle:
        still = []
        for i, (p, n) in pending:
            try:
                eng.submit(p, n, rng_seed=i)
            except QueueFull:
                still.append((i, (p, n)))
        pending = still
        eng.step()
    elapsed = time.perf_counter() - t0
    return {"skipped": False, "tp": MESH_TP, "parity": bool(parity),
            "tokens_per_s": sum(n for _, n in work) / elapsed,
            "decode_programs": eng.decode_compile_count()}


def _mesh_rank(fast, device):
    """A rank of ``--mesh``'s TP leg (``--mesh-rank``, spawned by
    :func:`bench_mesh`): gloo over the ranks, each on ``device`` (index 0
    of the card). Rank 0 prints the leg as its last line."""
    import torch

    from gradaccum_tpu_torch.examples.common import DP_TIMEOUT_S
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.utils.platform import resolve_device

    dev = "cuda:0" if str(device).startswith("cuda") else "cpu"
    info = mesh_lib.initialize_multihost(device=dev, backend="gloo", timeout_s=DP_TIMEOUT_S)
    try:
        with torch.no_grad():
            cfg, params, _, _ = _build(fast, resolve_device(dev))
            leg = _tp_leg(cfg, params, fast, dev)
    finally:
        mesh_lib.shutdown()
    if info["process_index"] == 0:
        _emit({"leg": "tp", **leg})
    return leg


def bench_mesh(cfg, params, fast, device):
    """The data-parallel replica curve and the tensor-parallel leg, one
    artifact (JAX's ``bench_mesh``; module docstring)."""
    import numpy as np

    from gradaccum_tpu_torch.examples.common import spawn_ranks
    from gradaccum_tpu_torch.serving import ReplicatedEngine, Scheduler

    shape, work = _mesh_workload(cfg, fast, np.random.default_rng(13))
    total_tokens = sum(n for _, n in work)

    def run_drain(fleet):
        t0 = time.perf_counter()
        for i, (p, n) in enumerate(work):
            fleet.submit(p, n, rng_seed=i)  # queues sized for the full load
        fleet.drain()
        elapsed = time.perf_counter() - t0
        for eng in fleet.replicas:
            for rid in list(eng.results):
                eng.pop_result(rid)
        return elapsed

    replica_counts = [1, 2] if fast else [1, 2, 4]
    fleets = {}
    for r in replica_counts:
        fleets[r] = ReplicatedEngine(
            params, cfg, replicas=r, tp=1, num_slots=shape["num_slots"],
            max_len=shape["max_len"], page_size=shape["page_size"],
            decode_block=shape["decode_block"],
            scheduler_factory=lambda: Scheduler(max_queue=4 * len(work)), device=device)
        run_drain(fleets[r])  # the warm pass
    best = {r: float("inf") for r in replica_counts}
    for _ in range(shape["rounds"]):
        for r in replica_counts:
            with _core_budget(r):
                best[r] = min(best[r], run_drain(fleets[r]))
    scaling = []
    for r in replica_counts:
        scaling.append({"replicas": r, "tokens_per_s": total_tokens / best[r],
                        "decode_programs_per_replica":
                            [e.decode_compile_count() for e in fleets[r].replicas]})
        _emit({"leg": "dp", **scaling[-1]})
        fleets[r].close()

    argv = ["--mesh-rank", "--device", device.type] + (["--fast"] if fast else [])
    tp_leg = spawn_ranks("gradaccum_tpu_torch.examples.bench_serving", argv, MESH_TP,
                         device.type, deadline_s=600)
    tp_leg.pop("leg")
    by_r = {s["replicas"]: s["tokens_per_s"] for s in scaling}
    dp2 = by_r[2] / by_r[1]
    compile_once = (all(all(c <= 1 for c in s["decode_programs_per_replica"])
                        for s in scaling) and tp_leg["decode_programs"] == 1)
    passed = dp2 >= 1.5 and compile_once and tp_leg["parity"] is True
    headline = "1→2 replicas: {:.2f}x tokens/s".format(dp2)
    if by_r.get(4):
        headline += ", 1→4: {:.2f}x".format(by_r[4] / by_r[1])
    headline += ", tp=2 parity {}".format("ok" if tp_leg["parity"] else "FAIL")
    return {
        "bench": "serving on one device: dp engine replicas (host threads) + tp=2 decode "
                 "tick (gloo ranks)",
        "workload": {**shape, "n_requests": len(work), "total_new_tokens": total_tokens,
                     "devices": 1, "tp_ranks": MESH_TP,
                     "xla_flags": None},  # JAX's simulated-device flags: none here
        "scaling": scaling,
        "tp": tp_leg,
        "dp_speedup_at_2": dp2,
        "headline": headline,
        "acceptance": {
            "required": "tokens/s at 2 dp replicas >= 1.5x 1 replica, tp-sharded greedy "
                        "parity exact, decode programs == 1 per replica",
            "passed": passed},
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
    ap.add_argument("--prefix", action="store_true",
                    help="prefix cache off-vs-on comparison at equal pool memory")
    ap.add_argument("--mesh", action="store_true",
                    help="dp replica curve + tp=2 decode tick (BENCH_serving_mp.json)")
    ap.add_argument("--mesh-rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if sum((args.paged, args.prefix, args.mesh)) > 1:
        ap.error("--paged / --prefix / --mesh are separate comparisons")
    if args.mesh_rank:
        return _mesh_rank(args.fast, args.device)

    import torch

    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    with torch.no_grad():
        cfg, params, prompts, knobs = _build(args.fast, device)
        if args.mesh:
            return _finalize(bench_mesh(cfg, params, args.fast, device), cfg, args.out, device)
        if args.paged:
            return _finalize(bench_paged(cfg, params, args.fast, device), cfg, args.out,
                             device)
        if args.prefix:
            return _finalize(bench_prefix(cfg, params, args.fast, device), cfg, args.out,
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
