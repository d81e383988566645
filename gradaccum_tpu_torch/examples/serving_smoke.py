"""Fast serving smoke: engine + threaded server on a tiny GPT, in a minute.

The port of ``tools/serving_smoke.py``. It checks the properties that
matter, not speed: (1) greedy outputs through the continuous-batching
engine are token for token solo ``generate_cached``; (2) the decode tick
ran one shape signature; (3) the threaded server streams and drains
cleanly; (4) the export manifest carries the engine's knobs. ``--paged``
runs the same gates through the paged KV pool (page tables, block
reservations, reclaim at idle); ``--prefix`` adds shared-prefix admission
(it implies ``--paged``) and gates a shared-system-prompt workload:
followers HIT the prefix index, skip their shared pages' prefill and still
match solo ``generate_cached``, with every block and index entry reclaimed
at idle. Exit code 0 = PASS.

``--mesh dp,tp`` adds the serving mesh's two axes: ``tp`` runs one request
through ``Engine(mesh=serving_mesh(2))`` in two ranks it spawns
(``examples/common.py :: spawn_ranks``, gloo, both on this device) and
gates token parity on both ranks, one tick signature and the manifest's
mesh; ``dp`` runs one replicated dispatch (``ReplicatedEngine(replicas=2,
tp=1)``) and gates parity, unique ids on both lattices, per-replica tick
signatures and the fleet manifest. Any comma combination works. Runs on the
card unless ``--device cpu``.

    python -m gradaccum_tpu_torch.examples.serving_smoke [--paged] [--prefix]
        [--mesh dp,tp] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

MESH_TP = 2


def _model(device):
    """The tiny GPT, random weights from seed 0, as the decode tree."""
    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle

    cfg = GPTConfig.tiny_for_tests(dropout=0.0)
    return cfg, params_tree(gpt_lm_bundle(cfg).init(0, device))


def _solo(params, cfg, prompt, n):
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    return generate_cached(params, cfg, prompt, n)[0, len(prompt):].tolist()


def _paged_kw(args):
    kw = dict(page_size=4) if args.paged else {}
    if args.prefix:
        kw["prefix_cache"] = True
    return kw


def _tp_rank(args):
    """A rank of the ``tp`` leg (``--mesh-rank``): one request through the
    mesh engine; rank 0 prints what its rank saw, then every rank's
    streams gathered (each rank's equal to rank 0's)."""
    import torch

    from gradaccum_tpu_torch.examples.common import DP_TIMEOUT_S
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.serving import Engine

    dev = "cuda:0" if args.device.startswith("cuda") else "cpu"
    info = mesh_lib.initialize_multihost(device=dev, backend="gloo", timeout_s=DP_TIMEOUT_S)
    try:
        with torch.no_grad():
            cfg, params = _model(dev)
            mesh = mesh_lib.serving_mesh(MESH_TP)
            eng = Engine(params, cfg, num_slots=2, max_len=32, mesh=mesh, device=dev,
                         **_paged_kw(args))
            prompt = [int(t) for t in args.prompt.split(",")]
            rid = eng.submit(prompt, 5)
            eng.run_until_idle()
            got, status = eng.pop_result(rid)
            mine = torch.tensor(got, dtype=torch.int64, device=dev)
            every = mesh.axis(mesh_lib.MODEL_AXIS).all_gather(mine[None], dim=0)
            out = {"tokens": list(got), "status": status,
                   "ranks_agree": bool((every == every[0]).all()),
                   "decode_programs": eng.decode_compile_count(),
                   "mesh": eng.manifest()["mesh"], "heads": int(eng.pool.k.shape[2])}
    finally:
        mesh_lib.shutdown()
    if info["process_index"] == 0:
        print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paged", action="store_true", help="run the smoke through the paged KV pool")
    ap.add_argument("--prefix", action="store_true",
                    help="paged pool + shared-prefix admission gates")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="serving-mesh axes to smoke: 'tp', 'dp', or 'dp,tp'")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh-rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--prompt", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.prefix:
        args.paged = True
    if args.mesh_rank:
        return _tp_rank(args)
    mesh_axes = []
    if args.mesh is not None:
        mesh_axes = [a.strip() for a in args.mesh.split(",") if a.strip()]
        unknown = set(mesh_axes) - {"dp", "tp"}
        if unknown:
            ap.error(f"--mesh axes must be dp/tp, got {sorted(unknown)}")

    import torch

    with torch.no_grad():
        return _smoke(args, mesh_axes)


def _smoke(args, mesh_axes) -> int:
    """The legs (module docstring); 0 when every gate holds."""
    import numpy as np

    from gradaccum_tpu_torch.serving import Engine, ServingServer, SimulationDriver
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg, params = _model(device)
    paged_kw = _paged_kw(args)
    mode = "prefix" if args.prefix else ("paged" if args.paged else "fixed")
    failures = []

    # 1+2: seeded trace parity + one tick signature
    engine = Engine(params, cfg, num_slots=4, max_len=32, decode_block=4, device=device,
                    **paged_kw)
    driver = SimulationDriver(engine, seed=0)
    trace = driver.make_trace(8, arrival_rate=0.6, prompt_len=(1, 12), max_new=(1, 12))
    records = driver.run(trace)
    for item, rec in zip(trace, records):
        if list(rec["tokens"]) != _solo(params, cfg, item.prompt, item.max_new_tokens):
            failures.append(f"parity mismatch on request {rec['request_id']}")
    if engine.decode_compile_count() != 1:
        failures.append(f"decode tick ran {engine.decode_compile_count()} signatures, want 1")
    if args.paged and engine.pool.allocated_blocks != 0:
        failures.append(f"{engine.pool.allocated_blocks} KV blocks leaked at idle")
    print(f"parity ({mode}): {len(records)} requests, "
          f"{engine.metrics.summary()['tokens_emitted']} tokens, "
          f"decode programs={engine.decode_compile_count()}")

    # 3: threaded server streams
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    with ServingServer(Engine(params, cfg, num_slots=2, max_len=24, device=device,
                              **paged_kw)) as srv:
        toks, reason = srv.submit(prompt, 6).result(timeout=60)
        stats = srv.stats()
    want = _solo(params, cfg, prompt, 6)
    if not (reason == "length" and list(toks) == want):
        failures.append(f"server stream mismatch: {toks} ({reason}) vs {want}")
    if args.paged and "free_kv_blocks" not in stats:
        failures.append(f"server stats missing block state: {stats}")
    print(f"server: streamed {len(toks)} tokens, finish={reason}")

    # 4: manifest knobs round-trip
    m = engine.manifest()
    if m["num_slots"] != 4 or m["max_len"] != 32 or m["decode_block"] != 4:
        failures.append(f"manifest knobs wrong: {m}")
    if args.paged and m["page_size"] != 4:
        failures.append(f"manifest paging knobs wrong: {m}")
    if m["prefix_cache"] != args.prefix:
        failures.append(f"manifest prefix knob wrong: {m}")

    # 5 (--prefix): a shared-system-prompt workload hits, skips prefill,
    # stays token-exact, and reclaims blocks and index at idle
    if args.prefix:
        sys_p = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
        eng = Engine(params, cfg, num_slots=4, max_len=32, device=device, **paged_kw)
        leader = eng.submit(sys_p, 10)
        eng.step()  # the leader admitted: its full pages are indexed
        followers = []
        for i in range(3):
            tail = rng.integers(0, cfg.vocab_size, 2 + i).astype(np.int32)
            followers.append((eng.submit(np.concatenate([sys_p, tail]), 6, rng_seed=i),
                              np.concatenate([sys_p, tail])))
        eng.run_until_idle()
        for rid, p in [(leader, sys_p)] + followers:
            n = 10 if rid == leader else 6
            if list(eng.results[rid]) != _solo(params, cfg, p, n):
                failures.append(f"prefix parity mismatch on request {rid}")
        pm = eng.metrics.summary()
        if eng.metrics.prefix_hits != 3:
            failures.append(f"expected 3 prefix hits, got {eng.metrics.prefix_hits}")
        if pm["prefill_tokens_skipped"] < 3 * 8:
            failures.append(f"prefill_tokens_skipped {pm['prefill_tokens_skipped']} < 24")
        if eng.pool.allocated_blocks != 0 or len(eng.prefix_cache) != 0:
            failures.append(f"prefix reclaim leak: {eng.pool.allocated_blocks} blocks, "
                            f"{len(eng.prefix_cache)} index entries at idle")
        print(f"prefix: {eng.metrics.prefix_hits} hits, {pm['prefill_tokens_skipped']} "
              f"prefill tokens skipped, blocks_saved={pm['blocks_saved']}")

    # 6 (--mesh tp): one request through a tp=2 mesh engine in two ranks
    if "tp" in mesh_axes:
        from gradaccum_tpu_torch.examples.common import spawn_ranks

        p = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
        argv = ["--mesh-rank", "--device", device.type, "--prompt",
                ",".join(str(int(t)) for t in p)]
        if args.prefix:
            argv.append("--prefix")
        elif args.paged:
            argv.append("--paged")
        got = spawn_ranks("gradaccum_tpu_torch.examples.serving_smoke", argv, MESH_TP,
                          device.type, deadline_s=300)
        want = _solo(params, cfg, p, 5)
        if got["status"] != "done" or got["tokens"] != want:
            failures.append(f"tp parity mismatch: {got['tokens']} vs {want}")
        if not got["ranks_agree"]:
            failures.append("tp ranks streamed different tokens")
        if got["decode_programs"] != 1:
            failures.append(f"tp decode ran {got['decode_programs']} signatures")
        if got["mesh"] != {"model": MESH_TP}:
            failures.append(f"tp manifest mesh wrong: {got['mesh']}")
        print(f"mesh tp: 1 request over {got['mesh']} ({got['heads']} heads a rank), parity "
              f"ok on both ranks, decode programs={got['decode_programs']}")

    # 7 (--mesh dp): one replicated dispatch: two engines, unique ids,
    # parity, per-replica tick signatures, the fleet manifest
    if "dp" in mesh_axes:
        from gradaccum_tpu_torch.serving import ReplicatedEngine

        fleet = ReplicatedEngine(params, cfg, replicas=2, tp=1, num_slots=2, max_len=32,
                                 device=device, **paged_kw)
        reqs = []
        for i in range(4):
            p = rng.integers(0, cfg.vocab_size, 4 + i).astype(np.int32)
            reqs.append((fleet.submit(p, 5, rng_seed=i), p))
        fleet.run_until_idle()
        rids = [rid for rid, _ in reqs]
        if len(set(rids)) != len(rids):
            failures.append(f"dp request ids collide: {rids}")
        if len({rid % 2 for rid in rids}) != 2:
            failures.append(f"dp dispatch never spread replicas: {rids}")
        for rid, p in reqs:
            got, status = fleet.pop_result(rid)
            if status != "done" or list(got) != _solo(params, cfg, p, 5):
                failures.append(f"dp parity mismatch on request {rid}")
        for eng in fleet.replicas:
            if eng.decode_compile_count() > 1:
                failures.append(f"replica {eng.replica_id} ran {eng.decode_compile_count()} "
                                "decode signatures")
        fm = fleet.manifest()
        if fm["replicas"] != 2 or len(fm["engines"]) != 2:
            failures.append(f"fleet manifest wrong: {fm}")
        if args.paged and any(e["page_size"] != 4 for e in fm["engines"]):
            failures.append(f"fleet manifest paging knobs wrong: {fm}")
        print(f"mesh dp: {len(reqs)} requests over 2 replicas (ids {rids}), parity ok")
        fleet.close()

    if failures:
        print("FAIL:\n  " + "\n  ".join(failures))
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
