"""Data-parallel replicas on one card in the port, against JAX's fleet.

The port's counterparts of the replica cases of JAX's
``tests/test_serving_multichip.py`` and of the free-running server cases of
``tests/test_serving_spec.py``: replicas on disjoint id lattices, prefix
affinity before least load, replica-named backpressure, fall-through probes
that are not rejections, a deterministic trace, the dict-like results, the
recover/requeue contract scoped to the faulted replica, ``drain()``, the
shared registry and manifest, and one loop thread per replica.

Lockstep scenarios run on JAX's fleet and the port's from the same seeded
traces: request ids, streams, stall keys, backpressure messages and
rejection counts are equal, and greedy streams equal the port's
``generate_cached``. The replicas share the one device (``tp=1`` tags them
``model=1`` as JAX's one-device meshes; ``tp=None`` puts no tag). The
threaded cases run the port alone and bound every wait.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_serving_reconfig import (  # noqa: F401 — the lm fixture
    WAIT,
    both,
    lm,
    solo,
    stacks,
    toks,
)

from gradaccum_tpu_torch.obs import trace as ttrace
from gradaccum_tpu_torch.resilience import faults as tfaults
import gradaccum_tpu_torch.serving as tserving

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def _driven(side, seed, n, **kw):
    fleet = side.fleet(**kw)
    driver = side.serving.SimulationDriver(fleet, seed=seed)
    trace = driver.make_trace(n, arrival_rate=0.8, prompt_len=(1, 10), max_new=(1, 8))
    records = driver.run(trace)
    return fleet, trace, [(r["request_id"], toks(r["tokens"]), r["status"]) for r in records]


def test_replicated_parity_unique_ids_and_per_replica_compile_bounds(lm):
    """Seeded traffic over two replicas is solo decode token for token, ids
    are unique on disjoint lattices (equal to JAX's), the shape bound holds
    per replica and both replicas served."""
    def run(side):
        fleet, trace, records = _driven(side, 1, 10, replicas=2, tp=1, num_slots=3,
                                        max_len=32, page_size=4)
        per = [(e.decode_compile_count() <= 1, e.pool.allocated_blocks,
                e.metrics.tokens_emitted > 0) for e in fleet.replicas]
        fleet.close()
        return records, per, [(t.prompt, t.max_new_tokens) for t in trace]

    records, per, trace = both(lm, run)
    assert per == [(True, 0, True)] * 2
    assert len({r[0] for r in records}) == len(records)
    for (prompt, n), (_, got, status) in zip(trace, records):
        assert status == "done" and got == solo(lm, prompt, n)


def test_replicated_prefix_affinity_keeps_hits_hot(lm):
    """Followers of a shared prompt route to the replica whose prefix cache
    holds its blocks; an unrelated prompt still goes to the idle one."""
    def run(side):
        rng = np.random.default_rng(4)
        fleet = side.fleet(replicas=2, tp=1, num_slots=4, max_len=32, page_size=4,
                           prefix_cache=True)
        sys_p = rng.integers(0, 96, 9).astype(np.int32)
        leader = fleet.submit(sys_p, 6)
        fleet.step()
        spread = fleet.submit(rng.integers(0, 96, 5).astype(np.int32), 4)
        followers = [fleet.submit(np.concatenate(
            [sys_p, rng.integers(0, 96, 2 + i).astype(np.int32)]), 4, rng_seed=i)
            for i in range(2)]
        fleet.run_until_idle()
        hits = [e.metrics.prefix_hits for e in fleet.replicas]
        fleet.close()
        return leader, spread, followers, hits

    leader, spread, followers, hits = both(lm, run)
    home = leader % 2
    assert spread % 2 != home and all(r % 2 == home for r in followers)
    assert hits[home] == 2


def test_replicated_bottleneck_names_replica_single_engine_does_not(lm):
    """Backpressure names the saturated replica behind a fleet; a single
    engine's message and stall keys stay unlabeled."""
    def run(side):
        s = side.serving
        kw = dict(num_slots=2, max_len=16, page_size=2, num_blocks=8)
        fleet = side.fleet(replicas=2, tp=1,
                           scheduler_factory=lambda: s.Scheduler(max_queue=1), **kw)
        p = np.arange(4, dtype=np.int32)
        fleet.submit(p, 8)
        fleet.submit(p, 8)
        fleet.step()
        fleet.submit(p, 8)
        fleet.submit(p, 8)
        with pytest.raises(s.QueueFull) as fleet_err:
            fleet.submit(p, 8)
        fleet.step()
        stalls = sorted(k for e in fleet.replicas for k in e.scheduler.stalls)
        fleet.run_until_idle()
        fleet.close()
        single = side.engine(scheduler=s.Scheduler(max_queue=1), **kw)
        single.submit(p, 8)
        single.step()
        single.submit(p, 8)
        with pytest.raises(s.QueueFull) as solo_err:
            single.submit(p, 8)
        single.step()
        solo_stalls = sorted(single.scheduler.stalls)
        single.run_until_idle()
        return str(fleet_err.value), stalls, str(solo_err.value), solo_stalls

    fleet_msg, stalls, solo_msg, solo_stalls = both(lm, run)
    assert "no free KV blocks" in fleet_msg and "replica " in fleet_msg
    assert any(k.startswith("replica ") and k.endswith("no_free_blocks") for k in stalls)
    assert "replica" not in solo_msg and "no free KV blocks" in solo_msg
    assert solo_stalls == ["no_free_blocks"]


def test_fallthrough_admission_is_not_a_rejection(lm):
    """A candidate refusing during fall-through is a probe: no rejection
    recorded and no id burned; a whole-fleet refusal is one rejection."""
    def run(side):
        s = side.serving
        rng = np.random.default_rng(9)
        fleet = side.fleet(replicas=2, tp=1, num_slots=2, max_len=32, page_size=4,
                           prefix_cache=True,
                           scheduler_factory=lambda: s.Scheduler(max_queue=1))
        sys_p = rng.integers(0, 96, 9).astype(np.int32)
        leader = fleet.submit(sys_p, 6)
        fleet.step()
        home = leader % 2
        fleet.replicas[home].submit(rng.integers(0, 96, 5).astype(np.int32), 4)
        next_id = fleet.replicas[home]._next_id
        follower = np.concatenate([sys_p, rng.integers(0, 96, 3).astype(np.int32)])
        rid = fleet.submit(follower, 4)
        probe = ([e.metrics.rejected for e in fleet.replicas],
                 fleet.replicas[home]._next_id == next_id)
        with pytest.raises(s.QueueFull, match="bottleneck") as err:
            fleet.submit(follower, 4)
        rejected = sum(e.metrics.rejected for e in fleet.replicas)
        fleet.run_until_idle()
        fleet.close()
        return home, rid, probe, str(err.value), rejected

    home, rid, probe, _, rejected = both(lm, run)
    assert rid % 2 != home and probe == ([0, 0], True) and rejected == 1


def test_replicated_deterministic_trace_is_reproducible(lm):
    """Two seeded runs under a deterministic tracer give byte-identical
    event streams (step() ticks the replicas in order under it), and the
    port's event names are JAX's, in JAX's order."""
    def one_run(side):
        fleet = side.fleet(replicas=2, tp=1, num_slots=3, max_len=32, page_size=4)
        tracer = side.trace.Tracer(deterministic=True)
        with side.trace.installed(tracer):
            driver = side.serving.SimulationDriver(fleet, seed=5)
            driver.run(driver.make_trace(8, arrival_rate=0.7, prompt_len=(1, 10),
                                         max_new=(1, 6)))
        snap = tracer.snapshot()
        fleet.close()
        return json.dumps(snap, sort_keys=True), [e["name"] for e in snap]

    names = {}
    for name, side in stacks(lm).items():
        first, names[name] = one_run(side)
        assert one_run(side)[0] == first
    assert names["torch"] == names["jax"]


def test_fleet_results_status_iterate_like_dicts(lm):
    def run(side):
        fleet = side.fleet(replicas=2, tp=1, num_slots=2, max_len=32, page_size=4)
        p = np.arange(6, dtype=np.int32)
        rids = [fleet.submit(p, 3, rng_seed=i) for i in range(3)]
        fleet.run_until_idle()
        out = (sorted(fleet.results), sorted(fleet.results.keys()),
               sorted(fleet.status.items()), [len(v) > 0 for v in fleet.results.values()],
               len(fleet.results), rids[0] in fleet.results)
        fleet.close()
        return rids, out

    rids, (keys, keys2, items, nonempty, n, has) = both(lm, run)
    assert keys == keys2 == sorted(rids) and items == [(r, "done") for r in sorted(rids)]
    assert all(nonempty) and n == 3 and has


def test_replicated_server_fault_requeues_on_fleet(lm):
    """A MID_DECODE_TICK crash through the lockstep server: only the faulted
    replica recovers, its request replays exactly, and stats() carries the
    per-replica blocks; the faults fired equal JAX's."""
    def run(side):
        f = side.faults
        prompt = np.random.default_rng(7).integers(0, 96, 6).astype(np.int32)
        fleet = side.fleet(replicas=2, tp=1, num_slots=2, max_len=32, page_size=4)
        inj = f.FaultInjector(f.FaultSchedule([f.FaultSpec(f.MID_DECODE_TICK, at=1,
                                                           kind=f.KIND_CRASH)]))
        with f.installed(inj):
            with side.serving.ServingServer(fleet, max_requeues=2) as srv:
                got, reason = srv.submit(prompt, 6).result(timeout=WAIT)
                stats = srv.stats()
        return ([tuple(x) for x in inj.fired], toks(got), reason, stats["replicas"],
                [p.get("replica_id") for p in stats["per_replica"]]), prompt

    (fired, got, reason, n, ids), prompt = both(lm, run)
    assert fired and reason == "length" and got == solo(lm, prompt, 6)
    assert n == 2 and ids == [0, 1]


def test_replicated_drain_free_runs_to_parity(lm):
    """``drain()`` (no cross-replica barrier) gives lockstep's tokens."""
    def run(side):
        rng = np.random.default_rng(9)
        fleet = side.fleet(replicas=2, tp=1, num_slots=2, max_len=32, page_size=4)
        reqs = []
        for i in range(6):
            p = rng.integers(0, 96, 3 + i).astype(np.int32)
            reqs.append((fleet.submit(p, 4 + i % 3, rng_seed=i), p, 4 + i % 3))
        fleet.drain()
        out = [(rid, toks(fleet.pop_result(rid)[0])) for rid, _, _ in reqs]
        idle = fleet.idle
        fleet.close()
        return out, idle, [(p, n) for _, p, n in reqs]

    out, idle, reqs = both(lm, run)
    assert idle
    for (_, got), (p, n) in zip(out, reqs):
        assert got == solo(lm, p, n)


def test_replicated_metrics_manifest_and_obs_tags(lm):
    """One shared registry with replica labels, the fleet manifest, and
    replica- and mesh-tagged serve/tick spans, as JAX's."""
    def run(side):
        fleet = side.fleet(replicas=2, tp=1, num_slots=2, max_len=32, page_size=4)
        p = np.arange(5, dtype=np.int32)
        tracer = side.trace.Tracer()
        with side.trace.installed(tracer):
            fleet.submit(p, 3)
            fleet.submit(p, 3, rng_seed=1)
            fleet.run_until_idle()
        prom = fleet.registry.to_prometheus()
        m = fleet.manifest()
        ticks = [ev["args"] for ev in tracer.snapshot() if ev.get("name") == "serve/tick"]
        fleet.close()
        return ('replica="0"' in prom and 'replica="1"' in prom,
                prom.count("serving_queue_depth{") >= 2, m["replicas"], m["mesh"], m["tp"],
                [e["replica_id"] for e in m["engines"]], m["engines"][0]["page_size"],
                sorted({a.get("replica") for a in ticks}), all("mesh" in a for a in ticks))

    assert both(lm, run) == (True, True, 2, {"model": 1}, 1, [0, 1], 4, [0, 1], True)


# -- free-running per-replica loops -------------------------------------------------------


def _fleet(lm, **kw):
    return stacks(lm)["torch"].fleet(**kw)


def test_free_running_server_parity_and_stats(lm):
    fleet = _fleet(lm, replicas=2, tp=None, num_slots=2, max_len=24)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 96, n).astype(np.int32) for n in (5, 3, 7, 4, 6, 2)]
    srv = tserving.ServingServer(fleet, free_running=True).start()
    try:
        handles = [srv.submit(p, 6) for p in prompts]
        for p, h in zip(prompts, handles):
            got, reason = h.result(timeout=WAIT)
            assert reason == "length" and toks(got) == solo(lm, p, 6)
        st = srv.stats()
        assert st["free_running"] is True and st["replicas"] == 2
        assert len(st["per_replica"]) == 2 and all(p["tick"] > 0 for p in st["per_replica"])
        assert len({h.request_id for h in handles}) == len(handles)
    finally:
        srv.stop()


def test_free_running_single_engine_falls_back_to_lockstep(lm):
    srv = tserving.ServingServer(stacks(lm)["torch"].engine(num_slots=1, max_len=16),
                                 free_running=True)
    assert srv._free_running is False
    srv.start()
    try:
        got, reason = srv.submit(np.ones(3, np.int32), 3).result(timeout=WAIT)
        assert reason == "length" and len(got) == 3
    finally:
        srv.stop()


def test_free_running_replica_fault_recovers_alone(lm):
    """A fault on one free-running replica recovers and requeues through the
    bounded contract while the fleet keeps serving; streams exact and
    stop() does not raise."""
    fleet = _fleet(lm, replicas=2, tp=None, num_slots=2, max_len=24)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 96, n).astype(np.int32) for n in (5, 4, 6, 3)]
    tracer = ttrace.Tracer(capacity=None)
    inj = tfaults.FaultInjector(tfaults.FaultSchedule(
        [tfaults.FaultSpec(tfaults.MID_DECODE_TICK, at=1)]))
    with tfaults.installed(inj), ttrace.installed(tracer):
        srv = tserving.ServingServer(fleet, free_running=True, max_requeues=2).start()
        try:
            handles = [srv.submit(p, 5) for p in prompts]
            results = [h.result(timeout=WAIT) for h in handles]
        finally:
            srv.stop()
    assert inj.fired
    faulted = [e["args"].get("replica") for e in tracer.snapshot()
               if e["name"] == "serve/engine_fault"]
    assert len(faulted) >= 1 and all(r in (0, 1) for r in faulted)
    for p, (got, reason) in zip(prompts, results):
        assert reason in ("eos", "length") and toks(got) == solo(lm, p, 5)


def test_free_running_targeted_recover_nudge(lm):
    """A recover nudge aimed at replica 1 is claimed by replica 1's loop
    alone; its work requeues and completes exactly."""
    fleet = _fleet(lm, replicas=2, tp=None, num_slots=2, max_len=24)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 96, n).astype(np.int32) for n in (5, 4, 6)]
    srv = tserving.ServingServer(fleet, free_running=True, max_requeues=2).start()
    try:
        handles = [srv.submit(p, 12) for p in prompts]
        srv.request_recover("test:dead_replica replica 1", replica=1)
        for p, h in zip(prompts, handles):
            got, reason = h.result(timeout=WAIT)
            assert reason in ("eos", "length") and toks(got) == solo(lm, p, 12)
        assert not srv._nudges
    finally:
        srv.stop()
