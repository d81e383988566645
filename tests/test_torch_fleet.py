"""The supervised serving fleet in the port, against JAX's.

The port's counterparts of JAX's ``tests/test_fleet.py``: membership leases
on the fleet's tick clock (ACTIVE -> SUSPECT -> DEAD, the out-of-band probe
keeping a partitioned member SUSPECT), a DEAD member excised behind a
partial-consensus proof it cannot vote in, every displaced stream finished
token for token on the survivors, ``replica_add`` widening the id lattice
by a generation behind a warm-up ramp, and a paged GROW appending a block
segment with no preemption.

The supervisor, fleet and engine scenarios run on JAX's stack and the
port's from the same seeds, the same spec at the same tick and the same
``FLEET_STEP`` schedule: streams, request ids, supervisor states, the
transition log, excise proofs, backpressure messages and counters are
equal, and greedy streams also equal the port's ``generate_cached``. The
free-running cases run the port alone (their ticks are scheduled by
threads on wall time), hold every stream to ``generate_cached``, and bound
every wait. The drain -> activate -> drain round trip attaches the healer
with the stock ladders, as JAX's does: planned maintenance leaves no
sentinel lease firing and charges no remediation budget.
"""

import time

import numpy as np
import pytest
import torch

from test_torch_serving_reconfig import (  # noqa: F401 — the lm fixture
    WAIT,
    assert_solo,
    both,
    lm,
    prompts_of,
    solo,
    stacks,
    toks,
)

from gradaccum_tpu_torch.resilience import faults as tfaults
from gradaccum_tpu_torch.serving import fleet as tfleet
import gradaccum_tpu_torch.serving as tserving

import importlib

jfleet = importlib.import_module("gradaccum_tpu.serving.fleet")
jcache = importlib.import_module("gradaccum_tpu.serving.cache_pool")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def fleet_lib(side):
    return jfleet if not side.port else tfleet


def log_of(sup):
    return [(t.replica, t.old, t.new, t.at, t.reason) for t in sup.log]


def proof_of(p):
    return (p.replica, p.step, tuple(p.decision), p.absent, p.voters, p.partial, p.valid)


# -- membership registry ------------------------------------------------------------------


def test_supervisor_lease_lifecycle_and_probe_guard(lm):
    """ACTIVE -> SUSPECT at suspect_after, -> DEAD only once the lease
    expired AND the probe failed; a live probe pins SUSPECT; a renewal
    brings a member without an injected fault back."""
    def run(side):
        fl = fleet_lib(side)
        clk, alive = [0.0], [True]
        sup = fl.FleetSupervisor(2, lease_ttl=10.0, suspect_after=4.0,
                                 probe=lambda r: alive[0], clock=lambda: clk[0])
        seen = [sup.states()]
        clk[0] = 5.0
        sup.heartbeat(0)
        seen.append(([(t.replica, t.new) for t in sup.poll()], sup.states()))
        clk[0] = 11.0
        sup.heartbeat(0)
        sup.poll()
        seen.append(sup.states())
        alive[0] = False
        seen.append(([(t.replica, t.new) for t in sup.poll()], sup.states()))
        seen.append(sup.heartbeat(1))
        sup.poll()
        seen.append(sup.states())
        sup.inject(side.faults.KIND_REPLICA_KILL, 1)
        seen.append((sup.heartbeat(1), sup.dropped_renewals))
        clk[0] = 16.0
        sup.poll()
        seen.append(sup.state(0))
        sup.heartbeat(0)
        sup.poll()
        seen.append(sup.state(0))
        return seen, log_of(sup)

    seen, log = both(lm, run)
    A, S, D = tfleet.ACTIVE, tfleet.SUSPECT, tfleet.DEAD
    assert seen[0] == {0: A, 1: A}
    assert seen[1] == ([(1, S)], {0: A, 1: S})
    assert seen[2] == {0: A, 1: S}
    assert seen[3] == ([(1, D)], {0: A, 1: D})
    assert seen[4] is True and seen[5] == {0: A, 1: A}
    assert seen[6][0] is False and seen[6][1] >= 1
    assert seen[7:] == [S, A] and len(log) == 6


def test_supervisor_injected_partition_drops_renewals(lm):
    def run(side):
        clk = [0.0]
        sup = fleet_lib(side).FleetSupervisor(2, lease_ttl=4.0, suspect_after=2.0,
                                              probe=lambda r: True, clock=lambda: clk[0])
        sup.inject(side.faults.KIND_LEASE_PARTITION, 1)
        clk[0] = 3.0
        sup.heartbeat(0)
        out = [sup.heartbeat(1)]
        sup.poll()
        out.append(sup.state(1))
        clk[0] = 5.0
        sup.heartbeat(0)
        sup.poll()
        out.append(sup.state(1))  # the probe says alive: SUSPECT, never DEAD
        sup.heal_injection(1)
        out.append(sup.heartbeat(1))
        sup.poll()
        out.append(sup.state(1))
        return out, log_of(sup), sup.status()

    out, _, status = both(lm, run)
    assert out == [False, tfleet.SUSPECT, tfleet.SUSPECT, True, tfleet.ACTIVE]
    assert status["dropped_renewals"] == 1


def test_supervisor_excise_proof_partial_consensus(lm):
    """The proof round resolves without the corpse's vote once its lease
    provably expired; a round naming a live member never resolves."""
    def run(side):
        clk = [0.0]
        sup = fleet_lib(side).FleetSupervisor(3, lease_ttl=4.0, probe=lambda r: False,
                                              clock=lambda: clk[0], bus_timeout=10.0)
        clk[0] = 1.0
        for r in (0, 2):
            sup.heartbeat(r)
        clk[0] = 6.0
        sup.heartbeat(0)
        sup.heartbeat(2)
        sup.poll()
        state = sup.state(1)
        proof = sup.excise_proof(1, step=7)
        with pytest.raises(RuntimeError, match="excise proof round"):
            sup.excise_proof(0, step=8, timeout=0.5)
        return state, proof_of(proof)

    state, proof = both(lm, run)
    assert state == tfleet.DEAD
    assert proof == (1, 7, (True, 7), (1,), (0, 2), True, True)


# -- seeded kill -> DEAD -> excise -> survivor parity -------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_seeded_kill_excise_survivor_parity(lm, temperature):
    """A seeded replica_kill at FLEET_STEP resolves DEAD through the lease
    ladder, the excision is proof-gated, and every displaced stream (the
    corpse's running ones too) finishes as solo decode: greedy and seeded."""
    kw = {} if temperature == 0.0 else dict(temperature=0.8, top_k=5)

    def run(side):
        f = side.faults
        fleet = side.fleet(replicas=3, tp=None, num_slots=3, max_len=32, page_size=4,
                           fleet_lease_ttl=5.0, fleet_suspect_after=2.0, **kw)
        reqs = {}
        for i, p in enumerate(prompts_of(7, seed=31)):
            reqs[fleet.submit(p, 16, rng_seed=500 + i)] = (p, 500 + i)
        plan = f.FaultSchedule([f.FaultSpec(f.FLEET_STEP, at=3, kind=f.KIND_REPLICA_KILL,
                                            target=1)])
        with f.installed(f.FaultInjector(plan)):
            for _ in range(60):
                fleet.step()
                if fleet.fleet.state(1) == fleet_lib(side).DEAD:
                    break
        dead_at = fleet.tick_count
        res = fleet.reconfigure(side.serving.replica_excise(1))
        moved = res.detail["resubmitted"]
        fleet.run_until_idle()
        out = {rid: toks(fleet.pop_result(moved.get(rid, rid))[0]) for rid in reqs}
        summary = (dead_at, res.ok, res.detail["excise_proof"], moved,
                   fleet.fleet.states(), fleet.active_replicas, log_of(fleet.fleet), out,
                   fleet.replicas[1].idle)
        fleet.close()
        return summary, reqs

    (dead_at, ok, proof, moved, states, active, log, out, corpse_idle), reqs = both(lm, run)
    assert ok and proof["valid"] and 1 in proof["absent"] and 1 not in proof["voters"]
    assert states[1] == tfleet.EXCISED and active == [0, 2] and corpse_idle and moved
    for rid, (p, seed) in reqs.items():
        assert out[rid] == solo(lm, p, 16, seed=seed if temperature else None, **kw)


def test_excision_names_shrunken_fleet_in_backpressure(lm):
    """QueueFull after an excision says why capacity shrank, the stats mark
    the excised member, and excision is terminal."""
    def run(side):
        fleet = side.fleet(replicas=2, tp=None, num_slots=2, max_len=32,
                           scheduler_factory=lambda: side.serving.Scheduler(max_queue=2),
                           fleet_lease_ttl=4.0, fleet_suspect_after=2.0)
        fleet.fleet.inject(side.faults.KIND_REPLICA_KILL, 1)
        for p in prompts_of(3, seed=33):
            fleet.submit(p, 12)
        for _ in range(40):
            fleet.step()
            if fleet.fleet.state(1) == fleet_lib(side).DEAD:
                break
        assert fleet.reconfigure(side.serving.replica_excise(1)).ok
        with pytest.raises(side.serving.QueueFull) as err:
            for p in prompts_of(12, seed=34):
                fleet.submit(p, 12)
        summary = fleet.metrics.summary()
        per = [(p["excised"], p["membership"]) for p in summary["per_replica"]]
        back = fleet.reconfigure(side.serving.replica_activate(1))
        fleet.close()
        return str(err.value), per, summary["excised_replicas"], back.ok, back.reason

    msg, per, excised, ok, reason = both(lm, run)
    assert "replica 1 excised" in msg and "1 active" in msg
    assert per[1] == (True, tfleet.EXCISED) and excised == [1]
    assert not ok and "terminal" in reason


def test_partition_refuses_excise_structured(lm):
    """A partitioned but live member stays SUSPECT: the excise refuses with
    a structured result; healed, it returns to ACTIVE and every stream is
    exact."""
    def run(side):
        fleet = side.fleet(replicas=2, tp=None, num_slots=3, max_len=32,
                           fleet_lease_ttl=4.0, fleet_suspect_after=2.0)
        reqs = {fleet.submit(p, 12): (p, 12) for p in prompts_of(4, seed=35)}
        fleet.fleet.inject(side.faults.KIND_LEASE_PARTITION, 1)
        for _ in range(20):
            fleet.step()
        state = fleet.fleet.state(1)
        res = fleet.reconfigure(side.serving.replica_excise(1))
        fleet.fleet.heal_injection(1)
        fleet.run_until_idle()
        for _ in range(3):
            fleet.step()
        out = {rid: (toks(fleet.results[fleet._moved.get(rid, rid)]),
                     fleet.status[fleet._moved.get(rid, rid)]) for rid in reqs}
        summary = (state, res.ok, res.reason, fleet.fleet.state(1), out, log_of(fleet.fleet))
        fleet.close()
        return summary, reqs

    (state, ok, reason, after, out, _), reqs = both(lm, run)
    assert state == tfleet.SUSPECT and not ok
    assert "excision refused" in reason and "suspect" in reason and after == tfleet.ACTIVE
    assert_solo(lm, out, reqs)


# -- live replica add ---------------------------------------------------------------------


def test_add_replica_widens_lattice_and_serves(lm):
    """add_replica under traffic: in-flight ids keep their owner, new ids
    come from the widened lattice (equal to JAX's), the newcomer warms up
    behind the ramp, and every stream is exact."""
    def run(side):
        fleet = side.fleet(replicas=2, tp=None, num_slots=3, max_len=32)
        reqs = {fleet.submit(p, 12): (p, 12) for p in prompts_of(4, seed=36)}
        for _ in range(3):
            fleet.step()
        res = fleet.reconfigure(side.serving.replica_add())
        warming = 2 in fleet._warmup
        new = {fleet.submit(p, 8): (p, 8) for p in prompts_of(6, seed=37)}
        fleet.run_until_idle()
        out = {rid: (toks(fleet.results[rid]), fleet.status[rid]) for rid in {**reqs, **new}}
        summary = (res.ok, res.detail, warming, [tuple(g) for g in fleet._generations],
                   sorted(new), out, fleet.active_replicas)
        fleet.close()
        return summary, reqs, new

    (ok, detail, warming, gens, new_ids, out, active), reqs, new = both(lm, run)
    assert ok and detail["replica"] == 2 and detail["warmup"] and warming
    assert gens[0] == (0, 2) and gens[-1][1] == 3 and gens[-1][0] >= max(reqs) + 1
    assert all(rid >= gens[-1][0] for rid in new_ids) and active == [0, 1, 2]
    assert_solo(lm, out, {**reqs, **new})


def test_excise_then_add_restores_capacity(lm):
    """Excise a DEAD member, add a replacement, and the fleet serves at full
    width again; the replacement takes traffic once warmed."""
    def run(side):
        fleet = side.fleet(replicas=2, tp=None, num_slots=2, max_len=32,
                           fleet_lease_ttl=4.0, fleet_suspect_after=2.0)
        for p in prompts_of(3, seed=38):
            fleet.submit(p, 10)
        fleet.fleet.inject(side.faults.KIND_REPLICA_KILL, 0)
        for _ in range(40):
            fleet.step()
            if fleet.fleet.state(0) == fleet_lib(side).DEAD:
                break
        ex = fleet.reconfigure(side.serving.replica_excise(0))
        res = fleet.reconfigure(side.serving.replica_add())
        idx = res.detail["replica"]
        for _ in range(16):
            fleet.step()
        reqs = {fleet.submit(p, 8): (p, 8) for p in prompts_of(6, seed=39)}
        fleet.run_until_idle()
        out = {rid: (toks(fleet.results[rid]), fleet.status[rid]) for rid in reqs}
        summary = (ex.ok, res.ok, idx, sorted(fleet.active_replicas), out,
                   fleet.replicas[idx].metrics.tokens_emitted)
        fleet.close()
        return summary, reqs

    (ex_ok, ok, idx, active, out, emitted), reqs = both(lm, run)
    assert ex_ok and ok and active == [1, idx] and emitted > 0
    assert_solo(lm, out, reqs)


def test_warmup_capped_fleet_takes_backpressure_not_drained(lm):
    """Every member warming at its ramp cap still takes the submit; the
    drained error stays for a fleet that truly is drained."""
    def run(side):
        fleet = side.fleet(replicas=2, tp=None, num_slots=4, max_len=32)
        p0, p1, p2 = prompts_of(3, seed=77)
        fleet.replicas[0].submit(p0, 8)
        fleet.replicas[1].submit(p1, 8)
        fleet._warmup = {0: 0, 1: 0}
        rid = fleet.submit(p2, 8)
        owner = fleet._owner(rid)
        fleet.run_until_idle()
        status = fleet.pop_result(rid)[1]
        fleet._inactive = {0, 1}
        with pytest.raises(RuntimeError, match="drained"):
            fleet.submit(p2, 8)
        fleet.close()
        return rid, owner, status

    rid, owner, status = both(lm, run)
    assert owner in (0, 1) and status == "done"


def test_fleet_status_snapshot(lm):
    def run(side):
        fleet = side.fleet(replicas=2, tp=None, num_slots=2, max_len=32)
        status = fleet.fleet.status()
        fleet.close()
        return status

    status = both(lm, run)
    assert set(status["members"]) == {0, 1}
    assert all(m["state"] == tfleet.ACTIVE for m in status["members"].values())


# -- incremental pool grow ----------------------------------------------------------------


def test_incremental_grow_zero_preemption_under_traffic(lm):
    """A paged GROW appends a second segment: nothing preempted, new
    admissions land at once, every stream exact, nothing leaked."""
    def run(side):
        eng = side.engine(num_slots=3, max_len=32, page_size=4, num_blocks=12)
        reqs = {eng.submit(p, 14): (p, 14) for p in prompts_of(3, seed=40, lo=5, hi=8)}
        for _ in range(4):
            eng.step()
        res = eng.reconfigure(side.serving.pool_resize(20))
        segments = list(eng.pool.segments)
        reqs.update({eng.submit(p, 10): (p, 10) for p in prompts_of(2, seed=41, lo=5, hi=8)})
        eng.run_until_idle()
        out = {rid: (toks(eng.results[rid]), eng.status[rid]) for rid in reqs}
        return (res.to_dict(), segments, eng.num_blocks, out, eng.pool.allocated_blocks,
                eng.metrics.preemptions), reqs

    (res, segments, nb, out, left, preempted), reqs = both(lm, run)
    assert res["ok"] and res["preempted"] == 0 and res["detail"]["incremental"]
    assert res["detail"]["segments"] == segments == [12, 8] and nb == 20
    assert left == 0 and preempted == 0
    assert_solo(lm, out, reqs)


def test_grown_pool_bounds_check_covers_total(lm):
    """After a grow the upload-time bounds check spans both segments: an id
    past the total faults, an id in the new segment is legal."""
    for side in stacks(lm).values():
        err = jcache.BlockTableCorruption if not side.port else tserving.BlockTableCorruption
        eng = side.engine(num_slots=2, max_len=32, page_size=4, num_blocks=8)
        assert eng.reconfigure(side.serving.pool_resize(14)).ok
        pool = eng.pool
        orig = int(pool.page_table[0, 0])
        pool.page_table[0, 0] = 15
        pool._table_device = None
        with pytest.raises(err):
            pool.page_table_device()
        pool.page_table[0, 0] = 13
        pool._table_device = None
        pool.page_table_device()
        pool.page_table[0, 0] = orig
        pool._table_device = None
        pool.page_table_device()
        eng.close()


# -- operator surfaces ----------------------------------------------------------------------


def test_suspect_lease_silence_dedups_latency_cliff(lm):
    """A dead member's lease anomaly does not also fire latency_cliff off
    the same silence; another replica still cliffs."""
    def run(side):
        s = side.sentinel
        clk = [0.0]
        snt = s.Sentinel(clock=lambda: clk[0], lease=1.0, cliff_warmup=4, cliff_consecutive=1)
        for _ in range(8):
            snt.observe_tick(0.01, replica=1)
            clk[0] += 0.01
        snt.heartbeat(replica=1, tick=5, busy=True)
        clk[0] = 10.0
        fired = [(a.kind, a.replica) for a in snt.check()]
        before = snt.deduped_cliffs
        snt.observe_tick(5.0, replica=1)
        out = (fired, snt.deduped_cliffs - before, snt.is_firing(s.LATENCY_CLIFF, 1))
        for _ in range(8):
            snt.observe_tick(0.01, replica=0)
            clk[0] += 0.01
        snt.observe_tick(5.0, replica=0)
        return out + (snt.is_firing(s.LATENCY_CLIFF, 0),)

    fired, deduped, cliff1, cliff0 = both(lm, run)
    assert ("dead_replica", 1) in fired and deduped == 1 and not cliff1 and cliff0


def _free_fleet(lm, **kw):
    return stacks(lm)["torch"].fleet(**kw)


def test_free_running_drain_activate_drain_no_leaks(lm):
    """A drain -> activate -> drain round trip on a free-running fleet under
    a seeded tick fault is planned maintenance: the streams are exact, no
    sentinel anomaly is left firing, and the healer attached with the stock
    ladders spends no remediation budget on it."""
    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.resilience.healer import Healer, default_ladders

    # cliff detection off: the seeded crash's recovery tick is a legitimate
    # spike, and this case gates lease and budget hygiene
    snt = Sentinel(lease=60.0, cliff_score=1e9)
    fleet = _free_fleet(lm, replicas=2, tp=None, num_slots=3, max_len=32, fleet_lease_ttl=1e6)
    server = tserving.ServingServer(fleet, free_running=True, sentinel=snt, max_requeues=2)
    healer = Healer(snt, default_ladders(server=server))
    server.attach_healer(healer)
    server.start()
    prompts = prompts_of(4, seed=42)
    plan = tfaults.FaultSchedule([tfaults.FaultSpec(tfaults.MID_DECODE_TICK, at=4,
                                                    kind=tfaults.KIND_CRASH)])
    try:
        with tfaults.installed(tfaults.FaultInjector(plan)):
            handles = [server.submit(p, 10) for p in prompts]
            for spec in (tserving.replica_drain(1), tserving.replica_activate(1),
                         tserving.replica_drain(1)):
                assert server.reconfigure(spec, timeout=WAIT).ok
            out = [h.result(timeout=WAIT) for h in handles]
        assert not snt.firing()
        assert healer.status()["actions_total"] == 0  # planned ops cost no budget
        assert fleet.fleet.state(1) == tfleet.ACTIVE  # drained = renewed
        st = server.stats()
        assert st["healer"]["actions_total"] == 0
        assert fleet.manifest()["healer"] == healer.manifest()
        assert st["fleet"]["members"][1]["state"] == tfleet.ACTIVE
        assert st["excised_replicas"] == [] and st["free_running"] is True
    finally:
        server.stop()
    for p, (got, reason) in zip(prompts, out):
        assert reason == "length" and toks(got) == solo(lm, p, 10)


def test_free_running_idle_member_keeps_lease_under_asymmetric_load(lm):
    """One member decoding a long stream ages the fleet clock while its
    neighbor idles: the idle loop renews its own lease, so the neighbor
    never leaves ACTIVE."""
    fleet = _free_fleet(lm, replicas=2, tp=None, num_slots=2, max_len=64,
                        fleet_lease_ttl=12.0, fleet_suspect_after=6.0)
    server = tserving.ServingServer(fleet, free_running=True).start()
    try:
        p = prompts_of(1, seed=61)[0]
        got, reason = server.submit(p, 36).result(timeout=WAIT)
        assert reason == "length" and toks(got) == solo(lm, p, 36)
        assert fleet.fleet.state(1) == tfleet.ACTIVE
        assert not [t for t in fleet.fleet.log if t.replica == 1 and t.new != tfleet.ACTIVE]
        assert fleet._excised == set()
    finally:
        server.stop()


def test_free_running_kill_of_replica_zero_still_supervised(lm):
    """When replica 0 dies, stewardship fails over: replica 1's loop stages
    it SUSPECT (hedging its waiting work) then DEAD, and the excise goes
    through; every stream is exact."""
    fleet = _free_fleet(lm, replicas=2, tp=None, num_slots=3, max_len=48,
                        fleet_lease_ttl=8.0, fleet_suspect_after=4.0)
    server = tserving.ServingServer(fleet, free_running=True).start()
    try:
        fleet.fleet.inject(tfaults.KIND_REPLICA_KILL, 0)
        prompts = prompts_of(2, seed=62)
        handles = [server.submit(p, 24) for p in prompts]
        deadline = time.monotonic() + WAIT
        while fleet.fleet.state(0) != tfleet.DEAD and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fleet.fleet.state(0) == tfleet.DEAD, fleet.fleet.states()
        res = server.reconfigure(tserving.replica_excise(0), timeout=WAIT)
        assert res.ok, res.reason
        assert fleet.fleet.state(0) == tfleet.EXCISED
        for p, h in zip(prompts, handles):
            got, reason = h.result(timeout=WAIT)
            assert reason == "length" and toks(got) == solo(lm, p, 24)
        assert fleet.active_replicas == [1]
    finally:
        server.stop()


def test_free_running_add_replica_serves(lm):
    """A free-running live ADD gives the newcomer its own loop thread, lock
    and budget; streams submitted after it are exact and ids unique."""
    fleet = _free_fleet(lm, replicas=2, tp=None, num_slots=2, max_len=32)
    server = tserving.ServingServer(fleet, free_running=True, watchdog_timeout=30.0).start()
    try:
        res = server.reconfigure(tserving.replica_add(), timeout=WAIT)
        assert res.ok and res.detail["replica"] == 2
        prompts = prompts_of(6, seed=63)
        handles = [server.submit(p, 6) for p in prompts]
        ids = [h.request_id for h in handles]
        for p, h in zip(prompts, handles):
            got, reason = h.result(timeout=WAIT)
            assert reason == "length" and toks(got) == solo(lm, p, 6)
        assert len(set(ids)) == len(ids) and len(server.stats()["per_replica"]) == 3
    finally:
        server.stop()


def test_tp_above_one_names_the_serving_mesh(lm):
    """tp=2 needs a process group of two ranks (JAX's words, adapted to
    ranks); the multi-rank fleet itself runs in
    ``tests/test_torch_serving_mesh.py``."""
    with pytest.raises(ValueError, match=r"replicas=2 x tp=2 needs 2 devices, have 1"):
        _free_fleet(lm, replicas=2, tp=2, num_slots=2, max_len=32)


def test_bench_fleet_fast(tmp_path):
    """``bench_fleet --fast`` on the CPU: JAX's acceptance (supervised
    availability >= 1.5x, every supervised stream exact, a valid proof,
    full strength restored by replica_add)."""
    from gradaccum_tpu_torch.examples import bench_fleet

    out = tmp_path / "fleet.json"
    result = bench_fleet.main(["--fast", "--device", "cpu", "--json", str(out)])
    assert result["acceptance"]["passed"], result
    sup = result["supervised"]
    assert sup["finished"] == sup["streams"] and sup["excise_proof"]["valid"]
    assert result["availability_ratio"] >= bench_fleet.GATE and out.exists()
