"""The serving failure contract in the port, against JAX's.

The port's counterparts of JAX's ``tests/test_serving_resilience.py``: an
exception out of ``engine.step()`` never strands a caller. Running requests
are recovered and requeued (bounded), an exhausted budget fails the handles
loudly (``result()`` raises, ``stop()`` re-raises), and a stalled tick is
broken by the watchdog. The requeued streams equal the unfaulted ones token
for token.

Every faulted scenario runs on JAX's engine and server and on the port's,
from the same seeded prompts and the same fault schedule, with every request
submitted before the loop starts (so one thread decides the ticks and the
schedule lands on the same tick on both sides). Streams, the faults fired,
and the counts of faults, failed, requeued and given-up requests are equal;
greedy float32 streams also equal ``generate_cached``. After every
``recover()`` of the port's engine the pool invariants hold
(:func:`pool_invariants`). The scenarios here cover the fault points the
other files do not: the overlapped ``MID_DECODE_TICK``, sampled streams,
``MID_SWAP_IO`` inside a preemption, the int8 pool, and a COW fork that
faults half done (the port alone). The other files hold the cases JAX keeps
beside their features: ``test_torch_serving.py`` (paged pool),
``_prefix.py``, ``_spec.py``, ``_admission.py`` and ``_cow.py``.

Only the watchdog cases run on wall time, with margins of 10x or more; every
wait has a timeout.
"""

import collections
import importlib
import time
import types

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.obs import trace as ttrace
from gradaccum_tpu_torch.parallel.mesh import serving_mesh
from gradaccum_tpu_torch.resilience import faults as tfaults
from gradaccum_tpu_torch.serving import (
    Engine,
    QueueFull,
    ReplicatedEngine,
    Request,
    Scheduler,
    ServingServer,
    StreamHandle,
)
from gradaccum_tpu_torch.serving import engine as tengine
from gradaccum_tpu_torch.serving import reconfig
from gradaccum_tpu_torch.utils import prng

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jserving = importlib.import_module("gradaccum_tpu.serving")
jfaults = importlib.import_module("gradaccum_tpu.resilience.faults")
jtrace = importlib.import_module("gradaccum_tpu.obs.trace")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

WAIT = 120  # seconds any handle may take before a case fails instead of hanging


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    params = jgpt.gpt_lm_bundle(jcfg).init(jax.random.PRNGKey(0),
                                           {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, tcfg, params_tree(model)


def sides(lm):
    """JAX's serving stack and the port's, behind one set of names."""
    jcfg, params, tcfg, tree = lm
    return {
        "jax": types.SimpleNamespace(
            engine=lambda **kw: jserving.Engine(params, jcfg, **kw),
            server=jserving.ServingServer, faults=jfaults, trace=jtrace,
            draft=lambda n: importlib.import_module(
                "gradaccum_tpu.models.gpt_decode").truncate_draft_params(params, jcfg, n),
            int8="int8", port=False),
        "torch": types.SimpleNamespace(
            engine=lambda **kw: Engine(tree, tcfg, device="cpu", **kw),
            server=ServingServer, faults=tfaults, trace=ttrace,
            draft=lambda n: tdec.truncate_draft_params(tree, tcfg, n),
            int8=torch.int8, port=True),
    }


def solo(lm, prompt, n, sampling=None, seed=0):
    _, _, tcfg, tree = lm
    return tdec.generate_cached(tree, tcfg, prompt, n, rng=prng.PRNGKey(seed),
                                **(sampling or {}))[0, len(prompt):].tolist()


def prompts_of(seed, n=4, lengths=(2, 8), vocab=96):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(*lengths))).astype(np.int32)
            for _ in range(n)]


def pool_invariants(engine, failed=()) -> list:
    """What must hold after ``recover()``: every slot free and gated (no
    active flag, host length 0), on a paged pool free + live blocks =
    ``num_blocks``, each block's refcount = the page-table rows holding it
    (the prefix index holds no reference), every row its slot's block list,
    and the prefix index and the radix tails naming only live blocks; no
    swap record of a recovered request. Returns the violations."""
    bad = []
    pool = engine.pool
    for s, req in enumerate(engine._slot_req):
        if req is not None or engine._active[s] or engine._slot_len[s]:
            bad.append(f"slot {s} not released")
    if engine.paged:
        held = collections.Counter()
        for s in range(pool.num_slots):
            row = [int(b) for b in pool.page_table[s] if b != pool.num_blocks]
            if row != pool.blocks_of(s):
                bad.append(f"slot {s} row {row} != blocks {pool.blocks_of(s)}")
            held.update(pool.blocks_of(s))
        live = [b for b in range(pool.num_blocks) if pool.refcount(b) > 0]
        if pool.free_blocks + len(live) != pool.num_blocks:
            bad.append(f"free {pool.free_blocks} + live {len(live)} != {pool.num_blocks}")
        for b in range(pool.num_blocks):
            if pool.refcount(b) != held[b]:
                bad.append(f"block {b} refcount {pool.refcount(b)} != rows {held[b]}")
        if engine.prefix_cache is not None:
            named = set(engine.prefix_cache._by_block) | set(
                engine.prefix_cache._tails._by_value)
            dead = sorted(b for b in named if pool.refcount(b) == 0)
            if dead:
                bad.append(f"prefix index names freed blocks {dead}")
    store = engine._swap_store
    if store is not None:
        bad += [f"swap record of {r.request_id} survived" for r in failed
                if r.request_id in store]
    return bad


def checked_recover(engine, log: list):
    """Wrap the port engine's ``recover`` to append the pool's invariant
    violations after every call to ``log``."""
    plain = engine.recover

    def recover():
        failed = plain()
        log.extend(pool_invariants(engine, failed))
        return failed

    engine.recover = recover
    return engine


def faulted_run(side, prompts, n, specs, engine_kw, server_kw=None, seeds=None):
    """Serve ``prompts`` (``n`` new tokens each, submitted before the loop
    starts) under the fault schedule ``specs`` (FaultSpec keyword dicts).
    ``engine_kw`` is a dict, or a function of the side giving one (a draft's
    weights differ per side). Returns the streams, the faults fired, the
    fault counts, and (the port) the invariant violations found after each
    recover."""
    engine = side.engine(**(engine_kw(side) if callable(engine_kw) else engine_kw))
    violations: list = []
    if side.port:
        checked_recover(engine, violations)
    f = side.faults
    inj = f.FaultInjector(f.FaultSchedule([f.FaultSpec(**s) for s in specs]))
    tracer = side.trace.Tracer(capacity=None)
    seeds = seeds if seeds is not None else list(range(len(prompts)))
    with f.installed(inj), side.trace.installed(tracer):
        server = side.server(engine, **(server_kw or dict(max_requeues=2)))
        handles = [server.submit(p, n, rng_seed=s) for p, s in zip(prompts, seeds)]
        server.start()
        streams = []
        for h in handles:
            try:
                toks, reason = h.result(timeout=WAIT)
                streams.append(([int(t) for t in toks], reason))
            except RuntimeError as e:
                streams.append((None, type(e.__cause__).__name__))
        try:
            server.stop()
            stopped = "ok"
        except RuntimeError as e:
            stopped = type(e.__cause__).__name__
    events = tracer.snapshot()
    names = collections.Counter(e["name"] for e in events)
    counts = dict(
        faults=names["serve/engine_fault"],
        failed=sum(e["args"]["failed"] for e in events if e["name"] == "serve/recover"),
        requeued=names["req/requeue"],
        given_up=sum(1 for e in events if e["name"] == "serve/engine_fault"
                     and e["args"]["give_up"]),
        errors=sorted({e["args"]["error"] for e in events
                       if e["name"] == "serve/engine_fault"}),
        stopped=stopped)
    return types.SimpleNamespace(
        streams=streams, fired=[tuple(x) for x in inj.fired], counts=counts,
        violations=violations, engine=engine)


def both(lm, *args, **kw):
    """``faulted_run`` on JAX's stack and the port's; asserts streams, fired
    faults and counts equal and no invariant broken. Returns the port's."""
    runs = {name: faulted_run(side, *args, **kw) for name, side in sides(lm).items()}
    j, t = runs["jax"], runs["torch"]
    assert t.streams == j.streams
    assert t.fired == j.fired and t.fired, "the schedule never fired"
    assert t.counts == j.counts
    assert t.violations == []
    return t


def assert_solo(lm, run, prompts, n, sampling=None, seeds=None):
    seeds = seeds if seeds is not None else range(len(prompts))
    for p, s, (toks, reason) in zip(prompts, seeds, run.streams):
        assert reason in ("eos", "length")
        assert toks == solo(lm, p, n, sampling, s)


# -- engine fault -> recover -> requeue --------------------------------------------


def test_engine_fault_requeues_and_parity_holds(lm):
    """A mid-tick crash: the in-flight requests are recovered, requeued, and
    their greedy streams still equal ``generate_cached``; nothing is left in
    the engine's bookkeeping."""
    prompts = prompts_of(11)
    run = both(lm, prompts, 6, [dict(point="mid_decode_tick", at=2)],
               dict(num_slots=2, max_len=32))
    assert run.fired == [("mid_decode_tick", 2, "crash")]
    assert run.counts["requeued"] == 2 and run.counts["given_up"] == 0
    assert_solo(lm, run, prompts, 6)
    assert run.engine.idle and not run.engine.results and not run.engine.status


def test_engine_fault_exhausts_budget_fails_loudly(lm):
    """Persistent faults: every handle fails with the engine error chained,
    submit refuses, stop() re-raises; the counts equal JAX's."""
    prompts = prompts_of(12, n=3)
    run = both(lm, prompts, 6, [dict(point="mid_decode_tick", at=None, count=1000)],
               dict(num_slots=2, max_len=32),
               server_kw=dict(max_requeues=1, max_engine_faults=2))
    assert run.streams == [(None, "InjectedCrash")] * 3
    assert run.counts["given_up"] == 1 and run.counts["stopped"] == "InjectedCrash"
    engine = _engine(lm, num_slots=2, max_len=32)
    inj = tfaults.FaultInjector(tfaults.FaultSchedule(
        [tfaults.FaultSpec(tfaults.MID_DECODE_TICK, at=None, count=1000)]))
    with tfaults.installed(inj):
        server = ServingServer(engine, max_requeues=1, max_engine_faults=2).start()
        for handle in [server.submit(p, 6) for p in prompts]:
            with pytest.raises(RuntimeError) as err:
                handle.result(timeout=WAIT)
            assert isinstance(err.value.__cause__, tfaults.InjectedCrash)
        with pytest.raises(RuntimeError, match="died"):
            server.submit(prompts[1], 4)
        with pytest.raises(RuntimeError, match="engine failed"):
            server.stop()


def _engine(lm, **kw):
    return sides(lm)["torch"].engine(**kw)


def test_engine_recover_releases_slots_and_keeps_queue(lm):
    """recover() frees every claimed slot, marks the running requests
    "error", keeps queued ones queued, and the engine serves exact results
    afterwards (stale pool contents are overwritten by the re-prefill); the
    same on JAX's engine."""
    prompts = prompts_of(5, n=3)
    got = {}
    for name, side in sides(lm).items():
        engine = side.engine(num_slots=2, max_len=32)
        rids = [engine.submit(p, 5) for p in prompts]
        engine.step()  # admits two, the third stays queued
        failed = [r.request_id for r in engine.recover()]
        state = (failed, engine.pool.active_count, engine.scheduler.depth,
                 [engine.status[r] for r in rids])
        for rid in rids[:2]:
            engine.pop_result(rid)
        rid2 = engine.submit(prompts[0], 5)
        engine.run_until_idle()
        outs = [engine.pop_result(r) for r in (rids[2], rid2)]
        got[name] = (state, [([int(t) for t in toks], st) for toks, st in outs])
        if side.port:
            assert pool_invariants(engine) == []
    assert got["torch"] == got["jax"]
    (failed, active, depth, status), outs = got["torch"]
    assert failed == [0, 1] and active == 0 and depth == 1
    assert status == ["error", "error", "queued"]
    assert outs == [(solo(lm, prompts[2], 5), "done"), (solo(lm, prompts[0], 5), "done")]


def test_fault_after_expiry_still_finishes_expired_handle(lm):
    """A request the faulted tick retired BEFORE raising (deadline expiry)
    lost its finish event with the exception: the server reconciles it from
    the engine's status instead of leaving its handle hanging."""
    engine = _engine(lm, num_slots=1, max_len=32)
    prompts = prompts_of(8, n=2)
    server = ServingServer(engine, max_requeues=2)  # ticks driven by hand
    blocker = server.submit(prompts[0], 10)
    engine.step()  # t=0: the blocker takes the only slot
    victim = server.submit(prompts[1], 2, deadline_ticks=0)  # deadline_tick=1
    engine.step()  # t=1: the boundary, not expired yet
    inj = tfaults.FaultInjector(tfaults.FaultSchedule(
        [tfaults.FaultSpec(tfaults.MID_DECODE_TICK, at=2)]))
    with tfaults.installed(inj):
        with pytest.raises(tfaults.InjectedCrash) as err:
            engine.step()  # t=2: expires the victim, then the tick dies
    assert engine.status[victim.request_id] == "timeout"
    server._handle_engine_fault(err.value)  # what the loop does on a fault
    assert victim.result(timeout=5) == ([], "timeout")
    assert blocker.error is None and not blocker.done  # requeued, not failed
    server.start()
    tokens, reason = blocker.result(timeout=WAIT)
    assert reason == "length" and tokens == solo(lm, prompts[0], 10)
    server.stop()


def test_admit_dispatch_failure_recovers_slots_and_requests(lm, monkeypatch):
    """A prefill that raises AFTER slots were claimed and requests popped
    from the queue is still recoverable: the slot map is filled before the
    dispatch, so recover() releases the slots and hands the requests back,
    and closes their metrics lifecycle."""
    engine = _engine(lm, num_slots=2, max_len=32)
    plain = tengine.prefill
    state = {"failed": False}

    def flaky(*args, **kw):
        if not state["failed"]:
            state["failed"] = True
            raise RuntimeError("prefill dispatch OOM")
        return plain(*args, **kw)

    monkeypatch.setattr(tengine, "prefill", flaky)
    prompt = prompts_of(12, n=1)[0]
    rid = engine.submit(prompt, 5)
    with pytest.raises(RuntimeError, match="prefill"):
        engine.step()
    failed = engine.recover()
    assert [r.request_id for r in failed] == [rid]
    assert engine.pool.active_count == 0 and pool_invariants(engine, failed) == []
    assert engine.pop_result(rid)[1] == "error"
    rid2 = engine.submit(prompt, 5)
    engine.run_until_idle()
    assert engine.pop_result(rid2) == (solo(lm, prompt, 5), "done")
    assert not engine.metrics._submit_t and not engine.metrics._last_token_t


# -- the watchdog (wall time, 10x margins) -------------------------------------------


def test_watchdog_unblocks_stalled_clients(lm):
    """A wedged tick (15x the watchdog's budget) must not hang result(): the
    watchdog fails the pending handles with TimeoutError before the tick
    returns, and stop() re-raises."""
    engine = _engine(lm, num_slots=2, max_len=32)
    plain = engine.step

    def wedged():
        time.sleep(1.5)
        return plain()

    engine.step = wedged
    server = ServingServer(engine, watchdog_timeout=0.1).start()
    handle = server.submit(prompts_of(1, n=1)[0], 4)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        handle.result(timeout=30)
    assert isinstance(err.value.__cause__, TimeoutError)
    assert time.monotonic() - t0 < 1.5  # unblocked BEFORE the tick returned
    with pytest.raises(RuntimeError, match="engine failed"):
        server.stop()


def test_slow_tick_fault_trips_watchdog(lm):
    """The seeded ``slow_tick`` kind (a wedged-but-alive dispatch stalled
    inside the tick, 15x the budget) trips the watchdog like a hung tick."""
    engine = _engine(lm, num_slots=2, max_len=32)
    inj = tfaults.FaultInjector(tfaults.FaultSchedule([
        tfaults.FaultSpec(tfaults.MID_DECODE_TICK, at=None, kind=tfaults.KIND_SLOW_TICK,
                          delay=1.5)]))
    with tfaults.installed(inj):
        server = ServingServer(engine, watchdog_timeout=0.1).start()
        handle = server.submit(prompts_of(1, n=1)[0], 4)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError) as err:
            handle.result(timeout=30)
        assert isinstance(err.value.__cause__, TimeoutError)
        assert time.monotonic() - t0 < 1.5  # failed before the stall ended
        with pytest.raises(RuntimeError, match="engine failed"):
            server.stop()
    assert inj.fired and inj.fired[0][2] == tfaults.KIND_SLOW_TICK


def test_slow_tick_under_watchdog_budget_is_harmless(lm):
    """A slow tick of 0.01 x the budget must not fire: the request completes
    and equals ``generate_cached``."""
    engine = _engine(lm, num_slots=2, max_len=32)
    inj = tfaults.FaultInjector(tfaults.FaultSchedule([
        tfaults.FaultSpec(tfaults.MID_DECODE_TICK, at=1, kind=tfaults.KIND_SLOW_TICK,
                          delay=0.05)]))
    prompt = prompts_of(1, n=1)[0]
    with tfaults.installed(inj):
        server = ServingServer(engine, watchdog_timeout=5.0).start()
        tokens, reason = server.submit(prompt, 4).result(timeout=WAIT)
        server.stop()
    assert inj.fired == [(tfaults.MID_DECODE_TICK, 1, tfaults.KIND_SLOW_TICK)]
    assert tokens == solo(lm, prompt, 4)


def test_watchdog_suspend_and_one_firing_per_window():
    """``suspend`` pauses the stall clock (an armed window restarts fresh on
    exit) and a stalled window fires once; the port's watchdog alone,
    clocked on margins of 10x."""
    from gradaccum_tpu_torch.resilience.watchdog import Watchdog

    fired = []
    wd = Watchdog(0.05, fired.append, poll=0.005).start()
    try:
        wd.arm()
        with wd.suspend():
            time.sleep(0.5)  # 10x the budget, planned
            wd.arm()  # a no-op while suspended
        assert fired == []
        wd.disarm()
        wd.arm()
        deadline = time.monotonic() + 10
        while not fired and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.5)
        assert len(fired) == 1 and fired[0] > 0.05
    finally:
        wd.stop()
    with pytest.raises(ValueError, match="timeout"):
        Watchdog(0, fired.append)


def test_stream_handle_error_propagation():
    handle = StreamHandle(7)
    handle._put(3)
    handle._fail(ValueError("boom"))
    assert handle.done
    with pytest.raises(RuntimeError, match="request 7 failed") as err:
        handle.result(timeout=1)
    assert isinstance(err.value.__cause__, ValueError)
    assert list(handle) == []  # iteration terminates, no hang


def test_stream_handle_restart_drops_stale_tokens():
    """A requeue restarts the handle: tokens of the faulted attempt, queued
    or already consumed, never glue onto the replayed generation."""
    handle = StreamHandle(3)
    handle._put(1)
    handle._put(2)
    it = iter(handle)
    assert next(it) == 1
    handle._restart()
    handle._put(7)
    handle._finish("length")
    assert handle.result(timeout=1) == ([7], "length")


# -- scheduler edge cases --------------------------------------------------------------


def test_queuefull_roundtrip_through_server(lm):
    """Backpressure surfaces as QueueFull from submit, and the same request
    succeeds after the queue drains."""
    engine = _engine(lm, num_slots=1, max_len=32, scheduler=Scheduler(max_queue=2))
    server = ServingServer(engine)  # not started: the queue can only fill
    prompts = prompts_of(9, n=3)
    server.submit(prompts[0], 4)
    server.submit(prompts[1], 4)
    with pytest.raises(QueueFull):
        server.submit(prompts[2], 4)
    server.start()
    retry, deadline = None, time.monotonic() + WAIT
    while retry is None:
        try:
            retry = server.submit(prompts[2], 4)
        except QueueFull:
            assert time.monotonic() < deadline, "queue never drained"
            time.sleep(0.01)
    assert retry.result(timeout=WAIT) == (solo(lm, prompts[2], 4), "length")
    server.stop()


def test_deadline_expiry_exactly_at_boundary():
    """tick == deadline_tick is still alive; expiry is strictly after."""
    sched = Scheduler()
    sched.submit(Request(request_id=0, prompt=np.array([1], np.int32), max_new_tokens=1,
                         deadline_tick=5))
    assert sched.expire(5) == [] and sched.depth == 1
    assert [r.request_id for r in sched.expire(6)] == [0] and sched.depth == 0


def test_engine_deadline_boundary(lm):
    """A queued request with deadline_ticks=d expires on the first tick after
    submit_tick + d, never on it."""
    engine = _engine(lm, num_slots=1, max_len=32)
    blocker = engine.submit(prompts_of(3, n=1)[0], 20)
    engine.step()
    rid = engine.submit(prompts_of(4, n=1)[0], 2, deadline_ticks=2)
    deadline_tick = engine.tick_count + 2
    expired_tick = None
    while engine.status[rid] == "queued":
        events = engine.step()
        if (rid, "timeout") in events.finished:
            expired_tick = events.tick
    assert engine.status[rid] == "timeout" and expired_tick == deadline_tick + 1
    engine.run_until_idle()
    engine.pop_result(rid), engine.pop_result(blocker)


def test_expire_already_cancelled_request(lm):
    """A cancelled queued request never double-reports as expired; cancel of
    an unknown or finished id is False; cancelling a running request frees
    its slot and keeps its partial stream."""
    engine = _engine(lm, num_slots=1, max_len=32)
    p = prompts_of(6, n=2)
    blocker = engine.submit(p[0], 8)
    engine.step()
    rid = engine.submit(p[1], 2, deadline_ticks=1)
    assert engine.cancel(rid) is True and engine.status[rid] == "cancelled"
    assert engine.cancel(rid) is False and engine.cancel(999) is False
    finished = []
    for _ in range(4):
        finished.extend(engine.step().finished)
    assert all(frid != rid for frid, _ in finished)
    assert engine.pop_result(rid) == ([], "cancelled")
    assert engine.cancel(blocker) is True and engine.pool.active_count == 0
    assert engine.cancel(blocker) is False
    tokens, status = engine.pop_result(blocker)
    assert status == "cancelled" and len(tokens) >= 1 and engine.idle


# -- the fault points, each beside JAX's --------------------------------------------------


@pytest.mark.parametrize("at", [0, 3])
def test_overlapped_mid_decode_fault_parity(lm, at):
    """The overlapped ``MID_DECODE_TICK`` (after both dispatches, before any
    readback): freshly admitted and running requests alike are handed back
    and requeued; streams equal JAX's and ``generate_cached``."""
    prompts = prompts_of(21)
    run = both(lm, prompts, 6, [dict(point="mid_decode_tick", at=at)],
               dict(num_slots=2, max_len=32, overlap_prefill=True))
    assert run.counts["failed"] == 2
    assert_solo(lm, run, prompts, 6)


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_streams_replay_through_a_fault(lm, paged):
    """Seeded sampling (T 0.8, top-k 5): the requeued request folds the same
    key with the same token index, so its stream is the calm one, JAX's and
    ``generate_cached``'s."""
    sampling = dict(temperature=0.8, top_k=5)
    prompts = prompts_of(22)
    kw = dict(num_slots=2, max_len=32, **sampling)
    if paged:
        kw["page_size"] = 4
    run = both(lm, prompts, 6, [dict(point="mid_decode_tick", at=2)], kw,
               seeds=[3, 5, 7, 9])
    assert_solo(lm, run, prompts, 6, sampling, seeds=[3, 5, 7, 9])


def test_swap_io_crash_during_a_preemption(lm):
    """A crash inside a victim's swap-out (``MID_SWAP_IO``, kind crash, not an
    IO error that would fall back to re-prefill) fails the tick with the
    victim still in its slot: recover() releases it, drops its record, and
    the requeued streams equal JAX's and ``generate_cached``."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 96, 6).astype(np.int32) for _ in range(4)]
    run = both(lm, prompts, 12, [dict(point="mid_swap_io", at=None)],
               dict(num_slots=4, max_len=32, page_size=4, num_blocks=10,
                    admission="optimistic", swap="host"),
               server_kw=dict(max_requeues=2))
    assert run.counts["faults"] == 1 and run.counts["failed"] >= 1
    assert_solo(lm, run, prompts, 12)
    assert run.engine.pool.allocated_blocks == 0 and len(run.engine._swap_store) == 0


def test_int8_pool_recovers_with_jax_s_streams(lm):
    """The int8 paged pool through a mid-tick crash: streams equal JAX's int8
    engine and a calm int8 run of the port's (int8 is not float32's)."""
    prompts = prompts_of(23)
    got = {}
    for name, side in sides(lm).items():
        got[name] = faulted_run(side, prompts, 8, [dict(point="mid_decode_tick", at=2)],
                                dict(num_slots=2, max_len=32, page_size=4,
                                     cache_dtype=side.int8))
    assert got["torch"].streams == got["jax"].streams
    assert got["torch"].counts == got["jax"].counts and got["torch"].violations == []
    calm = faulted_run(sides(lm)["torch"], prompts, 8, [],
                       dict(num_slots=2, max_len=32, page_size=4, cache_dtype=torch.int8))
    assert got["torch"].streams == calm.streams


def test_cow_fork_faulting_half_done_heals(lm, monkeypatch):
    """The port alone (JAX has no point inside a fork): a copy-on-write fork
    whose block copy raises after the pool handed out the private block.
    recover() frees the new block with the slot's page table, the shared
    tail with it, the invariants hold, and every requeued stream equals
    ``generate_cached``."""
    rng = np.random.default_rng(9)
    head = rng.integers(0, 96, 6).astype(np.int32)  # a page and a half of page 4
    prompts = [head, np.concatenate([head, [5]]).astype(np.int32),
               np.concatenate([head, [7, 8]]).astype(np.int32)]
    engine = checked_recover(_engine(lm, num_slots=3, max_len=32, page_size=4,
                                     prefix_cache=True), violations := [])
    plain = tengine.kv_map
    state = {"left": 1}

    def flaky(fn, *kvs):
        if fn.__name__ == "copy" and state["left"]:
            state["left"] -= 1
            raise RuntimeError("fork copy failed")
        return plain(fn, *kvs)

    monkeypatch.setattr(tengine, "kv_map", flaky)
    tracer = ttrace.Tracer(capacity=None)
    with ttrace.installed(tracer):
        server = ServingServer(engine, max_requeues=2)
        handles = [server.submit(prompts[0], 6)]
        engine.step()  # the head is admitted and indexed (its page and its tail)
        handles += [server.submit(p, 6) for p in prompts[1:]]
        server.start()  # the next admission adopts the tail and forks it
        results = [h.result(timeout=WAIT) for h in handles]
        server.stop()
    assert state["left"] == 0, "no fork happened"
    names = collections.Counter(e["name"] for e in tracer.snapshot())
    assert names["serve/engine_fault"] == 1 and names["req/requeue"] == 3
    assert violations == []
    for p, (toks, reason) in zip(prompts, results):
        assert (toks, reason) == (solo(lm, p, 6), "length")
    assert engine.pool.allocated_blocks == 0 and len(engine.prefix_cache) == 0


# -- refusals that remain ---------------------------------------------------------------


def _served(engine, call):
    """``call(server)`` on a started server around ``engine``; stopped after."""
    server = ServingServer(engine).start()
    try:
        return call(server)
    finally:
        server.stop()


def _grow(engine):
    return reconfig.pool_resize(engine.num_blocks + 2)


def _remediation_grows(engine):
    remediation = importlib.import_module("gradaccum_tpu_torch.resilience.remediation")

    def call(server):
        remediation.request_reconfig(server, lambda a: _grow(engine))(
            types.SimpleNamespace(kind="x", replica=None))
        deadline = time.monotonic() + WAIT
        while not engine.metrics.reconfigs and time.monotonic() < deadline:
            time.sleep(0.01)
        return engine.metrics.reconfigs == {"pool_resize": 1}

    return _served(engine, call)


def _healer_served(engine):
    """A server built with ``healer=`` (a Healer over its own sentinel)
    starts and stops; the ValueError cases are in test_torch_healer.py."""
    from gradaccum_tpu_torch.obs.sentinel import Sentinel
    from gradaccum_tpu_torch.resilience.healer import Healer

    snt = Sentinel()
    ServingServer(engine, sentinel=snt, healer=Healer(snt, {})).start().stop()
    return True


def _refused(error, words, call):
    with pytest.raises(error, match=words):
        call()
    return True


@pytest.mark.parametrize("call,item", [
    (_healer_served, None),
    (lambda e: ServingServer(e, free_running=True)._free_running is False, None),
    (lambda e: ServingServer(ReplicatedEngine(e.params, e.cfg, replicas=2, device="cpu",
                                              num_slots=1, max_len=8)).stats()["replicas"] == 2,
     None),
    (lambda e: _served(e, lambda s: s.request_reconfig(_grow(e)).result(timeout=WAIT).ok),
     None),
    (lambda e: _served(e, lambda s: s.reconfigure(_grow(e), timeout=WAIT).ok), None),
    (lambda e: e.reconfigure(_grow(e)).ok, None),
    (_remediation_grows, None),
    (lambda e: _refused(ValueError, "replicas=2 x tp=2 needs 2 devices, have 1",
                        lambda: ReplicatedEngine(e.params, e.cfg, replicas=2, tp=2,
                                                 device="cpu")), None),
    (lambda e: Engine(e.params, e.cfg, device="cpu", mesh=serving_mesh(1),
                      num_slots=1, max_len=8).manifest()["mesh"] == {"model": 1}, None),
    (lambda e: _refused(RuntimeError, "ranks > 0", ServingServer(
        Engine(e.params, e.cfg, device="cpu", mesh=serving_mesh(1), num_slots=1,
               max_len=8)).follow), None),
], ids=["healer", "free_running", "replicas", "request_reconfig", "server_reconfigure",
        "engine_reconfigure", "remediation_reconfig", "replicated_tp2", "engine_mesh",
        "server_over_mesh"])
def test_remaining_refusals_name_their_item(lm, call, item):
    """The refusals that remain name their ROADMAP.md item; the calls whose
    item has landed (item None) run: a server with a healer starts and stops,
    a single engine with ``free_running`` falls back to lockstep, a fleet
    serves, and live reconfiguration runs through the engine, the server and
    a remediation. The serving mesh has landed: a tp=2 fleet in one process
    is refused for want of ranks (JAX's words), an engine takes a one-rank
    mesh. So has the server over a mesh: over a one-rank mesh it leads and
    has no follower to be (``follow()`` refuses); the multi-rank server runs
    in ``tests/test_torch_serving_mesh_server.py``."""
    engine = _engine(lm, num_slots=1, max_len=8, page_size=4)
    if item is None:
        assert call(engine)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        call(engine)
