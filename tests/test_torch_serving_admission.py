"""Admission control, preemption and swap in the port's engine, against JAX's.

The port's counterparts of JAX's ``tests/test_serving_admission.py``, of
``test_serving_cow.py``'s deadline victim cases and of
``test_serving_spec.py``'s overlap parity. Each scenario runs on JAX's
engine and the port's from the same seeded inputs and must report the same
streams, preemptions, swap and resume counts, victims and resumes tick by
tick, pool states and policy state; the streams also equal the port's
``generate_cached`` for each prompt alone, as JAX's tests assert.

The fault cases run on JAX's server and the port's with one schedule: a
crash while requests are parked (the running ones requeue, the parked ones
resume on their own) and a corrupted page-table row
(``BlockTableCorruption`` at upload, healed by the requeue); streams,
fault counts and the pool invariants after each recover are checked. The
``preemption_storm`` anomaly fires once and routes through the stock
remediation.

The port alone: a rotted record falls back to re-prefill on the host store
and on the tiered store's disk rung, a ``MID_SWAP_IO`` fault on either
direction falls back, a record over the store's cap raises
``SwapCapacityError`` inside the engine and the request re-prefills, and
``bench_admission --fast`` meets JAX's acceptance.
"""

import importlib
import types

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.resilience import faults as tfaults
from gradaccum_tpu_torch.serving import (
    AdmissionPolicy,
    Engine,
    LengthQuantileEstimator,
    PagedCachePool,
    PoolPressure,
    PrefixCache,
    QueueFull,
    Scheduler,
    ServingServer,
    SimulationDriver,
    SwapCapacityError,
)
from gradaccum_tpu_torch.serving import admission as tadmission
from gradaccum_tpu_torch.utils import prng

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jdec = importlib.import_module("gradaccum_tpu.models.gpt_decode")
jserving = importlib.import_module("gradaccum_tpu.serving")
jadmission = importlib.import_module("gradaccum_tpu.serving.admission")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SAMPLED = dict(temperature=0.8, top_k=5)


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    params = jgpt.gpt_lm_bundle(jcfg).init(jax.random.PRNGKey(0),
                                           {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, tcfg, params_tree(model)


def _sides(lm):
    jcfg, params, tcfg, tree = lm
    return {
        "jax": types.SimpleNamespace(
            engine=lambda **kw: jserving.Engine(params, jcfg, **kw),
            draft=lambda n: jdec.truncate_draft_params(params, jcfg, n),
            pool=lambda **kw: jserving.PagedCachePool(jcfg, **kw),
            prefix=jserving.PrefixCache, policy=jserving.AdmissionPolicy,
            server=jserving.ServingServer, scheduler=jserving.Scheduler,
            driver=jserving.SimulationDriver, adm=jadmission, int8="int8"),
        "torch": types.SimpleNamespace(
            engine=lambda **kw: Engine(tree, tcfg, device="cpu", **kw),
            draft=lambda n: tdec.truncate_draft_params(tree, tcfg, n),
            pool=lambda **kw: PagedCachePool(tcfg, **kw),
            prefix=PrefixCache, policy=AdmissionPolicy, server=ServingServer,
            scheduler=Scheduler, driver=SimulationDriver, adm=tadmission,
            int8=torch.int8),
    }


def _both(lm, scenario):
    got = {name: scenario(side) for name, side in _sides(lm).items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _ints(tokens):
    return [int(t) for t in tokens]


def _solo(lm, prompt, n, sampling=None, seed=0):
    _, _, tcfg, tree = lm
    return tdec.generate_cached(tree, tcfg, prompt, n, rng=prng.PRNGKey(seed),
                                **(sampling or {}))[0, len(prompt):].tolist()


def _prompts(seed, n=4, length=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 96, length).astype(np.int32) for _ in range(n)]


def _replay(events):
    """Victims and resumes, tick by tick."""
    return [(e.tick, list(e.preempted), list(e.resumed)) for e in events
            if e.preempted or e.resumed]


def _bill(eng):
    m = eng.metrics
    return (m.preemptions, m.swap_outs, m.swap_ins, m.reprefills, m.swap_fallbacks,
            m.swap_bytes_out > 0, m.parked_peak)


def _drained(eng):
    return (eng.pool.allocated_blocks, eng.pool.unreserved_blocks == eng.pool.num_blocks,
            eng.scheduler.parked_depth, len(eng._parked_state))


# -- the estimator, the policy, the pool and the victim policy -----------------------


def test_quantile_estimator_warmup_and_window():
    """JAX's case, then a seeded stream of lengths: every quantile at every
    step equals JAX's estimator's."""
    for make in (LengthQuantileEstimator, jserving.LengthQuantileEstimator):
        est = make(window=8, min_samples=4)
        for g in (2, 3):
            est.observe(g)
        assert est.quantile(0.9) is None
        for g in (4, 5):
            est.observe(g)
        assert (est.quantile(1.0), est.quantile(0.5)) == (5, 4)
        for g in [20] * 8:
            est.observe(g)
        assert est.quantile(0.5) == 20
    rng = np.random.default_rng(0)
    ests = [LengthQuantileEstimator(window=16, min_samples=5),
            jserving.LengthQuantileEstimator(window=16, min_samples=5)]
    for g in rng.geometric(0.15, size=60):
        seen = []
        for est in ests:
            est.observe(int(g))
            seen.append([est.quantile(q) for q in (0.0, 0.3, 0.5, 0.75, 0.85, 1.0, 1.5)]
                        + [len(est), est.n_observed])
        assert seen[0] == seen[1]


def test_policy_budgets_and_governor():
    """JAX's budgets and governor case, every answer equal to JAX's policy's;
    then a seeded preemption and finish stream replayed through both."""

    def scenario(make):
        seen = []
        worst = 10 + 20
        seen.append(make(mode="reserve").budget_tokens(10, 20, 4, tick=0))
        seen.append(make(mode="optimistic").budget_tokens(10, 20, 4, tick=0))
        qnt = make(mode="quantile", q=0.9, min_samples=2)
        seen.append(qnt.budget_tokens(10, 20, 4, tick=0))
        for g in (4, 4, 6):
            qnt.observe_finish(g)
        seen += [qnt.budget_tokens(10, 20, 4, tick=0), qnt.budget_tokens(10, 2, 4, tick=0)]
        gov = make(mode="optimistic", storm_preempts=2, storm_window=16, cooldown=10)
        gov.note_preemption(5)
        seen.append(gov.governed(5))
        gov.note_preemption(6)
        seen += [gov.governed(6), gov.budget_tokens(10, 20, 4, tick=7), gov.governed(16),
                 gov.budget_tokens(10, 20, 4, tick=16)]
        gov.pin(20, ticks=3)
        seen += [gov.governed(22), gov.governed(23), gov.status()]
        rng = np.random.default_rng(1)
        pol = make(mode="quantile", q=0.75, min_samples=4, storm_window=8,
                   storm_preempts=3, cooldown=5)
        for tick in range(80):
            r = rng.random()
            if r < 0.2:
                pol.note_preemption(tick)
            elif r < 0.5:
                pol.observe_finish(int(rng.integers(1, 30)))
            seen.append((pol.budget_tokens(int(rng.integers(1, 9)), 24, 4, tick),
                         pol.governed(tick)))
        seen.append(pol.status())
        assert seen[:5] == [worst, 14, worst, seen[3], 12] and seen[3] < worst
        return seen

    assert scenario(AdmissionPolicy) == scenario(jserving.AdmissionPolicy)
    assert tadmission.resolve_policy(None) is None
    assert tadmission.resolve_policy("optimistic").mode == "optimistic"
    with pytest.raises(TypeError, match="admission must be"):
        tadmission.resolve_policy(3)


def test_pool_pressure_is_structured(lm):
    def scenario(side):
        pool = side.pool(num_slots=2, max_len=16, page_size=4, num_blocks=3)
        pool.allow_overcommit = True
        a = pool.claim()
        pool.reserve(a, 4)  # one block promised, more taken on demand
        with pytest.raises(Exception) as exc:
            pool.alloc_to(a, 16)  # wants 4 blocks, the pool holds 3
        e = exc.value
        return (type(e).__name__, e.slot == a, e.need_blocks, e.free_blocks,
                pool.allocated_blocks)

    assert _both(lm, scenario) == ("PoolPressure", True, 1, 0, 3)
    assert issubclass(PoolPressure, RuntimeError)


def test_victim_policy_never_picks_shared_or_hot_blocks(lm):
    """A slot whose blocks another slot shares, or the prefix cache indexes,
    is never the cheap victim; a slot with nothing reclaimable is none. The
    costs and picks equal JAX's on the same pool state."""

    def scenario(side):
        pc = side.prefix(4)
        pool = side.pool(num_slots=3, max_len=16, page_size=4, num_blocks=8, prefix_cache=pc)
        a = pool.claim()
        pool.reserve(a, 8)
        pool.alloc_to(a, 8)
        b = pool.claim()
        pool.reserve(b, 8)
        pool.alloc_to(b, 8)
        c = pool.claim()
        pool.reserve(c, 8, shared_blocks=2)
        pool.adopt_shared(c, pool.blocks_of(a))
        seen = [side.adm.pick_victim(pool, [a, b], None),
                side.adm.victim_cost(pool, a, None), side.adm.victim_cost(pool, b, None)]
        pc.insert(np.arange(4, dtype=np.int32), [pool.blocks_of(b)[0]])
        seen += [side.adm.victim_cost(pool, b, pc), side.adm.pick_victim(pool, [c], None),
                 side.adm.pick_victim(pool, [a, b, c], pc),
                 side.adm.pick_victim(pool, [a, b], pc, exclude=b),
                 side.adm.pick_victim(pool, [a, b], None, score=lambda s: (-s,))]
        assert seen[0] == b and seen[1] > seen[2] and seen[3] > seen[2]
        assert seen[4] is None
        return seen

    _both(lm, scenario)


def test_deadline_victim_cost_orders_by_progress_and_wait(lm):
    """JAX's case from ``test_serving_cow.py``: the stock primary term, then
    progress and queue wait; each cost equal to JAX's."""

    def scenario(side):
        pool = side.pool(num_slots=2, max_len=16, page_size=4, num_blocks=8)
        for s in pool.claim(), pool.claim():
            pool.reserve(s, 8)
            pool.alloc_to(s, 8)
        cost = side.adm.deadline_victim_cost
        base0 = side.adm.victim_cost(pool, 0, None)
        near_done = cost(pool, 0, None, progress=0.9, waited=0)
        fresh = cost(pool, 1, None, progress=0.1, waited=0)
        waited = cost(pool, 1, None, progress=0.1, waited=100)
        assert fresh < near_done and near_done[0] == base0[0] and fresh < waited
        return [base0, near_done, fresh, waited,
                cost(pool, 0, None, progress=-1.0, waited=3),
                cost(pool, 0, None, progress=7.0, waited=1000)]

    _both(lm, scenario)


# -- parity through forced preemption ---------------------------------------------------


@pytest.mark.parametrize("swap", ["host", "recompute"])
def test_fixed_pool_forced_preemption_parity(lm, swap):
    """Preempt a running request on the FIXED pool (the slot row is the swap
    unit), greedy and sampled."""
    prompt = np.arange(1, 7, dtype=np.int32)
    for sampling in ({}, SAMPLED):

        def scenario(side):
            eng = side.engine(num_slots=2, max_len=32, swap=swap, **sampling)
            rid = eng.submit(prompt, 10, rng_seed=3)
            for _ in range(3):
                eng.step()
            seen = [eng.preempt(rid), eng.status[rid], eng.preempt(rid)]
            eng.run_until_idle()
            return seen + [_ints(eng.results[rid]), _bill(eng)]

        got = _both(lm, scenario)
        assert got[:3] == [True, "preempted", False]
        assert got[3] == _solo(lm, prompt, 10, sampling, seed=3)
        assert got[4][2 if swap == "host" else 3] == 1


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_paged_optimistic_preemption_parity(lm, sampling):
    """Optimistic admission on a pool too small for everyone's worst case:
    pressure preempts, and every stream is the solo one; the victims and
    resumes tick by tick are JAX's."""
    kw = SAMPLED if sampling == "sampled" else {}
    prompts = _prompts(0)

    def scenario(side):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=10,
                          admission="optimistic", **kw)
        rids = [eng.submit(p, 12, rng_seed=i) for i, p in enumerate(prompts)]
        events = eng.run_until_idle()
        return ([_ints(eng.results[r]) for r in rids], _replay(events), _bill(eng),
                _drained(eng))

    streams, replay, bill, drained = _both(lm, scenario)
    assert bill[0] >= 1 and replay
    for i, (p, toks) in enumerate(zip(prompts, streams)):
        assert toks == _solo(lm, p, 12, kw, seed=i)
    assert drained == (0, True, 0, 0)


def test_prefix_shared_victim_decrefs_not_frees(lm):
    """A victim holding shared prefix blocks decrefs them; the survivor keeps
    decoding, and both streams are solo-identical."""
    rng = np.random.default_rng(1)
    sys_prompt = rng.integers(0, 96, 8).astype(np.int32)
    p1 = np.concatenate([sys_prompt, rng.integers(0, 96, 3).astype(np.int32)])
    p2 = np.concatenate([sys_prompt, rng.integers(0, 96, 2).astype(np.int32)])

    def scenario(side):
        eng = side.engine(num_slots=3, max_len=32, page_size=4, num_blocks=16,
                          prefix_cache=True, admission="quantile")
        r1 = eng.submit(p1, 10)
        eng.step()
        r2 = eng.submit(p2, 10)
        eng.step()
        shared = [b for b in eng.pool.blocks_of(0) if eng.pool.refcount(b) > 1]
        seen = [eng.pool.shared_blocks, eng.preempt(r1),
                [eng.pool.refcount(b) for b in shared], eng.status[r2]]
        events = eng.run_until_idle()
        return seen + [_ints(eng.results[r1]), _ints(eng.results[r2]), _replay(events),
                       _bill(eng), eng.pool.allocated_blocks]

    got = _both(lm, scenario)
    assert got[0] >= 2 and got[1] is True and min(got[2]) >= 1 and got[3] == "running"
    assert got[4] == _solo(lm, p1, 10) and got[5] == _solo(lm, p2, 10)
    assert got[-1] == 0


def test_swap_in_vs_reprefill_bitwise_parity(lm):
    """The two resume paths are interchangeable: one overcommitted trace
    restored by host swap-in and by re-prefill gives identical streams."""
    prompts = _prompts(2)

    def run(side, swap):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=10,
                          admission="optimistic", swap=swap)
        rids = [eng.submit(p, 12) for p in prompts]
        eng.run_until_idle()
        m = eng.metrics
        return ([_ints(eng.results[r]) for r in rids], m.swap_ins, m.swap_bytes_out,
                m.swap_bytes_in, m.reprefills, m.swap_outs,
                0 if eng._swap_store is None else len(eng._swap_store))

    def scenario(side):
        return run(side, "host"), run(side, "recompute")

    (out_swap, ins, b_out, b_in, _, _, left), (out_re, _, _, _, reps, outs, _) = \
        _both(lm, scenario)
    assert out_swap == out_re
    assert ins >= 1 and b_out > 0 and b_in > 0 and reps >= 1 and outs == 0 and left == 0


def test_swap_corruption_falls_back_to_reprefill(lm):
    """A record failing its sha check never re-enters the pool: the resume
    re-prefills, counted, with parity."""
    prompt = np.arange(1, 7, dtype=np.int32)

    def scenario(side):
        eng = side.engine(num_slots=2, max_len=32, page_size=4, admission="quantile",
                          swap="host")
        rid = eng.submit(prompt, 10)
        for _ in range(3):
            eng.step()
        eng.preempt(rid)
        eng._swap_store._recs[rid].arrays["k"].flat[0] += 1.0  # rot one element
        eng.run_until_idle()
        m = eng.metrics
        return _ints(eng.results[rid]), m.swap_fallbacks, m.reprefills, m.swap_ins

    toks, fallbacks, reprefills, ins = _both(lm, scenario)
    assert (fallbacks, reprefills, ins) == (1, 1, 0)
    assert toks == _solo(lm, prompt, 10)


@pytest.mark.parametrize("swap", ["host", "recompute"])
def test_victim_mid_speculation_parks_draft_cache(lm, swap):
    """A speculative victim parks its draft cache rows too: greedy streams
    stay solo-identical through the preemption, accept counts JAX's."""
    prompts = _prompts(3)

    def scenario(side):
        dparams, dcfg = side.draft(1)
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=10,
                          admission="optimistic", swap=swap, speculate_k=3,
                          draft_params=dparams, draft_cfg=dcfg)
        rids = [eng.submit(p, 12) for p in prompts]
        events = eng.run_until_idle()
        return ([_ints(eng.results[r]) for r in rids], _replay(events), _bill(eng),
                eng.metrics.spec_accepted)

    streams, _, bill, _ = _both(lm, scenario)
    assert bill[0] >= 1
    if swap == "host":
        assert bill[2] >= 1
    for p, toks in zip(prompts, streams):
        assert toks == _solo(lm, p, 12)


def test_preempt_then_cancel_cleans_everything(lm):
    prompt = np.arange(1, 7, dtype=np.int32)

    def scenario(side):
        eng = side.engine(num_slots=2, max_len=32, page_size=4, admission="quantile",
                          swap="host")
        rid = eng.submit(prompt, 10)
        for _ in range(3):
            eng.step()
        seen = [eng.preempt(rid), rid in eng._swap_store, eng.cancel(rid)]
        tokens, status = eng.pop_result(rid)
        return seen + [_ints(tokens), status, rid in eng._swap_store, len(eng._parked_state),
                       eng.scheduler.parked_depth, eng.pool.allocated_blocks, eng.cancel(rid)]

    got = _both(lm, scenario)
    assert got[:3] == [True, True, True] and got[4] == "cancelled" and len(got[3]) >= 1
    assert got[5:] == [False, 0, 0, 0, False]


# -- admission accounting and labels ----------------------------------------------------


def test_optimistic_beats_reserve_concurrency_at_equal_memory(lm):
    def peak(side, admission):
        eng = side.engine(num_slots=8, max_len=32, page_size=4, num_blocks=12,
                          admission=admission)
        prompt = np.arange(1, 5, dtype=np.int32)
        rids = [eng.submit(prompt, 20) for _ in range(6)]
        peak_active = 0
        while not eng.idle:
            eng.step()
            peak_active = max(peak_active, eng.pool.active_count)
        assert all(eng.status[r] == "done" for r in rids)
        return peak_active

    reserve, optimistic = _both(lm, lambda side: (peak(side, None), peak(side, "optimistic")))
    assert reserve <= 2 and optimistic >= 4


def test_stall_and_bottleneck_labels_are_policy_aware(lm):
    """A policy gate holding while blocks are free says "held by quantile
    gate"; the reserve-mode text is unchanged. Stalls and messages equal
    JAX's."""

    def scenario(side):
        eng = side.engine(num_slots=4, max_len=16, page_size=4, num_blocks=4,
                          admission="optimistic", scheduler=side.scheduler(max_queue=1))
        eng.submit(np.ones(8, np.int32), 8)
        eng.step()
        eng.pool.alloc_to(0, 12)
        eng.submit(np.ones(4, np.int32), 8)
        eng.step()
        stalls = dict(eng.scheduler.stalls)
        with pytest.raises(Exception, match="held by quantile gate") as e1:
            eng.submit(np.ones(4, np.int32), 8)
        eng2 = side.engine(num_slots=4, max_len=16, page_size=8, num_blocks=2,
                           scheduler=side.scheduler(max_queue=1))
        eng2.submit(np.ones(4, np.int32), 8)
        eng2.step()
        eng2.submit(np.ones(4, np.int32), 8)
        with pytest.raises(Exception, match="no free KV blocks") as e2:
            eng2.submit(np.ones(4, np.int32), 8)
        eng2.step()
        return (stalls, type(e1.value).__name__, str(e1.value), str(e2.value),
                dict(eng2.scheduler.stalls))

    stalls, kind, msg1, _, stalls2 = _both(lm, scenario)
    assert kind == QueueFull.__name__ and "held by quantile gate" in msg1
    assert any("held_by_quantile_gate" in k for k in stalls)
    assert "no_free_blocks" in stalls2 and not any("quantile" in k for k in stalls2)


def test_parked_queue_resumes_ahead_of_fresh_admissions(lm):
    p_hold = np.arange(1, 5, dtype=np.int32)
    p_big = np.arange(1, 9, dtype=np.int32)

    def scenario(side):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=6,
                          admission="optimistic")
        r_hold = eng.submit(p_hold, 12)
        eng.step()
        r_big = eng.submit(p_big, 8)
        eng.step()
        seen = [eng.status[r_big], eng.preempt(r_big)]
        hold_slot = next(s for s, req in enumerate(eng._slot_req) if req is not None)
        eng.pool.alloc_to(hold_slot, 20)
        seen.append(eng.pool.free_blocks)
        r_fresh = eng.submit(p_hold, 4)
        eng.step()
        seen += [eng.status[r_big], eng.status[r_fresh], dict(eng.scheduler.stalls),
                 eng._bottleneck()]
        events = eng.run_until_idle()
        return seen + [_replay(events)] + [_ints(eng.results[r])
                                           for r in (r_hold, r_big, r_fresh)]

    got = _both(lm, scenario)
    assert got[:2] == ["running", True] and got[2] < 3
    assert got[3:5] == ["preempted", "queued"]
    assert any("parked_queue_ahead" in k for k in got[5])
    assert "parked requests ahead" in got[6]
    assert got[8:] == [_solo(lm, p_hold, 12), _solo(lm, p_big, 8), _solo(lm, p_hold, 4)]


def test_governor_tightens_admission_under_thrash(lm):
    prompt = np.arange(1, 5, dtype=np.int32)

    def scenario(side):
        pol = side.policy(mode="optimistic", storm_preempts=1, storm_window=8, cooldown=1000)
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=16, admission=pol)
        r1 = eng.submit(prompt, 12)
        eng.step()
        seen = [eng.pool._slot_reserved[0], eng.preempt(r1), pol.governed(eng.tick_count)]
        eng.run_until_idle()
        eng.submit(prompt, 12)
        eng.step()
        slot = next(s for s, req in enumerate(eng._slot_req) if req is not None)
        seen += [eng.pool._slot_reserved[slot], pol.status()]
        eng.run_until_idle()
        return seen

    assert _both(lm, scenario)[:4] == [2, True, True, 4]


def test_manifest_and_stats_carry_admission_knobs(lm):
    def scenario(side):
        eng = side.engine(num_slots=2, max_len=16, page_size=4, admission="quantile",
                          swap="recompute")
        man = eng.manifest()
        with side.server(eng) as srv:
            srv.submit(np.ones(3, np.int32), 3).result(timeout=60)
            stats = srv.stats()
        eng2 = side.engine(num_slots=2, max_len=16)
        eng3 = side.engine(num_slots=2, max_len=16, page_size=4, swap_max_bytes=4096)
        with side.server(eng3) as srv:
            srv.submit(np.ones(3, np.int32), 3).result(timeout=60)
            stats3 = srv.stats()
        return ({k: man[k] for k in ("admission", "admission_q", "swap", "swap_max_bytes",
                                     "overlap_prefill", "victim_score", "memory")},
                stats["admission"], "swap_store" in stats, stats3["swap_store"],
                eng2.admission_policy is None, eng2.manifest()["admission"])

    man, adm, has_store, store3, no_policy, none = _both(lm, scenario)
    assert man["admission"] == "quantile" and man["admission_q"] == 0.85
    assert man["swap"] == "recompute" and adm["mode"] == "quantile"
    assert adm["parked"] == 0 and adm["governed"] is False
    assert has_store is False and store3["max_bytes"] == 4096
    assert no_policy and none is None


def test_admission_rejects_invalid_knobs(lm):
    def err(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — compared with JAX's
            return type(e).__name__, str(e)
        return None

    def scenario(side):
        seen = [err(lambda: side.engine(num_slots=2, max_len=16, admission="optimistic")),
                err(lambda: side.engine(num_slots=2, max_len=16, swap="disk")),
                err(lambda: side.engine(num_slots=2, max_len=16, page_size=4,
                                        admission="hopeful")),
                err(lambda: side.engine(num_slots=2, max_len=16, page_size=4,
                                        victim_score="fastest")),
                err(lambda: side.engine(num_slots=2, max_len=32, cache_dtype=side.int8)),
                err(lambda: side.engine(num_slots=2, max_len=32, page_size=4, swap="warm"))]
        seen.append(side.engine(num_slots=2, max_len=16,
                                admission="reserve").admission_policy.mode)
        return seen

    got = _both(lm, scenario)
    assert "needs paged mode" in got[0][1] and "swap must be" in got[1][1]
    assert "unknown admission mode" in got[2][1] and got[-1] == "reserve"


def test_reprefill_resume_honors_reduced_reservation(lm):
    p1 = np.arange(1, 9, dtype=np.int32)
    p2 = np.arange(2, 10, dtype=np.int32)

    def scenario(side):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=10,
                          admission="optimistic", swap="recompute")
        r1 = eng.submit(p1, 24)
        r2 = eng.submit(p2, 24)
        eng.step()
        eng.step()
        eng.preempt(r1)
        events = eng.run_until_idle()
        return _ints(eng.results[r1]), _ints(eng.results[r2]), _replay(events), _bill(eng)

    t1, t2, _, bill = _both(lm, scenario)
    assert t1 == _solo(lm, p1, 24) and t2 == _solo(lm, p2, 24) and bill[3] >= 1


@pytest.mark.parametrize("swap", ["host", "recompute"])
def test_resume_records_queue_wait_exactly_once(lm, swap):
    prompt = np.arange(1, 7, dtype=np.int32)

    def scenario(side):
        eng = side.engine(num_slots=2, max_len=32, page_size=4, admission="quantile",
                          swap=swap)
        rid = eng.submit(prompt, 10)
        for _ in range(3):
            eng.step()
        eng.preempt(rid)
        eng.run_until_idle()
        return eng.status[rid], len(eng.metrics.queue_wait), eng.metrics.prefix_misses

    assert _both(lm, scenario) == ("done", 1, 0)


def test_parked_requests_honor_deadlines(lm):
    prompt = np.arange(1, 5, dtype=np.int32)

    def scenario(side):
        eng = side.engine(num_slots=2, max_len=32, page_size=4, admission="quantile",
                          swap="host")
        rid = eng.submit(prompt, 20, deadline_ticks=0)
        eng.step()
        seen = [eng.preempt(rid), rid in eng._swap_store]
        r2 = eng.submit(prompt, 4)
        eng.step()
        seen += [eng.status[rid], rid in eng._swap_store, len(eng._parked_state),
                 eng.scheduler.parked_depth]
        tokens, status = eng.pop_result(rid)
        eng.run_until_idle()
        return seen + [status, len(tokens) >= 1, eng.status[r2]]

    assert _both(lm, scenario) == [True, True, "timeout", False, 0, 0, "timeout", True,
                                   "done"]


# -- victim scoring, overlap -------------------------------------------------------------


def test_engine_deadline_victim_score_picks_least_progress(lm):
    """``victim_score="deadline"`` and a callable: the victims JAX's engine
    picks, tick by tick, with parity for everyone."""
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(2, 7, dtype=np.int32),
               np.arange(3, 8, dtype=np.int32)]

    def run(side, victim_score):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=9,
                          admission="optimistic", victim_score=victim_score)
        rids, events = [], []
        for p in prompts:
            rids.append(eng.submit(p, 14))
            events.append(eng.step())
        events += eng.run_until_idle()
        return ([_ints(eng.results[r]) for r in rids], _replay(events),
                eng.metrics.preemptions, eng.manifest()["victim_score"])

    def scenario(side):
        calls = []

        def my_score(engine, slot):
            calls.append(slot)
            return (0, slot)

        out = [run(side, "deadline"), run(side, None), run(side, my_score)]
        return out, calls

    runs, calls = _both(lm, scenario)
    assert calls and [r[3] for r in runs] == ["deadline", None, "custom"]
    for streams, _, preemptions, _ in runs:
        assert preemptions >= 1
        assert streams == [_solo(lm, p, 14) for p in prompts]


@pytest.mark.parametrize("pool", ["fixed", "paged"])
def test_overlap_prefill_parity_fixed_and_paged(lm, pool):
    """Overlapped admission changes only the order inside a tick: every
    stream equals JAX's overlapped engine's, the port's lockstep engine's
    and ``generate_cached``'s (JAX's case: the fixed pool plain, the paged
    pool with speculation)."""
    seed = 6 if pool == "fixed" else 7
    trace_kw = dict(arrival_rate=0.6, prompt_len=(1, 12), max_new=(1, 12))

    def scenario(side, overlap=True):
        kw = dict(num_slots=4, max_len=32, overlap_prefill=overlap)
        if pool == "paged":
            dparams, dcfg = side.draft(1)
            kw.update(page_size=4, speculate_k=3, draft_params=dparams, draft_cfg=dcfg)
        eng = side.engine(**kw)
        driver = side.driver(eng, seed=seed)
        trace = driver.make_trace(8, **trace_kw)
        recs = driver.run(trace)
        return ([(_ints(r["tokens"]), r["status"]) for r in recs],
                [(list(map(int, t.prompt)), t.max_new_tokens) for t in trace],
                eng.manifest()["overlap_prefill"])

    streams, trace, overlapped = _both(lm, scenario)
    assert overlapped is True
    assert scenario(_sides(lm)["torch"], overlap=False)[0] == streams
    for (prompt, n), (toks, status) in zip(trace, streams):
        assert status == "done" and toks == _solo(lm, np.asarray(prompt, np.int32), n)


def test_overlap_prefill_with_preemption_protects_admitted_slots(lm):
    """Overlap under an optimistic policy: the slots admitted this tick are
    protected from preemption, the victims and resumes are JAX's, and every
    stream is solo-identical."""
    prompts = _prompts(9, n=6)

    def scenario(side):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=10,
                          admission="optimistic", overlap_prefill=True)
        rids = []
        events = []
        for p in prompts:
            rids.append(eng.submit(p, 12))
            events.append(eng.step())
        events += eng.run_until_idle()
        return [_ints(eng.results[r]) for r in rids], _replay(events), _bill(eng)

    streams, replay, bill = _both(lm, scenario)
    assert bill[0] >= 1 and replay
    assert streams == [_solo(lm, p, 12) for p in prompts]


# -- the port alone: fallbacks ------------------------------------------------------------


def _preempted_engine(lm, **kw):
    _, _, tcfg, tree = lm
    eng = Engine(tree, tcfg, device="cpu", num_slots=2, max_len=32, page_size=4,
                 admission="quantile", **kw)
    rid = eng.submit(np.arange(1, 7, dtype=np.int32), 10)
    for _ in range(3):
        eng.step()
    return eng, rid


def test_rotted_tier_record_falls_back_to_reprefill(lm, tmp_path):
    """A record rotted on the tiered store's disk rung fails its sha re-check
    on promotion: the request re-prefills, counted once, with parity."""
    from gradaccum_tpu_torch.memory.tiers import TieredStore

    eng, rid = _preempted_engine(lm, swap="tiered", swap_max_bytes=64)
    eng._swap_store = TieredStore(host_max_bytes=64, disk_dir=str(tmp_path))
    assert eng.preempt(rid)
    assert rid in eng._swap_store._disk
    z = dict(np.load(eng._swap_store._path(rid)))
    z["k"] = z["k"].copy()
    z["k"].flat[0] += 1.0
    np.savez(eng._swap_store._path(rid), **z)
    eng.run_until_idle()
    m = eng.metrics
    assert (m.swap_fallbacks, m.reprefills, m.swap_ins) == (1, 1, 0)
    assert eng._swap_store.corruptions == 1
    assert _ints(eng.results[rid]) == _solo(lm, np.arange(1, 7, dtype=np.int32), 10)


@pytest.mark.parametrize("at", ["put", "get"])
def test_mid_swap_io_fault_falls_back(lm, at):
    """A ``MID_SWAP_IO`` fault (index = the request id) on the swap-out or
    on the swap-in: the request re-prefills, counted once, with parity."""
    eng, rid = _preempted_engine(lm, swap="host")
    inj = tfaults.FaultInjector(tfaults.FaultSchedule([
        tfaults.FaultSpec(tfaults.MID_SWAP_IO, at=rid, kind=tfaults.KIND_IO_ERROR)]))
    if at == "get":
        assert eng.preempt(rid) and rid in eng._swap_store
    with tfaults.installed(inj):
        if at == "put":
            assert eng.preempt(rid) and rid not in eng._swap_store
        eng.run_until_idle()
    assert inj.fired == [(tfaults.MID_SWAP_IO, rid, tfaults.KIND_IO_ERROR)]
    m = eng.metrics
    assert (m.swap_fallbacks, m.reprefills, m.swap_ins) == (1, 1, 0)
    assert m.swap_outs == (1 if at == "get" else 0)
    assert _ints(eng.results[rid]) == _solo(lm, np.arange(1, 7, dtype=np.int32), 10)


def test_over_large_record_raises_capacity_and_reprefills(lm):
    """A record larger than ``swap_max_bytes``: the store raises
    ``SwapCapacityError`` (an OSError), the engine keeps no record, and the
    request re-prefills with parity."""
    eng, rid = _preempted_engine(lm, swap="host", swap_max_bytes=16)
    with pytest.raises(SwapCapacityError, match="re-prefill"):
        eng._swap_store.put(99, {"k": np.zeros(8, np.float32)}, 0, 1)
    assert issubclass(SwapCapacityError, OSError)
    assert eng.preempt(rid)
    assert rid not in eng._swap_store and eng._swap_store.held_bytes == 0
    eng.run_until_idle()
    m = eng.metrics
    assert (m.swap_fallbacks, m.reprefills, m.swap_ins, m.swap_outs) == (1, 1, 0, 0)
    assert _ints(eng.results[rid]) == _solo(lm, np.arange(1, 7, dtype=np.int32), 10)


def test_bench_admission_fast():
    """``bench_admission --fast`` on the CPU: three legs, parity on each, a
    real preemption in the optimistic leg, and JAX's acceptance."""
    from gradaccum_tpu_torch.examples import bench_admission

    result = bench_admission.main(["--fast", "--device", "cpu"])
    legs = {leg["admission"]: leg for leg in result["legs"]}
    assert set(legs) == {"reserve", "quantile", "optimistic"}
    for leg in legs.values():
        assert leg["requests_per_1k_ticks"] > 0 and leg["parity_ok"]
    assert legs["optimistic"]["preemptions"] >= 1
    assert result["acceptance"]["passed"]


# -- resilience and the sentinel ------------------------------------------------------------


def test_preempted_requests_survive_engine_fault(lm):
    """A tick crash while requests are parked: the running ones requeue, the
    parked ones resume on their own, and every stream equals JAX's and
    ``generate_cached``, with JAX's fault counts."""
    from test_torch_serving_resilience import both

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 96, 6).astype(np.int32) for _ in range(4)]
    run = both(lm, prompts, 12, [dict(point="mid_decode_tick", at=4)],
               dict(num_slots=4, max_len=32, page_size=4, num_blocks=10,
                    admission="optimistic"))
    assert run.streams == [(_solo(lm, p, 12), "length") for p in prompts]
    assert run.engine.pool.allocated_blocks == 0
    assert run.engine.metrics.preemptions >= 1


def test_block_table_corruption_is_structured_and_heals(lm):
    """The ``pool_page_table`` corrupt kind: the poisoned row faults as
    ``BlockTableCorruption`` at upload (no gather sees it), and the
    recover/requeue replays to JAX's stream and ``generate_cached``."""
    from test_torch_serving_resilience import both

    prompt = np.arange(1, 6, dtype=np.int32)
    run = both(lm, [prompt], 6, [dict(point="pool_page_table", at=2, kind="corrupt")],
               dict(num_slots=2, max_len=16, page_size=4))
    assert run.streams == [(_solo(lm, prompt, 6), "length")]
    assert run.counts["errors"] == ["BlockTableCorruption"] and run.counts["requeued"] == 1


def test_preemption_storm_sentinel_fires_and_remediates():
    """A sustained preemption rate fires ``preemption_storm`` once, routes
    through the stock remediation (recover + bounded requeue on the
    server), and resolves when the rate subsides."""
    from gradaccum_tpu_torch.obs import sentinel as obs_sentinel
    from gradaccum_tpu_torch.resilience import remediation

    recovers = []

    class FakeServer:
        def request_recover(self, reason, replica=None):
            recovers.append((reason, replica))

    snt = obs_sentinel.Sentinel(preempt_warmup=2, preempt_consecutive=2, preempt_ceiling=0.5)
    remediation.bind_default_remediations(snt, server=FakeServer())
    for _ in range(4):
        snt.observe_preemptions(0.9, replica=1)
    fires = [a for a in snt.anomalies
             if a.kind == obs_sentinel.PREEMPTION_STORM and a.state == "fire"]
    assert len(fires) == 1 and fires[0].replica == 1
    assert recovers == [("sentinel:preemption_storm replica 1", 1)]
    snt.observe_preemptions(0.0, replica=1)
    assert [a.state for a in snt.anomalies] == ["fire", "resolve"]
    assert snt.observe_preemptions(None) is None  # no admission plane: ignored
