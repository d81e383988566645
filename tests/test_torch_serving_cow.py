"""Copy-on-write tails in the port's serving engine, against JAX's.

The port's counterparts of JAX's ``tests/test_serving_cow.py``: the same
scenario on JAX's engine and the port's must report the same streams,
admission bills, fork counts and pool states, and the streams equal the
port's ``generate_cached`` for each prompt alone. Covered: the index's
sub-page entries (match, trim, forget, ``cow=False``), ``fork_cow``'s
accounting and its elision for the last reference, COW on against off
greedy and sampled, the fork deferred to the first decode write of a fully
shared prompt (its redundant write dropped), a page-aligned identical prompt
sharing every page, speculation over COW tails, the operator surfaces, the
full-chunk entry dropped with an elided fork, ``is_live`` ignoring sub-page
entries, and COW needing the prefix cache.

Since admission and swap landed (5d): the ``PoolPressure`` leg of
``test_pool_fork_cow_accounting`` (as its own case), a COW sharer preempted
after its fork on both swap legs, an unforked sharer preempted with nothing
private to swap, and a rotted swap record degrading to a prefix-aware
re-prefill without leaking a reference. JAX's deadline victim cases are in
``tests/test_torch_serving_admission.py``.

``test_bench_cow_fast``: the port's ``examples/bench_cow.py`` on JAX's
weights reports JAX's legs number for number and meets JAX's acceptance.

Left out: ``test_cow_reconfig_pool_shrink_parity`` (reconfiguration, 5g,
first half). A COW fork that faults half done is in
``tests/test_torch_serving_resilience.py``.
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
from gradaccum_tpu_torch.serving import (
    Engine,
    PagedCachePool,
    PoolPressure,
    PrefixCache,
    ServingServer,
    SimulationDriver,
    TraceItem,
)
from gradaccum_tpu_torch.utils import prng

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jdec = importlib.import_module("gradaccum_tpu.models.gpt_decode")
jserving = importlib.import_module("gradaccum_tpu.serving")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SAMPLING = {"greedy": {}, "sampled": dict(temperature=0.8, top_k=5)}


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

    def port_admit(engine, reqs):
        engine._admit_finish(engine._admit_dispatch(reqs), [], [], [])

    return {
        "jax": types.SimpleNamespace(
            engine=lambda **kw: jserving.Engine(params, jcfg, **kw),
            draft=lambda n: jdec.truncate_draft_params(params, jcfg, n),
            server=jserving.ServingServer,
            admit=lambda engine, reqs: engine._admit(reqs, [], [], [])),
        "torch": types.SimpleNamespace(
            engine=lambda **kw: Engine(tree, tcfg, device="cpu", **kw),
            draft=lambda n: tdec.truncate_draft_params(tree, tcfg, n),
            server=ServingServer, admit=port_admit),
    }


def _both(lm, scenario):
    got = {name: scenario(side) for name, side in _sides(lm).items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _ints(tokens):
    return [int(t) for t in tokens]


def _solo(lm, prompt, n, sampling="greedy", seed=0):
    _, _, tcfg, tree = lm
    return tdec.generate_cached(tree, tcfg, prompt, n, rng=prng.PRNGKey(seed),
                                **SAMPLING[sampling])[0, len(prompt):].tolist()


def _drained(pool):
    return (pool.allocated_blocks == 0 and pool.unreserved_blocks == pool.num_blocks
            and pool._orphans == 0)


def _admit_alone(side, engine, rid, prompt):
    """Admit the queued ``rid`` with no decode tick after it (its match
    seeded as the tick's admission gate seeds it)."""
    reqs = engine.scheduler.admit(engine.pool.free_count, engine.tick_count)
    engine._pending_match[rid] = engine.prefix_cache.match_cow(prompt)
    side.admit(engine, reqs)


# -- index and pool units -----------------------------------------------------------


def test_prefix_cache_cow_unit():
    """JAX's unit case; every answer is also JAX's index's."""
    answers = []
    for make in (PrefixCache, jserving.PrefixCache):
        seen = []
        pc = make(page_size=4)
        prompt = np.arange(11, dtype=np.int32)  # 2 full pages + a 3-token tail
        pc.insert(prompt, [7, 3])
        pc.insert_tail(prompt, 9)
        seen.append((len(pc), pc.tail_count, pc.match_cow(prompt)))
        other, mid = prompt.copy(), prompt.copy()
        other[10] = 90
        mid[5] = 90
        longer = np.arange(20, dtype=np.int32)
        seen += [pc.match_cow(other), pc.match_cow(mid), pc.match_cow(longer)]
        pc2 = make(page_size=8)
        pc2.insert_tail(np.arange(5, dtype=np.int32), 2)
        seen.append(pc2.match_cow(np.arange(6, dtype=np.int32)))
        pc.trim_tail(9, 2)
        seen.append(pc.match_cow(longer))
        pc.forget_block(9)
        seen += [pc.match_cow(longer), pc.is_live(9)]
        off = make(page_size=4, cow=False)
        off.insert(prompt, [7, 3])
        off.insert_tail(prompt, 9)
        aligned = np.arange(8, dtype=np.int32)
        seen += [off.match_cow(prompt), off.match_cow(aligned)]
        on = make(page_size=4)
        on.insert(prompt, [7, 3])
        seen.append(on.match_cow(aligned))
        answers.append(seen)
    assert answers[0] == answers[1]
    assert answers[0] == [
        (2, 9, ([7, 3], 9, 3)), ([7, 3], 9, 2), ([7], 3, 1), ([7, 3], 9, 3), ([], 2, 5),
        ([7, 3], 9, 2), ([7, 3], None, 0), False, ([7, 3], None, 0), ([7], None, 0),
        ([7, 3], None, 0)]


def test_pool_fork_cow_accounting(lm):
    """``fork_cow`` swaps an adopted tail for a private block with every
    count truthful, and elides the copy for the last reference; the port's
    pool beside JAX's at each step."""
    jcfg, _, tcfg, _ = lm

    def scenario(make, cfg):
        seen = []
        pool = make(cfg, num_slots=3, max_len=32, page_size=4, num_blocks=6)
        a = pool.claim()
        pool.reserve(a, 8)
        pool.alloc_to(a, 7)
        tail = pool.blocks_of(a)[1]
        b = pool.claim()
        pool.reserve(b, 8, shared_blocks=1)  # the tail's fork is not discounted
        pool.adopt_shared(b, [pool.blocks_of(a)[0], tail])
        seen.append((pool.refcount(tail), pool.shared_blocks))
        old = pool.fork_cow(b, 1)
        new = int(pool.page_table[b, 1])
        seen.append((old == tail, new != tail, pool.refcount(new), pool.owner_of(new),
                     pool.refcount(tail), pool.owner_of(tail), pool.shared_blocks,
                     pool.blocks_of(b)[1] == new))
        c = pool.claim()
        pool.reserve(c, 8)
        pool.adopt_shared(c, [tail])
        pool.release(a)
        seen.append(pool._orphans)
        seen.append((pool.fork_cow(c, 0), pool.owner_of(tail), pool.refcount(tail),
                     pool._orphans))
        with pytest.raises(ValueError, match="maps no live block"):
            pool.fork_cow(c, 3)
        pool.release(b)
        pool.release(c)
        seen.append((pool.allocated_blocks, pool.unreserved_blocks, pool._orphans))
        return seen

    got = scenario(PagedCachePool, tcfg)
    assert got == scenario(jserving.PagedCachePool, jcfg)
    assert got == [(2, 2), (True, True, 1, 1, 1, 0, 1, True), 2, (None, 2, 1, 1), (0, 6, 0)]


def test_pool_fork_cow_pressure_under_overcommit(lm):
    """JAX's pressure leg of ``test_pool_fork_cow_accounting``: a fork
    against a dry free list under ``allow_overcommit`` raises
    ``PoolPressure``, on both pools at the same state."""
    jcfg, _, tcfg, _ = lm

    def scenario(make, cfg, pressure):
        pool = make(cfg, num_slots=4, max_len=32, page_size=4, num_blocks=6)
        a = pool.claim()
        pool.reserve(a, 8)
        pool.alloc_to(a, 7)
        tail = pool.blocks_of(a)[1]
        c = pool.claim()
        pool.reserve(c, 8)
        pool.adopt_shared(c, [tail])
        pool.allow_overcommit = True
        e = pool.claim()
        pool.reserve(e, 4)
        pool.adopt_shared(e, [tail])
        pool.alloc_to(c, 4 * (len(pool.blocks_of(c)) + pool.free_blocks))
        seen = [pool.free_blocks, pool.refcount(tail), pool.blocks_of(c)]
        with pytest.raises(pressure) as exc:
            pool.fork_cow(e, 0)
        return seen + [exc.value.slot, exc.value.need_blocks, pool.blocks_of(e)]

    got = scenario(PagedCachePool, tcfg, PoolPressure)
    assert got == scenario(jserving.PagedCachePool, jcfg, jserving.PoolPressure)
    assert got[0] == 0


# -- preemption of COW sharers (5d) -----------------------------------------------------


def _cow_pair(seed):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, 96, 9).astype(np.int32)
    return (np.concatenate([sys_p, rng.integers(0, 96, 2).astype(np.int32)]),
            np.concatenate([sys_p, rng.integers(0, 96, 3).astype(np.int32)]))


@pytest.mark.parametrize("swap", ["host", "recompute"])
def test_cow_fork_under_forced_preemption_parity(lm, swap):
    """A COW sharer preempted after its fork resumes token for token on both
    swap legs (re-prefill re-adopts the shared head); the survivor is
    untouched and the pool drains. Bills and pool states equal JAX's."""
    p1, p2 = _cow_pair(10)

    def scenario(side):
        eng = side.engine(num_slots=3, max_len=32, page_size=4, prefix_cache=True,
                          admission="quantile", swap=swap)
        r1 = eng.submit(p1, 10)
        eng.step()
        r2 = eng.submit(p2, 10)
        eng.step()
        seen = [eng.metrics.cow_adoptions, eng.preempt(r2), eng.status[r1]]
        eng.run_until_idle()
        m = eng.metrics
        return seen + [_ints(eng.results[r1]), _ints(eng.results[r2]), m.swap_ins,
                       m.reprefills, m.resume_prefill_tokens_saved, _drained(eng.pool)]

    got = _both(lm, scenario)
    assert got[0] >= 1 and got[1] is True and got[2] == "running"
    assert got[3] == _solo(lm, p1, 10) and got[4] == _solo(lm, p2, 10)
    if swap == "host":
        assert got[5] == 1
    else:
        assert got[6] == 1 and got[7] >= 8
    assert got[8] is True


def test_unforked_cow_preemption_resumes_clean(lm):
    """A fully shared stream preempted before its first decode write has
    nothing private to swap: it parks an empty footprint and resumes by a
    1-token re-prefill that re-adopts everything."""
    prompt = np.random.default_rng(11).integers(0, 96, 9).astype(np.int32)

    def scenario(side):
        eng = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True,
                          admission="quantile", swap="host")
        r1 = eng.submit(prompt, 8)
        eng.step()
        r2 = eng.submit(prompt.copy(), 8)
        _admit_alone(side, eng, r2, prompt)
        eng._active[1] = True
        eng.status[r2] = "running"
        seen = [int(eng._slot_cow[1]), eng.preempt(r2), eng.metrics.swap_outs]
        eng.run_until_idle()
        return seen + [_ints(eng.results[r1]), _ints(eng.results[r2]), eng.metrics.reprefills,
                       _drained(eng.pool)]

    got = _both(lm, scenario)
    assert got[:3] == [9, True, 0]
    assert got[3] == got[4] == _solo(lm, prompt, 8)
    assert got[5:] == [1, True]


def test_swap_degrade_releases_cow_refs_and_readopts(lm):
    """A rotted record at resume degrades to re-prefill without leaking a
    shared or COW reference taken for the abandoned swap plan: the degraded
    resume re-adopts through the prefix-aware path, the pool drains."""
    p1, p2 = _cow_pair(12)

    def scenario(side):
        eng = side.engine(num_slots=3, max_len=32, page_size=4, prefix_cache=True,
                          admission="quantile", swap="host")
        r1 = eng.submit(p1, 10)
        eng.step()
        r2 = eng.submit(p2, 10)
        eng.step()
        eng.preempt(r2)
        eng._swap_store._recs[r2].arrays["k"].flat[0] += 1.0
        eng.run_until_idle()
        m = eng.metrics
        return [m.swap_fallbacks, m.swap_ins, m.reprefills, m.resume_prefill_tokens_saved,
                _ints(eng.results[r1]), _ints(eng.results[r2]), _drained(eng.pool),
                len(eng._swap_store)]

    got = _both(lm, scenario)
    assert got[:3] == [1, 0, 1] and got[3] >= 8
    assert got[4] == _solo(lm, p1, 10) and got[5] == _solo(lm, p2, 10)
    assert got[6:] == [True, 0]


# -- parity gates ---------------------------------------------------------------------


def _shared_trace(sys_len, n=5, seed=0):
    """JAX's trace: staggered arrivals behind one sub-page-tailed prompt."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, 96, sys_len).astype(np.int32)
    return [TraceItem(arrival_tick=0 if i == 0 else 1 + 2 * i,
                      prompt=np.concatenate([sys_p, rng.integers(0, 96, int(rng.integers(1, 5)))
                                             .astype(np.int32)]),
                      max_new_tokens=int(rng.integers(4, 9)), rng_seed=i) for i in range(n)]


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_cow_on_off_token_parity(lm, sampling):
    kw = SAMPLING[sampling]
    trace = _shared_trace(sys_len=9)
    jtrace = [jserving.server.TraceItem(arrival_tick=i.arrival_tick, prompt=i.prompt,
                                        max_new_tokens=i.max_new_tokens, rng_seed=i.rng_seed)
              for i in trace]

    def scenario(side):
        out = {}
        for cow in (False, True):
            engine = side.engine(num_slots=3, max_len=32, page_size=4, prefix_cache=True,
                                 cow_tails=cow, **kw)
            driver = (SimulationDriver if side.server is ServingServer
                      else jserving.SimulationDriver)(engine, seed=0)
            records = driver.run(trace if side.server is ServingServer else jtrace)
            m = engine.metrics
            out[cow] = dict(streams=[_ints(r["tokens"]) for r in records],
                            drained=_drained(engine.pool), ticks=engine.decode_compile_count(),
                            adoptions=m.cow_adoptions, forks=m.cow_forks,
                            skipped=m.prefill_tokens_skipped, index=len(engine.prefix_cache))
        return out

    out = _both(lm, scenario)
    assert out[True]["streams"] == out[False]["streams"]
    assert out[True]["adoptions"] > 0 and out[True]["forks"] > 0
    assert out[True]["skipped"] > out[False]["skipped"]
    for leg in out.values():
        assert leg["drained"] and leg["ticks"] == 1 and leg["index"] == 0
    for item, toks in zip(trace, out[True]["streams"]):
        assert toks == _solo(lm, item.prompt, item.max_new_tokens, sampling, item.rng_seed)


def test_fully_shared_prompt_defers_fork_and_drops_write(lm):
    """An identical prompt recomputes one token (its write dropped),
    allocates nothing at admission, and forks at its first decode write."""
    prompt = np.random.default_rng(7).integers(0, 96, 9).astype(np.int32)

    def scenario(side):
        engine = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True)
        r1 = engine.submit(prompt, 6)
        engine.step()
        m, pool = engine.metrics, engine.pool
        computed, blocks = m.prefill_tokens_computed, pool.allocated_blocks
        r2 = engine.submit(prompt.copy(), 6)
        _admit_alone(side, engine, r2, prompt)
        at_admission = (m.prefill_tokens_computed - computed, m.prefill_tokens_skipped,
                        pool.allocated_blocks - blocks, m.cow_adoptions, m.cow_forks,
                        int(engine._slot_cow[1]))
        engine.run_until_idle()
        return (at_admission, m.cow_forks, _ints(engine.results[r1]),
                _ints(engine.results[r2]), _drained(pool))

    at_admission, forks, s1, s2, drained = _both(lm, scenario)
    assert at_admission[0] == 1 and at_admission[1] >= 8
    assert at_admission[2:] == (0, 1, 0, 9)  # nothing allocated, armed, not forked
    assert forks == 1 and drained
    assert s1 == s2 == _solo(lm, prompt, 6)


def test_aligned_identical_prompt_shares_every_page(lm):
    prompt = np.random.default_rng(8).integers(0, 96, 8).astype(np.int32)  # 2 pages

    def scenario(side):
        grew = {}
        for cow in (False, True):
            engine = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True,
                                 cow_tails=cow)
            r1 = engine.submit(prompt, 4)
            engine.step()
            before = engine.pool.allocated_blocks
            r2 = engine.submit(prompt.copy(), 4)
            engine.step()
            grew[cow] = engine.pool.allocated_blocks - before
            engine.run_until_idle()
            grew[cow, "streams"] = [_ints(engine.results[r]) for r in (r1, r2)]
        return grew

    grew = _both(lm, scenario)
    assert grew[True] < grew[False]
    assert grew[True, "streams"] == grew[False, "streams"] == [_solo(lm, prompt, 4)] * 2


def test_cow_spec_parity(lm):
    rng = np.random.default_rng(9)
    sys_p = rng.integers(0, 96, 9).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 96, k).astype(np.int32)]) for k in (2, 3)]

    def scenario(side):
        draft, draft_cfg = side.draft(1)
        engine = side.engine(num_slots=3, max_len=32, page_size=4, prefix_cache=True,
                             speculate_k=3, draft_params=draft, draft_cfg=draft_cfg)
        rids = []
        for p in prompts:
            rids.append(engine.submit(p, 8))
            engine.step()
        engine.run_until_idle()
        m = engine.metrics
        return ([_ints(engine.results[r]) for r in rids], m.cow_adoptions, m.spec_accepted,
                engine.prefill_compile_count(), _drained(engine.pool))

    streams, adoptions, _, _, drained = _both(lm, scenario)
    assert adoptions >= 1 and drained
    assert streams == [_solo(lm, p, 8) for p in prompts]


# -- surfaces and regressions ------------------------------------------------------------


def test_cow_metrics_and_stats_surfaces(lm):
    prompt = np.random.default_rng(14).integers(0, 96, 9).astype(np.int32)

    def scenario(side):
        engine = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True)
        cow_knob = engine.manifest()["cow_tails"]
        engine.submit(prompt, 6)
        engine.step()
        engine.submit(prompt.copy(), 6)
        engine.step()
        engine.run_until_idle()
        m = engine.metrics.summary()
        stats = side.server(engine).stats()
        off = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True,
                          cow_tails=False)
        return (cow_knob, m["cow_adoptions"], m["cow_forks"], m["cow_tokens_shared"],
                m["cow_shared_blocks_peak"], stats["prefix"]["cow"],
                off.manifest()["cow_tails"], "cow" in side.server(off).stats()["prefix"])

    knob, adoptions, forks, shared, peak, cow, off_knob, off_has = _both(lm, scenario)
    assert knob is True and adoptions == 1 and forks == 1 and shared >= 1
    assert peak == 0  # the fork lands in the admitting tick, before the gauge
    assert cow["adoptions"] == 1 and cow["forks"] == 1
    assert off_knob is False and not off_has
    _, _, tcfg, tree = lm
    engine = Engine(tree, tcfg, num_slots=2, max_len=32, page_size=4, prefix_cache=True,
                    device="cpu")
    prom = engine.metrics.to_prometheus()
    for counter in ("serving_cow_adoptions_total", "serving_cow_forks_total",
                    "serving_resume_prefill_tokens_saved_total"):
        assert counter in prom


def test_elided_fork_drops_full_chunk_entry(lm):
    """B adopts A's last block as a fully shared COW tail, A cancels, B's
    fork elides and B decodes into the block: the block's full-chunk entry
    goes with the takeover, so A's exact prompt later misses it."""
    pa = np.random.default_rng(21).integers(0, 96, 8).astype(np.int32)
    pb = pa[:6].copy()

    def scenario(side):
        engine = side.engine(num_slots=3, max_len=32, page_size=4, prefix_cache=True)
        ra = engine.submit(pa, 8)
        engine.step()
        rb = engine.submit(pb, 8)
        _admit_alone(side, engine, rb, pb)
        adoptions = engine.metrics.cow_adoptions
        assert engine.cancel(ra)
        engine.step()
        elided = engine.metrics.cow_forks_elided
        rc = engine.submit(pa.copy(), 8)
        engine.run_until_idle()
        return (adoptions, elided, _ints(engine.results[rb]), _ints(engine.results[rc]),
                _drained(engine.pool))

    adoptions, elided, sb, sc, drained = _both(lm, scenario)
    assert adoptions == 1 and elided == 1 and drained
    assert sb == _solo(lm, pb, 8) and sc == _solo(lm, pa, 8)


def test_is_live_ignores_subpage_entries():
    for make in (PrefixCache, jserving.PrefixCache):
        pc = make(page_size=4)
        pc.insert(np.arange(8, dtype=np.int32), [5, 6])
        assert pc.is_live(5) and pc.is_live(6)
        pc.insert_tail(np.arange(11, dtype=np.int32), 7)
        assert pc.tail_count > 0 and not pc.is_live(7)


def test_cow_requires_prefix_mode(lm):
    _, _, tcfg, tree = lm
    assert Engine(tree, tcfg, num_slots=2, max_len=16, device="cpu").cow_tails is False
    assert Engine(tree, tcfg, num_slots=2, max_len=16, page_size=4,
                  device="cpu").cow_tails is False
    injected = Engine(tree, tcfg, num_slots=2, max_len=16, page_size=4,
                      prefix_cache=PrefixCache(4, cow=False), device="cpu")
    assert injected.cow_tails is False and injected.manifest()["cow_tails"] is False


def test_bench_cow_fast(lm, tmp_path):
    """``bench_cow --fast`` on JAX's weights: every capacity and resume leg
    equal to JAX's ``tools/bench_cow.py``, and JAX's checks on it."""
    import os
    import sys

    from gradaccum_tpu_torch.examples import bench_cow

    _, _, tcfg, tree = lm
    result = bench_cow.run(tree, tcfg, fast=True, device="cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools.bench_cow import main as jax_main

    want = jax_main(["--fast", "--out", str(tmp_path / "BENCH_cow.json")])
    for key in ("cow_legs", "resume_legs", "fixed_parity_ok", "peak_concurrency_x",
                "kv_bytes_per_stream_reduction", "resume_tokens_x"):
        assert result[key] == want[key], key
    assert result["acceptance"]["passed"] == want["acceptance"]["passed"]
    legs = {leg["leg"]: leg for leg in result["cow_legs"]}
    assert set(legs) == {"paged", "prefix", "cow"}
    assert all(leg["parity_ok"] and leg["decode_programs"] == 1 for leg in legs.values())
    assert legs["cow"]["prefill_tokens_skipped"] > legs["prefix"]["prefill_tokens_skipped"]
    assert legs["cow"]["cow_forks"] >= 1 and legs["paged"]["prefill_tokens_skipped"] == 0
    assert result["resume_tokens_x"] >= 2.0 and result["fixed_parity_ok"]
    assert result["acceptance"]["passed"]
