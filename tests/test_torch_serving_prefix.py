"""Prefix sharing in the port's serving engine, against JAX's.

The port's counterparts of JAX's ``tests/test_serving_prefix.py``. Each
scenario runs on JAX's engine and on the port's (JAX's tiny LM carried over)
and the two must report the same numbers: streams, admission bills, block
counts, stats. On top:

- three seeded traces whose prompts share a system prompt (an eos
  retirement mid-stream in each), greedy and sampled: prefix off, prefix on
  without COW tails and with them give the same streams, equal to the
  port's ``generate_cached`` and to JAX's engine, token for token;
- the pool replayed tick by tick beside JAX's on the same trace:
  ``blocks_of``, ``refcount``, ``shared_blocks`` and ``unreserved_blocks``
  after every tick, and the pool drains to zero;
- ``PrefixCache`` keys a prompt the same whatever it came as (an int64
  torch tensor, an int64 array, a list): the bytes hashed are ``np.int32``.

- a mid-tick crash on a prefix-sharing engine
  (``test_prefix_engine_recovers_from_tick_fault``): the recover decrefs
  through the normal release, the index ends empty, the requeued streams
  equal JAX's and ``generate_cached``, with JAX's fault counts.

Left out: the slow-lane
``test_serving_smoke_prefix`` (JAX's ``tools/serving_smoke.py``, never
ported) and ``test_bench_prefix_fast`` (``bench_serving --prefix --fast`` runs
in ``tests/test_torch_bench_serving.py``); ``test_bench_trend_*``
(``tools/bench_trend.py`` over JAX's committed artifacts, never ported).
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
    """Both packages behind one namespace each: a scenario written once runs
    on JAX's engine and on the port's."""
    jcfg, params, tcfg, tree = lm
    return {
        "jax": types.SimpleNamespace(
            cfg=jcfg, engine=lambda **kw: jserving.Engine(params, jcfg, **kw),
            server=jserving.ServingServer),
        "torch": types.SimpleNamespace(
            cfg=tcfg, engine=lambda **kw: Engine(tree, tcfg, device="cpu", **kw),
            server=ServingServer),
    }


def _both(lm, scenario):
    """Run ``scenario(side)`` on both packages; their observations must be
    equal. Returns the port's."""
    got = {name: scenario(side) for name, side in _sides(lm).items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _ints(tokens):
    return [int(t) for t in tokens]


def _solo(lm, prompt, n, sampling="greedy", seed=0):
    _, _, tcfg, tree = lm
    kw = SAMPLING[sampling]
    return tdec.generate_cached(tree, tcfg, prompt, n, rng=prng.PRNGKey(seed),
                                **kw)[0, len(prompt):].tolist()


def _drained(pool):
    return (pool.allocated_blocks == 0 and pool.unreserved_blocks == pool.num_blocks
            and pool._orphans == 0)


def _shared_prefix_trace(lm, n=6, sys_len=9, seed=0, eos_for=(2,)):
    """JAX's trace: staggered arrivals behind one system prompt, the leader a
    tick ahead; ``eos_for`` takes an eos from the request's own greedy
    stream so it retires mid-stream."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, 96, sys_len).astype(np.int32)
    items = []
    for i in range(n):
        tail = rng.integers(0, 96, int(rng.integers(2, 7))).astype(np.int32)
        prompt = np.concatenate([sys_p, tail])
        max_new = int(rng.integers(4, 10))
        eos = None
        if i in eos_for:
            full = _solo(lm, prompt, max_new)
            k = next((j for j in range(1, len(full)) if full[j] not in full[:j]), None)
            eos = None if k is None else int(full[k])
        items.append(TraceItem(arrival_tick=0 if i == 0 else 1 + 2 * i, prompt=prompt,
                               max_new_tokens=max_new, eos_id=eos, rng_seed=i))
    return items


def _jax_items(trace):
    return [jserving.server.TraceItem(arrival_tick=i.arrival_tick, prompt=i.prompt,
                                      max_new_tokens=i.max_new_tokens, eos_id=i.eos_id,
                                      rng_seed=i.rng_seed) for i in trace]


# -- the parity gate -------------------------------------------------------------


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_on_off_token_parity(lm, seed, sampling):
    kw = SAMPLING[sampling]
    trace = _shared_prefix_trace(lm, seed=seed)
    sides = _sides(lm)
    streams = {}
    for leg, prefix in (("off", dict(prefix_cache=False)),
                        ("on", dict(prefix_cache=True, cow_tails=False)),
                        ("cow", dict(prefix_cache=True))):
        engine = sides["torch"].engine(num_slots=3, max_len=32, page_size=4, **prefix, **kw)
        records = SimulationDriver(engine, seed=0).run(trace)
        assert _drained(engine.pool) and engine.decode_compile_count() == 1
        streams[leg] = [rec["tokens"] for rec in records]
        if leg != "off":
            m = engine.metrics.summary()
            assert m["prefix_hit_rate"] > 0 and m["prefill_tokens_skipped"] > 0
            assert m["shared_blocks_peak"] > 0 and len(engine.prefix_cache) == 0
    assert streams["on"] == streams["off"] == streams["cow"]
    jeng = sides["jax"].engine(num_slots=3, max_len=32, page_size=4, prefix_cache=True, **kw)
    jstreams = [_ints(rec["tokens"])
                for rec in jserving.SimulationDriver(jeng, seed=0).run(_jax_items(trace))]
    assert streams["cow"] == jstreams
    for item, toks in zip(trace, streams["cow"]):
        want = _solo(lm, item.prompt, item.max_new_tokens, sampling, item.rng_seed)
        if item.eos_id is not None and item.eos_id in want:
            want = want[:want.index(item.eos_id) + 1]
        assert toks == want


def _pool_view(pool, num_slots):
    return dict(blocks=[list(map(int, pool.blocks_of(s))) for s in range(num_slots)],
                refs=[pool.refcount(b) for b in range(pool.num_blocks)],
                shared=pool.shared_blocks, unreserved=pool.unreserved_blocks,
                allocated=pool.allocated_blocks, orphans=pool._orphans)


@pytest.mark.parametrize("cow", [False, True], ids=["prefix", "cow"])
def test_pool_replay_equals_jax_tick_by_tick(lm, cow):
    """The same shared-prefix trace fed to JAX's engine and the port's in
    lockstep: after every tick the pools hold the same blocks."""
    trace = _shared_prefix_trace(lm, n=7, seed=3, eos_for=(1, 4))

    def scenario(side):
        engine = side.engine(num_slots=3, max_len=32, page_size=4, num_blocks=20,
                             prefix_cache=True, cow_tails=cow)
        views, pending, tick = [], list(trace), 0
        while pending or not engine.idle:
            while pending and pending[0].arrival_tick <= tick:
                item = pending.pop(0)
                engine.submit(item.prompt, item.max_new_tokens, eos_id=item.eos_id,
                              rng_seed=item.rng_seed)
            engine.step()
            tick += 1
            views.append(_pool_view(engine.pool, 3))
        assert _drained(engine.pool)
        return views, engine.metrics.prefill_tokens_skipped, engine.metrics.cow_forks

    views, skipped, forks = _both(lm, scenario)
    assert skipped > 0 and max(v["shared"] for v in views) > 0
    assert (forks > 0) == cow


def test_prefix_hit_skips_prefill_and_shares_blocks(lm):
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, 96, 9).astype(np.int32)  # 2 full pages
    tail = rng.integers(0, 96, 3).astype(np.int32)

    def scenario(side):
        engine = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True)
        engine.submit(sys_p, 8)
        engine.step()
        before = engine.pool.allocated_blocks
        engine.submit(np.concatenate([sys_p, tail]), 8)
        engine.step()
        m = engine.metrics.summary()
        return dict(hits=engine.metrics.prefix_hits, skipped=m["prefill_tokens_skipped"],
                    saved=m["blocks_saved"], adoptions=m["cow_adoptions"],
                    forks=m["cow_forks"], shared=engine.pool.shared_blocks,
                    grew=engine.pool.allocated_blocks - before)

    # two full pages and the leader's one-token COW tail; the follower's
    # suffix write forks the tail; one fork block and one decode page
    assert _both(lm, scenario) == dict(hits=1, skipped=9, saved=3, adoptions=1, forks=1,
                                       shared=2, grew=2)


def test_prefix_blocks_survive_owner_release_then_reclaim(lm):
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, 96, 8).astype(np.int32)
    pa = np.concatenate([sys_p, rng.integers(0, 96, 4).astype(np.int32)])
    pb = np.concatenate([sys_p, rng.integers(0, 96, 6).astype(np.int32)])

    def scenario(side):
        engine = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True)
        ra = engine.submit(pa, 4)
        engine.step()
        rb = engine.submit(pb, 12)
        engine.step()
        out = dict(shared=engine.pool.shared_blocks)
        while engine.status[ra] != "done":
            engine.step()
        pool = engine.pool
        out.update(orphans=pool._orphans,
                   unreserved_gap=pool.num_blocks - pool._reserved_total - pool.unreserved_blocks)
        engine.run_until_idle()
        out.update(drained=_drained(pool), index=len(engine.prefix_cache))
        hits = engine.metrics.prefix_hits
        rc = engine.submit(pa, 4)  # recycled blocks: a clean miss, not a stale hit
        engine.run_until_idle()
        out.update(rehit=engine.metrics.prefix_hits - hits,
                   streams=[_ints(engine.results[r]) for r in (ra, rb, rc)])
        return out

    out = _both(lm, scenario)
    assert out["shared"] == 2 and out["orphans"] == 2 and out["unreserved_gap"] == 2
    assert out["drained"] and out["index"] == 0 and out["rehit"] == 0
    assert out["streams"] == [_solo(lm, pa, 4), _solo(lm, pb, 12), _solo(lm, pa, 4)]


def test_prefix_cancel_midstream_decrefs_shared_only(lm):
    rng = np.random.default_rng(5)
    sys_p = rng.integers(0, 96, 8).astype(np.int32)
    pa = np.concatenate([sys_p, rng.integers(0, 96, 4).astype(np.int32)])
    pb = np.concatenate([sys_p, rng.integers(0, 96, 5).astype(np.int32)])

    def scenario(side):
        engine = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True)
        ra = engine.submit(pa, 10)
        engine.step()
        rb = engine.submit(pb, 10)
        engine.step()
        pool = engine.pool
        mid = (pool.shared_blocks, pool.allocated_blocks, pool._reserved_total)
        assert engine.cancel(rb)
        after = (pool.shared_blocks, pool.allocated_blocks, pool._reserved_total)
        partial, status = engine.pop_result(rb)
        engine.run_until_idle()
        return dict(mid=mid, after=after, status=status, partial=_ints(partial),
                    a=_ints(engine.results[ra]), drained=_drained(pool))

    out = _both(lm, scenario)
    assert out["mid"][0] == 2 and out["after"][0] == 0
    assert out["after"][1] < out["mid"][1] and out["after"][2] < out["mid"][2]
    assert out["status"] == "cancelled" and out["drained"]
    assert out["a"] == _solo(lm, pa, 10)
    assert out["partial"] == _solo(lm, pb, 10)[:len(out["partial"])]


def test_prefix_aware_reservation_admits_what_sharing_affords(lm):
    """A follower that fits only because its prefix is shared is admitted
    with the cache on and stalls for blocks with it off, same pool."""
    rng = np.random.default_rng(6)
    sys_p = rng.integers(0, 96, 8).astype(np.int32)
    tail = rng.integers(0, 96, 2).astype(np.int32)

    def scenario(side):
        out = {}
        for prefix in (False, True):
            engine = side.engine(num_slots=2, max_len=16, page_size=4, num_blocks=6,
                                 prefix_cache=prefix)
            engine.submit(sys_p, 6)
            engine.step()
            rid = engine.submit(np.concatenate([sys_p, tail]), 6)
            engine.step()
            status, stalls = engine.status[rid], dict(engine.scheduler.stalls)
            engine.run_until_idle()
            out[prefix] = (status, stalls, _ints(engine.results[rid]))
        return out

    out = _both(lm, scenario)
    assert out[False][0] == "queued" and out[False][1].get("no_free_blocks", 0) > 0
    assert out[True][0] == "running" and out[True][2] == out[False][2]


# -- pool and index units ---------------------------------------------------------


def test_prefix_cache_unit():
    """JAX's unit case on the port's index, each answer also JAX's."""
    for make in (PrefixCache, jserving.PrefixCache):
        pc = make(page_size=4)
        prompt = np.arange(12, dtype=np.int32)
        pc.insert(prompt, [7, 3, 9])
        assert len(pc) == 3
        assert pc.match(prompt) == [7, 3]  # clamped below the prompt
        assert pc.match(np.arange(20, dtype=np.int32)) == [7, 3, 9]
        other = np.concatenate([np.arange(4), np.full(8, 99)]).astype(np.int32)
        assert pc.match(other) == [7]
        assert pc.match(np.arange(4, dtype=np.int32)) == []
        pc.forget_block(3)
        assert pc.match(np.arange(20, dtype=np.int32)) == [7]
        pc.insert(prompt, [1, 2])  # the first writer stays canonical
        assert pc.match(np.arange(20, dtype=np.int32)) == [7, 2, 9]
        pc.clear()
        assert len(pc) == 0 and pc.match(prompt) == []


def test_prefix_cache_keys_int32_bytes_whatever_the_input():
    """A prompt given as an int64 torch tensor, an int64 array or a list
    keys as JAX's index keys its ``np.int32`` bytes."""
    prompt = np.random.default_rng(9).integers(0, 96, 13)
    forms = [prompt.astype(np.int32), prompt.astype(np.int64), prompt.tolist(),
             torch.tensor(prompt, dtype=torch.int64)]
    jpc = jserving.PrefixCache(page_size=4)
    jpc.insert(prompt.astype(np.int32), [5, 6, 7])
    jpc.insert_tail(prompt.astype(np.int32), 8)
    want = jpc.match_cow(prompt.astype(np.int32))
    assert want == ([5, 6, 7], 8, 1)
    for form in forms:
        pc = PrefixCache(page_size=4)
        pc.insert(form, [5, 6, 7])
        pc.insert_tail(form, 8)
        assert pc._by_hash == jpc._by_hash and pc.tail_count == jpc.tail_count
        for query in forms:
            assert pc.match_cow(query) == want
            assert pc.match(query) == jpc.match(prompt.astype(np.int32))


def test_pool_refcount_and_shared_reservation_accounting(lm):
    """JAX's unit case, the port's pool beside JAX's at every step."""
    jcfg, _, tcfg, _ = lm

    def scenario(make, cfg, cache):
        pc = cache(page_size=4)
        pool = make(cfg, num_slots=3, max_len=16, page_size=4, num_blocks=8, prefix_cache=pc)
        seen = []
        a = pool.claim()
        pool.reserve(a, 12)
        pool.alloc_to(a, 12)
        blocks_a = pool.blocks_of(a)
        pc.insert(np.arange(12, dtype=np.int32), blocks_a)
        b = pool.claim()
        seen.append(pool.can_reserve(16, shared_blocks=2))
        pool.reserve(b, 16, shared_blocks=2)
        pool.adopt_shared(b, blocks_a[:2])
        seen.append((pool._reserved_total, pool.shared_blocks,
                     [int(x) for x in pool.page_table[b, :2]]))
        with pytest.raises(ValueError, match="must precede"):
            pool.adopt_shared(b, blocks_a[:2])
        pool.alloc_to(b, 16)
        seen.append(pool.allocated_blocks)
        pool.release(a)  # the shared blocks orphan and stay indexed
        seen.append((pool.allocated_blocks, pool._orphans, pool.unreserved_blocks,
                     pc.match(np.arange(20, dtype=np.int32))))
        pool.release(b)  # the last sharer frees them and the index forgets
        seen.append((pool.allocated_blocks, pool._orphans, pool.unreserved_blocks,
                     pc.match(np.arange(20, dtype=np.int32))))
        c = pool.claim()
        with pytest.raises(ValueError, match="dead block"):
            pool.adopt_shared(c, blocks_a[:2])
        return seen

    got = scenario(PagedCachePool, tcfg, PrefixCache)
    assert got == scenario(jserving.PagedCachePool, jcfg, jserving.PrefixCache)
    assert got == [True, (5, 2, [0, 1]), 5, (4, 2, 4, [0, 1]), (0, 0, 8, [])]


def test_page_table_device_memoized(lm):
    _, _, tcfg, _ = lm
    pool = PagedCachePool(tcfg, num_slots=2, max_len=16, page_size=4, num_blocks=8)
    t0 = pool.page_table_device()
    assert pool.page_table_device() is t0
    a = pool.claim()
    pool.reserve(a, 8)
    pool.alloc_to(a, 8)
    t1 = pool.page_table_device()
    assert t1 is not t0
    pool.alloc_to(a, 8)  # no growth, no upload
    assert pool.page_table_device() is t1
    b = pool.claim()
    pool.reserve(b, 8, shared_blocks=1)
    pool.adopt_shared(b, pool.blocks_of(a)[:1])
    t2 = pool.page_table_device()
    assert t2 is not t1
    assert pool.fork_cow(b, 0) is not None  # a fork rewrites the table
    assert pool.page_table_device() is not t2
    pool.release(a)
    engine = Engine(lm[3], tcfg, num_slots=2, max_len=32, page_size=16, device="cpu")
    engine.submit(np.ones(3, np.int32), 8)
    engine.step()
    mid = engine.pool.page_table_device()
    engine.step()  # inside the page: the same tensor
    assert engine.pool.page_table_device() is mid
    engine.run_until_idle()


def test_prefix_cache_requires_paged_mode(lm):
    for side in _sides(lm).values():
        with pytest.raises(ValueError, match="needs paged mode"):
            side.engine(num_slots=2, max_len=32, prefix_cache=True)
        with pytest.raises(ValueError, match="needs paged mode"):
            side.engine(num_slots=2, max_len=32, prefix_cache=PrefixCache(4)
                        if side.server is ServingServer else jserving.PrefixCache(4))
    _, _, tcfg, _ = lm
    with pytest.raises(ValueError, match="prefix cache page_size 8 != pool page_size 4"):
        PagedCachePool(tcfg, 2, 16, 4, 8, prefix_cache=PrefixCache(8))


# -- surfaces --------------------------------------------------------------------


def test_prefix_manifest_and_server_stats(lm):
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, 96, 8).astype(np.int32)
    tail = rng.integers(0, 96, 3).astype(np.int32)

    def scenario(side):
        engine = side.engine(num_slots=2, max_len=32, page_size=4, prefix_cache=True)
        manifest = engine.manifest()
        engine.submit(sys_p, 12)
        engine.step()
        engine.submit(np.concatenate([sys_p, tail]), 4)
        engine.step()
        stats = side.server(engine).stats()
        engine.run_until_idle()
        plain = side.engine(num_slots=2, max_len=32, page_size=4)
        return (manifest["prefix_cache"], manifest["cow_tails"], stats["prefix"],
                plain.manifest()["prefix_cache"], "prefix" in side.server(plain).stats())

    on, cow, pfx, plain_on, plain_has = _both(lm, scenario)
    assert on is True and cow is True and plain_on is False and not plain_has
    assert pfx["prefix_hit_rate"] == 0.5 and pfx["shared_kv_blocks"] == 2
    assert pfx["blocks_saved"] == 2 and pfx["prefill_tokens_skipped"] == 8
    assert pfx["indexed_chunks"] >= 2


def test_server_cancel_midstream_threadsafe(lm):
    """``ServingServer.cancel`` under the engine lock, against the loop's
    ticks, on a prefix engine with a live sharer: the cancelled handle
    finishes "cancelled", the sharer's stream is untouched, and the pool
    drains."""
    _, _, tcfg, tree = lm
    rng = np.random.default_rng(12)
    sys_p = rng.integers(0, 96, 8).astype(np.int32)
    pa = np.concatenate([sys_p, rng.integers(0, 96, 3).astype(np.int32)])
    pb = np.concatenate([sys_p, rng.integers(0, 96, 5).astype(np.int32)])
    engine = Engine(tree, tcfg, num_slots=2, max_len=64, page_size=4, prefix_cache=True,
                    device="cpu")
    with ServingServer(engine) as srv:
        keep = srv.submit(pa, 30)
        next(iter(keep))  # the leader runs, its pages indexed
        doomed = srv.submit(pb, 40)
        next(iter(doomed))
        cancelled = srv.cancel(doomed.request_id)
        tokens, reason = doomed.result(timeout=60)
        if cancelled:
            assert reason == "cancelled" and len(tokens) >= 1
        else:  # the loop finished all 40 before the cancel landed
            assert reason in ("eos", "length")
        assert not srv.cancel(doomed.request_id)
        assert keep.result(timeout=60) == (_solo(lm, pa, 30), "length")
    assert engine.metrics.prefix_hits == 1
    assert _drained(engine.pool)


# -- resilience ------------------------------------------------------------------------


def test_prefix_engine_recovers_from_tick_fault(lm):
    """A mid-tick crash on a prefix-sharing engine decrefs through the
    normal release, no index entry outlives its blocks, and the replayed
    requests' greedy streams equal JAX's and ``generate_cached``."""
    from test_torch_serving_resilience import both, solo

    rng = np.random.default_rng(8)
    sys_p = rng.integers(0, 96, 8).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 96, n).astype(np.int32)])
               for n in (3, 4)]
    run = both(lm, prompts, 6, [dict(point="mid_decode_tick", at=3)],
               dict(num_slots=2, max_len=32, page_size=4, prefix_cache=True))
    assert run.streams == [(solo(lm, p, 6), "length") for p in prompts]
    pool = run.engine.pool
    assert pool.allocated_blocks == 0 and pool.unreserved_blocks == pool.num_blocks
    assert len(run.engine.prefix_cache) == 0
