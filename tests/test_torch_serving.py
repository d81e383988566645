"""The port's serving engine, scheduler, pools, metrics and server.

Counterparts of JAX's ``tests/test_serving.py`` and
``tests/test_serving_paged.py`` for the fixed and paged pools (the parity
matrix itself is ``tests/test_torch_serving_parity.py``), each run on the
port and, where the case has numbers, on JAX beside it:

- pool and scheduler replays: one seeded sequence of operations on JAX's
  objects and the port's; free counts, reservations, refcounts, owners,
  page tables and every error raised are equal at each step;
- eos retirement, cancel, submit validation, backpressure naming slots or
  blocks, deadlines, block-gated admission, batch admission within the
  block budget, dynamic decode blocks, metrics on the tick clock (the whole
  summary equal to JAX's engine's), the trace of a deterministic tracer
  byte for byte equal to JAX's, the manifest and ``memory_stats`` equal to
  JAX's, ``export_predict(extra=engine.manifest())``;
- the threaded server: streaming, timeouts, stop, rejection, cancel,
  stats;
- every knob and method of a later ROADMAP.md item raises
  ``NotImplementedError`` naming it; those of items that have landed since
  (prefix sharing, 5b; speculation, 5c; admission, swap and overlap, 5d;
  int8 KV, 5e; the ops plane, 5f; recover and the watchdog, 5h's first
  half) work instead; an engine without a card raises;
- the paged pool through a mid-tick fault: recover releases slots and
  blocks, the requeued stream equals JAX's and ``generate_cached``.

JAX's cases with no counterpart: the slow-lane bench cases (``--fast`` runs
here in ``tests/test_torch_bench_serving.py``). JAX's compile counts map to
the engine's count of input-shape signatures.
"""

import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator.export import export_predict, load_manifest
from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.obs import trace as ttrace
from gradaccum_tpu_torch.obs.sentinel import Sentinel
from gradaccum_tpu_torch.obs.slo import SLOEvaluator, default_serving_objectives
from gradaccum_tpu_torch.resilience import faults as tfaults
from gradaccum_tpu_torch.serving import (
    CachePool,
    Engine,
    PagedCachePool,
    PrefixCache,
    QueueFull,
    Request,
    Scheduler,
    ServingMetrics,
    ServingServer,
    SimulationDriver,
)
from gradaccum_tpu_torch.serving import reconfig

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jserving = importlib.import_module("gradaccum_tpu.serving")
jtrace = importlib.import_module("gradaccum_tpu.obs.trace")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    bundle = jgpt.gpt_lm_bundle(jcfg)
    params = bundle.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, tcfg, model, params_tree(model)


def _engine(lm, **kw):
    _, _, tcfg, _, tree = lm
    return Engine(tree, tcfg, device="cpu", **kw)


def _jengine(lm, **kw):
    jcfg, params, _, _, _ = lm
    return jserving.Engine(params, jcfg, **kw)


def _solo(lm, prompt, n):
    _, _, tcfg, _, tree = lm
    return tdec.generate_cached(tree, tcfg, prompt, n)[0, len(prompt):].tolist()


# -- pool and scheduler replays ------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error is what is compared
        return (type(e).__name__, str(e))


def _pool_state(pool):
    return dict(free=pool.free_count, active=pool.active_count,
                free_blocks=pool.free_blocks, allocated=pool.allocated_blocks,
                unreserved=pool.unreserved_blocks, shared=pool.shared_blocks,
                admittable=pool.admittable_blocks, num_blocks=pool.num_blocks,
                capacity=pool.token_capacity, table=pool.page_table.tolist(),
                refs=[pool.refcount(b) for b in range(pool.num_blocks)],
                owners=[pool.owner_of(b) for b in range(pool.num_blocks)],
                slot_blocks=[pool.blocks_of(s) for s in range(pool.num_slots)])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_paged_pool_replay_equals_jax(lm, seed):
    jcfg, _, tcfg, _, _ = lm
    jpool = jserving.PagedCachePool(jcfg, num_slots=3, max_len=16, page_size=4, num_blocks=8)
    tpool = PagedCachePool(tcfg, num_slots=3, max_len=16, page_size=4, num_blocks=8)
    rng = np.random.default_rng(seed)
    for _ in range(120):
        op = rng.choice(["claim", "release", "reserve", "alloc", "adopt", "grow"],
                        p=[0.2, 0.15, 0.2, 0.3, 0.1, 0.05])
        slot = int(rng.integers(0, 3))
        tokens = int(rng.integers(1, 20))
        live = [b for b in range(jpool.num_blocks) if jpool.refcount(b) > 0]
        adopt = [int(b) for b in rng.choice(live, size=min(len(live), 2), replace=False)] \
            if live else []
        calls = {"claim": lambda p: p.claim(), "release": lambda p: p.release(slot),
                 "reserve": lambda p: p.reserve(slot, tokens, int(rng_shared)),
                 "alloc": lambda p: p.alloc_to(slot, tokens),
                 "adopt": lambda p: p.adopt_shared(slot, adopt),
                 "grow": lambda p: p.grow(int(rng_shared) + 1)}
        rng_shared = int(rng.integers(0, 2))
        if op == "grow" and jpool.num_blocks > 12:
            continue
        assert _outcome(lambda: calls[op](jpool)) == _outcome(lambda: calls[op](tpool)), op
        assert _pool_state(tpool) == _pool_state(jpool), op
    assert tpool.k.shape[1] == tpool.num_blocks + 1  # the trash block
    if not (tpool.page_table > tpool.num_blocks).any():
        assert tpool.page_table_device().tolist() == np.asarray(jpool.page_table_device()).tolist()


def test_paged_pool_accounting():
    """JAX's ``test_paged_pool_accounting``, on the port's pool."""
    cfg = tgpt.GPTConfig.tiny_for_tests()
    pool = PagedCachePool(cfg, num_slots=2, max_len=16, page_size=4, num_blocks=6)
    assert pool.token_capacity == 24
    a = pool.claim()
    pool.reserve(a, 10)
    assert pool.unreserved_blocks == 3
    pool.alloc_to(a, 5)
    assert pool.allocated_blocks == 2 and pool.free_blocks == 4
    assert (pool.page_table[a, :2] != pool.num_blocks).all()
    assert (pool.page_table[a, 2:] == pool.num_blocks).all()
    pool.alloc_to(a, 5)
    assert pool.allocated_blocks == 2
    pool.alloc_to(a, 9)
    assert pool.allocated_blocks == 3
    with pytest.raises(ValueError, match="reserved only"):
        pool.alloc_to(a, 13)
    b = pool.claim()
    assert not pool.can_reserve(16)
    with pytest.raises(ValueError, match="cannot reserve"):
        pool.reserve(b, 16)
    pool.reserve(b, 12)
    pool.release(a)
    assert pool.allocated_blocks == 0 and pool.unreserved_blocks == 3
    assert (pool.page_table[a] == pool.num_blocks).all()
    with pytest.raises(ValueError, match="not claimed"):
        pool.release(a)
    pool.release(b)
    assert pool.unreserved_blocks == 6 and pool.free_blocks == 6


def test_pools_reject_what_jax_rejects(lm):
    jcfg, _, tcfg, _, _ = lm
    for make in (jserving.PagedCachePool, PagedCachePool):
        cfg = jcfg if make is jserving.PagedCachePool else tcfg
        with pytest.raises(ValueError, match="multiple of page_size"):
            make(cfg, num_slots=2, max_len=10, page_size=4, num_blocks=4)
        with pytest.raises(ValueError, match="max_position_embeddings"):
            make(cfg, num_slots=2, max_len=128, page_size=4, num_blocks=4)
    pool = PagedCachePool(tcfg, num_slots=1, max_len=8, page_size=4, num_blocks=2)
    pool.page_table[0, 0] = 9  # corrupted host bookkeeping faults at upload
    with pytest.raises(Exception, match="out-of-range block id 9"):
        pool.page_table_device()


def test_cache_pool_claim_release_equals_jax(lm):
    jcfg, _, tcfg, _, _ = lm
    jpool, tpool = jserving.CachePool(jcfg, 2, 8), CachePool(tcfg, 2, 8)
    assert tuple(tpool.k.shape) == tuple(jpool.k.shape)
    ops = ["claim", "claim", "claim", "release0", "claim", "release0", "release0",
           "release1", "claim"]
    for op in ops:
        call = (lambda p: p.claim()) if op == "claim" else (lambda p: p.release(int(op[-1])))
        assert _outcome(lambda: call(jpool)) == _outcome(lambda: call(tpool))
        assert (tpool.free_count, tpool.occupancy) == (jpool.free_count, jpool.occupancy)


def _req(i, deadline=None):
    return Request(request_id=i, prompt=np.ones(2, np.int32), max_new_tokens=2,
                   deadline_tick=deadline)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_replay_equals_jax(seed):
    kw = dict(max_queue=5, max_prefill_per_tick=2, prefill_interval=2)
    js, ts = jserving.Scheduler(**kw), Scheduler(**kw)
    rng = np.random.default_rng(seed)
    rid = 0
    for tick in range(60):
        op = rng.choice(["submit", "cancel", "expire", "admit", "park", "stall"])
        if op == "submit":
            deadline = None if rng.random() < 0.5 else tick + int(rng.integers(0, 4))
            calls = [lambda s, r=rid, d=deadline: s.submit(
                (jserving.Request if s is js else Request)(
                    request_id=r, prompt=np.ones(2, np.int32), max_new_tokens=2,
                    deadline_tick=d))]
            rid += 1
        elif op == "cancel":
            victim = int(rng.integers(0, rid + 1))
            calls = [lambda s: s.cancel(victim)]
        elif op == "expire":
            calls = [lambda s: [r.request_id for r in s.expire(tick)]]
        elif op == "admit":
            free, budget = int(rng.integers(0, 4)), int(rng.integers(0, 3))
            calls = [lambda s: [r.request_id for r in s.admit(
                free, tick, fits=lambda r, n=[budget]: (n.__setitem__(0, n[0] - 1)
                                                        or n[0] >= 0))]]
        elif op == "park":
            calls = [lambda s: s.park((jserving.Request if s is js else Request)(
                request_id=1000 + tick, prompt=np.ones(2, np.int32), max_new_tokens=1))]
        else:
            calls = [lambda s: s.record_stall("no_free_slots")]
        for call in calls:
            assert _outcome(lambda: call(js)) == _outcome(lambda: call(ts)), op
        assert (ts.depth, ts.parked_depth, ts.stalls) == (js.depth, js.parked_depth, js.stalls)
        assert [r.request_id for r in ts.pending()] == [r.request_id for r in js.pending()]


def test_scheduler_policy_knobs():
    s = Scheduler(max_queue=8, max_prefill_per_tick=2, prefill_interval=2)
    for i in range(5):
        s.submit(_req(i))
    assert s.admit(free_slots=4, tick=1) == []
    assert [r.request_id for r in s.admit(free_slots=4, tick=2)] == [0, 1]
    assert [r.request_id for r in s.admit(free_slots=1, tick=4)] == [2]
    assert s.depth == 2
    with pytest.raises(ValueError, match="max_queue"):
        Scheduler(max_queue=0)


# -- engine -------------------------------------------------------------------


def _eos_case(lm, seed):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 96, 6).astype(np.int32)
    full = np.asarray(_solo(lm, prompt, 8))
    k = next(i for i in range(1, len(full)) if full[i] not in full[:i])
    return prompt, full, k


def test_engine_eos_retires_slot(lm):
    prompt, full, k = _eos_case(lm, 0)
    engine = _engine(lm, num_slots=1, max_len=32)
    rid = engine.submit(prompt, 8, eos_id=int(full[k]))
    rid2 = engine.submit(prompt, 4)
    engine.run_until_idle()
    assert engine.results[rid] == list(full[:k + 1]) and engine.status[rid] == "done"
    assert engine.results[rid2] == list(full[:4])


def test_paged_eos_reclaims_blocks_and_reuses_them(lm):
    prompt, full, k = _eos_case(lm, 0)
    engine = _engine(lm, num_slots=2, max_len=16, page_size=4, num_blocks=4)
    rid = engine.submit(prompt, 8, eos_id=int(full[k]))
    rid2 = engine.submit(prompt, 4)  # blocked on blocks, not slots
    engine.run_until_idle()
    assert engine.results[rid] == list(full[:k + 1])
    assert engine.results[rid2] == list(full[:4])
    assert engine.scheduler.stalls.get("no_free_blocks", 0) > 0
    assert engine.pool.allocated_blocks == 0


def test_paged_cancel_midstream_reclaims_blocks_and_reservation(lm):
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 96, 6).astype(np.int32)
    engine = _engine(lm, num_slots=2, max_len=16, page_size=4, num_blocks=4)
    rid = engine.submit(prompt, 8)
    engine.step()
    rid2 = engine.submit(prompt, 4)
    engine.step()
    assert engine.status[rid2] == "queued" and engine.pool.allocated_blocks > 0
    assert engine.cancel(rid) is True
    assert engine.pool.allocated_blocks == 0
    assert engine.pool.unreserved_blocks == engine.pool.num_blocks
    tokens, status = engine.pop_result(rid)
    assert status == "cancelled" and len(tokens) >= 1
    engine.run_until_idle()
    assert engine.results[rid2] == _solo(lm, prompt, 4)
    assert engine.cancel(rid2) is False  # finished
    queued = engine.submit(prompt, 2)
    assert engine.cancel(queued) is True and engine.status[queued] == "cancelled"


def test_engine_submit_validation(lm):
    engine = _engine(lm, num_slots=2, max_len=16)
    with pytest.raises(ValueError, match="exceed max_len"):
        engine.submit(np.zeros(10, np.int32), 7)
    with pytest.raises(ValueError, match="empty prompt"):
        engine.submit(np.zeros(0, np.int32), 2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit(np.zeros(4, np.int32), 0)
    with pytest.raises(ValueError, match="top_k"):
        _engine(lm, num_slots=2, max_len=16, temperature=0.5, top_k=97)
    with pytest.raises(ValueError, match="temperature"):
        _engine(lm, num_slots=2, max_len=16, top_k=3)
    with pytest.raises(ValueError, match="decode_block"):
        _engine(lm, decode_block=0)
    with pytest.raises(ValueError, match="num_blocks needs page_size"):
        _engine(lm, num_blocks=4)
    paged = _engine(lm, num_slots=2, max_len=32, page_size=8, num_blocks=2)
    with pytest.raises(ValueError, match="could never be admitted"):
        paged.submit(np.ones(10, np.int32), 16)


def test_engine_backpressure_and_timeout(lm):
    engine = _engine(lm, num_slots=1, max_len=16, scheduler=Scheduler(max_queue=3))
    prompt = np.ones(4, np.int32)
    engine.submit(prompt, 4)
    engine.submit(prompt, 4)
    engine.submit(prompt, 4, deadline_ticks=1)
    with pytest.raises(QueueFull):
        engine.submit(prompt, 4)
    assert engine.metrics.rejected == 1
    engine.run_until_idle()
    assert engine.status[2] == "timeout" and engine.results[2] == []
    assert sorted(r for r, s in engine.status.items() if s == "done") == [0, 1]


def test_queuefull_names_the_bottleneck(lm):
    engine = _engine(lm, num_slots=4, max_len=16, page_size=8, num_blocks=2,
                     scheduler=Scheduler(max_queue=1))
    engine.submit(np.ones(4, np.int32), 8)
    engine.step()
    engine.submit(np.ones(4, np.int32), 8)
    with pytest.raises(QueueFull, match="no free KV blocks"):
        engine.submit(np.ones(4, np.int32), 8)
    engine2 = _engine(lm, num_slots=1, max_len=16, scheduler=Scheduler(max_queue=1),
                      replica_id=2)
    engine2.submit(np.ones(4, np.int32), 8)
    engine2.step()
    engine2.submit(np.ones(4, np.int32), 8)
    with pytest.raises(QueueFull, match="replica 2: no free slots"):
        engine2.submit(np.ones(4, np.int32), 8)


def test_paged_admission_blocks_are_the_gate(lm):
    engine = _engine(lm, num_slots=8, max_len=32, page_size=8, num_blocks=4)
    rids = [engine.submit(np.ones(4, np.int32), 8) for _ in range(4)]
    engine.run_until_idle()
    assert all(engine.status[r] == "done" for r in rids)
    assert engine.scheduler.stalls.get("no_free_blocks", 0) > 0
    assert engine.scheduler.stalls.get("no_free_slots", 0) == 0


@pytest.mark.parametrize("num_blocks,running", [(4, 2), (3, 1)])
def test_paged_batch_admission_respects_block_budget(lm, num_blocks, running):
    """Reservations of earlier requests in the same admission batch count:
    4 blocks admit two 2-block requests of three, 3 blocks exactly one."""
    engine = _engine(lm, num_slots=4, max_len=32, page_size=8, num_blocks=num_blocks)
    rids = [engine.submit(np.ones(4, np.int32), 8) for _ in range(3)]
    engine.step()
    assert sum(engine.status[r] == "running" for r in rids) == running
    assert engine.pool._reserved_total == 2 * running
    assert engine.scheduler.stalls.get("no_free_blocks", 0) == 1
    engine.run_until_idle()
    assert all(engine.status[r] == "done" for r in rids)


def test_paged_dynamic_decode_block(lm):
    engine = _engine(lm, num_slots=2, max_len=32, page_size=4, decode_block_set=(1, 4))
    driver = SimulationDriver(engine, seed=3)
    trace = driver.make_trace(8, arrival_rate=0.9, prompt_len=(1, 10), max_new=(4, 12))
    for item, rec in zip(trace, driver.run(trace)):
        assert rec["tokens"] == _solo(lm, item.prompt, item.max_new_tokens)
    assert set(engine.metrics.summary()["decode_block_ticks"]) == {1, 4}
    assert engine.decode_compile_count() == 2


@pytest.mark.parametrize("pool", ["fixed", "paged"])
def test_metrics_and_trace_equal_jax_s_on_the_tick_clock(lm, pool):
    """The whole metrics summary (TTFT, latencies, occupancy, token and KV
    gauges, decode blocks, counters) and the deterministic trace, byte for
    byte, equal JAX's engine's on the same trace."""
    kw = dict(num_slots=2, max_len=32, decode_block_set=(1, 4))
    if pool == "paged":
        kw.update(page_size=4)
    outs = []
    for make, tr_mod, drv in ((_jengine, jtrace, jserving.SimulationDriver),
                              (_engine, ttrace, SimulationDriver)):
        tracer = tr_mod.Tracer(deterministic=True)
        engine = make(lm, tracer=tracer, **kw)
        driver = drv(engine, seed=4)
        driver.run(driver.make_trace(6, arrival_rate=0.5, prompt_len=(1, 8), max_new=(2, 8)))
        outs.append((engine.metrics.summary(), tracer.to_bytes(), engine.prefill_compile_count()))
    (jm, jt, jp), (tm, tt, tp) = outs
    assert tm == jm
    assert tm["ttft"]["count"] == 6 and tm["finished"] == {"length": 6}
    assert tt == jt
    assert tp == jp


def test_metrics_events_export(tmp_path, lm):
    from gradaccum_tpu_torch.estimator.events import EventWriter

    writer = EventWriter(str(tmp_path))
    metrics = ServingMetrics(event_writer=writer)
    engine = _engine(lm, num_slots=2, max_len=16, metrics=metrics)
    engine.submit(np.ones(3, np.int32), 3)
    engine.run_until_idle()
    engine.close()
    assert metrics.summary()["tokens_emitted"] == 3
    if writer.active:
        sub = os.path.join(str(tmp_path), "serving")
        assert os.path.isdir(sub) and os.listdir(sub)
    assert "serving_tokens_emitted_total 3" in metrics.to_prometheus()


def test_paged_metrics_token_level_gauges(lm):
    def run(**kw):
        engine = _engine(lm, num_slots=4, max_len=32, **kw)
        driver = SimulationDriver(engine, seed=2)
        driver.run(driver.make_trace(8, arrival_rate=0.7, prompt_len=(1, 6), max_new=(2, 6)))
        return engine.metrics.summary()

    fixed, paged = run(), run(page_size=4)
    for m in (fixed, paged):
        assert m["tokens_in_flight"]["count"] == m["ticks"]
        assert 0 < m["token_occupancy"]["mean"] <= 1
        assert m["kv_bytes_per_token_in_flight"] > 0
    assert paged["block_waterline"] is not None and fixed["block_waterline"] is None
    assert paged["kv_bytes_per_token_in_flight"] < 0.7 * fixed["kv_bytes_per_token_in_flight"]


@pytest.mark.parametrize("kw", [
    dict(num_slots=4, max_len=32, decode_block=8),
    dict(num_slots=4, max_len=32, page_size=8, num_blocks=12, decode_block_set=(1, 4)),
    dict(num_slots=2, max_len=16, temperature=0.7, top_k=3, replica_id=1),
    dict(num_slots=2, max_len=16, page_size=4, cache_dtype="bf16"),
], ids=["fixed", "paged", "sampled", "bf16"])
def test_manifest_and_memory_stats_equal_jax_s(lm, kw):
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("cache_dtype") == "bf16":
        jkw["cache_dtype"], tkw["cache_dtype"] = jax.numpy.bfloat16, torch.bfloat16
    jeng, teng = _jengine(lm, **jkw), _engine(lm, **tkw)
    assert teng.manifest() == jeng.manifest()
    for eng in (jeng, teng):
        eng.submit(np.ones(3, np.int32), 4)
        eng.step()
    assert teng.memory_stats() == jeng.memory_stats()
    if "cache_dtype" in kw:
        assert teng.pool.k.dtype == torch.bfloat16 and teng.manifest()["cache_dtype"] == "bfloat16"
        assert teng._token_bytes * 2 == _engine(lm, num_slots=2, max_len=16)._token_bytes
        teng.run_until_idle()
        assert len(teng.results[0]) == 4


def test_export_manifest_records_serving_knobs(tmp_path, lm):
    _, _, tcfg, model, _ = lm
    bundle = tgpt.gpt_lm_bundle(tcfg)
    sample = {"input_ids": np.zeros((2, 8), np.int32)}
    for sub, kw, check in (
            ("fixed", dict(num_slots=4, max_len=32, decode_block=8),
             dict(num_slots=4, max_len=32, decode_block=8, temperature=0.0)),
            ("paged", dict(num_slots=4, max_len=32, page_size=8, num_blocks=12,
                           decode_block_set=(1, 4)),
             dict(page_size=8, num_blocks=12, decode_block_set=[1, 4]))):
        engine = _engine(lm, **kw)
        export_predict(bundle.predict, model, sample, str(tmp_path / sub),
                       extra=engine.manifest())
        extra = load_manifest(str(tmp_path / sub))["extra"]
        assert extra == json.loads(json.dumps(engine.manifest()))
        for key, value in check.items():
            assert extra[key] == value
    export_predict(bundle.predict, model, sample, str(tmp_path / "none"))
    assert "extra" not in load_manifest(str(tmp_path / "none"))


def test_ids_replica_and_rebase(lm):
    engine = _engine(lm, num_slots=1, max_len=16, replica_id=3, id_start=3, id_stride=4)
    assert [engine.submit(np.ones(2, np.int32), 1) for _ in range(2)] == [3, 7]
    with pytest.raises(ValueError, match="re-issue"):
        engine.rebase_ids(5, 8)
    engine.rebase_ids(19, 8)
    assert engine.submit(np.ones(2, np.int32), 1) == 19
    assert engine.scheduler.label == "replica 3"
    engine.run_until_idle()
    assert engine.obs_tags() == {"replica": 3}


def test_profile_window_writes_a_trace(tmp_path, lm):
    engine = _engine(lm, num_slots=2, max_len=16, profile_dir=str(tmp_path),
                     profile_start_tick=1, profile_num_ticks=2)
    engine.submit(np.ones(3, np.int32), 6)
    engine.run_until_idle()
    engine.close()
    assert engine._profiler.trace_path and os.path.exists(engine._profiler.trace_path)


# -- later items refuse -------------------------------------------------------


def _landed_engine(lm, kw):
    """An engine with a knob of a landed item: it serves a request as
    ``generate_cached`` does."""
    _, _, tcfg, _, tree = lm
    if kw.get("speculate_k"):
        draft, draft_cfg = tdec.truncate_draft_params(tree, tcfg, 1)
        kw = dict(kw, draft_params=draft, draft_cfg=draft_cfg)
    engine = _engine(lm, num_slots=2, max_len=16, **kw)
    prompt = np.arange(1, 7, dtype=np.int32)
    rid = engine.submit(prompt, 5)
    engine.run_until_idle()
    assert engine.pop_result(rid) == (_solo(lm, prompt, 5), "done")
    return engine


# None: the item has landed, and the knob works
REFUSED = {
    "prefix_cache": (dict(page_size=4, prefix_cache=True), None),
    "speculate_k": (dict(speculate_k=2), None),
    "overlap_prefill": (dict(overlap_prefill=True), None),
    "admission": (dict(page_size=4, admission="quantile"), None),
    "swap": (dict(swap="recompute"), None),
    "swap_max_bytes": (dict(swap_max_bytes=1 << 20), None),
    "victim_score": (dict(victim_score="deadline"), None),
    "int8": (dict(page_size=4, cache_dtype=torch.int8), None),
    "mesh": (dict(mesh=object()), "5g"),
}


@pytest.mark.parametrize("knob", sorted(REFUSED))
def test_engine_knobs_of_later_items_raise(lm, knob):
    kw, item = REFUSED[knob]
    if item is None:
        engine = _landed_engine(lm, kw)
        if knob == "int8":
            assert engine.manifest()["cache_dtype"] == "int8"
        else:
            assert engine.manifest()[knob] == kw[knob]
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        _engine(lm, num_slots=2, max_len=16, **kw)


@pytest.mark.parametrize("call,item", [
    (lambda e, s: e.preempt(0), None),
    (lambda e, s: e.reconfigure(reconfig.pool_resize(e.num_blocks + 1)), None),
    (lambda e, s: e.recover(), None), (lambda e, s: s.request_recover("x"), None),
    (lambda e, s: s.request_reconfig(reconfig.pool_resize(e.num_blocks + 1)), None),
    (lambda e, s: _reconfigure_served(e, s), None),
    (lambda e, s: ServingServer(e, watchdog_timeout=1.0), None),
    (lambda e, s: _healer_served(e), None),
    (lambda e, s: ServingServer(e, sentinel=Sentinel()), None),
    (lambda e, s: ServingServer(e, slo=SLOEvaluator(default_serving_objectives())), None),
    (lambda e, s: ServingServer(e, telemetry_port=0).start().stop(), None),
    (lambda e, s: ServingServer(e, free_running=True), None),
    (lambda e, s: _prefix_pool_matches(e), None),
    (lambda e, s: _fork_cow_copies(e), None),
], ids=["preempt", "reconfigure", "recover", "request_recover", "request_reconfig",
        "server_reconfigure", "watchdog", "healer", "sentinel", "slo", "telemetry",
        "free_running", "prefix_pool", "fork_cow"])
def test_methods_of_later_items_raise(lm, call, item):
    """Item None: the item has landed, and the call works."""
    engine = _engine(lm, num_slots=1, max_len=8, page_size=4)
    server = ServingServer(engine)
    if item is None:
        call(engine, server)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        call(engine, server)


def _healer_served(engine):
    """A server built with ``healer=`` (a Healer over its own sentinel)
    starts and stops; the ValueError cases are in test_torch_healer.py."""
    from gradaccum_tpu_torch.resilience.healer import Healer

    snt = Sentinel()
    ServingServer(engine, sentinel=snt, healer=Healer(snt, {})).start().stop()


def _reconfigure_served(engine, server):
    """The blocking reconfigure through a started server: the pool grows."""
    server.start()
    try:
        result = server.reconfigure(reconfig.pool_resize(engine.num_blocks + 1), timeout=60)
    finally:
        server.stop()
    assert result.ok and engine.num_blocks == engine.pool.num_blocks


def _prefix_pool_matches(engine):
    """A pool with a prefix cache indexes a written prompt's pages and a
    later prompt sharing them matches, as JAX's pool does."""
    cache = PrefixCache(4)
    pool = PagedCachePool(engine.cfg, 2, 16, 4, 6, prefix_cache=cache)
    prompt = np.arange(10, dtype=np.int32)
    a = pool.claim()
    pool.reserve(a, 12)
    pool.alloc_to(a, 10)
    cache.insert(prompt, pool.blocks_of(a)[:2])
    assert cache.match(np.concatenate([prompt[:8], [50, 51]])) == pool.blocks_of(a)[:2]
    pool.release(a)  # the blocks free, and the index forgets them
    assert cache.match(prompt) == [] and len(cache) == 0


def _fork_cow_copies(engine):
    """``fork_cow`` gives an adopted block's page a private block while a
    sharer lives, and elides the fork for the last reference."""
    pool = PagedCachePool(engine.cfg, 2, 16, 4, 6)
    a, b = pool.claim(), pool.claim()
    pool.reserve(a, 8)
    pool.alloc_to(a, 8)
    pool.reserve(b, 8, shared_blocks=1)
    pool.adopt_shared(b, pool.blocks_of(a))
    old = pool.blocks_of(a)[1]
    assert pool.fork_cow(b, 1) == old and pool.blocks_of(b)[1] != old
    assert pool.refcount(old) == 1 and pool.shared_blocks == 1
    pool.release(a)
    assert pool.fork_cow(b, 0) is None and pool.owner_of(pool.blocks_of(b)[0]) == b


def test_engine_defaults_to_the_card(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusal does not apply")
    _, _, tcfg, model, _ = lm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, tcfg, max_len=32)
    assert Engine(model, tcfg, max_len=32, device="cpu").device.type == "cpu"  # a module too


# -- the threaded server --------------------------------------------------------


def test_server_streams_and_blocks(lm):
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, 96, 5).astype(np.int32)
    p2 = rng.integers(0, 96, 3).astype(np.int32)
    with ServingServer(_engine(lm, num_slots=2, max_len=24)) as srv:
        h1, h2 = srv.submit(p1, 8), srv.submit(p2, 6)
        streamed = list(h2)
        t1, r1 = h1.result(timeout=60)
        t2, r2 = h2.result(timeout=60)
    assert (r1, r2) == ("length", "length")
    assert t1 == _solo(lm, p1, 8) and t2 == _solo(lm, p2, 6) == streamed


def test_stream_handle_timeout_and_idempotent_result(lm):
    srv = ServingServer(_engine(lm, num_slots=1, max_len=16))
    handle = srv.submit(np.ones(3, np.int32), 3)
    with pytest.raises(TimeoutError, match="still running"):
        handle.result(timeout=0.05)
    srv.start()
    toks, reason = handle.result(timeout=60)
    assert reason == "length" and len(toks) == 3 and handle.done
    assert handle.result(timeout=1) == (toks, reason)
    srv.stop()
    with pytest.raises(RuntimeError, match="cannot be restarted"):
        srv.start()


def test_server_stop_aborts_inflight_handles(lm):
    srv = ServingServer(_engine(lm, num_slots=1, max_len=16))
    h1 = srv.submit(np.ones(3, np.int32), 4)
    h2 = srv.submit(np.ones(3, np.int32), 4)
    srv.stop()
    assert h1.result(timeout=1)[1] == "aborted" and h2.result(timeout=1)[1] == "aborted"


def test_server_rejects_when_queue_full_and_cancels(lm):
    engine = _engine(lm, num_slots=1, max_len=16, page_size=4,
                     scheduler=Scheduler(max_queue=2))
    srv = ServingServer(engine)  # not started: nothing drains the queue
    h1 = srv.submit(np.ones(2, np.int32), 4)
    srv.submit(np.ones(2, np.int32), 4)
    with pytest.raises(QueueFull, match="bottleneck"):
        srv.submit(np.ones(2, np.int32), 4)
    assert srv.cancel(h1.request_id) and h1.result(timeout=1)[1] == "cancelled"
    assert not srv.cancel(12345)
    srv.start()
    srv.stop()


def test_server_stats_surface_block_state(lm):
    engine = _engine(lm, num_slots=2, max_len=16, page_size=4)
    with ServingServer(engine) as srv:
        srv.submit(np.ones(3, np.int32), 3).result(timeout=60)
        stats = srv.stats()
    assert stats["num_kv_blocks"] == engine.pool.num_blocks
    assert stats["kv_token_capacity"] == engine.pool.token_capacity
    assert "free_kv_blocks" in stats and stats["metrics"]["tokens_emitted"] == 3
    assert stats["memory"] == engine.memory_stats()


def test_server_fails_handles_on_an_engine_fault(lm):
    engine = _engine(lm, num_slots=1, max_len=16)

    def boom():
        raise RuntimeError("device lost")

    engine.step = boom
    srv = ServingServer(engine).start()
    handle = srv.submit(np.ones(3, np.int32), 3)
    with pytest.raises(RuntimeError, match="engine error"):
        handle.result(timeout=60)
    with pytest.raises(RuntimeError, match="engine thread died"):
        srv.submit(np.ones(3, np.int32), 3)
    with pytest.raises(RuntimeError, match="serving engine failed"):
        srv.stop()


# -- resilience ------------------------------------------------------------------------


def test_paged_engine_recovers_from_tick_fault(lm):
    """A mid-tick crash on the paged pool releases slots AND blocks; the
    replayed request decodes to JAX's stream and ``generate_cached``'s, with
    JAX's fault counts, and the pool invariants hold after the recover."""
    from test_torch_serving_resilience import both

    prompt = np.arange(1, 6, dtype=np.int32)
    run = both(lm[:3] + (lm[4],), [prompt], 6, [dict(point=tfaults.MID_DECODE_TICK, at=2)],
               dict(num_slots=2, max_len=16, page_size=4))
    assert run.streams == [(_solo(lm, prompt, 6), "length")]
    assert run.counts["requeued"] == 1
    assert run.engine.pool.allocated_blocks == 0
    assert run.engine.pool.unreserved_blocks == run.engine.pool.num_blocks
