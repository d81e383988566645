"""Speculative decoding in the port's serving engine, against JAX's.

The port's counterparts of JAX's ``tests/test_serving_spec.py``. The gate:
greedy speculation (k = 2 and 4, a draft truncated from the target and a
separately initialised one, the fixed and the paged pool) gives every
request the tokens of the non-speculative engine (``generate_cached`` on the
request alone), and the tokens and accept counts of JAX's speculative engine
on the same trace; sampled speculation gives JAX's tokens and accept counts
draw for draw (the keys fold ``pos * (k + 2) + column`` and a salt per draw,
``utils/prng.py``). Around it: accepted runs crossing page boundaries (a
full-depth draft, accept rate >= 0.9), an all-rejecting draft, ``k = 0``,
the validation errors with JAX's messages, speculation over shared prefix
blocks, cancel mid-speculation, eos inside an accepted run, the metrics
and manifest, a bfloat16 cache with a draft, and the queue-wait accounting
cases of JAX's file.

Since the fault contract and the ops plane landed (5h's first half, 5f): a
crash mid-cycle leaves the draft cache dirty and the requeued streams still
equal JAX's and ``generate_cached``
(``test_spec_recover_dirty_draft_cache_and_requeue_parity``, lockstep and
overlapped), the overlapped crash point hands back freshly admitted
requests, ``degenerate_draft`` fires and resolves, and ``bench_spec
--fast`` meets JAX's checks.

Left out, with their items: ``test_spec_parity_tp_mesh`` (the serving mesh,
5g, second half); the free-running server cases (the same).
``test_overlap_prefill_parity_fixed_and_paged`` is in
``tests/test_torch_serving_admission.py`` with the rest of item 5d.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.serving import Engine, Scheduler, SimulationDriver
from gradaccum_tpu_torch.utils import prng

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jdec = importlib.import_module("gradaccum_tpu.models.gpt_decode")
jserving = importlib.import_module("gradaccum_tpu.serving")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SAMPLED = dict(temperature=0.8, top_k=5)
POOLS = {"fixed": {}, "paged": dict(page_size=4)}


def _port(params):
    model = tgpt.GPTLM(tgpt.GPTConfig.tiny_for_tests(dropout=0.0))
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return params_tree(model)


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    init = jgpt.gpt_lm_bundle(jcfg).init
    params = init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    # a draft of its own: other random weights, the target's shape
    other = init(jax.random.PRNGKey(99), {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    return jcfg, params, tcfg, _port(params), other, _port(other)


def _draft(lm, kind):
    """``(jax draft, its cfg, port draft, its cfg)``: the target's first
    layer, its whole depth, or the other weights' two layers."""
    jcfg, params, tcfg, tree, other, other_tree = lm
    jsrc, tsrc, n = {"truncated": (params, tree, 1), "full": (params, tree, 2),
                     "separate": (other, other_tree, 2)}[kind]
    return jdec.truncate_draft_params(jsrc, jcfg, n) + tdec.truncate_draft_params(tsrc, tcfg, n)


def _engines(lm, kind, **kw):
    """JAX's speculative engine and the port's, the same knobs."""
    jcfg, params, tcfg, tree, _, _ = lm
    jd, jdc, td, tdc = _draft(lm, kind)
    return (jserving.Engine(params, jcfg, draft_params=jd, draft_cfg=jdc, **kw),
            Engine(tree, tcfg, draft_params=td, draft_cfg=tdc, device="cpu", **kw))


def _ints(tokens):
    return [int(t) for t in tokens]


def _solo(lm, prompt, n, seed=0, **kw):
    _, _, tcfg, tree, _, _ = lm
    return tdec.generate_cached(tree, tcfg, prompt, n, rng=prng.PRNGKey(seed),
                                **kw)[0, len(prompt):].tolist()


def _run_both(lm, kind, seed=0, n=8, trace_kw=None, **kw):
    """One seeded trace (JAX's draws) through JAX's speculative engine and
    the port's: equal streams and accept counts. Returns the port's engine,
    the trace and its streams."""
    jeng, teng = _engines(lm, kind, **kw)
    tkw = dict(arrival_rate=0.6, prompt_len=(1, 12), max_new=(1, 12))
    tkw.update(trace_kw or {})
    jdrv, tdrv = jserving.SimulationDriver(jeng, seed=seed), SimulationDriver(teng, seed=seed)
    trace = tdrv.make_trace(n, **tkw)
    jrecs = jdrv.run(jdrv.make_trace(n, **tkw))
    trecs = tdrv.run(trace)
    streams = [r["tokens"] for r in trecs]
    assert all(r["status"] == "done" for r in trecs)
    assert streams == [_ints(r["tokens"]) for r in jrecs]
    assert (teng.metrics.spec_proposed, teng.metrics.spec_accepted) == \
        (jeng.metrics.spec_proposed, jeng.metrics.spec_accepted)
    assert teng.decode_compile_count() == jeng.decode_compile_count() == 1
    assert teng.prefill_compile_count() == jeng.prefill_compile_count()
    return teng, trace, streams


# -- the parity gates -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["truncated", "separate"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_spec_greedy_equals_plain_engine_and_jax(lm, pool, k, kind):
    engine, trace, streams = _run_both(lm, kind, seed=k, num_slots=4, max_len=32,
                                       speculate_k=k, **POOLS[pool])
    _, _, tcfg, tree, _, _ = lm
    plain = Engine(tree, tcfg, num_slots=4, max_len=32, device="cpu", **POOLS[pool])
    assert [r["tokens"] for r in SimulationDriver(plain, seed=k).run(trace)] == streams
    for item, toks in zip(trace, streams):
        assert toks == _solo(lm, item.prompt, item.max_new_tokens)
    assert engine.metrics.spec_proposed > 0 and engine.idle
    if pool == "paged":
        assert engine.pool.free_blocks == engine.pool.num_blocks


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_spec_sampled_equals_jax_draw_for_draw(lm, pool, k):
    """Rejection sampling with JAX's keys: the same tokens and accept counts
    as JAX's engine, every request complete, and a second run identical."""
    kw = dict(num_slots=3, max_len=32, speculate_k=k, **SAMPLED, **POOLS[pool])
    trace_kw = dict(arrival_rate=0.8, prompt_len=(2, 10), max_new=(3, 10))
    engine, trace, streams = _run_both(lm, "truncated", seed=21, n=6, trace_kw=trace_kw, **kw)
    _, rerun = _engines(lm, "truncated", **kw)
    assert [r["tokens"] for r in SimulationDriver(rerun, seed=21).run(trace)] == streams
    for item, toks in zip(trace, streams):
        assert len(toks) == item.max_new_tokens and all(0 <= t < 96 for t in toks)
    assert 0 < engine.metrics.spec_accepted < engine.metrics.spec_proposed


def test_spec_all_accept_crosses_page_boundary(lm):
    """A full-depth draft at page size 2: runs of k + 1 tokens stride page
    boundaries, and the accept rate reads >= 0.9."""
    engine, trace, streams = _run_both(lm, "full", seed=2, n=5, num_slots=2, max_len=32,
                                       page_size=2, speculate_k=4,
                                       trace_kw=dict(max_new=(8, 12)))
    assert engine.metrics.spec_accept_rate() >= 0.9
    for item, toks in zip(trace, streams):
        assert toks == _solo(lm, item.prompt, item.max_new_tokens)


def test_spec_all_rejected_still_emits_target_tokens(lm):
    """The other weights' draft rejects nearly every proposal; each cycle
    still emits the target's own token."""
    engine, trace, streams = _run_both(lm, "separate", seed=3, n=6, num_slots=3, max_len=32,
                                       speculate_k=2)
    assert engine.metrics.spec_accept_rate() < 0.5
    for item, toks in zip(trace, streams):
        assert toks == _solo(lm, item.prompt, item.max_new_tokens)


def test_spec_k0_fallback_is_plain_engine(lm):
    _, _, tcfg, tree, _, _ = lm
    draft, draft_cfg = tdec.truncate_draft_params(tree, tcfg, 1)
    engine = Engine(tree, tcfg, num_slots=2, max_len=32, speculate_k=0, draft_params=draft,
                    draft_cfg=draft_cfg, device="cpu")
    assert engine.draft_params is None and engine._draft_k is None
    driver = SimulationDriver(engine, seed=4)
    trace = driver.make_trace(5, arrival_rate=0.6, prompt_len=(1, 12), max_new=(1, 12))
    for item, rec in zip(trace, driver.run(trace)):
        assert rec["tokens"] == _solo(lm, item.prompt, item.max_new_tokens)
    assert engine.metrics.spec_proposed == 0 and engine.manifest()["speculate_k"] == 0


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error is what is compared
        return type(e).__name__, str(e)
    return None


def test_spec_validation_with_jax_s_messages(lm):
    """Each bad construction raises JAX's ValueError with JAX's message; an
    int8 cache with speculation is JAX's ValueError, and an int8 paged engine
    without speculation builds (5e)."""
    jcfg, params, tcfg, tree, _, _ = lm
    jd, jdc, td, tdc = _draft(lm, "truncated")
    jbad, tbad = dataclasses.replace(jdc, vocab_size=7), dataclasses.replace(tdc, vocab_size=7)
    cases = [  # (JAX's knobs, the port's)
        (dict(), dict()),  # no draft
        (dict(draft_params=jd, draft_cfg=jbad), dict(draft_params=td, draft_cfg=tbad)),
        (dict(draft_params=jd, draft_cfg=jdc, decode_block=4),
         dict(draft_params=td, draft_cfg=tdc, decode_block=4)),
        (dict(draft_params=jd, draft_cfg=jdc, decode_block_set=(1, 2)),
         dict(draft_params=td, draft_cfg=tdc, decode_block_set=(1, 2))),
        (dict(draft_params=jd, draft_cfg=jdc, page_size=4, cache_dtype=jax.numpy.int8),
         dict(draft_params=td, draft_cfg=tdc, page_size=4, cache_dtype=torch.int8)),
    ]
    for jkw, tkw in cases:
        want = _error(lambda: jserving.Engine(params, jcfg, speculate_k=2, **jkw))
        assert want is not None and want[0] == "ValueError", jkw
        assert _error(lambda: Engine(tree, tcfg, speculate_k=2, device="cpu", **tkw)) == want
    assert _error(lambda: Engine(tree, tcfg, speculate_k=-1, device="cpu")) == \
        _error(lambda: jserving.Engine(params, jcfg, speculate_k=-1))
    assert Engine(tree, tcfg, max_len=32, page_size=4, cache_dtype=torch.int8,
                  device="cpu").manifest()["memory"]["kv_quant"] is True
    assert _error(lambda: tdec.truncate_draft_params(tree, tcfg, 3)) == \
        _error(lambda: jdec.truncate_draft_params(params, jcfg, 3))


# -- prefix sharing with speculation ----------------------------------------------------


def test_spec_accept_into_shared_prefix_tail(lm):
    """Sharers of one system prompt speculating with a full-depth draft:
    verify reads the shared blocks, its writes land past them, the streams
    are solo's and JAX's, and every refcount unwinds."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, 96, 9).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 96, 3).astype(np.int32)])
               for _ in range(6)]
    out = []
    for engine in _engines(lm, "full", num_slots=4, max_len=32, page_size=4,
                           prefix_cache=True, speculate_k=3):
        rids = []
        for p in prompts:
            rids.append(engine.submit(p, 12))
            engine.step()
        engine.run_until_idle()
        m = engine.metrics
        out.append(([_ints(engine.results[r]) for r in rids], m.prefix_hits,
                     m.shared_blocks_peak, m.spec_accepted, m.spec_proposed,
                     engine.pool.free_blocks == engine.pool.num_blocks))
    assert out[0] == out[1]
    streams, hits, peak, accepted, proposed, drained = out[1]
    assert streams == [_solo(lm, p, 12) for p in prompts]
    assert hits > 0 and peak > 0 and accepted >= 0.8 * proposed and drained


# -- cancel and eos ----------------------------------------------------------------------


def test_spec_cancel_mid_speculation(lm):
    rng = np.random.default_rng(11)
    p1 = rng.integers(0, 96, 5).astype(np.int32)
    p2 = rng.integers(0, 96, 4).astype(np.int32)
    out = []
    for engine in _engines(lm, "truncated", num_slots=2, max_len=32, page_size=4,
                           speculate_k=3):
        r1, r2 = engine.submit(p1, 10), engine.submit(p2, 6)
        engine.step()
        engine.step()  # one speculative cycle at least
        assert engine.cancel(r1) and engine.status[r1] == "cancelled"
        partial = _ints(engine.results[r1])
        engine.run_until_idle()
        out.append((partial, _ints(engine.results[r2]),
                     engine.pool.free_blocks == engine.pool.num_blocks))
    assert out[0] == out[1]
    partial, second, drained = out[1]
    assert partial == _solo(lm, p1, 10)[:len(partial)] and len(partial) > 1
    assert second == _solo(lm, p2, 6) and drained


def test_spec_eos_discards_accepted_tail(lm):
    rng = np.random.default_rng(17)
    for _ in range(8):
        prompt = rng.integers(0, 96, 6).astype(np.int32)
        full = _solo(lm, prompt, 8)
        k = next((i for i in range(1, len(full)) if full[i] not in full[:i]), None)
        if k is not None:
            break
    assert k is not None, "no usable eos token in 8 seeded prompts"
    out = []
    for engine in _engines(lm, "full", num_slots=1, max_len=32, speculate_k=4):
        rid = engine.submit(prompt, 8, eos_id=int(full[k]))
        engine.run_until_idle()
        out.append((_ints(engine.results[rid]), engine.status[rid]))
    assert out[0] == out[1] == (full[:k + 1], "done")


# -- metrics, manifest, dtypes -------------------------------------------------------------


def test_spec_accept_rate_in_metrics_and_manifest(lm):
    jeng, engine = _engines(lm, "truncated", num_slots=2, max_len=32, speculate_k=3)
    for eng in (jeng, engine):
        eng.submit(np.ones(4, np.int32), 6)
        eng.run_until_idle()
    m, jm = engine.metrics.summary(), jeng.metrics.summary()
    assert m["spec_proposed"] == jm["spec_proposed"] > 0
    assert m["spec_accept_rate"] == jm["spec_accept_rate"] is not None
    prom = engine.metrics.to_prometheus().replace("/", "_")
    for name in ("serving_spec_proposed_total", "serving_spec_accepted_total",
                 "serving_spec_accept_rate"):
        assert name in prom
    assert engine.manifest() == jeng.manifest()
    assert engine.manifest()["speculate_k"] == 3 and engine.manifest()["draft_num_layers"] == 1


def test_cache_dtype_bf16_pools_and_draft(lm):
    """JAX's case: a bfloat16 cache with a draft stores bfloat16 on both
    pools and the draft's cache, at half the bytes per token, and runs."""
    _, _, tcfg, tree, _, _ = lm
    draft, draft_cfg = tdec.truncate_draft_params(tree, tcfg, 1)
    fixed = Engine(tree, tcfg, num_slots=2, max_len=32, cache_dtype=torch.bfloat16,
                   speculate_k=2, draft_params=draft, draft_cfg=draft_cfg, device="cpu")
    plain = Engine(tree, tcfg, num_slots=2, max_len=32, device="cpu")
    assert fixed.pool.k.dtype == fixed._draft_k.dtype == torch.bfloat16
    assert fixed._token_bytes * 2 == plain._token_bytes
    paged = Engine(tree, tcfg, num_slots=2, max_len=32, page_size=4, speculate_k=2,
                   draft_params=draft, draft_cfg=draft_cfg, cache_dtype=torch.bfloat16,
                   device="cpu")
    assert paged.pool.k.dtype == paged._draft_k.dtype == torch.bfloat16
    for engine in (fixed, paged):
        rid = engine.submit(np.ones(5, np.int32), 6)
        engine.run_until_idle()
        assert len(engine.results[rid]) == 6
        assert engine.manifest()["cache_dtype"] == "bfloat16"


def test_truncated_draft_shares_the_engine_s_tensors(lm):
    """A draft carved from the target rides on the engine's own copies of
    the target's weights (one copy each on the device)."""
    _, _, tcfg, tree, _, _ = lm
    draft, draft_cfg = tdec.truncate_draft_params(tree, tcfg, 1)
    engine = Engine(tree, tcfg, num_slots=2, max_len=16, speculate_k=2, draft_params=draft,
                    draft_cfg=draft_cfg, device="cpu")
    emb = engine.params["params"]["word_embeddings"]["embedding"]
    assert engine.draft_params["params"]["word_embeddings"]["embedding"] is emb
    assert engine.draft_params["params"]["layer_0"] == engine.params["params"]["layer_0"]


def test_queue_wait_recorded_once_under_prefill_interval(lm):
    jcfg, params, tcfg, tree, _, _ = lm
    waits = []
    for engine in (jserving.Engine(params, jcfg, num_slots=2, max_len=16,
                                   scheduler=jserving.Scheduler(prefill_interval=3)),
                   Engine(tree, tcfg, num_slots=2, max_len=16,
                          scheduler=Scheduler(prefill_interval=3), device="cpu")):
        engine.metrics.clock = lambda e=engine: float(e.tick_count)
        engine.step()
        rid = engine.submit(np.ones(3, np.int32), 8)
        engine.step()
        engine.step()
        assert engine.metrics.queue_wait.summary()["count"] == 0
        engine.step()
        assert engine.status[rid] == "running"
        waits.append(engine.metrics.queue_wait.summary())
        engine.run_until_idle()
    assert waits[0] == waits[1]
    assert waits[1]["count"] == 1 and waits[1]["mean"] == pytest.approx(2.0)


def test_queue_wait_counts_timeout_expiry(lm):
    jcfg, params, tcfg, tree, _, _ = lm
    waits = []
    for engine in (jserving.Engine(params, jcfg, num_slots=1, max_len=16),
                   Engine(tree, tcfg, num_slots=1, max_len=16, device="cpu")):
        engine.metrics.clock = lambda e=engine: float(e.tick_count)
        engine.submit(np.ones(3, np.int32), 8)
        rid = engine.submit(np.ones(3, np.int32), 2, deadline_ticks=2)
        engine.run_until_idle()
        assert engine.status[rid] == "timeout"
        waits.append(engine.metrics.queue_wait.summary())
    assert waits[0] == waits[1]
    assert waits[1]["count"] == 2 and waits[1]["p99"] >= 2.0


# -- resilience and the sentinel ------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True])
def test_spec_recover_dirty_draft_cache_and_requeue_parity(lm, overlap):
    """A seeded crash in a speculative tick (overlapped: after the cycle
    wrote both caches, nothing read back) leaves the draft cache dirty;
    recover gates it with the pool's slots, the server requeues, and the
    replayed greedy streams equal JAX's and ``generate_cached``."""
    from test_torch_serving_resilience import both, solo

    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 96, n).astype(np.int32) for n in (5, 3, 6, 4)]
    base = lm[:4]

    def kw(side):
        dparams, dcfg = side.draft(1)
        return dict(num_slots=2, max_len=32, page_size=4, speculate_k=3,
                    draft_params=dparams, draft_cfg=dcfg, overlap_prefill=overlap)

    run = both(base, prompts, 6, [dict(point="mid_decode_tick", at=2)], kw)
    assert run.fired == [("mid_decode_tick", 2, "crash")]
    assert run.streams == [(solo(base, p, 6), "length") for p in prompts]
    assert run.engine.idle and run.engine.pool.free_blocks == run.engine.pool.num_blocks


def test_overlap_prefill_fault_recovers_admitted_requests(lm):
    """The overlapped crash point sits after BOTH dispatches: freshly
    admitted requests are in slots and recover() hands them back, as JAX's."""
    from test_torch_serving_resilience import pool_invariants, sides

    got = {}
    for name, side in sides(lm[:4]).items():
        engine = side.engine(num_slots=2, max_len=32, overlap_prefill=True)
        f = side.faults
        inj = f.FaultInjector(f.FaultSchedule([f.FaultSpec(f.MID_DECODE_TICK, at=0)]))
        rid = engine.submit(np.ones(4, np.int32), 4)
        with f.installed(inj):
            with pytest.raises(f.InjectedCrash):
                engine.step()
        failed = engine.recover()
        got[name] = ([r.request_id for r in failed], engine.status[rid],
                     engine.pool.active_count)
        if side.port:
            assert pool_invariants(engine, failed) == []
    assert got["torch"] == got["jax"] == ([0], "error", 0)


def test_sentinel_degenerate_draft_fires_and_resolves():
    from gradaccum_tpu_torch.obs.sentinel import DEGENERATE_DRAFT, Sentinel

    s = Sentinel(clock=lambda: 0.0, accept_floor=0.2, accept_warmup=2, accept_consecutive=3)
    fired = []
    s.on(DEGENERATE_DRAFT, fired.append)
    s.observe_accept(None)  # no speculation this tick: ignored
    for _ in range(10):
        s.observe_accept(0.05, replica=1)
    assert len(fired) == 1 and fired[0].replica == 1  # level-held
    assert (DEGENERATE_DRAFT, 1) in s.firing()
    s.observe_accept(0.9, replica=1)
    assert (DEGENERATE_DRAFT, 1) not in s.firing()


def test_bench_spec_fast(tmp_path):
    """``bench_spec --fast`` on the CPU: JAX's fast-mode checks (every leg's
    greedy streams equal the plain engine's, the sweep and the accept rates
    in range, the artifact written)."""
    from gradaccum_tpu_torch.examples import bench_spec

    out = tmp_path / "spec.json"
    result = bench_spec.main(["--fast", "--device", "cpu", "--out", str(out)])
    assert out.exists() and result["parity_ok"]
    assert result["baseline"]["tokens_per_s"] > 0 and result["speculative"]["tokens_per_s"] > 0
    assert result["speculative"]["accept_rate"] is not None
    assert result["baseline"]["decode_programs"] == result["speculative"]["decode_programs"] == 1
    assert len(result["accept_sweep"]) >= 2
    for leg in result["accept_sweep"]:
        assert 0.0 <= leg["accept_rate"] <= 1.0 and leg["tokens_per_s"] > 0
    assert all(v > 0 for v in result["ttft_under_load"]["p99_s"].values())
    assert result["acceptance"]["required"]
