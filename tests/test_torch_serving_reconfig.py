"""Live reconfiguration under traffic in the port, against JAX's.

The port's counterparts of JAX's ``tests/test_serving_reconfig.py`` and of
``test_serving_cow.py :: test_cow_reconfig_pool_shrink_parity``: a pool
resize or a checkpoint swap applied mid-stream finishes every in-flight
request with the unreconfigured run's tokens (greedy and sampled, through
both the swap-in and the re-prefill resume), a shrink below demand refuses
with ``demand``/``supply``, a corrupt checkpoint degrades and the old
weights keep serving, and a ``MID_RECONFIG`` kill lands in a clean old or
new configuration.

Every engine scenario runs on JAX's stack and the port's from the same
seeded prompts, the same spec at the same tick and the same fault schedule;
streams, ``ReconfigResult`` (kind, ok, preempted, detail), the refusal's
fields, stall labels and the preemption and reconfiguration counters are
equal, and greedy float32 streams also equal the port's
``generate_cached``. The watchdog cases run on wall time (margins of 3x or
more over the timeout); every other wait has a timeout.
"""

import dataclasses
import importlib
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator import checkpoint as tckpt
from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.obs import sentinel as tsentinel
from gradaccum_tpu_torch.obs import trace as ttrace
from gradaccum_tpu_torch.resilience import faults as tfaults
from gradaccum_tpu_torch.resilience import preemption as tpreemption
from gradaccum_tpu_torch.resilience import remediation as tremediation
from gradaccum_tpu_torch.resilience.watchdog import Watchdog
from gradaccum_tpu_torch.serving import reconfig as treconfig
from gradaccum_tpu_torch.utils import prng
import gradaccum_tpu_torch.serving as tserving

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jdec = importlib.import_module("gradaccum_tpu.models.gpt_decode")
jserving = importlib.import_module("gradaccum_tpu.serving")
jreconfig = importlib.import_module("gradaccum_tpu.serving.reconfig")
jfaults = importlib.import_module("gradaccum_tpu.resilience.faults")
jckpt = importlib.import_module("gradaccum_tpu.estimator.checkpoint")
jpreemption = importlib.import_module("gradaccum_tpu.resilience.preemption")
jsentinel = importlib.import_module("gradaccum_tpu.obs.sentinel")
jtrace = importlib.import_module("gradaccum_tpu.obs.trace")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

WAIT = 120  # seconds any handle or future may take before a case fails


def _carry(params, tcfg):
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return params_tree(model)


@pytest.fixture(scope="module")
def lm():
    """JAX's tiny GPT at seed 0 and seed 99, and both carried into the port."""
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    bundle = jgpt.gpt_lm_bundle(jcfg)
    ids = {"input_ids": np.zeros((1, 8), np.int32)}
    params = bundle.init(jax.random.PRNGKey(0), ids)
    other = bundle.init(jax.random.PRNGKey(99), ids)
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    return types.SimpleNamespace(jcfg=jcfg, params=params, other=other, tcfg=tcfg,
                                 tree=_carry(params, tcfg), other_tree=_carry(other, tcfg))


def stacks(lm):
    """JAX's serving stack and the port's behind one set of names."""
    return {
        "jax": types.SimpleNamespace(
            name="jax", params=lm.params, other=lm.other, cfg=lm.jcfg,
            engine=lambda **kw: jserving.Engine(lm.params, lm.jcfg, **kw),
            fleet=lambda **kw: jserving.ReplicatedEngine(lm.params, lm.jcfg, **kw),
            serving=jserving, reconfig=jreconfig, faults=jfaults, trace=jtrace,
            sentinel=jsentinel, preemption=jpreemption,
            save=lambda d, p: jckpt.save(d, jax.device_get(p), step=1), port=False),
        "torch": types.SimpleNamespace(
            name="torch", params=lm.tree, other=lm.other_tree, cfg=lm.tcfg,
            engine=lambda **kw: tserving.Engine(lm.tree, lm.tcfg, device="cpu", **kw),
            fleet=lambda **kw: tserving.ReplicatedEngine(lm.tree, lm.tcfg, device="cpu", **kw),
            serving=tserving, reconfig=treconfig, faults=tfaults, trace=ttrace,
            sentinel=tsentinel, preemption=tpreemption,
            save=lambda d, p: tckpt.save(d, {"params": p, "step": 1}, step=1), port=True),
    }


def prompts_of(n, seed=0, lo=2, hi=8, vocab=96):
    """JAX's ``_prompts``: the same draws in the same order."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(int(rng.integers(lo, hi)),)).astype(np.int32)
            for _ in range(n)]


def solo(lm, prompt, n, tree=None, seed=None, **kw):
    """The port's ``generate_cached`` of one request (its seed as the key)."""
    if seed is not None:
        kw["rng"] = prng.PRNGKey(seed)
    out = tdec.generate_cached(tree if tree is not None else lm.tree, lm.tcfg, prompt, n, **kw)
    return [int(t) for t in out[0, len(prompt):]]


def plain(x):
    """A summary with numpy arrays and scalars as lists and ints, so two
    sides' summaries compare with ``==``."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def both(lm, scenario, *args, **kw):
    """``scenario(side, ...)`` on JAX's stack and the port's; asserts the two
    summaries equal and returns the port's."""
    got = {name: scenario(side, *args, **kw) for name, side in stacks(lm).items()}
    assert plain(got["torch"]) == plain(got["jax"])
    return got["torch"]


def toks(x):
    return [int(t) for t in x]


def result_of(res, path=None):
    """A ``ReconfigResult`` as a comparable dict (a side's own checkpoint
    path replaced by a placeholder; the tick kept)."""
    d = res.to_dict()
    if path is not None and d["detail"].get("checkpoint") == path:
        d["detail"]["checkpoint"] = "<ckpt>"
    return d


def drain(engine, reqs):
    """Run to idle; ``{rid: (tokens, status)}`` of ``reqs``."""
    engine.run_until_idle()
    return {rid: (toks(engine.results[rid]), engine.status[rid]) for rid in reqs}


def assert_solo(lm, out, reqs, tree=None, **kw):
    for rid, (prompt, n) in reqs.items():
        got, status = out[rid]
        assert status == "done", (rid, status)
        assert got == solo(lm, prompt, n, tree=tree, **kw), rid


def counters(engine):
    m = engine.metrics
    return dict(preemptions=m.preemptions, swap_ins=m.swap_ins, reprefills=m.reprefills,
                swap_fallbacks=m.swap_fallbacks, reconfigs=dict(m.reconfigs),
                reconfig_failures=m.reconfig_failures, stalls=dict(engine.scheduler.stalls))


# -- params digest --------------------------------------------------------------------


def test_params_digest_equals_jax(lm):
    """Carried-over weights digest to JAX's own hex string (numpy dtype
    names, shapes and bytes in JAX's leaf order); other weights do not."""
    want = jreconfig.params_digest(lm.params)
    assert treconfig.params_digest(lm.tree) == want
    assert treconfig.params_digest(lm.other_tree) == jreconfig.params_digest(lm.other)
    assert treconfig.params_digest(lm.other_tree) != want
    model = tgpt.GPTLM(lm.tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(lm.params["params"])))
    assert treconfig.params_digest(params_tree(model)) == want


# -- pool resize ------------------------------------------------------------------------


def _grow(side, overlap):
    eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=16,
                      overlap_prefill=overlap)
    reqs = {eng.submit(p, 10): (p, 10) for p in prompts_of(4, seed=1)}
    for _ in range(3):
        eng.step()
    res = eng.reconfigure(side.serving.pool_resize(24))
    out = drain(eng, reqs)
    return result_of(res), out, counters(eng), eng.num_blocks, eng.pool.num_blocks, reqs


@pytest.mark.parametrize("overlap", [False, True])
def test_pool_grow_parity_under_traffic(lm, overlap):
    """A grow appends a segment: no preemption, and every stream is the
    unreconfigured one, with the overlapped tick too (its prefill and decode
    in flight together read the grown pool)."""
    res, out, count, nb, pool_nb, reqs = both(lm, _grow, overlap)
    assert res["ok"] and res["preempted"] == 0
    assert res["detail"]["incremental"] is True and res["detail"]["segments"] == [16, 8]
    assert nb == pool_nb == 24 and count["reconfigs"] == {"pool_resize": 1}
    assert_solo(lm, out, reqs)


@pytest.mark.parametrize("swap", ["host", "recompute"])
def test_pool_shrink_under_load_parity(lm, swap):
    """A shrink under live traffic: both resume legs give the calm streams."""
    def run(side):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=24,
                          admission="optimistic", swap=swap)
        reqs = {eng.submit(p, 10): (p, 10) for p in prompts_of(4, seed=2)}
        for _ in range(3):
            eng.step()
        res = eng.reconfigure(side.serving.pool_resize(12))
        return result_of(res), drain(eng, reqs), counters(eng), reqs

    res, out, count, reqs = both(lm, run)
    assert res["ok"] and res["preempted"] > 0
    assert_solo(lm, out, reqs)
    assert (count["swap_ins"] if swap == "host" else count["reprefills"]) > 0


def test_prefix_pool_reconfig_parity_and_resharing(lm):
    """A prefix-shared pool shrinks cleanly (no stale hash survives) and the
    rebuilt pool shares again."""
    def run(side):
        sys_prompt = prompts_of(1, seed=3, lo=8, hi=9)[0]
        rng = np.random.default_rng(4)
        prompts = [np.concatenate([sys_prompt, rng.integers(0, 96, 3).astype(np.int32)])
                   for _ in range(4)]
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=24,
                          prefix_cache=True)
        reqs = {eng.submit(p, 8): (p, 8) for p in prompts[:2]}
        for _ in range(3):
            eng.step()
        res = eng.reconfigure(side.serving.pool_resize(16))
        indexed = len(eng.prefix_cache)
        hits = eng.metrics.prefix_hits
        reqs.update({eng.submit(p, 8): (p, 8) for p in prompts[2:]})
        out = drain(eng, reqs)
        return result_of(res), indexed, hits, eng.metrics.prefix_hits, out, reqs

    res, indexed, hits_before, hits_after, out, reqs = both(lm, run)
    assert res["ok"] and indexed == 0 and hits_after > hits_before
    assert_solo(lm, out, reqs)


def test_sampled_parity_through_reconfig(lm):
    """Seeded sampling survives the park and resume: the streams equal the
    run without the reconfiguration, and JAX's."""
    def run(side, reconfig):
        eng = side.engine(num_slots=3, max_len=32, page_size=4, num_blocks=18,
                          temperature=0.8, top_k=5)
        rids = [eng.submit(p, 8, rng_seed=100 + i) for i, p in enumerate(prompts_of(3, seed=5))]
        for _ in range(3):
            eng.step()
        if reconfig:
            assert eng.reconfigure(side.serving.pool_resize(24)).ok
        eng.run_until_idle()
        return [toks(eng.pop_result(r)[0]) for r in rids]

    assert both(lm, run, True) == both(lm, run, False)


@pytest.mark.parametrize("admission", [None, "quantile", "optimistic"])
def test_shrink_refuses_below_demand(lm, admission):
    """The refusal's ``demand``/``supply`` equal JAX's under each admission
    policy (the floor is the largest single reservation among running,
    parked and queued requests), nothing changes, and the request runs to
    its solo stream."""
    p = prompts_of(1, seed=6, lo=6, hi=7)[0]

    def run(side):
        kw = {} if admission is None else dict(admission=admission)
        eng = side.engine(num_slots=2, max_len=32, page_size=4, num_blocks=16, **kw)
        rid = eng.submit(p, 20)
        queued = eng.submit(prompts_of(1, seed=60)[0], 24)
        eng.step()
        if admission is not None:
            # the queued one was admitted beside it: park it
            assert eng.preempt(queued)
        with pytest.raises(side.serving.ReconfigError) as err:
            eng.reconfigure(side.serving.pool_resize(2))
        fields = (err.value.demand, err.value.supply, str(err.value))
        state = (eng.num_blocks, eng.pool.num_blocks, dict(eng.metrics.reconfigs))
        out = drain(eng, [rid, queued])
        return fields, state, out[rid]

    (demand, supply, _), state, (got, status) = both(lm, run)
    assert supply == 2 and demand > 2 and state == (16, 16, {})
    assert status == "done" and got == solo(lm, p, 20)


def test_resize_refused_on_fixed_pool(lm):
    def run(side):
        eng = side.engine(num_slots=2, max_len=32)
        with pytest.raises(side.serving.ReconfigError) as err:
            eng.reconfigure(side.serving.pool_resize(8))
        return str(err.value), err.value.demand, err.value.supply

    both(lm, run)


def test_reconfiguring_stall_label(lm):
    """Fresh traffic held by a shrink's quiesce is named ``reconfiguring``."""
    def run(side):
        eng = side.engine(num_slots=1, max_len=32, page_size=4, num_blocks=16)
        prompts = prompts_of(2, seed=7)
        reqs = {eng.submit(prompts[0], 6): (prompts[0], 6)}
        eng.step()
        reqs[eng.submit(prompts[1], 6)] = (prompts[1], 6)  # queued behind
        res = eng.reconfigure(side.serving.pool_resize(12))
        return result_of(res), dict(eng.scheduler.stalls), drain(eng, reqs), reqs

    res, stalls, out, reqs = both(lm, run)
    assert res["ok"] and stalls.get("reconfiguring", 0) >= 1
    assert_solo(lm, out, reqs)


def test_int8_and_f32_grow_under_prefix_traffic(lm):
    """A grow under prefix-sharing traffic keeps every live prefix entry and
    preempts nothing, in float32 and on the int8 pool: streams equal JAX's
    (float32 also ``generate_cached``), and later admissions still hit."""
    def run(side, int8):
        sys_prompt = prompts_of(1, seed=70, lo=9, hi=10)[0]
        rng = np.random.default_rng(71)
        prompts = [np.concatenate([sys_prompt, rng.integers(0, 96, 3).astype(np.int32)])
                   for _ in range(4)]
        kw = dict(cache_dtype="int8" if not side.port else torch.int8) if int8 else {}
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=12,
                          prefix_cache=True, **kw)
        reqs = {eng.submit(p, 8): (p, 8) for p in prompts[:2]}
        for _ in range(3):
            eng.step()
        indexed = len(eng.prefix_cache)
        res = eng.reconfigure(side.serving.pool_resize(20))
        kept = len(eng.prefix_cache)
        reqs.update({eng.submit(p, 8): (p, 8) for p in prompts[2:]})
        out = drain(eng, reqs)
        return (result_of(res), indexed, kept, eng.metrics.prefix_hits,
                eng.metrics.preemptions, out, eng.pool.allocated_blocks, reqs)

    for int8 in (False, True):
        res, indexed, kept, hits, preempted, out, left, reqs = both(lm, run, int8)
        assert res["ok"] and res["preempted"] == 0 and preempted == 0
        assert kept == indexed > 0 and hits >= 2 and left == 0
        if not int8:
            assert_solo(lm, out, reqs)


def test_cow_reconfig_pool_shrink_parity(lm):
    """A live shrink over copy-on-write sharers: every slot parks (its COW
    references dropped with it), the rebuilt index is empty, and the resumed
    streams are exact."""
    def run(side):
        rng = np.random.default_rng(13)
        sys_p = rng.integers(0, 96, 9).astype(np.int32)
        p1 = np.concatenate([sys_p, rng.integers(0, 96, 2).astype(np.int32)])
        p2 = np.concatenate([sys_p, rng.integers(0, 96, 3).astype(np.int32)])
        eng = side.engine(num_slots=3, max_len=32, page_size=4, num_blocks=16,
                          prefix_cache=True, admission="quantile", swap="recompute")
        r1 = eng.submit(p1, 8)
        eng.step()
        r2 = eng.submit(p2, 8)
        eng.step()
        adopted = eng.metrics.cow_adoptions
        res = eng.reconfigure(side.serving.pool_resize(8))
        state = (len(eng.prefix_cache), bool(np.asarray(eng._slot_cow).any()))
        out = drain(eng, [r1, r2])
        return (adopted, result_of(res), state, out, eng.pool.allocated_blocks,
                {r1: (p1, 8), r2: (p2, 8)})

    adopted, res, state, out, left, reqs = both(lm, run)
    assert adopted >= 1 and res["ok"] and res["preempted"] == 2
    assert state == (0, False) and left == 0
    assert_solo(lm, out, reqs)


# -- checkpoint swap ---------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_checkpoint_swap_same_weights_parity(lm, paged, tmp_path):
    """A redeploy of identical weights through each side's own checkpoint:
    the swapped K/V stays valid (swap-in resumes) and streams are exact."""
    def run(side):
        d = str(tmp_path / side.name)
        side.save(d, side.params)
        kw = dict(page_size=4, num_blocks=16) if paged else {}
        eng = side.engine(num_slots=3, max_len=32, **kw)
        reqs = {eng.submit(p, 10): (p, 10) for p in prompts_of(3, seed=8)}
        for _ in range(3):
            eng.step()
        res = eng.reconfigure(side.serving.checkpoint_swap(checkpoint=d))
        ins_before = eng.metrics.swap_ins
        return result_of(res, d), ins_before, drain(eng, reqs), counters(eng), reqs

    res, ins_before, out, count, reqs = both(lm, run)
    assert res["ok"] and res["detail"]["weights_unchanged"] is True
    assert ins_before == 0 and count["swap_ins"] > 0
    assert_solo(lm, out, reqs)


def test_checkpoint_swap_new_weights_continuation(lm):
    """Changed weights re-prefill every resume: the continuation is
    ``generate_cached`` of prompt + generated under the NEW weights."""
    p = prompts_of(1, seed=9)[0]

    def run(side):
        eng = side.engine(num_slots=2, max_len=32, page_size=4, num_blocks=16)
        rid = eng.submit(p, 10)
        for _ in range(4):
            eng.step()
        g = len(eng.results[rid])
        res = eng.reconfigure(side.serving.checkpoint_swap(params=side.other))
        return g, result_of(res), drain(eng, [rid])[rid], counters(eng)

    g, res, (got, status), count = both(lm, run)
    assert g > 0 and res["ok"] and res["detail"]["weights_unchanged"] is False
    assert status == "done" and got[:g] == solo(lm, p, 10)[:g]
    ext = np.concatenate([p, np.asarray(got[:g], np.int32)])
    assert got[g:] == solo(lm, ext, 10 - g, tree=lm.other_tree)
    assert count["reprefills"] > 0 and count["swap_ins"] == 0


def test_checkpoint_swap_corrupt_quarantines_and_keeps_serving(lm, tmp_path):
    """A byte rotted after the manifest recorded it: the file is quarantined,
    the swap degrades (``ok=False``, nothing preempted) and the old weights
    keep serving."""
    def run(side):
        d = str(tmp_path / side.name)
        path = side.save(d, side.params)
        with open(path, "r+b") as f:
            f.seek(10)
            f.write(b"\xff\xff\xff\xff")
        eng = side.engine(num_slots=2, max_len=32, page_size=4, num_blocks=16)
        reqs = {eng.submit(p, 8): (p, 8) for p in prompts_of(2, seed=10)}
        for _ in range(2):
            eng.step()
        res = eng.reconfigure(side.serving.checkpoint_swap(checkpoint=d))
        assert "rejected" in res.reason
        d_res = result_of(res, d)
        d_res["reason"] = "<rejected>"
        return d_res, drain(eng, reqs), counters(eng), reqs

    res, out, count, reqs = both(lm, run)
    assert not res["ok"] and res["detail"]["quarantined"] and res["preempted"] == 0
    assert count["reconfig_failures"] == 1
    assert_solo(lm, out, reqs)


def test_checkpoint_swap_keeps_a_stale_draft(lm):
    """A swap without ``draft_params`` keeps the old draft (carved from the
    old target's tensors, which the swap never writes): greedy streams are
    the new target's all the same, equal to JAX's, and a new draft is taken
    when given."""
    p = prompts_of(1, seed=19)[0]

    def run(side, refresh):
        draft = (jdec.truncate_draft_params(side.params, side.cfg, 1) if not side.port
                 else tdec.truncate_draft_params(side.params, side.cfg, 1))
        eng = side.engine(num_slots=2, max_len=32, speculate_k=2, draft_params=draft[0],
                          draft_cfg=draft[1])
        rid = eng.submit(p, 12)
        for _ in range(2):
            eng.step()
        g = len(eng.results[rid])
        new_draft = None
        if refresh:
            new_draft = (jdec.truncate_draft_params(side.other, side.cfg, 1)[0] if not side.port
                         else tdec.truncate_draft_params(side.other, side.cfg, 1)[0])
        res = eng.reconfigure(side.serving.checkpoint_swap(params=side.other,
                                                           draft_params=new_draft))
        out = drain(eng, [rid])[rid]
        return g, result_of(res), out

    for refresh in (False, True):
        g, res, (got, status) = both(lm, run, refresh)
        assert res["detail"]["draft_refreshed"] is refresh and status == "done"
        ext = np.concatenate([p, np.asarray(got[:g], np.int32)])
        assert got[g:] == solo(lm, ext, 12 - g, tree=lm.other_tree)


# -- fault injection through reconfig --------------------------------------------------


@pytest.mark.parametrize("at,expect_new", [(0, False), (1, True)])
def test_mid_reconfig_crash_lands_clean(lm, at, expect_new):
    """A kill mid-rebuild leaves the old (2n) or the new (2n+1) pool, never a
    torn one, with everything parked; the parked work drains exactly."""
    def run(side):
        eng = side.engine(num_slots=3, max_len=32, page_size=4, num_blocks=16)
        reqs = {eng.submit(p, 8): (p, 8) for p in prompts_of(3, seed=11)}
        for _ in range(3):
            eng.step()
        f = side.faults
        inj = f.FaultInjector(f.FaultSchedule([f.FaultSpec(f.MID_RECONFIG, at=at)]))
        with f.installed(inj):
            with pytest.raises(f.InjectedCrash):
                eng.reconfigure(side.serving.pool_resize(8))
        state = (eng.num_blocks, eng.pool.num_blocks, eng.pool.active_count,
                 eng.reconfiguring, eng._reconfig_count, [tuple(x) for x in inj.fired])
        return state, drain(eng, reqs), reqs

    (nb, pool_nb, active, busy, count, fired), out, reqs = both(lm, run)
    assert fired == [("mid_reconfig", at, "crash")] and count == 1
    assert nb == pool_nb == (8 if expect_new else 16) and active == 0 and not busy
    assert_solo(lm, out, reqs)


def test_mid_reconfig_retry_fires_fresh_indices(lm):
    """The count advances through a kill: a kill at 2n, a kill at 2n+1 of
    the retry, then a clean retry; the streams are the calm ones."""
    def run(side):
        eng = side.engine(num_slots=3, max_len=32, page_size=4, num_blocks=16,
                          admission="optimistic", swap="host")
        reqs = {eng.submit(p, 8): (p, 8) for p in prompts_of(3, seed=17)}
        for _ in range(2):
            eng.step()
        f = side.faults
        inj = f.FaultInjector(f.FaultSchedule([f.FaultSpec(f.MID_RECONFIG, at=0),
                                               f.FaultSpec(f.MID_RECONFIG, at=3)]))
        results = []
        with f.installed(inj):
            for nb in (10, 10, 10):
                try:
                    results.append(result_of(eng.reconfigure(side.serving.pool_resize(nb))))
                except f.InjectedCrash:
                    results.append("crash")
                eng.step()
        return results, [tuple(x) for x in inj.fired], drain(eng, reqs), counters(eng), reqs

    results, fired, out, count, reqs = both(lm, run)
    assert results[:2] == ["crash", "crash"] and results[2]["ok"]
    assert fired == [("mid_reconfig", 0, "crash"), ("mid_reconfig", 3, "crash")]
    assert_solo(lm, out, reqs)


def test_server_reconfig_crash_routes_through_fault_contract(lm):
    """Through the server a crash-point kill fails the future, the fault
    contract recovers and requeues, and every stream completes exactly."""
    def run(side):
        eng = side.engine(num_slots=3, max_len=32, page_size=4, num_blocks=16)
        f = side.faults
        inj = f.FaultInjector(f.FaultSchedule([f.FaultSpec(f.MID_RECONFIG, at=0)]))
        prompts = prompts_of(3, seed=12)
        with f.installed(inj):
            server = side.serving.ServingServer(eng).start()
            handles = [server.submit(p, 8) for p in prompts]
            for h in handles:
                next(iter(h))  # every stream is under way
            fut = server.request_reconfig(side.serving.pool_resize(8))
            with pytest.raises(f.InjectedCrash):
                fut.result(timeout=WAIT)
            out = [h.result(timeout=WAIT) for h in handles]
            server.stop()
        return [(toks(t), r) for t, r in out], [tuple(x) for x in inj.fired], eng.num_blocks

    out, fired, nb = both(lm, run)
    assert fired == [("mid_reconfig", 0, "crash")] and nb == 16
    for p, (got, reason) in zip(prompts_of(3, seed=12), out):
        assert reason == "length" and got == solo(lm, p, 8)


def test_refused_spec_settles_future_with_reconfig_error(lm):
    """A spec refused on the loop thread settles the future with the
    ``ReconfigError`` (its fields intact); the engine keeps serving and no
    reconfiguration is counted."""
    def run(side):
        engine = side.engine(num_slots=2, max_len=32, page_size=4, num_blocks=24)
        with side.serving.ServingServer(engine) as server:
            h = server.submit(prompts_of(1, seed=5)[0], 12)
            fut = server.request_reconfig(side.serving.pool_resize(1))
            with pytest.raises(side.serving.ReconfigError) as err:
                fut.result(timeout=WAIT)
            got = h.result(timeout=WAIT)
        return (err.value.demand, err.value.supply, engine.num_blocks,
                dict(engine.metrics.reconfigs), toks(got[0]), got[1])

    demand, supply, nb, reconfigs, got, reason = both(lm, run)
    assert supply == 1 and demand is not None and nb == 24 and reconfigs == {}
    assert reason == "length" and got == solo(lm, prompts_of(1, seed=5)[0], 12)


def test_giveup_fails_pending_reconfig_future(lm):
    """A reconfiguration queued while the tick that blows the give-up budget
    runs fails with the engine's error instead of hanging."""
    engine = stacks(lm)["torch"].engine(num_slots=2, max_len=32, page_size=4, num_blocks=24)
    in_step, release = threading.Event(), threading.Event()

    def wedged_step():
        in_step.set()
        assert release.wait(timeout=WAIT)
        raise RuntimeError("tick died after the reconfig was queued")

    engine.step = wedged_step
    server = tserving.ServingServer(engine, max_engine_faults=0).start()
    try:
        server.submit(prompts_of(1, seed=6)[0], 4)
        assert in_step.wait(timeout=WAIT)
        fut = server.request_reconfig(tserving.pool_resize(32))
        release.set()
        with pytest.raises(RuntimeError, match="tick died"):
            fut.result(timeout=WAIT)
    finally:
        release.set()
        with pytest.raises(RuntimeError):
            server.stop()


def test_server_reconfigure_under_watchdog_and_sentinel(lm):
    """The server runs a shrink inside the sentinel's maintenance window: a
    rebuild three times the heartbeat lease fires no stall, the watchdog
    attached fails no handle, and the streams are exact."""
    engine = stacks(lm)["torch"].engine(num_slots=3, max_len=32, page_size=4, num_blocks=16)
    plain = engine.reconfigure

    def slow(spec):
        time.sleep(3.0)  # 3x the sentinel's lease, inside the rebuild
        return plain(spec)

    engine.reconfigure = slow
    snt = tsentinel.Sentinel(lease=1.0)
    prompts = prompts_of(3, seed=14)
    server = tserving.ServingServer(engine, watchdog_timeout=30.0, sentinel=snt).start()
    try:
        handles = [server.submit(p, 16) for p in prompts]
        for h in handles:
            next(iter(h))  # every stream is under way
        res = server.reconfigure(tserving.pool_resize(12), timeout=WAIT)
        out = [h.result(timeout=WAIT) for h in handles]
    finally:
        server.stop()
    assert res.ok and res.preempted >= 1
    assert all(a.kind != "stall" for a in snt.anomalies)
    for p, (got, reason) in zip(prompts, out):
        assert reason == "length" and toks(got) == solo(lm, p, 16)
    stats = engine.metrics.summary()
    assert stats["reconfigs"] == {"pool_resize": 1}


def test_remediation_request_reconfig_grows_the_pool(lm):
    """``remediation.request_reconfig`` turns a fired anomaly into a pool
    grow on the loop thread; a spec function returning None skips."""
    engine = stacks(lm)["torch"].engine(num_slots=2, max_len=32, page_size=4, num_blocks=12)
    snt = tsentinel.Sentinel()
    server = tserving.ServingServer(engine, sentinel=snt)
    specs = iter([None, tserving.pool_resize(20, initiator="healer")])
    snt.on(tsentinel.PREEMPTION_STORM,
           tremediation.request_reconfig(server, lambda a: next(specs)))
    server.start()
    try:
        snt.fire(tsentinel.PREEMPTION_STORM)
        snt.resolve(tsentinel.PREEMPTION_STORM)
        snt.fire(tsentinel.PREEMPTION_STORM)
        deadline = time.monotonic() + WAIT
        while engine.num_blocks != 20 and time.monotonic() < deadline:
            time.sleep(0.01)
        h = server.submit(prompts_of(1, seed=15)[0], 6)
        got, reason = h.result(timeout=WAIT)
    finally:
        server.stop()
    assert engine.num_blocks == 20 and engine.last_reconfig.initiator == "healer"
    assert engine.metrics.reconfigs_by_initiator == {"healer": 1}
    assert toks(got) == solo(lm, prompts_of(1, seed=15)[0], 6)


# -- replica scale ------------------------------------------------------------------------


def test_replica_drain_and_activate_engine_level(lm):
    """A drained replica's work re-dispatches across the fleet (the streams
    are exact), new ids land on the survivors, and activation restores it;
    ids and results equal JAX's."""
    def run(side):
        fleet = side.fleet(replicas=2, tp=None, num_slots=3, max_len=32)
        prompts = prompts_of(4, seed=13)
        rids = [fleet.submit(p, 8) for p in prompts]
        for _ in range(2):
            fleet.step()
        res = fleet.reconfigure(side.serving.replica_drain(1))
        idle = fleet.replicas[1].idle
        late = [fleet.submit(p, 4) for p in prompts_of(2, seed=14)]
        fleet.run_until_idle()
        moved = res.detail["resubmitted"]
        out = [fleet.pop_result(moved.get(r, r)) for r in rids]
        back = fleet.reconfigure(side.serving.replica_activate(1))
        fleet.close()
        return (result_of(res), idle, late, [(toks(t), s) for t, s in out],
                result_of(back), fleet.active_replicas)

    res, idle, late, out, back, active = both(lm, run)
    assert res["ok"] and res["detail"]["active_replicas"] == [0] and not res["detail"]["failed"]
    assert idle and all(r % 2 == 0 for r in late)
    for p, (got, status) in zip(prompts_of(4, seed=13), out):
        assert status == "done" and got == solo(lm, p, 8)
    assert back["ok"] and active == [0, 1]


def test_server_replica_drain_rebinds_handles(lm):
    """Through the server a drained replica's streams keep their handles:
    every ``result()`` is the exact generation."""
    fleet = stacks(lm)["torch"].fleet(replicas=2, tp=None, num_slots=4, max_len=32)
    server = tserving.ServingServer(fleet)
    prompts = prompts_of(4, seed=15)
    handles = [server.submit(p, 10) for p in prompts]
    fut = server.request_reconfig(tserving.replica_drain(1))
    server.start()
    try:
        result = fut.result(timeout=WAIT)
        out = [h.result(timeout=WAIT) for h in handles]
    finally:
        server.stop()
    assert result.ok and not result.detail["failed"] and result.detail["resubmitted"]
    for p, (got, reason) in zip(prompts, out):
        assert reason == "length" and toks(got) == solo(lm, p, 10)


def test_fleet_shrink_refusal_never_tears(lm):
    """A refusal on any replica refuses the whole fleet before any replica
    rebuilds: never mixed block counts."""
    def run(side):
        fleet = side.fleet(replicas=2, tp=None, num_slots=2, max_len=32, page_size=4,
                           num_blocks=16)
        reqs = {fleet.submit(p, 20): (p, 20) for p in prompts_of(2, seed=19, lo=6, hi=8)}
        fleet.step()
        with pytest.raises(side.serving.ReconfigError) as err:
            fleet.reconfigure(side.serving.pool_resize(2))
        blocks = [e.num_blocks for e in fleet.replicas]
        fleet.run_until_idle()
        out = {rid: (toks(fleet.results[rid]), fleet.status[rid]) for rid in reqs}
        fleet.close()
        return (err.value.demand, err.value.supply), blocks, out, reqs

    _, blocks, out, reqs = both(lm, run)
    assert blocks == [16, 16]
    assert_solo(lm, out, reqs)


def test_drain_replica_parks_sentinel_lease(lm):
    """Draining a busy replica parks its heartbeat lease: the planned
    silence fires no dead_replica, on either side."""
    def run(side):
        clk = [0.0]
        snt = side.sentinel.Sentinel(clock=lambda: clk[0], lease=1.0)
        fleet = side.fleet(replicas=2, tp=None, num_slots=4, max_len=32, sentinel=snt)
        for p in prompts_of(4, seed=20):
            fleet.submit(p, 8)
        fleet.step()
        fleet.reconfigure(side.serving.replica_drain(1))
        clk[0] = 10.0
        fired = [(a.kind, a.replica) for a in snt.check()]
        fleet.run_until_idle()
        fleet.close()
        return fired

    fired = both(lm, run)
    assert all(r != 1 for _, r in fired)


def test_server_free_running_pool_resize(lm):
    """A free-running fleet grows every replica's pool under traffic; the
    streams are exact."""
    fleet = stacks(lm)["torch"].fleet(replicas=2, tp=None, num_slots=3, max_len=32,
                                      page_size=4, num_blocks=16)
    server = tserving.ServingServer(fleet, free_running=True).start()
    prompts = prompts_of(4, seed=16)
    try:
        handles = [server.submit(p, 10) for p in prompts]
        result = server.reconfigure(tserving.pool_resize(24), timeout=WAIT)
        out = [h.result(timeout=WAIT) for h in handles]
    finally:
        server.stop()
    assert result.ok and all(e.num_blocks == 24 for e in fleet.replicas)
    for p, (got, reason) in zip(prompts, out):
        assert reason == "length" and toks(got) == solo(lm, p, 10)


def test_engine_refuses_replica_scale(lm):
    def run(side):
        eng = side.engine(num_slots=2, max_len=32)
        with pytest.raises(side.serving.ReconfigError) as err:
            eng.reconfigure(side.serving.replica_drain(0))
        return str(err.value)

    both(lm, run)


def test_fleet_checkpoint_swap_shares_one_copy(lm, tmp_path):
    """A fleet's checkpoint swap restores once and every replica takes the
    same tensors (one copy of the weights); streams equal JAX's fleet."""
    def run(side):
        d = str(tmp_path / side.name)
        side.save(d, side.params)
        fleet = side.fleet(replicas=2, tp=None, num_slots=2, max_len=32, page_size=4,
                           num_blocks=16)
        reqs = {fleet.submit(p, 8): (p, 8) for p in prompts_of(4, seed=21)}
        fleet.step()
        res = fleet.reconfigure(side.serving.checkpoint_swap(checkpoint=d))
        shared = (side.port and all(
            a is b for a, b in zip(treconfig._leaves(fleet.replicas[0].params),
                                   treconfig._leaves(fleet.replicas[1].params))))
        fleet.run_until_idle()
        out = {rid: (toks(fleet.results[rid]), fleet.status[rid]) for rid in reqs}
        fleet.close()
        return res.ok, res.preempted, [r["detail"]["weights_unchanged"]
                                       for r in res.detail["per_replica"]], out, shared, reqs

    got = {name: run(side) for name, side in stacks(lm).items()}
    assert got["torch"][:4] == got["jax"][:4]
    ok, _, unchanged, out, shared, reqs = got["torch"]
    assert ok and unchanged == [True, True] and shared
    assert_solo(lm, out, reqs)


# -- watchdog / sentinel maintenance ------------------------------------------------------


def test_watchdog_suspend_blocks_false_stall():
    fired = []
    wd = Watchdog(timeout=0.05, on_stall=fired.append, poll=0.01).start()
    try:
        wd.arm()
        with wd.suspend():
            time.sleep(0.15)  # a planned long operation
            wd.arm()          # arms inside the window are ignored
            time.sleep(0.1)
        assert not fired
        wd.arm()
        time.sleep(0.2)
        assert fired  # real stalls still fire after the window closes
    finally:
        wd.stop()


def test_watchdog_suspend_restores_open_window():
    """A window open when suspension begins restarts at its exit: the rest
    of the armed dispatch keeps stall detection."""
    fired = []
    wd = Watchdog(timeout=0.05, on_stall=fired.append, poll=0.01).start()
    try:
        wd.arm()
        with wd.suspend():
            time.sleep(0.12)
        assert not fired
        time.sleep(0.2)
        assert fired
    finally:
        wd.stop()


def test_sentinel_maintenance_pauses_leases(lm):
    def run(side):
        clk = [0.0]
        snt = side.sentinel.Sentinel(clock=lambda: clk[0], lease=1.0)
        snt.heartbeat(tick=1, busy=True)
        with snt.maintenance():
            clk[0] = 10.0
            during = snt.check()
        after = snt.check()
        clk[0] = 25.0
        return len(during), len(after), [a.kind for a in snt.check()]

    assert both(lm, run) == (0, 0, ["stall"])


# -- bounded host swap store --------------------------------------------------------------


def test_swap_store_max_bytes_evicts_oldest(lm):
    def run(side):
        st = side.serving.HostSwapStore(max_bytes=100)
        arr = {"k": np.zeros(10, np.float32)}  # 40 bytes a record
        st.put(1, arr, 0, 4)
        st.put(2, arr, 0, 4)
        a = st.held_bytes
        st.put(3, arr, 0, 4)  # evicts rid 1
        b = (st.held_bytes, st.evictions, 1 in st, 2 in st, 3 in st)
        with pytest.raises(OSError):
            st.put(4, {"k": np.zeros(100, np.float32)}, 0, 4)
        st.discard(2)
        return a, b, st.held_bytes

    assert both(lm, run) == (80, (80, 1, False, True, True), 40)


def test_engine_swap_cap_degrades_to_reprefill(lm):
    """A capped store evicts to re-prefill: host memory stays bounded and
    the streams stay exact."""
    def run(side):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=12,
                          admission="optimistic", swap="host", swap_max_bytes=1)
        reqs = {eng.submit(p, 10): (p, 10) for p in prompts_of(4, seed=17)}
        out = drain(eng, reqs)
        return (eng.manifest()["swap_max_bytes"], out, counters(eng),
                eng._swap_store.held_bytes, reqs)

    cap, out, count, held, reqs = both(lm, run)
    assert cap == 1 and held == 0
    if count["preemptions"]:
        assert count["swap_fallbacks"] > 0 and count["swap_ins"] == 0
    assert_solo(lm, out, reqs)


def test_swap_store_bytes_gauge_on_metrics(lm):
    """A pressure preemption leaves its record in the store when the tick's
    gauges sample, and the gauge is on ``/metrics``."""
    def run(side):
        eng = side.engine(num_slots=4, max_len=32, page_size=4, num_blocks=8,
                          admission="optimistic", swap="host")
        reqs = {eng.submit(p, 12): (p, 12) for p in prompts_of(4, seed=18, lo=4, hi=8)}
        peak = 0
        while not eng.idle:
            eng.step()
            peak = max(peak, eng.metrics.swap_store_bytes)
        prom = "serving/swap_store_bytes" in eng.metrics.to_prometheus() or \
            "serving_swap_store_bytes" in eng.metrics.to_prometheus()
        out = {rid: (toks(eng.results[rid]), eng.status[rid]) for rid in reqs}
        return eng.metrics.preemptions, peak, prom, out, reqs

    preemptions, peak, prom, out, reqs = both(lm, run)
    assert preemptions > 0 and peak > 0 and prom
    assert_solo(lm, out, reqs)


# -- host liveness leases -----------------------------------------------------------------


def test_host_lease_distinguishes_gone_from_slow(lm):
    for side in stacks(lm).values():
        bus_t = side.preemption.LocalDrainBus
        clk = [0.0]
        bus = bus_t(2, timeout=30.0, lease_ttl=1.0, clock=lambda: clk[0])
        bus.renew(1, now=0.0)
        clk[0] = 5.0
        t0 = time.monotonic()
        assert bus.exchange(0, True, 7) == (True, 7)
        assert time.monotonic() - t0 < 5.0
        assert bus.partial_rounds == 1 and bus.last_partial() == (1,)
        bus2 = bus_t(2, timeout=30.0, lease_ttl=60.0, clock=lambda: clk[0])
        bus2.renew(1, now=clk[0])
        out = {}

        def late_host():
            time.sleep(0.25)
            out[1] = bus2.exchange(1, False, 9)

        th = threading.Thread(target=late_host)
        th.start()
        res = bus2.exchange(0, True, 7)
        th.join(timeout=WAIT)
        assert res == (True, 9) == out[1] and bus2.partial_rounds == 0


def test_host_lease_unknown_is_not_gone(lm):
    for side in stacks(lm).values():
        clk = [0.0]
        bus = side.preemption.LocalDrainBus(2, timeout=0.3, lease_ttl=1.0,
                                            clock=lambda: clk[0])
        with pytest.raises(TimeoutError):
            bus.exchange(0, True, 7)
        assert bus.partial_rounds == 0


def test_drain_consensus_lease_api(lm):
    def run(side):
        clk = [0.0]
        pre = side.preemption
        bus = pre.LocalDrainBus(2, timeout=30.0, clock=lambda: clk[0])
        c0 = pre.DrainConsensus(multiprocess=False, bus=bus, host_id=0, lease_ttl=1.0)
        c1 = pre.DrainConsensus(multiprocess=False, bus=bus, host_id=1, lease_ttl=1.0)
        ttl = bus.lease_ttl
        c0.renew_lease(now=0.0)
        c1.renew_lease(now=0.0)
        live = c0.peer_liveness(now=0.5)
        clk[0] = 5.0
        return ttl, live, c0.peer_liveness(now=5.0)

    assert both(lm, run) == (1.0, {0: "live", 1: "live"}, {0: "expired", 1: "expired"})


def test_agree_reconfig_tick_over_consensus():
    """One reconfig tick agreed over the drain-consensus exchange: (any host
    wants it, max of the ticks)."""
    bus = tpreemption.LocalDrainBus(2, timeout=30.0)
    c0 = tpreemption.DrainConsensus(multiprocess=False, bus=bus, host_id=0)
    c1 = tpreemption.DrainConsensus(multiprocess=False, bus=bus, host_id=1)
    out = {}

    def host1():
        out[1] = treconfig.agree_tick(c1, False, 41)

    th = threading.Thread(target=host1)
    th.start()
    out[0] = treconfig.agree_tick(c0, True, 38)
    th.join(timeout=WAIT)
    assert out[0] == out[1] == (True, 41)


# -- misc ----------------------------------------------------------------------------------


def test_spec_validation(lm):
    for side in stacks(lm).values():
        s = side.serving
        with pytest.raises(ValueError):
            s.pool_resize(0)
        with pytest.raises(ValueError):
            s.checkpoint_swap()
        with pytest.raises(ValueError):
            s.checkpoint_swap(checkpoint="x", params={})
        with pytest.raises(ValueError):
            side.reconfig.ReconfigSpec("nonsense")
        spec = s.replica_excise(2, initiator="healer")
        assert spec.to_dict() == {"kind": "replica_scale", "num_blocks": None,
                                  "checkpoint": None, "replica": 2, "action": "excise",
                                  "initiator": "healer", "inline_params": False}
    assert dataclasses.asdict(treconfig.replica_add()) == {
        k: v for k, v in dataclasses.asdict(jreconfig.replica_add()).items()}


def test_bench_reconfig_fast(tmp_path, capsys):
    """``bench_reconfig --fast`` on the CPU: both transitions finish every
    request with parity in both legs, and the live resize keeps JAX's 1.5x
    availability over stop-the-world."""
    from gradaccum_tpu_torch.examples import bench_reconfig

    out = tmp_path / "reconfig.json"
    result = bench_reconfig.main(["--fast", "--device", "cpu", "--json", str(out)])
    assert result["acceptance"]["passed"], result["acceptance"]
    for kind in ("resize", "ckpt_swap"):
        t = result["transition"][kind]
        assert t["availability_ratio"] > 0 and t["live"]["time_to_recover_ticks"] is not None
    assert result["transition"]["resize"]["availability_ratio"] >= 1.5
    assert out.exists()
