"""The int8 KV codec, the swap stores and the tiered ladder, against JAX's.

The port's counterparts of JAX's ``tests/test_memory.py`` cases of the KV
codec, the stores, the engine and the sentinel's ``tier_thrash`` anomaly:

- ``kv_quantize`` codes and scales BITWISE equal to JAX's over random,
  all-zero, +-max and rounding-tie vectors, and within JAX's error bound;
  where the scale is subnormal (JAX flushes it, the port keeps it) the
  port's own bound: finite scales, codes within +-127, the round trip
  within absmax / 254 plus the subnormal grid's steps;
- the dequantizing page view of an int8 pool within 1e-6 of JAX's, and an
  int8 decode step and prefill beside JAX's;
- the tiered store's demotions, promotions, evictions and corruption
  handling event for event with JAX's, and the host store's capacity
  accounting;
- int8 engines through tier churn token for token with JAX's and with a
  calm int8 engine, their swap records carrying the quantized leaves;
- bfloat16 pools (the port alone): records hold the raw bits as ``int16``
  with the dtype beside them, through the host store and the disk rung;
- ``bench_mem --fast`` meets JAX's acceptance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.memory import quant as tquant
from gradaccum_tpu_torch.memory.tiers import TieredStore
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.serving import Engine
from gradaccum_tpu_torch.serving.swap import (
    HostSwapStore,
    SwapCapacityError,
    SwapError,
    to_device,
    to_host,
)
from gradaccum_tpu_torch.utils import prng

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jdec = importlib.import_module("gradaccum_tpu.models.gpt_decode")
jquant = importlib.import_module("gradaccum_tpu.memory.quant")
jtiers = importlib.import_module("gradaccum_tpu.memory.tiers")
jswap = importlib.import_module("gradaccum_tpu.serving.swap")
jserving = importlib.import_module("gradaccum_tpu.serving")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    params = jgpt.gpt_lm_bundle(jcfg).init(jax.random.PRNGKey(0),
                                           {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, tcfg, params_tree(model)


def _ints(tokens):
    return [int(t) for t in tokens]


def _codec_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3.0, (2, 5, 3, 4, 8)).astype(np.float32)
    x[0, 0, 0, 0] = 0.0                                   # all zero
    x[0, 0, 0, 1] = np.finfo(np.float32).max              # +max
    x[0, 0, 0, 2] = -np.finfo(np.float32).max             # -max
    x[0, 0, 0, 3] = [127.0, 0.5, -0.5, 1.5, 2.5, -2.5, 63.5, 0.0]  # ties at scale 1
    # (no vector with absmax under 127 x FLT_MIN: its scale is subnormal,
    # which XLA's CPU flushes to zero and torch keeps)
    x[1, 4, 2, 3] = [1e-30, -1e-30, 3e-31, 0, 0, 0, 0, 0]
    return x


# -- the codec -----------------------------------------------------------------------


def test_kv_quantize_roundtrip_error_bound():
    """Codes and scales bitwise JAX's; dequantized within absmax / 254 per
    vector; all-zero vectors survive exactly."""
    x = _codec_inputs()
    q, scale = tquant.kv_quantize(torch.from_numpy(x))
    jq, js = jquant.kv_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    back = tquant.kv_dequantize(q, scale, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jquant.kv_dequantize(jq, js, jnp.float32)))
    finite = np.isfinite(x).all(-1) & (np.abs(x).max(-1) < 1e30)
    bound = np.abs(x).max(-1, keepdims=True) / 254.0
    assert np.all((np.abs(back - x) <= bound + 1e-7)[finite])
    zq, zs = tquant.kv_quantize(torch.zeros(1, 2, 1, 3, 8))
    assert not zq.any() and not zs.any()
    assert not tquant.kv_dequantize(zq, zs, torch.float32).any()
    # bf16 values quantize as their float32 upcast, as JAX's do
    xb = torch.from_numpy(x[1]).to(torch.bfloat16)
    jb = jnp.asarray(x[1]).astype(jnp.bfloat16)
    np.testing.assert_array_equal(tquant.kv_quantize(xb)[0].numpy(),
                                  np.asarray(jquant.kv_quantize(jb)[0]))


def test_kv_quantize_subnormal_scales_stay_bounded():
    """Vectors whose absmax is under 127 x FLT_MIN get a subnormal scale,
    which XLA's CPU flushes to zero (codes 0, error = absmax) and torch
    keeps, so the bitwise case above leaves them out. The port's own
    behaviour there: every scale finite and subnormal, codes within +-127,
    and the round trip within absmax / 254 plus 64 steps of the subnormal
    grid (2^-149). The grid term is needed: a subnormal scale is itself a
    multiple of 2^-149, so for absmax = 128 * 2^-149 with an element of
    2^-149 every possible scale leaves an error of one whole step, about
    twice absmax / 254. Where the scale is exact the plain bound holds."""
    step = 2.0 ** -149
    tiny = float(np.finfo(np.float32).tiny)
    rng = np.random.default_rng(1)
    # absmax log-uniform over [one grid step, 127 x FLT_MIN)
    k = np.exp(rng.uniform(0.0, np.log(127 * tiny / step), 4096))
    x = rng.uniform(-1.0, 1.0, (4096, 16))
    x = (x / np.abs(x).max(1, keepdims=True) * (k * step)[:, None]).astype(np.float32)
    x[:, 0] = np.sign(x[:, 0]) * np.abs(x).max(1)
    x[0] = [128 * step, step] + [0.0] * 14  # the example above
    x[1] = [127 * 5 * step, -5 * step, 2 * step] + [0.0] * 13  # an exact scale of 5 steps
    q, scale = tquant.kv_quantize(torch.from_numpy(x))
    scale = scale.numpy().astype(np.float64)
    assert np.isfinite(scale).all() and (scale < tiny).all()
    assert int(q.abs().max()) <= 127
    back = tquant.kv_dequantize(q, torch.from_numpy(scale.astype(np.float32)),
                                torch.float32).numpy().astype(np.float64)
    absmax = np.abs(x.astype(np.float64)).max(1)
    err = np.abs(back - x).max(1)
    assert np.all(err <= absmax / 254 + 64 * step)
    assert scale[1] == 5 * step and err[1] <= absmax[1] / 254


def test_quant_kv_pytree_helpers():
    q = torch.zeros(2, 3, 4, 8, dtype=torch.int8)
    kv = tquant.QuantKV(q, torch.ones(2, 3, 4))
    assert tquant.is_quantized_kv(kv) and not tquant.is_quantized_kv(q)
    assert kv.shape == (2, 3, 4, 8) and kv.nbytes == q.numel() + 4 * 24
    assert kv.device == q.device and kv.dtype == torch.int8
    assert kv.nbytes == jquant.QuantKV(jnp.zeros((2, 3, 4, 8), jnp.int8),
                                       jnp.ones((2, 3, 4))).nbytes
    taken = tquant.kv_map(lambda a: a[:, :1], kv)
    assert isinstance(taken, tquant.QuantKV) and taken.scale.shape == (2, 1, 4)
    assert tquant.kv_map(lambda a, b: a + b, q, q).dtype == torch.int8


# -- the int8 paged pool -------------------------------------------------------------------


def _int8_pools(rng, num_blocks=6, page=4, layers=2, heads=2, hd=16):
    """The same random int8 pool for both packages: JAX's ``[L, blocks, ...]``
    and the port's with its trash block after them."""
    q = rng.integers(-127, 128, (layers, num_blocks + 1, heads, page, hd)).astype(np.int8)
    s = rng.uniform(0, 0.05, (layers, num_blocks + 1, heads, page)).astype(np.float32)
    port = tquant.QuantKV(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))
    jax_pool = jquant.QuantKV(jnp.asarray(q[:, :num_blocks]), jnp.asarray(s[:, :num_blocks]))
    return port, jax_pool


def test_int8_page_view_within_1e6_of_jax():
    rng = np.random.default_rng(1)
    port, jpool = _int8_pools(rng)
    table = np.asarray([[3, 0, 6], [5, 6, 6]], np.int64)  # 6: the sentinel
    kv_shape = (2, 2, 12, 16)
    for i in range(2):
        got = tdec._virt_view(port, i, tdec._read_table(torch.from_numpy(table), 6), kv_shape,
                              torch.float32)
        want = jdec._virt_view(jpool, i, jnp.asarray(table, jnp.int32), kv_shape, jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_int8_decode_and_prefill_beside_jax(lm):
    """A prefill and decode steps into int8 pools on both packages: the pools'
    real blocks hold codes within one step and scales within 1e-6 of JAX's,
    and the logits agree (the same K/V up to float32 rounding, quantized)."""
    jcfg, params, tcfg, tree = lm
    nb, page = 8, 4
    tk, tv = tdec.init_paged_pool(tcfg, nb, page, cache_dtype=torch.int8)
    jk, jv = jdec.init_paged_pool(jcfg, nb, page, cache_dtype="int8")
    assert isinstance(tk, tquant.QuantKV) and tk.q.shape[1] == nb + 1
    assert tk.scale.shape == tk.q.shape[:-1] and tk.q.dtype == torch.int8
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 96, (2, 6)).astype(np.int32)
    lens = np.asarray([6, 4], np.int32)
    ids[1, :2] = 0
    rows = np.asarray([[0, 1], [2, 8]], np.int64)  # 8: the sentinel
    tk, tv, tl = tdec.prefill_paged(tree, tcfg, ids, lens, tk, tv, rows)
    jk, jv, jl = jdec.prefill_paged(params, jcfg, ids, lens, jk, jv,
                                    jnp.asarray(rows, jnp.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    table = np.asarray([[0, 1, 3, 8], [2, 4, 8, 8]], np.int64)
    lengths = np.asarray([6, 4])
    tok = np.asarray(jl).argmax(-1)
    for _ in range(4):
        tk, tv, tlen, tlog = tdec.decode_step_paged(
            tree, tcfg, tk, tv, torch.from_numpy(table), torch.from_numpy(lengths),
            torch.from_numpy(tok))
        jk, jv, jlen, jlog = jdec.decode_step_paged(
            params, jcfg, jk, jv, jnp.asarray(table, jnp.int32), jnp.asarray(lengths),
            jnp.asarray(tok))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
        lengths, tok = np.array(jlen), np.array(jlog).argmax(-1)
    for t, j in ((tk, jk), (tv, jv)):
        dq = np.abs(t.q[:, :nb].numpy().astype(np.int32) - np.asarray(j.q).astype(np.int32))
        assert dq.max() <= 1
        np.testing.assert_allclose(t.scale[:, :nb].numpy(), np.asarray(j.scale), rtol=1e-5,
                                   atol=1e-6)
    kb, vb = tdec.gather_blocks(tk, tv, [1, 3])
    assert isinstance(kb, tquant.QuantKV) and kb.q.shape[1] == 2
    tdec.scatter_blocks(tk, tv, [5, 8], kb, vb)  # 8: the sentinel, lands in the trash
    assert torch.equal(tk.q[:, 5], kb.q[:, 0]) and torch.equal(tv.scale[:, 5], vb.scale[:, 0])


# -- the stores ------------------------------------------------------------------------------


def _arrays(rng):
    # one 1024-byte record: k and v of 128 float32 each
    return {"k": rng.normal(0, 1, (128,)).astype(np.float32),
            "v": rng.normal(0, 1, (128,)).astype(np.float32)}


def _tier_scenario(make, path, swap_error, capacity_error):
    """JAX's two ladder cases as one trace; returns what each step saw."""
    seen = []
    rng = np.random.default_rng(2)
    st = make(host_max_bytes=2048, disk_max_bytes=1 << 20, disk_dir=str(path / "a"))
    recs = {rid: _arrays(rng) for rid in range(4)}
    for rid, arrays in recs.items():
        st.put(rid, arrays, page_start=0, length=rid + 1)
    seen.append((st.stats(), st.demotions, len(st), all(rid in st for rid in recs)))
    rec = st.get(0)
    np.testing.assert_array_equal(rec.arrays["k"], recs[0]["k"])
    seen.append((rec.length, st.promotions, 0 in st._host, list(st._lru)))
    victim = next(iter(st._disk))
    path_ = st._path(victim)
    raw = open(path_, "rb").read()
    open(path_, "wb").write(raw[:-8] + bytes(8))
    with pytest.raises(swap_error):
        st.get(victim)
    seen.append((st.corruptions, victim in st))
    st.put(99, {"k": np.zeros(4096, np.float32)}, 0, 7)
    seen.append((99 in st._disk, 99 not in st._host, st.get(99).length))
    st2 = make(host_max_bytes=1024, disk_max_bytes=2048, disk_dir=str(path / "b"))
    rng = np.random.default_rng(3)
    for rid in range(4):
        st2.put(rid, _arrays(rng), 0, 1)
    gone = [e.rid for e in st2.events if e.kind == "evict"]
    for rid in gone:
        with pytest.raises(KeyError):
            st2.get(rid)
    with pytest.raises(capacity_error) as ei:
        st2.put(7, {"k": np.zeros(8192, np.float32)}, 0, 1)
    msg = str(ei.value)
    assert "1024" in msg and "2048" in msg and "re-prefill" in msg
    seen.append((st2.evictions, gone, [tuple(e) for e in st.events + st2.events],
                 st2.stats()))
    st2.clear()
    seen.append((len(st2), st2.stats()))
    return seen


def test_tiered_store_demotes_lru_and_promotes_sha_checked(tmp_path):
    """JAX's ladder cases (LRU demotion, sha-checked promotion, a rotted
    container dropped, an oversized record straight to disk, disk overflow
    evicting the oldest, the capacity message) step for step with JAX's
    store."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = _tier_scenario(TieredStore, tmp_path / "t", SwapError, SwapCapacityError)
    want = _tier_scenario(jtiers.TieredStore, tmp_path / "j", jswap.SwapError,
                          jswap.SwapCapacityError)
    assert got == want
    assert got[0][0]["host_records"] == 2 and got[0][0]["disk_records"] == 2
    assert got[2] == (1, False) and got[4][0] >= 1


def test_tiered_store_disk_overflow_evicts_oldest(tmp_path):
    rng = np.random.default_rng(3)
    st = TieredStore(host_max_bytes=1024, disk_max_bytes=2048, disk_dir=str(tmp_path))
    for rid in range(4):
        st.put(rid, _arrays(rng), 0, 1)
    assert st.evictions >= 1
    for rid in [e.rid for e in st.events if e.kind == "evict"]:
        assert rid not in st
        with pytest.raises(KeyError):
            st.get(rid)


def test_swap_capacity_error_reports_held_vs_limit_and_accounting():
    """JAX's case on the port's store, and the same answers from JAX's."""

    def scenario(make, capacity_error):
        st = make(max_bytes=4096)
        a = {"k": np.zeros(256, np.float32)}
        st.put(1, a, 0, 1)
        seen = [st.held_bytes]
        with pytest.raises(capacity_error) as ei:
            st.put(2, {"k": np.zeros(4096, np.float32)}, 0, 1)
        msg = str(ei.value)
        assert "16384" in msg and "1024" in msg and "4096" in msg
        seen.append(st.held_bytes)
        st.discard(1)
        seen.append((st.held_bytes, len(st)))
        st.put(1, a, 0, 1)
        st.put(2, a, 0, 2)
        seen.append((st.held_bytes, len(st)))
        st.put(1, a, 0, 3)
        seen.append((st.held_bytes, len(st)))
        for rid in (3, 4):  # over the cap: the oldest go first
            st.put(rid, {"k": np.zeros(512, np.float32)}, 0, 1)
        seen.append((st.held_bytes, len(st), st.evictions, sorted(st._recs)))
        return seen

    got = scenario(HostSwapStore, SwapCapacityError)
    assert got == scenario(jswap.HostSwapStore, jswap.SwapCapacityError)
    assert got[:5] == [1024, 1024, (0, 0), (2048, 2), (2048, 2)]


def test_host_store_digest_and_raw_bits():
    """A record's digest covers its bytes and its dtype names; a bfloat16
    tensor round-trips through ``to_host``/``to_device`` bit for bit."""
    t = torch.randn(3, 5).to(torch.bfloat16)
    a, name = to_host(t)
    assert a.dtype == np.int16 and name == "bfloat16"
    assert torch.equal(to_device(a, name, "cpu"), t)
    f, none = to_host(torch.ones(2))
    assert f.dtype == np.float32 and none is None
    st = HostSwapStore()
    rec = st.put(5, {"k": a}, 0, 3, {"k": name})
    assert rec.dtypes == {"k": "bfloat16"} and st.get(5) is rec
    rec.dtypes["k"] = "float16"
    with pytest.raises(SwapError):
        st.get(5)
    plain = jswap.HostSwapStore().put(1, {"k": f}, 2, 3)
    assert HostSwapStore().put(1, {"k": f}, 2, 3).digest == plain.digest


# -- engines ---------------------------------------------------------------------------------


def _engine(lm, side, **kw):
    jcfg, params, tcfg, tree = lm
    if side == "jax":
        if kw.get("cache_dtype") is torch.int8:
            kw["cache_dtype"] = "int8"
        return jserving.Engine(params, jcfg, **kw)
    return Engine(tree, tcfg, device="cpu", **kw)


def test_engine_int8_greedy_parity_through_tier_churn(lm):
    """int8 + tiered swap with a host rung too small for any record: every
    preemption demotes to disk and every resume promotes back. Tokens equal
    JAX's engine's, a second run's, and a calm int8 engine's."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 96, 6).astype(np.int32) for _ in range(4)]

    def run(side, **kw):
        eng = _engine(lm, side, num_slots=4, max_len=32, page_size=4, num_blocks=10,
                      cache_dtype=torch.int8, **kw)
        rids = [eng.submit(p, 12) for p in prompts]
        events = eng.run_until_idle()
        return eng, [_ints(eng.results[r]) for r in rids], [
            (e.tick, e.preempted, e.resumed) for e in events if e.preempted or e.resumed]

    churn = dict(admission="optimistic", swap="tiered", swap_max_bytes=512)
    e1, out1, replay1 = run("torch", **churn)
    _, jout, jreplay = run("jax", **churn)
    assert (out1, replay1) == (jout, jreplay)
    assert e1.metrics.preemptions >= 1 and e1.metrics.swap_ins >= 1
    st = e1._swap_store.stats()
    assert st["demotions"] >= 1 and st["promotions"] >= 1
    assert run("torch", **churn)[1] == out1
    assert run("torch")[1] == out1
    ms = e1.memory_stats()
    _, tcfg = lm[0], lm[2]
    assert ms["kv_quant"] and ms["tiers"]["demotions"] >= 1
    assert ms["token_bytes"] == 2 * tcfg.num_layers * (tcfg.hidden_size + tcfg.num_heads * 4)
    assert e1.manifest()["memory"] == {"kv_quant": True, "token_bytes": ms["token_bytes"],
                                       "tiered_swap": True}
    assert e1.manifest()["cache_dtype"] == "int8"
    summ = e1.metrics.summary()
    assert summ["tier_demotions"] >= 1 and summ["tier_promotions"] >= 1


def test_engine_int8_swap_record_carries_quant_leaves(lm):
    prompt = np.arange(1, 7, dtype=np.int32)
    got = {}
    for side in ("torch", "jax"):
        eng = _engine(lm, side, num_slots=2, max_len=32, page_size=4, admission="quantile",
                      swap="host", cache_dtype=torch.int8)
        rid = eng.submit(prompt, 10)
        for _ in range(3):
            eng.step()
        assert eng.preempt(rid)
        rec = eng._swap_store._recs[rid]
        assert {"k_q", "k_scale", "v_q", "v_scale"} <= set(rec.arrays)
        assert rec.arrays["k_q"].dtype == np.int8 and rec.arrays["k_scale"].dtype == np.float32
        shapes = {k: a.shape for k, a in rec.arrays.items()}
        eng.run_until_idle()
        got[side] = (_ints(eng.results[rid]), eng.metrics.swap_ins, shapes, rec.nbytes)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 1
    base = _engine(lm, "torch", num_slots=2, max_len=32, page_size=4, cache_dtype=torch.int8)
    rb = base.submit(prompt, 10)
    base.run_until_idle()
    assert got["torch"][0] == _ints(base.results[rb])


def test_engine_int8_prefix_cow_under_pressure_equals_jax(lm):
    """int8 with prefix sharing, COW tails and optimistic admission: forks
    copy codes and scales, and streams, victims and resumes equal JAX's."""
    rng = np.random.default_rng(8)
    sys_prompt = rng.integers(0, 96, 7).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, 96, int(n)).astype(np.int32)])
               for n in (0, 2, 1, 3, 0)]
    got = {}
    for side in ("torch", "jax"):
        eng = _engine(lm, side, num_slots=4, max_len=32, page_size=4, num_blocks=12,
                      cache_dtype=torch.int8, prefix_cache=True, admission="optimistic",
                      swap="host")
        rids, events = [], []
        for p in prompts:
            rids.append(eng.submit(p, 10))
            events.append(eng.step())
        events += eng.run_until_idle()
        m = eng.metrics
        got[side] = ([_ints(eng.results[r]) for r in rids],
                     [(e.tick, e.preempted, e.resumed) for e in events
                      if e.preempted or e.resumed],
                     (m.preemptions, m.swap_ins, m.reprefills, m.cow_forks),
                     eng.pool.allocated_blocks)
    assert got["torch"] == got["jax"]
    assert got["torch"][2][0] >= 1 and got["torch"][2][3] >= 1


def test_engine_int8_guards(lm):
    """JAX's refusals, word for word: int8 needs paging, an unknown swap
    mode, int8 with speculation; and ``init_cache`` refuses int8."""

    def err(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    jcfg, params, tcfg, tree = lm
    for kw in (dict(num_slots=2, max_len=32, cache_dtype=torch.int8),
               dict(num_slots=2, max_len=32, page_size=4, swap="warm")):
        want = err(lambda: _engine(lm, "jax", **dict(kw)))
        assert want is not None and err(lambda: _engine(lm, "torch", **kw)) == want
    with pytest.raises(ValueError, match="paged pool layout"):
        tdec.init_cache(tcfg, 2, 8, cache_dtype=torch.int8)
    eng = _engine(lm, "torch", num_slots=2, max_len=32, page_size=4, cache_dtype="int8")
    assert isinstance(eng.pool.k, tquant.QuantKV) and eng.manifest()["cache_dtype"] == "int8"


@pytest.mark.parametrize("swap", ["host", "tiered"])
@pytest.mark.parametrize("pool", ["fixed", "paged"])
def test_bf16_swap_records_hold_raw_bits(lm, tmp_path, swap, pool):
    """A bfloat16 pool's records hold ``int16`` bits with the dtype beside
    them (the card's numpy has no bfloat16), on the host store and through
    the disk rung; the resumed stream equals a calm bfloat16 engine's."""
    prompt = np.arange(1, 7, dtype=np.int32)
    kw = dict(num_slots=2, max_len=32, cache_dtype=torch.bfloat16, swap=swap)
    if pool == "paged":
        kw.update(page_size=4, admission="quantile")
    if swap == "tiered":
        kw["swap_max_bytes"] = 64  # every record spills to disk
    eng = _engine(lm, "torch", **kw)
    if swap == "tiered":
        eng._swap_store = TieredStore(host_max_bytes=64, disk_dir=str(tmp_path))
    rid = eng.submit(prompt, 10)
    for _ in range(3):
        eng.step()
    assert eng.preempt(rid)
    store = eng._swap_store
    if swap == "tiered":
        assert rid in store._disk
        with np.load(store._path(rid)) as z:
            assert z["k"].dtype == np.int16
    else:
        rec = store._recs[rid]
        assert rec.arrays["k"].dtype == np.int16 and rec.dtypes == {"k": "bfloat16",
                                                                     "v": "bfloat16"}
    eng.run_until_idle()
    assert eng.metrics.swap_ins == 1 and eng.metrics.swap_fallbacks == 0
    calm = _engine(lm, "torch", **{k: v for k, v in kw.items()
                                   if k not in ("swap", "swap_max_bytes", "admission")})
    rc = calm.submit(prompt, 10)
    calm.run_until_idle()
    assert _ints(eng.results[rid]) == _ints(calm.results[rc])


def test_bench_mem_fast():
    """``bench_mem --fast`` on the CPU: the state ladder >= 4x with every loss
    falling, the KV ladder >= 2x with parity, JAX's acceptance."""
    from gradaccum_tpu_torch.examples import bench_mem

    result = bench_mem.main(["--fast", "--device", "cpu"])
    assert result["state_bytes_ladder_vs_f32"] >= 4.0
    assert result["kv_ram_per_stream_ladder_vs_bf16"] >= 2.0
    rows = {r["config"]: r for r in result["kv_stream_ladder"]}
    assert rows["int8+tiered"]["tier_promotions"] >= 1
    assert all(r["greedy_parity_vs_calm"] for r in rows.values())
    assert result["acceptance"]["passed"]


def test_kv_tiers_generate_cached_reference(lm):
    """The calm int8 engine itself against JAX's calm int8 engine and the
    float32 ``generate_cached``: int8 and JAX's int8 agree token for token;
    the float32 agreement rate is recorded, not gated (quantization moves
    tokens in JAX too)."""
    _, _, tcfg, tree = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 96, 5).astype(np.int32) for _ in range(3)]
    got = {}
    for side in ("torch", "jax"):
        eng = _engine(lm, side, num_slots=3, max_len=32, page_size=4, cache_dtype=torch.int8)
        rids = [eng.submit(p, 12) for p in prompts]
        eng.run_until_idle()
        got[side] = [_ints(eng.results[r]) for r in rids]
    assert got["torch"] == got["jax"]
    f32 = [tdec.generate_cached(tree, tcfg, p, 12, rng=prng.PRNGKey(0))[0, 5:].tolist()
           for p in prompts]
    agree = np.mean([a == b for s, f in zip(got["torch"], f32) for a, b in zip(s, f)])
    assert 0.0 <= agree <= 1.0


def test_sentinel_tier_thrash_fires_and_resolves():
    """A demotion rate pinned above the ceiling fires ``tier_thrash`` once;
    decay below it resolves; a second storm fires again; the anomaly log
    equals JAX's for the same feed."""
    from gradaccum_tpu_torch.obs import sentinel as tsentinel

    jsentinel = importlib.import_module("gradaccum_tpu.obs.sentinel")
    logs = []
    for mod in (tsentinel, jsentinel):
        t = [0.0]
        snt = mod.Sentinel(clock=lambda: t[0], thrash_ceiling=0.5, thrash_warmup=2,
                           thrash_consecutive=3)
        fired = []
        snt.on(mod.TIER_THRASH, fired.append)
        for _ in range(8):
            t[0] += 1.0
            snt.observe_tier_spills(2.0)
        assert len(fired) == 1 and fired[0].detail["demotion_rate"] == 2.0
        t[0] += 1.0
        snt.observe_tier_spills(0.0)
        assert (mod.TIER_THRASH, None) not in snt.firing()
        for _ in range(4):
            t[0] += 1.0
            snt.observe_tier_spills(3.0)
        assert len(fired) == 2
        snt.observe_tier_spills(None)  # no tiered store: ignored
        logs.append(snt.anomalies_bytes())
    assert logs[0] == logs[1]
