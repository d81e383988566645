"""The port's KV-cache decode (``models/gpt_decode.py``) against JAX's.

JAX's tiny LM (``GPTConfig.tiny_for_tests(dropout=0.0)``, ``PRNGKey(0)``) is
carried into the port's ``GPTLM`` and read back as the decode tree
(``interop.py :: params_tree``); both packages see the same numpy inputs.

- ``prefill`` logits and caches, dense and ragged (left-padded), within
  1e-5; ``decode_step``, ``decode_step_ragged`` and ``decode_step_paged``
  logits and the K/V they write within 1e-5 at per-row positions, with an
  inactive row, a full row and a row at its write limit.
- The paged pool's sentinel: a dropped write changes no real block, and a
  read through a sentinel page reads the last real block, as JAX's clamped
  gather does (garbage in the trash block moves no logit). ``gather_blocks``/``scatter_blocks`` are exact, out-of-range
  ids included (clamped reads, dropped writes).
- ``generate_cached`` greedy, ``top_k=1`` and sampled at temperature 0.8
  (with and without ``top_k``) token for token with JAX's under the same
  seed.
- ``cache_dtype=bfloat16``: JAX's own test of the knob holds no token
  parity against float32 (``tests/test_serving_spec.py``: the dtype, half
  the bytes per token, a run to completion, the manifest); here the decode
  logits from a bfloat16 cache are also held to JAX's from its bfloat16
  cache within BF16_TOL.
- The functions of later items raise ``NotImplementedError`` naming them;
  those of items that have landed since (5b, 5c) run, each held to JAX in
  ``tests/test_torch_prefix_decode.py``.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.utils import prng

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jdec = importlib.import_module("gradaccum_tpu.models.gpt_decode")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# K/V rounded to bfloat16 on both sides from float32 values that differ in
# the last bits: a value on a rounding boundary lands one bf16 step apart
# (2^-8 relative), which moves a logit by about that much at most
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    params = jgpt.gpt_lm_bundle(jcfg).init(jax.random.PRNGKey(0),
                                           {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, tcfg, model, params_tree(model)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=msg, **tol)


def test_params_tree_is_views_of_the_module(lm):
    _, params, _, model, tree = lm
    q = tree["params"]["layer_0"]["attention"]["query"]["kernel"]
    assert q.data_ptr() == model.layer_0.attention.query.weight.data_ptr()
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(params["params"]["layer_0"]["attention"]["query"]["kernel"]))


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_prefill_matches_jax(lm, ragged):
    jcfg, params, tcfg, _, tree = lm
    ids = np.random.default_rng(0).integers(0, 96, (3, 10)).astype(np.int32)
    lens = np.array([10, 4, 7], np.int32) if ragged else None
    jc, jl = jdec.prefill(params, jcfg, ids, 24, lengths=lens)
    tc, tl = tdec.prefill(tree, tcfg, ids, 24, lengths=lens)
    _close(tl, jl, msg="logits")
    _close(tc.k, jc.k, msg="k")
    _close(tc.v, jc.v, msg="v")
    if ragged:
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    else:
        assert tc.length == int(jc.length) == 10
    with pytest.raises(ValueError, match="exceeds max_len"):
        tdec.prefill(tree, tcfg, ids, 8)


def test_decode_step_matches_jax(lm):
    jcfg, params, tcfg, _, tree = lm
    ids = np.random.default_rng(1).integers(0, 96, (2, 6)).astype(np.int32)
    jc, _ = jdec.prefill(params, jcfg, ids, 16)
    tc, _ = tdec.prefill(tree, tcfg, ids, 16)
    tok = np.array([5, 17], np.int32)
    for _ in range(3):
        jc, jl = jdec.decode_step(params, jcfg, jc, tok)
        tc, tl = tdec.decode_step(tree, tcfg, tc, tok)
        _close(tl, jl)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        assert tc.length == int(jc.length)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_decode_step_ragged_matches_jax(lm):
    """Rows at their own positions: one inactive, one full (position ==
    max_len): neither writes nor advances."""
    jcfg, params, tcfg, _, tree = lm
    rng = np.random.default_rng(2)
    max_len = 12
    k = rng.normal(size=(2, 4, 2, max_len, 16)).astype(np.float32)
    v = rng.normal(size=(2, 4, 2, max_len, 16)).astype(np.float32)
    lengths = np.array([3, 7, 12, 5], np.int32)
    active = np.array([True, True, True, False])
    tok = np.array([1, 2, 3, 4], np.int32)
    jc = jdec.DecodeCache(k=jax.numpy.asarray(k), v=jax.numpy.asarray(v), length=lengths)
    tc = tdec.DecodeCache(k=torch.tensor(k), v=torch.tensor(v),
                          length=torch.tensor(lengths, dtype=torch.int64))
    for _ in range(2):
        jc, jl = jdec.decode_step_ragged(params, jcfg, jc, tok, active)
        tc, tl = tdec.decode_step_ragged(tree, tcfg, tc, torch.tensor(tok), torch.tensor(active))
        _close(tl[:2], np.asarray(jl)[:2])  # the full and the inactive rows' logits are discarded
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_array_equal(tc.k[:, 2:].numpy(), k[:, 2:])  # nothing written there


def _paged_setup(seed=3):
    """A pool of 6 real blocks of 4, page tables of 4 pages with sentinels."""
    rng = np.random.default_rng(seed)
    nb, page = 6, 4
    pool_k = rng.normal(size=(2, nb, 2, page, 16)).astype(np.float32)
    pool_v = rng.normal(size=(2, nb, 2, page, 16)).astype(np.float32)
    table = np.array([[0, 3, nb, nb], [1, 2, 5, nb], [4, nb, nb, nb]], np.int32)
    lengths = np.array([6, 9, 4], np.int32)  # row 2 at a page boundary into a sentinel
    return pool_k, pool_v, table, lengths


def _torch_pool(pool, trash=0.0):
    pad = np.full((pool.shape[0], 1) + pool.shape[2:], trash, np.float32)
    return torch.tensor(np.concatenate([pool, pad], axis=1))


def test_decode_step_paged_matches_jax(lm):
    jcfg, params, tcfg, _, tree = lm
    pool_k, pool_v, table, lengths = _paged_setup()
    active = np.array([True, True, True])
    limit = np.array([20, 10, 20], np.int32)  # row 1 writes at 9, then stops at its limit
    tok = np.array([7, 8, 9], np.int32)
    jk, jv, jlen = jax.numpy.asarray(pool_k), jax.numpy.asarray(pool_v), lengths
    tk, tv = _torch_pool(pool_k), _torch_pool(pool_v)
    tlen = torch.tensor(lengths, dtype=torch.int64)
    ttable = torch.tensor(table, dtype=torch.int64)
    for _ in range(2):
        jk, jv, jlen, jl = jdec.decode_step_paged(params, jcfg, jk, jv, table, jlen, tok,
                                                  active, limit)
        tk, tv, tlen, tl = tdec.decode_step_paged(tree, tcfg, tk, tv, ttable, tlen,
                                                  torch.tensor(tok), torch.tensor(active),
                                                  torch.tensor(limit, dtype=torch.int64))
        # row 2 writes into a sentinel page (the engine never lets a slot
        # do so): JAX drops the write and reads a clamped real block there,
        # and so does the port (its write lands in the trash block)
        _close(tl, jl)
        _close(tk[:, :6], jk)
        _close(tv[:, :6], jv)
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert tlen.tolist() == [8, 10, 6]


def test_sentinel_write_dropped_and_read_masked(lm):
    _, _, tcfg, _, tree = lm
    pool_k, pool_v, table, lengths = _paged_setup(4)
    ttable = torch.tensor(table, dtype=torch.int64)
    tlen = torch.tensor(lengths, dtype=torch.int64)
    tok = torch.tensor([3, 4, 5])
    # an inactive row and a sentinel page write nothing real
    active = torch.tensor([False, True, True])
    tk, tv = _torch_pool(pool_k), _torch_pool(pool_v)
    tk, tv, new_len, logits = tdec.decode_step_paged(tree, tcfg, tk, tv, ttable, tlen, tok,
                                                     active)
    assert new_len.tolist() == [6, 10, 5]
    changed = (tk[:, :6] != torch.tensor(pool_k)).any(dim=(0, 2, 3, 4))
    assert changed.tolist() == [False] * 5 + [True]  # row 1's position 9: page 2, block 5
    assert (tk[:, 6] != 0).any()  # row 2's write went to the trash block
    # garbage in the trash block (dropped writes land there, no read does) moves no logit
    ga, gv = _torch_pool(pool_k, trash=1e3), _torch_pool(pool_v, trash=-1e3)
    _, _, _, garbage = tdec.decode_step_paged(tree, tcfg, ga, gv, ttable, tlen, tok, active)
    assert torch.equal(garbage[:2], logits[:2])
    np.testing.assert_array_equal(ga[:, :6].numpy(), tk[:, :6].numpy())


def test_gather_and_scatter_blocks_are_exact(lm):
    pool_k, pool_v, _, _ = _paged_setup(5)
    tk, tv = _torch_pool(pool_k), _torch_pool(pool_v)
    ids = np.array([4, 0, 9, 5], np.int32)  # 9 is out of range: clamps to block 5
    jkb, jvb = jdec.gather_blocks(pool_k, pool_v, ids)
    tkb, tvb = tdec.gather_blocks(tk, tv, torch.tensor(ids))
    np.testing.assert_array_equal(tkb.numpy(), np.asarray(jkb))
    np.testing.assert_array_equal(tvb.numpy(), np.asarray(jvb))
    rng = np.random.default_rng(6)
    kb = rng.normal(size=(2, 3, 2, 4, 16)).astype(np.float32)
    vb = rng.normal(size=(2, 3, 2, 4, 16)).astype(np.float32)
    dst = np.array([2, 6, 1], np.int32)  # 6 == num_blocks: the dropped padding
    jk2, jv2 = jdec.scatter_blocks(jax.numpy.asarray(pool_k), jax.numpy.asarray(pool_v), dst,
                                   kb, vb)
    tk2, tv2 = tdec.scatter_blocks(tk, tv, torch.tensor(dst), torch.tensor(kb),
                                   torch.tensor(vb))
    assert tk2 is tk  # in place
    np.testing.assert_array_equal(tk2[:, :6].numpy(), np.asarray(jk2))
    np.testing.assert_array_equal(tv2[:, :6].numpy(), np.asarray(jv2))


def test_prefill_paged_matches_jax(lm):
    jcfg, params, tcfg, _, tree = lm
    pool_k, pool_v, _, _ = _paged_setup(7)
    ids = np.random.default_rng(8).integers(0, 96, (2, 8)).astype(np.int32)
    lens = np.array([8, 3], np.int32)
    rows = np.array([[2, 4], [5, 6]], np.int32)  # row 1's second page: the sentinel
    jk, jv, jl = jdec.prefill_paged(params, jcfg, ids, lens, jax.numpy.asarray(pool_k),
                                    jax.numpy.asarray(pool_v), rows)
    tk, tv, tl = tdec.prefill_paged(tree, tcfg, ids, torch.tensor(lens),
                                    _torch_pool(pool_k), _torch_pool(pool_v),
                                    torch.tensor(rows, dtype=torch.int64))
    _close(tl, jl)
    _close(tk[:, :6], jk)
    _close(tv[:, :6], jv)


@pytest.mark.parametrize("top_k", [None, 1], ids=["greedy", "top_k-1"])
def test_generate_cached_greedy_token_for_token(lm, top_k):
    jcfg, params, tcfg, _, tree = lm
    rng = np.random.default_rng(9)
    for n in (1, 5, 12):
        prompt = rng.integers(0, 96, n).astype(np.int32)
        kw = {} if top_k is None else dict(top_k=1, temperature=0.7)
        want = np.asarray(jdec.generate_cached(
            params, jcfg, prompt, 14, rng=jax.random.PRNGKey(n), **kw))
        got = tdec.generate_cached(tree, tcfg, prompt, 14, rng=prng.PRNGKey(n), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    greedy = tdec.generate_cached(tree, tcfg, prompt, 14)
    assert torch.equal(greedy, tgpt.greedy_generate(lm[3], prompt, 14))


@pytest.mark.parametrize("top_k", [None, 5], ids=["full", "top_k-5"])
def test_generate_cached_sampled_token_for_token(lm, top_k):
    jcfg, params, tcfg, _, tree = lm
    rng = np.random.default_rng(10)
    for seed in (0, 1, 2):
        prompt = rng.integers(0, 96, (2, 4 + seed)).astype(np.int32)
        want = np.asarray(jdec.generate_cached(params, jcfg, prompt, 16, temperature=0.8,
                                               rng=jax.random.PRNGKey(seed), top_k=top_k))
        got = tdec.generate_cached(tree, tcfg, prompt, 16, temperature=0.8,
                                   rng=prng.PRNGKey(seed), top_k=top_k)
        np.testing.assert_array_equal(got.numpy(), want)


def test_generate_cached_validation(lm):
    _, _, tcfg, _, tree = lm
    with pytest.raises(ValueError, match="rng key"):
        tdec.generate_cached(tree, tcfg, [1, 2], 3, temperature=0.5)
    with pytest.raises(ValueError, match="exceed max_len"):
        tdec.generate_cached(tree, tcfg, [1, 2], 3, max_len=4)
    with pytest.raises(ValueError, match="top_k"):
        tdec.generate_cached(tree, tcfg, [1, 2], 3, top_k=97)


def test_cache_dtype_bf16(lm):
    jcfg, params, tcfg, _, tree = lm
    assert tdec.init_cache(tcfg, 2, 8).k.dtype == torch.float32
    assert tdec.init_cache(tcfg, 2, 8, cache_dtype=torch.bfloat16).k.dtype == torch.bfloat16
    k, _ = tdec.init_paged_pool(tcfg, 4, 4, cache_dtype=torch.bfloat16)
    assert k.dtype == torch.bfloat16 and k.shape[1] == 5  # 4 blocks and the trash block
    ids = np.random.default_rng(11).integers(0, 96, (2, 5)).astype(np.int32)
    lens = np.array([5, 3], np.int32)
    jc, jl = jdec.prefill(params, jcfg, ids, 12, lengths=lens)
    tc, tl = tdec.prefill(tree, tcfg, ids, 12, lengths=lens)
    jc = jdec.DecodeCache(k=jc.k.astype(jax.numpy.bfloat16), v=jc.v.astype(jax.numpy.bfloat16),
                          length=jc.length)
    tc = tdec.DecodeCache(k=tc.k.to(torch.bfloat16), v=tc.v.to(torch.bfloat16),
                          length=tc.length)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jc, jl = jdec.decode_step_ragged(params, jcfg, jc, tok)
        tc, tl = tdec.decode_step_ragged(tree, tcfg, tc, torch.tensor(tok))
        assert tc.k.dtype == torch.bfloat16 and tl.dtype == torch.float32
        _close(tl, jl, BF16_TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_later_items_raise(lm):
    """The calls of items 5b, 5c and 5e now run: the int8 pool (5e) is a
    QuantKV of codes and one scale per head vector."""
    _, _, tcfg, _, tree = lm
    tok = torch.tensor([[3, 4, 5]])
    cache = tdec.init_cache(tcfg, 1, 8)
    cache = tdec.DecodeCache(cache.k, cache.v, torch.tensor([2]))
    assert tdec.verify_step_ragged(tree, tcfg, cache, tok)[1].shape == (1, 3, 96)
    k, v = tdec.init_paged_pool(tcfg, 4, 4)
    table = torch.tensor([[0, 1]])
    assert tdec.verify_step_paged(tree, tcfg, k, v, table, torch.tensor([2]), tok)[2].shape \
        == (1, 3, 96)
    assert tdec.truncate_draft_params(tree, tcfg, 1)[1].num_layers == 1
    ids = np.ones((1, 4), np.int32)
    _, _, logits = tdec.prefill_paged(tree, tcfg, ids, [4], k, v, [[2]], start_lens=[4],
                                      read_tables=[[0]])
    _, _, cow = tdec.prefill_paged_cow(tree, tcfg, ids, [4], [4], [4], k, v, [[0]], [[0, 2]])
    assert torch.equal(logits, cow)
    qk, qv = tdec.init_paged_pool(tcfg, 4, 4, cache_dtype=torch.int8)
    assert qk.q.dtype == torch.int8 and qk.q.shape == k.shape
    assert qv.scale.dtype == torch.float32 and qv.scale.shape == k.shape[:-1]
    with pytest.raises(ValueError, match="paged pool layout"):  # JAX's refusal
        tdec.init_cache(tcfg, 2, 8, cache_dtype=torch.int8)
