"""The port's speculative and prefix-sharing decode steps against JAX's.

JAX's tiny LM carried into the port, the same numpy inputs on both sides
(the pattern of ``tests/test_torch_gpt_decode.py``):

- ``verify_step_ragged`` and ``verify_step_paged`` (five positions a row,
  k = 4): logits within 1e-5 of JAX's and of a loop of
  ``decode_step_ragged`` / ``decode_step_paged``; the cache and pool after
  the call equal JAX's within 1e-5, with the writes JAX drops dropped here
  too: positions past ``max_len`` (a row at ``max_len - 1``), past the
  write ``limit``, and a masked row's; a query past its limit reads the
  sentinel pages as JAX's clamped gather does;
- ``prefill_paged``'s suffix mode (page-aligned prefixes) and
  ``prefill_paged_cow`` (aligned and sub-page boundaries, ``write_starts``
  dropping the redundant writes of a fully shared prompt): logits and pool
  within 1e-5 of JAX's, and the logits within 1e-5 of a prefill of the
  whole prompt;
- ``truncate_draft_params``: the draft's leaves are the target's tensors.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec

jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jdec = importlib.import_module("gradaccum_tpu.models.gpt_decode")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NB, PAGE, HD = 8, 4, 16  # real blocks, page size, head dim of the tiny LM


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    params = jgpt.gpt_lm_bundle(jcfg).init(jax.random.PRNGKey(0),
                                           {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, tcfg, params_tree(model)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=msg, **TOL)


def _pools(seed):
    """A random pool of NB real blocks: JAX's arrays and the port's (its
    trash block appended, zeros)."""
    rng = np.random.default_rng(seed)
    shape = (2, NB, 2, PAGE, HD)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    pad = np.zeros((2, 1, 2, PAGE, HD), np.float32)
    return ((jax.numpy.asarray(k), jax.numpy.asarray(v)),
            (torch.tensor(np.concatenate([k, pad], 1)), torch.tensor(np.concatenate([v, pad], 1))))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.int64)


# -- verify steps ---------------------------------------------------------------


def test_verify_step_ragged_matches_jax_and_a_decode_loop(lm):
    jcfg, params, tcfg, tree = lm
    rng = np.random.default_rng(1)
    max_len, n = 12, 5  # k = 4 drafts and the current token
    k = rng.normal(size=(2, 4, 2, max_len, HD)).astype(np.float32)
    v = rng.normal(size=(2, 4, 2, max_len, HD)).astype(np.float32)
    # row 1 at max_len - 1: one write lands, four are dropped; row 3 masked
    lengths = np.array([3, max_len - 1, 6, 5], np.int32)
    active = np.array([True, True, True, False])
    tokens = rng.integers(0, 96, (4, n)).astype(np.int32)
    jc, jl = jdec.verify_step_ragged(
        params, jcfg, jdec.DecodeCache(jax.numpy.asarray(k), jax.numpy.asarray(v), lengths),
        tokens, active)
    tc, tl = tdec.verify_step_ragged(
        tree, tcfg, tdec.DecodeCache(torch.tensor(k), torch.tensor(v), _t(lengths)),
        torch.tensor(tokens), torch.tensor(active))
    assert tuple(tl.shape) == (4, n, 96)
    _close(tl, jl)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert tc.length.tolist() == lengths.tolist()  # the caller advances
    np.testing.assert_array_equal(tc.k[:, 3].numpy(), k[:, 3])  # the masked row
    np.testing.assert_array_equal(tc.k[:, 1, :, :max_len - 1].numpy(), k[:, 1, :, :max_len - 1])
    # a loop of single steps gives the same logits at every position inside
    # the cache, and the same cache
    loop = tdec.DecodeCache(torch.tensor(k), torch.tensor(v), _t(lengths))
    for j in range(n):
        loop, step_logits = tdec.decode_step_ragged(tree, tcfg, loop, torch.tensor(tokens[:, j]),
                                                    torch.tensor(active))
        inside = (lengths + j < max_len) & active
        _close(tl[inside, j], step_logits[inside].numpy(), msg=f"column {j}")
    _close(tc.k, loop.k.numpy())
    _close(tc.v, loop.v.numpy())


def test_verify_step_paged_matches_jax_and_a_decode_loop(lm):
    jcfg, params, tcfg, tree = lm
    (jk, jv), (tk, tv) = _pools(2)
    n = 5
    table = np.array([[0, 3, 6, NB], [1, 2, 5, NB], [4, 7, NB, NB]], np.int32)
    lengths = np.array([6, 9, 4], np.int32)
    limit = np.array([10, 11, 8], np.int32)  # rows 0 and 1 stop at their limits mid-run
    active = np.array([True, True, True])
    tokens = np.random.default_rng(3).integers(0, 96, (3, n)).astype(np.int32)
    k0, v0 = tk.clone(), tv.clone()
    jk, jv, jl = jdec.verify_step_paged(params, jcfg, jk, jv, table, lengths, tokens, active,
                                        limit)
    tk, tv, tl = tdec.verify_step_paged(tree, tcfg, tk, tv, _t(table), _t(lengths),
                                        torch.tensor(tokens), torch.tensor(active), _t(limit))
    _close(tk[:, :NB], jk)
    _close(tv[:, :NB], jv)
    # a query past its limit reads sentinel pages: the last real block, as
    # JAX's clamped gather reads it
    _close(tl, jl)
    emitted = lengths[:, None] + np.arange(n)[None, :] < limit[:, None]
    lk, lv, llen = k0, v0, _t(lengths)
    for j in range(n):
        lk, lv, llen, step_logits = tdec.decode_step_paged(
            tree, tcfg, lk, lv, _t(table), llen, torch.tensor(tokens[:, j]),
            torch.tensor(active), _t(limit))
        _close(tl[emitted[:, j], j], step_logits[emitted[:, j]].numpy(), msg=f"column {j}")
    _close(tk[:, :NB], lk[:, :NB].numpy())
    _close(tv[:, :NB], lv[:, :NB].numpy())


# -- suffix prefill ---------------------------------------------------------------


def _shared_setup(lm, seed):
    """Two prompts' prefixes written into the pool by a plain paged prefill
    (JAX's and the port's): row 0's prompt 14 tokens in blocks 0-3, row 1's
    9 in blocks 4-6."""
    jcfg, params, tcfg, tree = lm
    (jk, jv), (tk, tv) = _pools(seed)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 96, 14).astype(np.int32), rng.integers(0, 96, 9).astype(np.int32)]
    ids = np.zeros((2, 16), np.int32)
    for i, p in enumerate(prompts):
        ids[i, 16 - p.size:] = p
    lens = np.array([p.size for p in prompts], np.int32)
    rows = np.array([[0, 1, 2, 3], [4, 5, 6, NB]], np.int32)
    jk, jv, _ = jdec.prefill_paged(params, jcfg, ids, lens, jk, jv, rows)
    tk, tv, _ = tdec.prefill_paged(tree, tcfg, ids, _t(lens), tk, tv, _t(rows))
    _close(tk[:, :NB], jk)
    return prompts, (jk, jv), (tk, tv)


def _full_logits(lm, prompt):
    _, _, tcfg, tree = lm
    return tdec.prefill(tree, tcfg, prompt[None], prompt.size)[1][0]


def _left_pad(tails, s0):
    ids = np.zeros((len(tails), s0), np.int32)
    for i, t in enumerate(tails):
        ids[i, s0 - t.size:] = t
    return ids, np.array([t.size for t in tails], np.int32)


def test_suffix_prefill_matches_jax(lm):
    """Page-aligned shared prefixes (8 and 4 tokens): the tails prefill
    against the pooled prefix and write their own pages only."""
    jcfg, params, tcfg, tree = lm
    prompts, (jk, jv), (tk, tv) = _shared_setup(lm, 4)
    rng = np.random.default_rng(5)
    full = [np.concatenate([prompts[0][:8], rng.integers(0, 96, 5).astype(np.int32)]),
            np.concatenate([prompts[1][:4], rng.integers(0, 96, 6).astype(np.int32)])]
    starts = np.array([8, 4], np.int32)
    ids, lens = _left_pad([f[s:] for f, s in zip(full, starts)], 8)
    read = np.array([[0, 1], [4, NB]], np.int32)  # the rows' leading page-table entries
    rows = np.array([[7, NB], [3, 2]], np.int32)  # each tail's own pages
    k0 = tk.clone()
    jk, jv, jl = jdec.prefill_paged(params, jcfg, ids, lens, jk, jv, rows, start_lens=starts,
                                    read_tables=read)
    tk, tv, tl = tdec.prefill_paged(tree, tcfg, ids, _t(lens), tk, tv, _t(rows),
                                    start_lens=_t(starts), read_tables=_t(read))
    _close(tl, jl)
    _close(tk[:, :NB], jk)
    _close(tv[:, :NB], jv)
    for i, f in enumerate(full):
        _close(tl[i], _full_logits(lm, f).numpy(), msg=f"row {i} against its whole prompt")
    # the shared pages were only read
    np.testing.assert_array_equal(tk[:, [0, 1, 4]].numpy(), k0[:, [0, 1, 4]].numpy())
    with pytest.raises(ValueError, match="read_tables"):
        tdec.prefill_paged(tree, tcfg, ids, _t(lens), tk, tv, _t(rows), start_lens=_t(starts))


def test_prefill_paged_cow_matches_jax(lm):
    """Three rows: a sub-page boundary (6 of 14 shared, the forked tail
    block 7 holding a copy of block 1), an aligned one (4 shared), and a
    fully shared prompt (9 of 9: its last token recomputes for the logits
    with the write dropped)."""
    jcfg, params, tcfg, tree = lm
    prompts, (jk, jv), (tk, tv) = _shared_setup(lm, 6)
    rng = np.random.default_rng(7)
    full = [np.concatenate([prompts[0][:6], rng.integers(0, 96, 5).astype(np.int32)]),
            np.concatenate([prompts[0][:4], rng.integers(0, 96, 3).astype(np.int32)]),
            prompts[1]]
    jk = jk.at[:, 7].set(jk[:, 1])  # the engine's fork copy
    tk[:, 7] = tk[:, 1]
    jv = jv.at[:, 7].set(jv[:, 1])
    tv[:, 7] = tv[:, 1]
    shared = np.array([6, 4, 9], np.int32)
    starts = np.minimum(shared, [f.size - 1 for f in full]).astype(np.int32)
    ids, lens = _left_pad([f[s:] for f, s in zip(full, starts)], 8)
    write = np.array([[0, 7, 3, NB], [0, 2, NB, NB], [4, 5, 6, NB]], np.int32)
    read = write[:, :4]
    before = tk.clone()
    jk, jv, jl = jdec.prefill_paged_cow(params, jcfg, ids, lens, starts, shared, jk, jv, read,
                                        write)
    tk, tv, tl = tdec.prefill_paged_cow(tree, tcfg, ids, _t(lens), _t(starts), _t(shared), tk,
                                        tv, _t(read), _t(write))
    _close(tl, jl)
    _close(tk[:, :NB], jk)
    _close(tv[:, :NB], jv)
    for i, f in enumerate(full):
        _close(tl[i], _full_logits(lm, f).numpy(), msg=f"row {i} against its whole prompt")
    # the fully shared row stored nothing, and block 7 kept the copied head
    np.testing.assert_array_equal(tk[:, 4:7].numpy(), before[:, 4:7].numpy())
    np.testing.assert_array_equal(tk[:, 7, :, :2].numpy(), before[:, 7, :, :2].numpy())


def test_truncate_draft_params_shares_the_targets_tensors(lm):
    jcfg, params, tcfg, tree = lm
    draft, dcfg = tdec.truncate_draft_params(tree, tcfg, 1)
    jdraft, jdcfg = jdec.truncate_draft_params(params, jcfg, 1)
    assert dcfg.num_layers == jdcfg.num_layers == 1 and dcfg.vocab_size == tcfg.vocab_size
    assert sorted(draft["params"]) == sorted(jdraft["params"])
    for name in draft["params"]:
        a = jax.tree_util.tree_leaves(draft["params"][name])
        b = jax.tree_util.tree_leaves(tree["params"][name])
        assert all(x.data_ptr() == y.data_ptr() for x, y in zip(a, b)), name
    for bad in (0, 3):
        with pytest.raises(ValueError, match=r"draft num_layers must be in \[1, 2\]"):
            tdec.truncate_draft_params(tree, tcfg, bad)
