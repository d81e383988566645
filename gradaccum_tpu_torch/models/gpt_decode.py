"""KV-cache autoregressive decoding for GPT, for the port.

The port of ``gradaccum_tpu/models/gpt_decode.py``. :func:`prefill` runs
the prompt once and keeps every layer's key/value projections in a cache
allocated at ``max_len``; each decode step projects only the newest token
and attends against the cache. Two cache layouts, as in JAX:

- the fixed layout ``[num_layers, B, H, max_len, head_dim]`` (a
  :class:`DecodeCache`; the serving engine reads its batch axis as slots);
- the paged pool ``[num_layers, num_blocks + 1, H, page_size, head_dim]``
  addressed through per-slot page tables of block ids
  (:func:`init_paged_pool`, :func:`decode_step_paged`,
  :func:`prefill_paged`).

The functions read the parameter tree JAX's decode reads,
``params["params"]["layer_i"]["attention"]["query"]["kernel"]`` and so on,
kernels ``[in, out]``: ``interop.py :: params_tree`` builds it from the
port's ``GPTLM`` as views of the module's own tensors, so training hands
over to decoding without a copy.

**In place.** JAX donates the cache and pool buffers; here every step and
every prefill into a pool writes its K/V into the tensors it was given
(``index_put_``) and returns them, and nothing copies ``[L, slots, H, T,
hd]`` or ``[L, blocks, H, page, hd]`` per step. Callers that need the old
contents clone first.

**Out-of-range indices.** JAX's gathers clamp an index past the end and
its scatters drop it; the page tables' sentinel ``num_blocks`` relies on
both. Torch raises instead, so the semantics are made explicit:

- the paged pool holds one more block than its ``num_blocks``, the
  *trash block* at index ``num_blocks``. A dropped write (a masked slot, a
  position past its write limit, a sentinel page) lands there. A read
  through a sentinel page reads the last real block, as JAX's clamped
  gather does: mostly at virtual positions the attention mask removes, but
  a verify query past its slot's write limit sees them, and its logits
  (never emitted) then equal JAX's too. Sizes reported to users
  (``memory_stats``, ``kv_pool_bytes``) stay JAX's, ``num_blocks`` blocks.
- the fixed cache drops a masked write by writing back the value already
  held where it lands: a single-position step clamps the position to the
  last one, and a multi-position verify step moves a position past the
  end ``n`` places down, below the row's first write (each row writes
  only its own slot and its targets stay distinct, so no two writes
  meet).
- positions past the position table clamp to its last row, as JAX's
  gather does; only tokens the caller discards are computed there.

Sampling is :func:`sample_token`, JAX's rule with JAX's random numbers
(``utils/prng.py``): a request's tokens depend on its seed and the token
index, never on its slot or batch.

**Speculative decoding** (:func:`truncate_draft_params`,
:func:`verify_step_ragged`, :func:`verify_step_paged`) scores a row's next
``n`` tokens in one multi-position step. **Prefix sharing**
(:func:`prefill_paged`'s suffix mode, :func:`prefill_paged_cow`) prefills
only the unshared tail of a prompt against the shared prefix's K/V read
from the pool. Both are torch ops, as JAX's are XLA: no flash kernel runs
on the decode path.

**int8 pools** (``cache_dtype=torch.int8``, paged only): the pool is a
:class:`~gradaccum_tpu_torch.memory.quant.QuantKV`, int8 codes and one
float32 scale per (position, head) vector. A write quantizes and scatters
codes and scales at the same indices; a read gathers the pages and
dequantizes them to the compute dtype. Block moves map over both leaves.

**Tensor parallelism** (``mesh=``, the model axis of a serving mesh, one
process per rank): ``params`` is then this rank's block of the tree under
``parallel/tp.py :: gpt_tp_rules`` and every cache holds this rank's
``num_heads / tp`` heads (``init_cache``/``init_paged_pool`` with ``tp=``).
QKV and the FFN's intermediate are column-parallel, so each rank runs its
own heads; the attention output and the FFN output are row-parallel, each
followed by ``tp.reduce_from`` and then its bias, added once; the lookup is
``tp.vocab_parallel_embed``, and the tied head's logits are gathered whole
with ``tp.gather_slices``, so every rank holds the same logits bit for bit
and samples the same token from its request's stream. A micro-step issues
``2 * num_layers + 2`` collectives. The head dimension always comes from
the whole config (``hidden_size / num_heads``); the local head count from
the tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from gradaccum_tpu_torch.memory.quant import (
    QuantKV,
    is_quantized_kv,
    kv_dequantize,
    kv_map,
    kv_quantize,
)
from gradaccum_tpu_torch.models.gpt import GPTConfig
from gradaccum_tpu_torch.parallel import tp as tp_lib
from gradaccum_tpu_torch.utils import prng


def _is_int8(cache_dtype) -> bool:
    return cache_dtype is not None and cache_dtype == torch.int8


class DecodeCache(NamedTuple):
    """Per-layer keys and values ``[num_layers, B, H, max_len, head_dim]``
    and the positions filled: a Python int for a dense batch, a ``[B]``
    int64 tensor for a ragged one."""

    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, torch.Tensor]


def _param_device(params) -> torch.device:
    return params["params"]["word_embeddings"]["embedding"].device


def _dense(p, x):
    """``x @ kernel + bias`` in the promoted dtype, one ``addmm``."""
    kernel = p["kernel"]
    dt = torch.promote_types(x.dtype, kernel.dtype)
    lead = x.shape[:-1]
    y = torch.addmm(p["bias"].to(dt), x.reshape(-1, x.shape[-1]).to(dt), kernel.to(dt))
    return y.view(*lead, y.shape[-1])


def _row_dense(p, x, mesh):
    """A row-parallel ``x @ kernel + bias``: this rank's part of the
    product, summed over the model axis, then the (replicated) bias once."""
    if mesh is None:
        return _dense(p, x)
    kernel = p["kernel"]
    dt = torch.promote_types(x.dtype, kernel.dtype)
    lead = x.shape[:-1]
    y = torch.mm(x.reshape(-1, x.shape[-1]).to(dt), kernel.to(dt))
    y = tp_lib.reduce_from(y, mesh) + p["bias"].to(dt)
    return y.view(*lead, y.shape[-1])


def _head_dim(cfg: GPTConfig) -> int:
    """The head dimension of the WHOLE model: a rank holds fewer heads of
    the same width."""
    return cfg.hidden_size // cfg.num_heads


def _local_heads(cfg: GPTConfig, tp: int) -> int:
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} is not divisible by tp={tp}")
    return cfg.num_heads // tp


def _layer_norm(p, x, eps):
    dt = torch.promote_types(x.dtype, p["scale"].dtype)
    return F.layer_norm(x.to(dt), x.shape[-1:], p["scale"].to(dt), p["bias"].to(dt), eps)


def _split_heads(t, head_dim):
    b, s, d = t.shape
    return t.view(b, s, d // head_dim, head_dim).transpose(1, 2)


def _merge_heads(t):
    b, h, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, h * hd)


def _attend(q, k, v, pos_mask):
    """q ``[B, H, Sq, hd]``, k/v ``[B, H, T, hd]``, ``pos_mask`` additive
    and broadcastable to ``[B, H, Sq, T]``."""
    # a tensor divisor (filled on the device, no host copy): CUDA divides by
    # a Python scalar as a multiply by its reciprocal, JAX divides
    depth = torch.full((), math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)
    scores = torch.div(torch.matmul(q, k.transpose(-1, -2)), depth) + pos_mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _block(cfg: GPTConfig, lp, x, attend_fn, mesh=None):
    """One decoder block (pre-LN, ``models/gpt.py``), dropout off; under a
    ``mesh``, this rank's heads and FFN columns, the two row-parallel
    outputs summed over it."""
    hd = _head_dim(cfg)
    h = _layer_norm(lp["attention_LayerNorm"], x, cfg.layer_norm_eps)
    ap = lp["attention"]
    q = _split_heads(_dense(ap["query"], h), hd)
    k = _split_heads(_dense(ap["key"], h), hd)
    v = _split_heads(_dense(ap["value"], h), hd)
    ctx, cache_kv = attend_fn(q, k, v)
    x = x + _row_dense(ap["output"], _merge_heads(ctx), mesh)
    h = _layer_norm(lp["mlp_LayerNorm"], x, cfg.layer_norm_eps)
    h = F.gelu(_dense(lp["intermediate"], h), approximate="tanh")
    return x + _row_dense(lp["ffn_output"], h, mesh), cache_kv


def _embed(params, cfg: GPTConfig, ids, positions, mesh=None):
    p = params["params"]
    positions = positions.clamp(0, cfg.max_position_embeddings - 1)  # JAX's gather clamps
    table = p["word_embeddings"]["embedding"]
    if mesh is None:
        tok = F.embedding(ids, table)
    else:
        tok = tp_lib.vocab_parallel_embed(ids, table, mesh)
    pos = F.embedding(positions, p["position_embeddings"]["embedding"])
    return (tok + pos).to(cfg.dtype)


def _lm_head(params, cfg: GPTConfig, x, mesh=None):
    """Float32 logits of the tied head; under a ``mesh``, this rank's vocab
    slice gathered whole (once per call, however many rows)."""
    p = params["params"]
    x = _layer_norm(p["final_LayerNorm"], x, cfg.layer_norm_eps)
    logits = torch.matmul(x.float(), p["word_embeddings"]["embedding"].float().t())
    if mesh is None:
        return logits
    return tp_lib.gather_slices(logits, mesh, dim=-1)


def _mask_value(visible, dtype):
    """0 where visible, -1e9 elsewhere, in ``dtype``."""
    return ((~visible).to(dtype) * -1e9).to(dtype)


def _ragged_self_mask(cfg: GPTConfig, s0: int, pad):
    """Additive mask of a left-padded ragged batch: query i sees key j iff
    j <= i and j is a real column. ``[B, 1, S0, S0]``."""
    ar = torch.arange(s0, device=pad.device)
    causal = ar[None, :] <= ar[:, None]
    real = ar[None, :] >= pad[:, None]
    visible = causal[None] & real[:, None, :]
    return _mask_value(visible, cfg.dtype)[:, None]


def _compact_ragged(k_stack, v_stack, pad, lengths, out_len: int):
    """Shift row b's real positions of ``[L, B, H, S0, hd]`` to
    ``[0, lengths[b])`` of an ``out_len`` axis, zeros after."""
    num_layers, b, h, s0, hd = k_stack.shape
    ar = torch.arange(out_len, device=pad.device)
    idx = (ar[None, :] + pad[:, None]).clamp(0, s0 - 1)
    keep = (ar[None, :] < lengths[:, None])[None, :, None, :, None]
    idx5 = idx[None, :, None, :, None].expand(num_layers, b, h, out_len, hd)
    zero = torch.zeros((), dtype=k_stack.dtype, device=k_stack.device)
    k_stack = torch.where(keep, torch.gather(k_stack, 3, idx5), zero)
    v_stack = torch.where(keep, torch.gather(v_stack, 3, idx5), zero)
    return k_stack, v_stack


def init_cache(cfg: GPTConfig, batch: int, max_len: int, cache_dtype=None,
               device=None, tp: int = 1) -> DecodeCache:
    """A zeroed fixed cache. ``cache_dtype`` (``torch.bfloat16``) stores
    K/V narrower than the compute dtype: reads upcast at the attention,
    writes downcast. ``tp``: one rank's cache of a model axis that wide,
    ``num_heads / tp`` heads."""
    if max_len > cfg.max_position_embeddings:
        raise ValueError(f"max_len {max_len} exceeds max_position_embeddings "
                         f"{cfg.max_position_embeddings}")
    if _is_int8(cache_dtype):
        raise ValueError(
            "cache_dtype=int8 needs per-vector quantization scales, which only "
            "the paged pool layout carries (init_paged_pool); the fixed-slot "
            "cache stores raw dtypes only")
    shape = (cfg.num_layers, batch, _local_heads(cfg, tp), max_len, _head_dim(cfg))
    dtype = cfg.dtype if cache_dtype is None else cache_dtype
    return DecodeCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def truncate_draft_params(params, cfg: GPTConfig, num_layers: int):
    """A draft model carved from the target's own weights: its first
    ``num_layers`` blocks with the (tied) embeddings and the final
    LayerNorm. Returns ``(draft_params, draft_cfg)`` for
    ``Engine(speculate_k=, draft_params=, draft_cfg=)``; the leaves are the
    target's own tensors, not copies."""
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(f"draft num_layers must be in [1, {cfg.num_layers}], "
                         f"got {num_layers}")
    p = params["params"]
    keep = {name: leaf for name, leaf in p.items() if not name.startswith("layer_")}
    for i in range(num_layers):
        keep[f"layer_{i}"] = p[f"layer_{i}"]
    return {"params": keep}, dataclasses.replace(cfg, num_layers=num_layers)


def _as_ids(ids, device):
    ids = torch.as_tensor(ids, device=device)
    return ids.to(torch.int64)


def prefill(params, cfg: GPTConfig, prompt_ids, max_len: int, lengths=None, mesh=None):
    """Run the prompt once and fill a fresh cache of ``max_len``. Returns
    ``(cache, last_logits [B, vocab])``.

    ``lengths`` (``[B]``, each in ``[1, S0]``) makes the batch ragged: row b
    is left-padded, its real tokens in the last ``lengths[b]`` columns; the
    pad is masked and positioned away, and row b's K/V are compacted to
    positions ``[0, lengths[b])``, so ``cache.length`` is ``[B]`` and
    decoding goes on with :func:`decode_step_ragged`. ``mesh``: the model
    axis ``params`` is this rank's block of (module docstring)."""
    device = _param_device(params)
    ids = _as_ids(prompt_ids, device)
    b, s0 = ids.shape
    if s0 > max_len:
        raise ValueError(f"prompt length {s0} exceeds max_len {max_len}: the KV cache "
                         "is allocated at max_len, so the prompt cannot fit")
    ragged = lengths is not None
    ar = torch.arange(s0, device=device)
    if ragged:
        lengths = torch.as_tensor(lengths, device=device).to(torch.int64)
        if tuple(lengths.shape) != (b,):
            raise ValueError(f"lengths must be [batch]={b}, got {tuple(lengths.shape)}")
        if bool(((lengths < 1) | (lengths > s0)).any()):
            raise ValueError(f"lengths must be in [1, S0={s0}] per row, got "
                             f"{lengths.tolist()}")
        pad = s0 - lengths
        positions = (ar[None, :] - pad[:, None]).clamp(min=0)
        pos_mask = _ragged_self_mask(cfg, s0, pad)
    else:
        positions = ar[None, :].expand(b, s0)
        pos_mask = _mask_value(ar[None, :] <= ar[:, None], cfg.dtype)[None, None]
    x = _embed(params, cfg, ids, positions, mesh)

    ks, vs = [], []

    def attend_full(q, k, v):
        return _attend(q, k, v, pos_mask), (k, v)

    p = params["params"]
    for i in range(cfg.num_layers):
        x, (k, v) = _block(cfg, p[f"layer_{i}"], x, attend_full, mesh)
        ks.append(k)
        vs.append(v)

    k_stack, v_stack = torch.stack(ks), torch.stack(vs)  # [L, B, H, S0, hd]
    if ragged:
        k_stack, v_stack = _compact_ragged(k_stack, v_stack, pad, lengths, max_len)
        length = lengths
    else:
        k_stack = F.pad(k_stack, (0, 0, 0, max_len - s0))
        v_stack = F.pad(v_stack, (0, 0, 0, max_len - s0))
        length = s0
    logits = _lm_head(params, cfg, x[:, -1:, :], mesh)[:, 0]
    return DecodeCache(k=k_stack, v=v_stack, length=length), logits


def decode_step(params, cfg: GPTConfig, cache: DecodeCache, token):
    """One cached step of a dense batch: ``token`` ``[B]`` at position
    ``cache.length`` (an int). Writes into ``cache.k``/``cache.v`` and
    returns ``(cache, logits [B, vocab])``."""
    pos = int(cache.length)
    token = torch.as_tensor(token, device=cache.k.device).to(torch.int64)
    b = token.shape[0]
    max_len = cache.k.shape[3]
    x = _embed(params, cfg, token[:, None],
               torch.full((b, 1), pos, dtype=torch.int64, device=token.device))
    visible = torch.arange(max_len, device=token.device) <= pos
    pos_mask = _mask_value(visible, cfg.dtype)[None, None, None, :]
    p = params["params"]
    new_k, new_v = cache.k, cache.v

    for i in range(cfg.num_layers):

        def attend_cached(q, k, v, i=i):
            new_k[i, :, :, pos] = k[:, :, 0].to(new_k.dtype)
            new_v[i, :, :, pos] = v[:, :, 0].to(new_v.dtype)
            return _attend(q, new_k[i].to(q.dtype), new_v[i].to(q.dtype), pos_mask), None

        x, _ = _block(cfg, p[f"layer_{i}"], x, attend_cached)

    logits = _lm_head(params, cfg, x)[:, 0]
    return DecodeCache(k=new_k, v=new_v, length=pos + 1), logits


def decode_step_ragged(params, cfg: GPTConfig, cache: DecodeCache, token, active=None,
                       mesh=None):
    """A cached step with per-row positions (``cache.length`` ``[B]``): row
    b's token is written at ``length[b]``. Rows where ``active`` is False,
    and rows whose position has reached ``max_len``, are computed but
    neither written nor advanced (the engine steps every slot and masks the
    empty ones). Writes in place; returns ``(cache, logits [B, vocab])``."""
    pos = cache.length
    device = cache.k.device
    token = torch.as_tensor(token, device=device).to(torch.int64)
    b = token.shape[0]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=device)
    max_len, num_heads = cache.k.shape[3], cache.k.shape[2]
    x = _embed(params, cfg, token[:, None], pos[:, None], mesh)
    visible = torch.arange(max_len, device=device)[None, :] <= pos[:, None]
    pos_mask = _mask_value(visible, cfg.dtype)[:, None, None, :]
    # a dropped write puts back the value the row already holds there
    writable = (active & (pos < max_len))[:, None, None]
    wpos = pos.clamp(max=max_len - 1)[:, None]
    bidx = torch.arange(b, device=device)[:, None]
    hidx = torch.arange(num_heads, device=device)[None]
    p = params["params"]
    new_k, new_v = cache.k, cache.v

    for i in range(cfg.num_layers):

        def attend_cached(q, k, v, i=i):
            for pool, val in ((new_k, k), (new_v, v)):
                old = pool[i, bidx, hidx, wpos]
                pool[i, bidx, hidx, wpos] = torch.where(writable, val[:, :, 0].to(pool.dtype),
                                                        old)
            return _attend(q, new_k[i].to(q.dtype), new_v[i].to(q.dtype), pos_mask), None

        x, _ = _block(cfg, p[f"layer_{i}"], x, attend_cached, mesh)

    logits = _lm_head(params, cfg, x, mesh)[:, 0]
    new_len = torch.where(active, pos + 1, pos)
    return DecodeCache(k=new_k, v=new_v, length=new_len), logits


def verify_step_ragged(params, cfg: GPTConfig, cache: DecodeCache, tokens, active=None,
                       mesh=None):
    """The multi-position cached step of speculative decoding: ``tokens``
    ``[B, n]`` are row b's next ``n`` tokens at positions ``length[b] + j``.
    All ``n`` K/V pairs are written (a masked row's, and positions at or
    past ``max_len``, are dropped) and query j sees the cache up to its own
    position, so the logits equal a loop of ``n`` :func:`decode_step_ragged`
    calls. ``cache.length`` comes back unchanged: the caller advances it by
    its accept count. Writes in place; returns ``(cache, logits [B, n,
    vocab])``."""
    pos = cache.length
    device = cache.k.device
    tokens = torch.as_tensor(tokens, device=device).to(torch.int64)
    b, n = tokens.shape
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=device)
    max_len, num_heads = cache.k.shape[3], cache.k.shape[2]
    positions = pos[:, None] + torch.arange(n, device=device)[None, :]  # [B, n]
    x = _embed(params, cfg, tokens, positions, mesh)
    visible = torch.arange(max_len, device=device)[None, None, :] <= positions[:, :, None]
    pos_mask = _mask_value(visible, cfg.dtype)[:, None]  # [B, 1, n, T]
    # a position past the end writes back, n places down, what is already
    # there: below the row's first write, distinct for distinct j
    inside = positions < max_len
    writable = (active[:, None] & inside)[:, None, :, None]  # [B, 1, n, 1]
    wpos = torch.where(inside, positions, positions - n).clamp(0, max_len - 1)
    bidx = torch.arange(b, device=device)[:, None, None]
    hidx = torch.arange(num_heads, device=device)[None, :, None]
    widx = wpos[:, None, :]  # [B, 1, n]
    p = params["params"]
    new_k, new_v = cache.k, cache.v

    for i in range(cfg.num_layers):

        def attend_cached(q, k, v, i=i):
            for pool, val in ((new_k, k), (new_v, v)):  # val [B, H, n, hd]
                old = pool[i, bidx, hidx, widx]
                pool[i, bidx, hidx, widx] = torch.where(writable, val.to(pool.dtype), old)
            return _attend(q, new_k[i].to(q.dtype), new_v[i].to(q.dtype), pos_mask), None

        x, _ = _block(cfg, p[f"layer_{i}"], x, attend_cached, mesh)

    logits = _lm_head(params, cfg, x, mesh)  # [B, n, V]
    return DecodeCache(k=new_k, v=new_v, length=pos), logits


# -- the paged pool -----------------------------------------------------------


def init_paged_pool(cfg: GPTConfig, num_blocks: int, page_size: int, cache_dtype=None,
                    device=None, tp: int = 1):
    """The block pool, K and V ``[L, num_blocks + 1, H, page_size, hd]``:
    blocks ``0..num_blocks-1`` are real, block ``num_blocks`` is the trash
    block that page-table sentinels address (dropped writes land there,
    reads through it are masked). ``cache_dtype=torch.int8`` gives
    :class:`QuantKV` pools. ``tp``: one rank's pool of a model axis that
    wide, ``H = num_heads / tp`` heads of every block."""
    if num_blocks < 1:
        raise ValueError(f"need at least one block, got {num_blocks}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    shape = (cfg.num_layers, num_blocks + 1, _local_heads(cfg, tp), page_size, _head_dim(cfg))
    if _is_int8(cache_dtype):
        # codes [L, blocks + 1, H, page, hd] and scales one rank lower
        def zeros():
            return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                           torch.zeros(shape[:-1], dtype=torch.float32, device=device))

        return zeros(), zeros()
    dtype = cfg.dtype if cache_dtype is None else cache_dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def pool_blocks(pool) -> int:
    """The pool's real block count, ``num_blocks`` (the trash block apart)."""
    return pool.shape[1] - 1


def _trash_ids(ids, num_blocks: int):
    """Block ids with everything outside ``[0, num_blocks)`` sent to the
    trash block: JAX drops those writes."""
    return torch.where((ids < 0) | (ids >= num_blocks),
                       torch.full_like(ids, num_blocks), ids)


def _pool_write(pool, idx, values):
    """Scatter ``values`` into ``pool`` at the index tuple ``idx``, in place,
    downcast to the pool's dtype. A quantized pool takes the codes and the
    scales at the same indices (the scale array is one rank lower, so the
    same tuple addresses it)."""
    if is_quantized_kv(pool):
        q, scale = kv_quantize(values)
        pool.q[idx] = q
        pool.scale[idx] = scale
        return pool
    pool[idx] = values.to(pool.dtype)
    return pool


def _read_table(page_table, num_blocks: int):
    """Block ids for reading: the sentinel clamps to the last real block,
    as JAX's gather clamps it."""
    return page_table.clamp(max=num_blocks - 1)


def _virt_view(pool, i, page_table, kv_shape, dtype):
    """Layer ``i``'s pages gathered through ``page_table`` (a
    :func:`_read_table`) into the virtual ``[B, H, max_pages * page_size,
    hd]`` view, upcast (a quantized pool: dequantized) to ``dtype``."""
    if is_quantized_kv(pool):
        q = pool.q[i][page_table].permute(0, 2, 1, 3, 4).reshape(kv_shape)
        scale = pool.scale[i][page_table].permute(0, 2, 1, 3).reshape(kv_shape[:-1])
        return kv_dequantize(q, scale, dtype)
    return pool[i][page_table].permute(0, 2, 1, 3, 4).reshape(kv_shape).to(dtype)


def gather_blocks(pool_k, pool_v, block_ids):
    """Whole blocks out of the pool: ``(k, v)`` each ``[L, n, H, page, hd]``.
    Ids past the last real block clamp to it, as JAX's gather does (the
    caller drops those rows). A quantized pool gives :class:`QuantKV`
    blocks."""
    ids = torch.as_tensor(block_ids, device=pool_k.device).to(torch.int64)
    ids = ids.clamp(0, pool_blocks(pool_k) - 1)

    def take(a):
        return a[:, ids]

    return kv_map(take, pool_k), kv_map(take, pool_v)


def scatter_blocks(pool_k, pool_v, block_ids, k_blocks, v_blocks):
    """Write ``n`` whole blocks into the pool at ``block_ids``, in place; ids
    outside ``[0, num_blocks)`` (the sentinel padding) write nothing real.
    Blocks of a quantized pool are :class:`QuantKV` and land leaf by leaf,
    as they are (no second quantization). Returns ``(pool_k, pool_v)``."""
    ids = torch.as_tensor(block_ids, device=pool_k.device).to(torch.int64)
    ids = _trash_ids(ids, pool_blocks(pool_k))

    def put(pool, blocks):
        pool[:, ids] = torch.as_tensor(blocks, device=pool.device).to(pool.dtype)
        return pool

    kv_map(put, pool_k, k_blocks)
    kv_map(put, pool_v, v_blocks)
    return pool_k, pool_v


def decode_step_paged(params, cfg: GPTConfig, pool_k, pool_v, page_table, lengths, token,
                      active=None, limit=None, mesh=None):
    """One cached step against the paged pool through ``page_table`` ``[B,
    max_pages]``. ``limit`` (``[B]``) is each slot's write budget: positions
    at or past it are neither written nor advanced. Reads gather each slot's
    pages into the virtual view; the mask covers ``[0, length]`` of it.
    Writes in place; returns ``(pool_k, pool_v, new_lengths, logits)``."""
    device = pool_k.device
    token = torch.as_tensor(token, device=device).to(torch.int64)
    b = token.shape[0]
    num_blocks, page_size = pool_blocks(pool_k), pool_k.shape[3]
    max_pages = page_table.shape[1]
    t_virt = max_pages * page_size
    pos = lengths
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=device)
    writable = active if limit is None else active & (pos < limit)
    x = _embed(params, cfg, token[:, None], pos[:, None], mesh)
    visible = torch.arange(t_virt, device=device)[None, :] <= pos[:, None]
    pos_mask = _mask_value(visible, cfg.dtype)[:, None, None, :]
    page = (pos // page_size).clamp(max=max_pages - 1)[:, None]
    blk = torch.gather(page_table, 1, page)
    blk = torch.where(writable[:, None], blk, torch.full_like(blk, num_blocks))
    off = (pos % page_size)[:, None]
    heads = pool_k.shape[2]
    hidx = torch.arange(heads, device=device)[None]
    read = _read_table(page_table, num_blocks)
    p = params["params"]

    for i in range(cfg.num_layers):

        def attend_cached(q, k, v, i=i):
            _pool_write(pool_k, (i, blk, hidx, off), k[:, :, 0, :])
            _pool_write(pool_v, (i, blk, hidx, off), v[:, :, 0, :])
            kv_shape = (b, heads, t_virt, k.shape[-1])
            k_virt = _virt_view(pool_k, i, read, kv_shape, q.dtype)
            v_virt = _virt_view(pool_v, i, read, kv_shape, q.dtype)
            return _attend(q, k_virt, v_virt, pos_mask), None

        x, _ = _block(cfg, p[f"layer_{i}"], x, attend_cached, mesh)

    logits = _lm_head(params, cfg, x, mesh)[:, 0]
    new_len = torch.where(writable, pos + 1, pos)
    return pool_k, pool_v, new_len, logits


def verify_step_paged(params, cfg: GPTConfig, pool_k, pool_v, page_table, lengths, tokens,
                      active=None, limit=None, mesh=None):
    """The paged twin of :func:`verify_step_ragged`: ``n`` positions per slot
    written through the page table and scored in one step. Positions at or
    past a slot's write ``limit``, and a masked slot's, go to the trash
    block. Lengths are the caller's to advance. Writes in place; returns
    ``(pool_k, pool_v, logits [B, n, vocab])``."""
    device = pool_k.device
    tokens = torch.as_tensor(tokens, device=device).to(torch.int64)
    b, n = tokens.shape
    num_blocks, page_size = pool_blocks(pool_k), pool_k.shape[3]
    max_pages = page_table.shape[1]
    t_virt = max_pages * page_size
    pos = lengths
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=device)
    positions = pos[:, None] + torch.arange(n, device=device)[None, :]  # [B, n]
    writable = active[:, None].expand(b, n)
    if limit is not None:
        writable = writable & (positions < limit[:, None])
    x = _embed(params, cfg, tokens, positions, mesh)
    visible = torch.arange(t_virt, device=device)[None, None, :] <= positions[:, :, None]
    pos_mask = _mask_value(visible, cfg.dtype)[:, None]
    page = (positions // page_size).clamp(max=max_pages - 1)
    blk = torch.gather(page_table, 1, page)
    blk = torch.where(writable, blk, torch.full_like(blk, num_blocks))
    heads = pool_k.shape[2]
    idx = (blk[:, None, :], torch.arange(heads, device=device)[None, :, None],
           (positions % page_size)[:, None, :])  # each [B|1, H|1, n]
    read = _read_table(page_table, num_blocks)
    p = params["params"]

    for i in range(cfg.num_layers):

        def attend_cached(q, k, v, i=i):
            _pool_write(pool_k, (i,) + idx, k)  # k/v [B, H, n, hd]
            _pool_write(pool_v, (i,) + idx, v)
            kv_shape = (b, heads, t_virt, k.shape[-1])
            k_virt = _virt_view(pool_k, i, read, kv_shape, q.dtype)
            v_virt = _virt_view(pool_v, i, read, kv_shape, q.dtype)
            return _attend(q, k_virt, v_virt, pos_mask), None

        x, _ = _block(cfg, p[f"layer_{i}"], x, attend_cached, mesh)

    return pool_k, pool_v, _lm_head(params, cfg, x, mesh)


def prefill_paged(params, cfg: GPTConfig, prompt_ids, prompt_lens, pool_k, pool_v,
                  page_rows, start_lens=None, read_tables=None, mesh=None):
    """Ragged batched prefill straight into pool blocks: ``prompt_ids``
    ``[B, S0]`` left-padded, ``prompt_lens`` ``[B]``, ``page_rows`` ``[B,
    ceil(S0 / page_size)]`` each row's block ids for its prompt pages (the
    sentinel ``num_blocks`` past them). The compacted K/V are written page
    by page, in place. Returns ``(pool_k, pool_v, last_logits)``.

    **Suffix mode** (``start_lens`` ``[B]``, each a PAGE-ALIGNED token
    count): row b's prompt begins with ``start_lens[b]`` tokens whose K/V
    already live in the pool (a prefix hit), and ``prompt_ids`` /
    ``prompt_lens`` hold only the unshared tail. The tail runs at positions
    ``start_lens[b] + j`` and attends to the shared prefix read through
    ``read_tables`` ``[B, P]`` (the rows' leading page-table entries,
    masked past each row's prefix) and to itself; ``page_rows`` then name
    the tail's pages only, so the shared pages are never written."""
    device = pool_k.device
    ids = _as_ids(prompt_ids, device)
    page_rows = torch.as_tensor(page_rows, device=device).to(torch.int64)
    b, s0 = ids.shape
    page_size = pool_k.shape[3]
    s0_pages = -(-s0 // page_size)
    if tuple(page_rows.shape) != (b, s0_pages):
        raise ValueError(f"page_rows must be [batch={b}, ceil(S0/page)={s0_pages}], "
                         f"got {tuple(page_rows.shape)}")
    if start_lens is None:
        cache, logits = prefill(params, cfg, ids, s0_pages * page_size, lengths=prompt_lens,
                                mesh=mesh)
        k_stack, v_stack = cache.k, cache.v
    else:
        if read_tables is None:
            raise ValueError("suffix mode needs read_tables (the full page-table rows "
                             "for reading the shared prefix)")
        k_stack, v_stack, logits = _prefill_suffix(params, cfg, ids, prompt_lens, start_lens,
                                                   pool_k, pool_v, read_tables,
                                                   s0_pages * page_size, mesh)
    num_layers, _, heads, _, hd = k_stack.shape

    def to_pages(t):  # [L, B, H, s0p*P, hd] -> [L, B, s0p, H, P, hd]
        return t.view(num_layers, b, heads, s0_pages, page_size, hd).permute(0, 1, 3, 2, 4, 5)

    idx = (slice(None), _trash_ids(page_rows, pool_blocks(pool_k)))
    _pool_write(pool_k, idx, to_pages(k_stack))
    _pool_write(pool_v, idx, to_pages(v_stack))
    return pool_k, pool_v, logits


def prefill_paged_cow(params, cfg: GPTConfig, suffix_ids, suffix_lens, start_lens,
                      write_starts, pool_k, pool_v, read_tables, write_tables, mesh=None):
    """The suffix prefill of copy-on-write sharing: :func:`prefill_paged`'s
    suffix mode for a shared region that need not be page-aligned, with
    per-POSITION writes. ``start_lens`` ``[B]`` is each row's first
    recomputed position; the prefix is masked exactly to it. Positions
    below ``write_starts`` ``[B]`` are not stored (a fully shared prompt
    recomputes its last token for the logits only), nor are pad columns;
    every other position lands at its (block, offset) through
    ``write_tables`` ``[B, max_pages]``, the rows' whole page-table rows,
    so a write mid-page leaves the copied content below it alone. Dropped
    writes go to the trash block. Returns ``(pool_k, pool_v,
    last_logits)``."""
    device = pool_k.device
    ids = _as_ids(suffix_ids, device)
    write_tables = torch.as_tensor(write_tables, device=device).to(torch.int64)
    b, s0 = ids.shape
    num_blocks, page_size = pool_blocks(pool_k), pool_k.shape[3]
    max_pages = write_tables.shape[1]
    out_len = -(-s0 // page_size) * page_size
    k_stack, v_stack, logits = _prefill_suffix(params, cfg, ids, suffix_lens, start_lens,
                                               pool_k, pool_v, read_tables, out_len, mesh)
    start_lens = torch.as_tensor(start_lens, device=device).to(torch.int64)
    write_starts = torch.as_tensor(write_starts, device=device).to(torch.int64)
    suffix_lens = torch.as_tensor(suffix_lens, device=device).to(torch.int64)
    ar = torch.arange(out_len, device=device)
    positions = start_lens[:, None] + ar[None, :]  # [B, T]: tail token j at start + j
    valid = (ar[None, :] < suffix_lens[:, None]) & (positions >= write_starts[:, None])
    page = (positions // page_size).clamp(max=max_pages - 1)
    blk = torch.gather(write_tables, 1, page)
    blk = torch.where(valid, blk, torch.full_like(blk, num_blocks))
    idx = (slice(None), blk[:, None, :],
           torch.arange(k_stack.shape[2], device=device)[None, :, None],
           (positions % page_size)[:, None, :])  # k_stack [L, B, H, T, hd]
    _pool_write(pool_k, idx, k_stack)
    _pool_write(pool_v, idx, v_stack)
    return pool_k, pool_v, logits


def _prefill_suffix(params, cfg: GPTConfig, suffix_ids, suffix_lens, start_lens, pool_k,
                    pool_v, read_tables, out_len, mesh=None):
    """The body of the suffix modes: run only the unshared tail, attending
    to the shared prefix's pooled K/V (exactly ``[0, start_lens[b])`` of the
    gathered pages, a partial last page included) and to the tail itself
    under the ragged causal mask. Returns the tail's compacted ``(k_stack,
    v_stack)`` ``[L, B, H, out_len, hd]`` and the last token's logits.

    Every layer reads the prefix from the pool as it stood before this
    admission: the pool is written only after this returns, by the
    caller."""
    device = pool_k.device
    ids = _as_ids(suffix_ids, device)
    read_tables = _read_table(torch.as_tensor(read_tables, device=device).to(torch.int64),
                              pool_blocks(pool_k))
    b, s0 = ids.shape
    num_heads = pool_k.shape[2]  # this rank's heads under a mesh
    page_size = pool_k.shape[3]
    t_virt = read_tables.shape[1] * page_size
    suffix_lens = torch.as_tensor(suffix_lens, device=device).to(torch.int64)
    start_lens = torch.as_tensor(start_lens, device=device).to(torch.int64)
    pad = s0 - suffix_lens
    ar = torch.arange(s0, device=device)
    positions = start_lens[:, None] + (ar[None, :] - pad[:, None]).clamp(min=0)
    x = _embed(params, cfg, ids, positions, mesh)
    self_mask = _ragged_self_mask(cfg, s0, pad)  # [B, 1, S0, S0]
    # every tail query sits past the prefix: no causal term on that side
    vis_pref = torch.arange(t_virt, device=device)[None, :] < start_lens[:, None]
    pref_mask = _mask_value(vis_pref, cfg.dtype)[:, None, None, :].expand(b, 1, s0, t_virt)
    mask = torch.cat([pref_mask, self_mask], dim=-1)

    ks, vs = [], []
    p = params["params"]
    for i in range(cfg.num_layers):

        def attend_mixed(q, k, v, i=i):
            kv_shape = (b, num_heads, t_virt, k.shape[-1])
            k_all = torch.cat([_virt_view(pool_k, i, read_tables, kv_shape, k.dtype), k], dim=2)
            v_all = torch.cat([_virt_view(pool_v, i, read_tables, kv_shape, v.dtype), v], dim=2)
            return _attend(q, k_all, v_all, mask), (k, v)

        x, (k, v) = _block(cfg, p[f"layer_{i}"], x, attend_mixed, mesh)
        ks.append(k)
        vs.append(v)

    k_stack, v_stack = _compact_ragged(torch.stack(ks), torch.stack(vs), pad, suffix_lens,
                                       out_len)
    return k_stack, v_stack, _lm_head(params, cfg, x[:, -1:, :], mesh)[:, 0]


# -- sampling and generation --------------------------------------------------


def _top_k_mask(logits, k: int):
    """Keep the k largest logits (ties at the threshold all survive), the
    rest to -inf."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, torch.full_like(logits, -math.inf))


def sample_token(logits, rng, index, temperature: float, top_k: Optional[int] = None):
    """The next-token rule shared by :func:`generate_cached` and the serving
    engine: argmax at ``temperature`` 0, else
    ``categorical(fold_in(rng, index), logits / temperature)`` after the
    optional top-k mask. ``rng`` ``[2]`` with an int ``index`` draws over
    the whole ``[B, V]`` (JAX's single-key call); ``rng`` ``[B, 2]`` with
    ``index`` ``[B]`` draws each row from its own key (the engine's slots).
    The division is tensor by tensor: CUDA divides by a Python scalar as a
    multiply by its reciprocal."""
    if top_k is not None:
        logits = _top_k_mask(logits, top_k)
    if temperature > 0:
        t = torch.full((), temperature, dtype=logits.dtype, device=logits.device)
        return prng.categorical(prng.fold_in(rng, index), torch.div(logits, t))
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def generate_cached(params, cfg: GPTConfig, prompt_ids, num_steps: int,
                    temperature: float = 0.0, rng=None, max_len=None, top_k=None):
    """Greedy at ``temperature == 0``, else sampling (``rng`` a key from
    ``utils/prng.py :: PRNGKey``), optionally over the ``top_k`` most likely
    tokens: one prefill, then one cached step per token. Returns ``[B, S0 +
    num_steps]`` int64 ids on the parameters' device."""
    if temperature > 0 and rng is None:
        raise ValueError("temperature sampling needs an rng key")
    device = _param_device(params)
    ids = _as_ids(prompt_ids, device)
    if ids.dim() == 1:
        ids = ids[None, :]
    s0 = ids.shape[1]
    if max_len is None:
        max_len = s0 + num_steps
    if s0 + num_steps > max_len:
        raise ValueError(f"prompt {s0} + steps {num_steps} exceed max_len {max_len}")
    if top_k is not None:
        top_k = int(top_k)
        if not 1 <= top_k <= cfg.vocab_size:
            raise ValueError(f"top_k must be in [1, vocab_size={cfg.vocab_size}], got {top_k}")
    if rng is None:
        rng = prng.PRNGKey(0)
    rng = rng.to(device)
    cache, logits = prefill(params, cfg, ids, max_len)
    toks = []
    for i in range(num_steps):
        tok = sample_token(logits, rng, i, temperature, top_k)
        toks.append(tok)
        if i + 1 < num_steps:  # the last token's step would only feed a discarded pick
            cache, logits = decode_step(params, cfg, cache, tok)
    if not toks:
        return ids
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
