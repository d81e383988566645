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
  position past its write limit, a sentinel page) lands there; a read
  through a sentinel page reads it, at virtual positions the attention
  mask removes. Sizes reported to users (``memory_stats``,
  ``kv_pool_bytes``) stay JAX's, ``num_blocks`` blocks.
- the fixed cache drops a masked row's write by writing back the value it
  already holds (each row writes only its own slot, so no two writes
  meet).
- positions past the position table clamp to its last row, as JAX's
  gather does; only tokens the caller discards are computed there.

Sampling is :func:`sample_token`, JAX's rule with JAX's random numbers
(``utils/prng.py``): a request's tokens depend on its seed and the token
index, never on its slot or batch.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: ``verify_step_ragged``/``verify_step_paged`` and
``truncate_draft_params`` (speculative decoding, item 5c),
``prefill_paged_cow`` and the suffix mode of ``prefill_paged`` (prefix
sharing, item 5b), and an int8 pool (the int8 KV codec, item 5e).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from gradaccum_tpu_torch.models.gpt import GPTConfig
from gradaccum_tpu_torch.utils import prng

SPEC_ITEM = "speculative decoding (ROADMAP.md item 5c)"
PREFIX_ITEM = "prefix sharing and copy-on-write (ROADMAP.md item 5b)"
INT8_ITEM = "the int8 KV codec (ROADMAP.md item 5e)"


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


def _layer_norm(p, x, eps):
    dt = torch.promote_types(x.dtype, p["scale"].dtype)
    return F.layer_norm(x.to(dt), x.shape[-1:], p["scale"].to(dt), p["bias"].to(dt), eps)


def _split_heads(t, num_heads):
    b, s, d = t.shape
    return t.view(b, s, num_heads, d // num_heads).transpose(1, 2)


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


def _block(cfg: GPTConfig, lp, x, attend_fn):
    """One decoder block (pre-LN, ``models/gpt.py``), dropout off."""
    h = _layer_norm(lp["attention_LayerNorm"], x, cfg.layer_norm_eps)
    ap = lp["attention"]
    q = _split_heads(_dense(ap["query"], h), cfg.num_heads)
    k = _split_heads(_dense(ap["key"], h), cfg.num_heads)
    v = _split_heads(_dense(ap["value"], h), cfg.num_heads)
    ctx, cache_kv = attend_fn(q, k, v)
    x = x + _dense(ap["output"], _merge_heads(ctx))
    h = _layer_norm(lp["mlp_LayerNorm"], x, cfg.layer_norm_eps)
    h = F.gelu(_dense(lp["intermediate"], h), approximate="tanh")
    return x + _dense(lp["ffn_output"], h), cache_kv


def _embed(params, cfg: GPTConfig, ids, positions):
    p = params["params"]
    positions = positions.clamp(0, cfg.max_position_embeddings - 1)  # JAX's gather clamps
    tok = F.embedding(ids, p["word_embeddings"]["embedding"])
    pos = F.embedding(positions, p["position_embeddings"]["embedding"])
    return (tok + pos).to(cfg.dtype)


def _lm_head(params, cfg: GPTConfig, x):
    p = params["params"]
    x = _layer_norm(p["final_LayerNorm"], x, cfg.layer_norm_eps)
    return torch.matmul(x.float(), p["word_embeddings"]["embedding"].float().t())


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
               device=None) -> DecodeCache:
    """A zeroed fixed cache. ``cache_dtype`` (``torch.bfloat16``) stores
    K/V narrower than the compute dtype: reads upcast at the attention,
    writes downcast."""
    if max_len > cfg.max_position_embeddings:
        raise ValueError(f"max_len {max_len} exceeds max_position_embeddings "
                         f"{cfg.max_position_embeddings}")
    if _is_int8(cache_dtype):
        raise ValueError(
            "cache_dtype=int8 needs per-vector quantization scales, which only "
            "the paged pool layout carries (init_paged_pool); the fixed-slot "
            "cache stores raw dtypes only")
    hd = cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, batch, cfg.num_heads, max_len, hd)
    dtype = cfg.dtype if cache_dtype is None else cache_dtype
    return DecodeCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def truncate_draft_params(params, cfg: GPTConfig, num_layers: int):
    raise NotImplementedError(f"truncate_draft_params waits for {SPEC_ITEM}")


def _as_ids(ids, device):
    ids = torch.as_tensor(ids, device=device)
    return ids.to(torch.int64)


def prefill(params, cfg: GPTConfig, prompt_ids, max_len: int, lengths=None):
    """Run the prompt once and fill a fresh cache of ``max_len``. Returns
    ``(cache, last_logits [B, vocab])``.

    ``lengths`` (``[B]``, each in ``[1, S0]``) makes the batch ragged: row b
    is left-padded, its real tokens in the last ``lengths[b]`` columns; the
    pad is masked and positioned away, and row b's K/V are compacted to
    positions ``[0, lengths[b])``, so ``cache.length`` is ``[B]`` and
    decoding goes on with :func:`decode_step_ragged`."""
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
    x = _embed(params, cfg, ids, positions)

    ks, vs = [], []

    def attend_full(q, k, v):
        return _attend(q, k, v, pos_mask), (k, v)

    p = params["params"]
    for i in range(cfg.num_layers):
        x, (k, v) = _block(cfg, p[f"layer_{i}"], x, attend_full)
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
    logits = _lm_head(params, cfg, x[:, -1:, :])[:, 0]
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


def decode_step_ragged(params, cfg: GPTConfig, cache: DecodeCache, token, active=None):
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
    x = _embed(params, cfg, token[:, None], pos[:, None])
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

        x, _ = _block(cfg, p[f"layer_{i}"], x, attend_cached)

    logits = _lm_head(params, cfg, x)[:, 0]
    new_len = torch.where(active, pos + 1, pos)
    return DecodeCache(k=new_k, v=new_v, length=new_len), logits


def verify_step_ragged(params, cfg: GPTConfig, cache: DecodeCache, tokens, active=None):
    raise NotImplementedError(f"verify_step_ragged waits for {SPEC_ITEM}")


# -- the paged pool -----------------------------------------------------------


def init_paged_pool(cfg: GPTConfig, num_blocks: int, page_size: int, cache_dtype=None,
                    device=None):
    """The block pool, K and V ``[L, num_blocks + 1, H, page_size, hd]``:
    blocks ``0..num_blocks-1`` are real, block ``num_blocks`` is the trash
    block that page-table sentinels address (dropped writes land there,
    reads through it are masked)."""
    if num_blocks < 1:
        raise ValueError(f"need at least one block, got {num_blocks}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if _is_int8(cache_dtype):
        raise NotImplementedError(f"cache_dtype=int8 waits for {INT8_ITEM}")
    hd = cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, num_blocks + 1, cfg.num_heads, page_size, hd)
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
    downcast to the pool's dtype."""
    pool[idx] = values.to(pool.dtype)
    return pool


def _virt_view(pool, i, page_table, kv_shape, dtype):
    """Layer ``i``'s pages gathered through ``page_table`` into the virtual
    ``[B, H, max_pages * page_size, hd]`` view, upcast to ``dtype``."""
    return pool[i][page_table].permute(0, 2, 1, 3, 4).reshape(kv_shape).to(dtype)


def gather_blocks(pool_k, pool_v, block_ids):
    """Whole blocks out of the pool: ``(k, v)`` each ``[L, n, H, page, hd]``.
    Ids past the last real block clamp to it, as JAX's gather does (the
    caller drops those rows)."""
    ids = torch.as_tensor(block_ids, device=pool_k.device).to(torch.int64)
    ids = ids.clamp(0, pool_blocks(pool_k) - 1)
    return pool_k[:, ids], pool_v[:, ids]


def scatter_blocks(pool_k, pool_v, block_ids, k_blocks, v_blocks):
    """Write ``n`` whole blocks into the pool at ``block_ids``, in place; ids
    outside ``[0, num_blocks)`` (the sentinel padding) write nothing real.
    Returns ``(pool_k, pool_v)``."""
    ids = torch.as_tensor(block_ids, device=pool_k.device).to(torch.int64)
    ids = _trash_ids(ids, pool_blocks(pool_k))
    _pool_write(pool_k, (slice(None), ids), torch.as_tensor(k_blocks, device=pool_k.device))
    _pool_write(pool_v, (slice(None), ids), torch.as_tensor(v_blocks, device=pool_v.device))
    return pool_k, pool_v


def decode_step_paged(params, cfg: GPTConfig, pool_k, pool_v, page_table, lengths, token,
                      active=None, limit=None):
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
    x = _embed(params, cfg, token[:, None], pos[:, None])
    visible = torch.arange(t_virt, device=device)[None, :] <= pos[:, None]
    pos_mask = _mask_value(visible, cfg.dtype)[:, None, None, :]
    page = (pos // page_size).clamp(max=max_pages - 1)[:, None]
    blk = torch.gather(page_table, 1, page)
    blk = torch.where(writable[:, None], blk, torch.full_like(blk, num_blocks))
    off = (pos % page_size)[:, None]
    hidx = torch.arange(cfg.num_heads, device=device)[None]
    p = params["params"]

    for i in range(cfg.num_layers):

        def attend_cached(q, k, v, i=i):
            _pool_write(pool_k, (i, blk, hidx, off), k[:, :, 0, :])
            _pool_write(pool_v, (i, blk, hidx, off), v[:, :, 0, :])
            kv_shape = (b, cfg.num_heads, t_virt, k.shape[-1])
            k_virt = _virt_view(pool_k, i, page_table, kv_shape, q.dtype)
            v_virt = _virt_view(pool_v, i, page_table, kv_shape, q.dtype)
            return _attend(q, k_virt, v_virt, pos_mask), None

        x, _ = _block(cfg, p[f"layer_{i}"], x, attend_cached)

    logits = _lm_head(params, cfg, x)[:, 0]
    new_len = torch.where(writable, pos + 1, pos)
    return pool_k, pool_v, new_len, logits


def verify_step_paged(params, cfg: GPTConfig, pool_k, pool_v, page_table, lengths, tokens,
                      active=None, limit=None):
    raise NotImplementedError(f"verify_step_paged waits for {SPEC_ITEM}")


def prefill_paged(params, cfg: GPTConfig, prompt_ids, prompt_lens, pool_k, pool_v,
                  page_rows, start_lens=None, read_tables=None):
    """Ragged batched prefill straight into pool blocks: ``prompt_ids``
    ``[B, S0]`` left-padded, ``prompt_lens`` ``[B]``, ``page_rows`` ``[B,
    ceil(S0 / page_size)]`` each row's block ids for its prompt pages (the
    sentinel ``num_blocks`` past them). The compacted K/V are written page
    by page, in place. Returns ``(pool_k, pool_v, last_logits)``."""
    if start_lens is not None or read_tables is not None:
        raise NotImplementedError(f"prefill_paged's suffix mode waits for {PREFIX_ITEM}")
    device = pool_k.device
    ids = _as_ids(prompt_ids, device)
    page_rows = torch.as_tensor(page_rows, device=device).to(torch.int64)
    b, s0 = ids.shape
    page_size = pool_k.shape[3]
    s0_pages = -(-s0 // page_size)
    if tuple(page_rows.shape) != (b, s0_pages):
        raise ValueError(f"page_rows must be [batch={b}, ceil(S0/page)={s0_pages}], "
                         f"got {tuple(page_rows.shape)}")
    cache, logits = prefill(params, cfg, ids, s0_pages * page_size, lengths=prompt_lens)
    num_layers, _, heads, _, hd = cache.k.shape

    def to_pages(t):  # [L, B, H, s0p*P, hd] -> [L, B, s0p, H, P, hd]
        return t.view(num_layers, b, heads, s0_pages, page_size, hd).permute(0, 1, 3, 2, 4, 5)

    idx = (slice(None), _trash_ids(page_rows, pool_blocks(pool_k)))
    _pool_write(pool_k, idx, to_pages(cache.k))
    _pool_write(pool_v, idx, to_pages(cache.v))
    return pool_k, pool_v, logits


def prefill_paged_cow(*args, **kwargs):
    raise NotImplementedError(f"prefill_paged_cow waits for {PREFIX_ITEM}")


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
