"""The continuous-batching engine: one decode tick, many requests.

The port of ``gradaccum_tpu/serving/engine.py`` for the fixed and paged
pools. A pool of ``num_slots`` decode slots is advanced by one tick: a
Python loop of ``decode_block`` micro-steps on fixed-shape tensors, each
stepping ALL slots at their own cache positions (inactive ones masked) and
sampling every slot's next token from its own request's stream, then ONE
readback of the block's tokens. Admissions batch-prefill the queued
prompts, left-padded and ragged, straight into the claimed slots (or their
pool blocks); retirements only flip host bookkeeping.

Greedy and seeded-sampled outputs equal
:func:`~gradaccum_tpu_torch.models.gpt_decode.generate_cached` on each
request alone, token for token: the same prefill arithmetic, the same
cache layout, the same ``sample_token`` rule keyed by the request's seed and
the token's index. Batching changes throughput, never results.

**Static shapes.** JAX counts compiled programs
(``decode_compile_count``/``prefill_compile_count``). Here nothing
compiles; the engine keeps the names and counts the distinct input-shape
signatures its tick and its admission have been given: one per block size
for the tick, one per (batch, bucketed length) for admission. That is the
contract a CUDA graph of the tick would need.

**Not ported yet**, each raising ``NotImplementedError`` with its
ROADMAP.md item: ``prefix_cache`` (5b), ``speculate_k > 0`` (5c),
``admission``, ``swap`` other than the default, ``swap_max_bytes``,
``victim_score``, ``overlap_prefill`` and ``preempt`` (5d),
``cache_dtype=int8`` (5e), ``mesh`` and ``reconfigure`` (5g), and
``recover`` (5h).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gradaccum_tpu_torch.interop import params_tree
from gradaccum_tpu_torch.models.gpt import GPTConfig
from gradaccum_tpu_torch.models.gpt_decode import (
    INT8_ITEM,
    PREFIX_ITEM,
    SPEC_ITEM,
    DecodeCache,
    decode_step_paged,
    decode_step_ragged,
    prefill,
    prefill_paged,
    sample_token,
)
from gradaccum_tpu_torch.obs import trace as obs_trace
from gradaccum_tpu_torch.serving.cache_pool import CachePool, PagedCachePool
from gradaccum_tpu_torch.serving.metrics import ServingMetrics
from gradaccum_tpu_torch.serving.scheduler import QueueFull, Request, Scheduler
from gradaccum_tpu_torch.utils import prng
from gradaccum_tpu_torch.utils.platform import resolve_device
from gradaccum_tpu_torch.utils.profiling import StepWindowProfiler

ADMISSION_ITEM = "admission control and swap (ROADMAP.md item 5d)"
FLEET_ITEM = "reconfiguration, replicas and the serving mesh (ROADMAP.md item 5g)"
RECOVER_ITEM = "the serving fault points and Engine.recover (ROADMAP.md item 5h)"


@dataclasses.dataclass
class StepEvents:
    """What one engine tick did, for front-ends to stream out."""

    emitted: List[Tuple[int, int]]    # (request_id, token)
    finished: List[Tuple[int, str]]   # (request_id, reason: eos|length|timeout)
    admitted: List[int]               # request_ids prefilled this tick
    tick: int
    preempted: List[int] = dataclasses.field(default_factory=list)
    resumed: List[int] = dataclasses.field(default_factory=list)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


class Engine:
    """Multiplexes concurrent generation requests through one decode tick.

    ``params``: the port's ``GPTLM`` or its decode tree
    (``interop.py :: params_tree``). ``temperature`` and ``top_k`` are
    engine-level; the random stream is per request (``rng_seed``).
    ``decode_block`` micro-steps run per tick before the host sees tokens;
    ``decode_block_set`` (e.g. ``(1, 4)``) picks per tick from queue
    pressure, the smallest block while admissions wait, the largest once the
    queue is drained. Tokens are the same for every block size.

    ``page_size`` switches to the paged pool: ``num_blocks`` blocks of
    ``page_size`` positions shared by all slots (default ``num_slots *
    max_len / page_size``, the fixed pool's bytes), admission reserving a
    request's worst-case pages, so the engine refuses admission (and says it
    was BLOCKS) instead of preempting.

    ``replica_id`` names this engine in backpressure messages, stall keys,
    spans and metric labels; ``id_start``/``id_stride`` give it a request-id
    lattice. ``device``: the card unless ``"cpu"`` is asked for. Not
    thread-safe: ``ServingServer`` serializes access."""

    def __init__(
        self,
        params,
        cfg: GPTConfig,
        num_slots: int = 4,
        max_len: int = 128,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        decode_block: int = 1,
        decode_block_set: Optional[Tuple[int, ...]] = None,
        page_size: Optional[int] = None,
        num_blocks: Optional[int] = None,
        prefix_cache=None,
        cow_tails: bool = True,
        victim_score=None,
        scheduler: Optional[Scheduler] = None,
        metrics: Optional[ServingMetrics] = None,
        min_prefill_bucket: int = 8,
        profile_dir: Optional[str] = None,
        profile_start_tick: int = 0,
        profile_num_ticks: int = 0,
        tracer=None,
        mesh=None,
        replica_id: Optional[int] = None,
        id_start: int = 0,
        id_stride: int = 1,
        speculate_k: int = 0,
        draft_params=None,
        draft_cfg: Optional[GPTConfig] = None,
        cache_dtype=None,
        overlap_prefill: bool = False,
        admission=None,
        swap: str = "host",
        swap_max_bytes: Optional[int] = None,
        device="cuda",
    ):
        if top_k is not None and temperature <= 0:
            raise ValueError("top_k sampling needs temperature > 0 "
                             "(top_k with temperature 0 is just greedy)")
        if top_k is not None and not 1 <= int(top_k) <= cfg.vocab_size:
            raise ValueError(f"top_k must be in [1, {cfg.vocab_size}]")
        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        if num_blocks is not None and page_size is None:
            raise ValueError("num_blocks needs page_size (paged mode)")
        if id_stride < 1:
            raise ValueError(f"id_stride must be >= 1, got {id_stride}")
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if swap not in ("host", "recompute", "tiered"):
            raise ValueError(f"swap must be 'host', 'recompute', or 'tiered', got {swap!r}")
        refused = [
            (prefix_cache is not None and prefix_cache is not False, "prefix_cache",
             PREFIX_ITEM),
            (speculate_k > 0, "speculate_k", SPEC_ITEM),
            (cache_dtype is not None and cache_dtype == torch.int8, "cache_dtype=int8",
             INT8_ITEM),
            (bool(overlap_prefill), "overlap_prefill", ADMISSION_ITEM),
            (admission is not None, "admission", ADMISSION_ITEM),
            (swap != "host" or swap_max_bytes is not None, "swap", ADMISSION_ITEM),
            (victim_score is not None, "victim_score", ADMISSION_ITEM),
            (mesh is not None, "mesh", FLEET_ITEM),
        ]
        for hit, knob, item in refused:
            if hit:
                raise NotImplementedError(f"Engine({knob}=...) waits for {item}")
        self.device = resolve_device(device)
        if isinstance(params, torch.nn.Module):
            params = params_tree(params)
        self.params = _tree_to(params, self.device)
        self.cfg = cfg
        self.max_len = max_len
        self.temperature = float(temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.paged = page_size is not None
        self.page_size = None if page_size is None else int(page_size)
        self.cache_dtype = cache_dtype
        if self.paged:
            if num_blocks is None:
                num_blocks = num_slots * max_len // self.page_size  # the fixed pool's bytes
            self.num_blocks = int(num_blocks)
            self.pool = PagedCachePool(cfg, num_slots, max_len, self.page_size,
                                       self.num_blocks, cache_dtype=cache_dtype,
                                       device=self.device)
        else:
            self.num_blocks = None
            self.pool = CachePool(cfg, num_slots, max_len, cache_dtype=cache_dtype,
                                  device=self.device)
        self.replica_id = None if replica_id is None else int(replica_id)
        self._obs_args: Dict[str, object] = {}
        if self.replica_id is not None:
            self._obs_args["replica"] = self.replica_id
        self.scheduler = scheduler or Scheduler()
        if self.replica_id is not None and self.scheduler.label is None:
            self.scheduler.label = f"replica {self.replica_id}"
        self.metrics = metrics or ServingMetrics(replica_id=self.replica_id)
        self._tracer = tracer
        if tracer is not None and getattr(self.scheduler, "_tracer", None) is None:
            self.scheduler.tracer = tracer
        self._req_submit_ts: Dict[int, float] = {}
        self._req_admit_ts: Dict[int, float] = {}
        self.min_prefill_bucket = min_prefill_bucket
        self._profiler = StepWindowProfiler(profile_dir, profile_start_tick, profile_num_ticks)

        dev = self.device
        self._cur_tok = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self._gen = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self._rngs = torch.zeros(num_slots, 2, dtype=torch.int64, device=dev)
        self._limit = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self._active = np.zeros((num_slots,), bool)
        self._slot_req: List[Optional[Request]] = [None] * num_slots
        # host mirrors of each slot's length and write limit (exact: lengths
        # advance by min(block, limit - len) per tick), so the page allocator
        # and the token gauges never read the card
        self._slot_len = np.zeros((num_slots,), np.int64)
        self._slot_limit = np.zeros((num_slots,), np.int64)

        if decode_block_set is not None:
            blocks = sorted({int(b) for b in decode_block_set})
            if not blocks or blocks[0] < 1:
                raise ValueError(f"decode_block_set must be >= 1 ints, got {decode_block_set}")
            self.decode_block_set = tuple(blocks)
            self.decode_block = blocks[-1]
        else:
            self.decode_block_set = (int(decode_block),)
            self.decode_block = int(decode_block)
        self._tick_shapes: set = set()
        self._admit_shapes: set = set()
        self._tick = 0
        self._next_id = int(id_start)
        self._id_stride = int(id_stride)
        # per-request outputs; front-ends evict them with pop_result()
        self.results: Dict[int, List[int]] = {}
        self.status: Dict[int, str] = {}

    # -- introspection ----------------------------------------------------

    def obs_tags(self) -> dict:
        return dict(self._obs_args)

    @property
    def tracer(self):
        """The injected tracer, or the process-global one resolved now."""
        return obs_trace.resolve(self._tracer)

    @tracer.setter
    def tracer(self, tracer) -> None:
        self._tracer = tracer

    @property
    def idle(self) -> bool:
        return (self.scheduler.depth == 0 and self.pool.active_count == 0
                and self.scheduler.parked_depth == 0)

    @property
    def tick_count(self) -> int:
        return self._tick

    def decode_compile_count(self) -> int:
        """Distinct input-shape signatures the decode tick has run with:
        one per block size used, never more with traffic (JAX counts its
        compiled tick programs)."""
        return len(self._tick_shapes)

    def prefill_compile_count(self) -> int:
        """Distinct (batch, bucketed length) signatures of the admission
        prefill, bounded by the bucket set."""
        return len(self._admit_shapes)

    def manifest(self) -> dict:
        """The engine's serving shape for the export manifest
        (``estimator/export.py``), with JAX's keys and values."""
        return {
            "num_slots": self.pool.num_slots,
            "max_len": self.max_len,
            "decode_block": self.decode_block,
            "decode_block_set": list(self.decode_block_set),
            "page_size": self.page_size,
            "num_blocks": self.num_blocks,
            "prefix_cache": False,
            "cow_tails": False,
            "victim_score": None,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "min_prefill_bucket": self.min_prefill_bucket,
            "mesh": None,
            "replica_id": self.replica_id,
            "speculate_k": 0,
            "draft_num_layers": None,
            "cache_dtype": None if self.cache_dtype is None else _dtype_name(self.cache_dtype),
            "overlap_prefill": False,
            "admission": None,
            "admission_q": None,
            "swap": "host",
            "swap_max_bytes": None,
            "memory": {"kv_quant": False, "token_bytes": self._token_bytes,
                       "tiered_swap": False},
            "healer": getattr(self, "healer_knobs", None),
        }

    def memory_stats(self) -> dict:
        """Bytes per token at the pool's storage dtype and the bytes the pool
        charges for what is in flight."""
        if self.paged:
            used_tokens = self.pool.allocated_blocks * self.page_size
        else:
            used_tokens = self.pool.active_count * self.max_len
        return {"kv_quant": False, "token_bytes": self._token_bytes,
                "kv_bytes_in_use": used_tokens * self._token_bytes}

    @property
    def kv_pool_bytes(self) -> int:
        """The pool's K/V bytes at JAX's logical size (the trash block of the
        paged pool apart)."""
        tokens = (self.num_blocks * self.page_size if self.paged
                  else self.pool.num_slots * self.max_len)
        return tokens * self._token_bytes

    # -- request intake ---------------------------------------------------

    def rebase_ids(self, id_start: int, id_stride: int) -> None:
        """Move onto a wider id lattice: future ids from ``id_start`` with
        ``id_stride``; ``id_start`` may not re-issue an id."""
        if int(id_start) < self._next_id:
            raise ValueError(f"id_start {id_start} would re-issue: this engine's next id "
                             f"is already {self._next_id}")
        if int(id_stride) < 1:
            raise ValueError(f"id_stride must be >= 1, got {id_stride}")
        self._next_id = int(id_start)
        self._id_stride = int(id_stride)

    def submit(self, prompt, max_new_tokens: int, eos_id: Optional[int] = None,
               rng_seed: int = 0, deadline_ticks: Optional[int] = None,
               _quiet_full: bool = False) -> int:
        """Queue one request; returns its id. Raises ``QueueFull`` on
        backpressure (naming the scarce resource) and ValueError for a
        request that could never fit."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                             f"exceed max_len {self.max_len}")
        if self.paged:
            need = self.pool.blocks_for(prompt.size + max_new_tokens)
            if need > self.pool.num_blocks:
                raise ValueError(f"request needs {need} KV blocks but the pool only has "
                                 f"{self.pool.num_blocks} — it could never be admitted")
        rid = self._next_id
        self._next_id += self._id_stride
        req = Request(request_id=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_id=eos_id, rng_seed=int(rng_seed),
                      deadline_tick=(None if deadline_ticks is None
                                     else self._tick + int(deadline_ticks)),
                      submit_tick=self._tick)
        tr = self.tracer
        try:
            self.scheduler.submit(req)
        except QueueFull as e:
            bottleneck = self._bottleneck()
            if _quiet_full:
                self._next_id = rid
                raise QueueFull(f"{e}; bottleneck: {bottleneck}") from None
            self.metrics.record_reject(rid)
            if tr.enabled:
                tr.event("req/reject", cat="request", rid=rid, bottleneck=bottleneck,
                         **self._obs_args)
            raise QueueFull(f"{e}; bottleneck: {bottleneck}") from None
        except Exception:
            self.metrics.record_reject(rid)
            raise
        self.results[rid] = []
        self.status[rid] = "queued"
        self.metrics.record_submit(rid)
        if tr.enabled:
            self._req_submit_ts[rid] = tr.now()
            tr.event("req/submit", cat="request", rid=rid, prompt_len=int(prompt.size),
                     max_new=int(max_new_tokens), **self._obs_args)
        return rid

    # -- the tick ---------------------------------------------------------

    def _pick_block(self) -> int:
        """Smallest block while requests wait, largest otherwise."""
        if len(self.decode_block_set) == 1 or self.scheduler.depth > 0:
            return self.decode_block_set[0]
        return self.decode_block_set[-1]

    def _bottleneck(self) -> str:
        """Which pool resource is exhausted now (backpressure detail)."""
        tag = "" if self.replica_id is None else f"replica {self.replica_id}: "
        if self.pool.free_count == 0:
            return tag + "no free slots"
        if self.paged:
            head = self.scheduler.peek()
            need = (1 if head is None
                    else self.pool.blocks_for(head.prompt.size + head.max_new_tokens))
            if need > self.pool.unreserved_blocks:
                return tag + "no free KV blocks"
        return tag + "queue backlog (slots available)"

    @property
    def _token_bytes(self) -> int:
        """Pool bytes per cache position (K and V, all layers) at the pool's
        storage dtype."""
        dtype = self.cfg.dtype if self.cache_dtype is None else self.cache_dtype
        return 2 * self.cfg.num_layers * self.cfg.hidden_size * dtype.itemsize

    def step(self) -> StepEvents:
        """One tick: expire -> admit/prefill -> decode block. Traced as one
        ``serve/tick`` span (``serve/prefill`` and ``serve/decode`` inside)."""
        tr = self.tracer
        if not tr.enabled:
            return self._step()
        with tr.span("serve/tick", cat="serving", tick=self._tick, **self._obs_args) as sp:
            events = self._step()
            sp.set(admitted=len(events.admitted), emitted=len(events.emitted),
                   finished=len(events.finished))
            return events

    @torch.no_grad()
    def _step(self) -> StepEvents:
        t = self._tick
        tr = self.tracer
        self._profiler.observe(t)
        emitted: List[Tuple[int, int]] = []
        finished: List[Tuple[int, str]] = []
        admitted: List[int] = []

        for req in self.scheduler.expire(t):
            self.status[req.request_id] = "timeout"
            finished.append((req.request_id, "timeout"))
            self.metrics.record_expired(req.request_id)
            self.metrics.record_finish(req.request_id, "timeout")
            ts0 = self._req_submit_ts.pop(req.request_id, None)
            if tr.enabled and ts0 is not None:
                tr.complete("req/queue", ts0, cat="request", rid=req.request_id,
                            outcome="timeout", **self._obs_args)

        fits = None
        if self.paged:
            # reservations of earlier requests in this same admission batch
            # count: they reach the pool only inside _admit
            pending = [0]

            def fits(r):
                total = self.pool.blocks_for(r.prompt.size + r.max_new_tokens)
                if total > self.pool.max_pages or \
                        pending[0] + total > self.pool.unreserved_blocks:
                    return False
                pending[0] += total
                return True

        reqs = self.scheduler.admit(self.pool.free_count, t, fits=fits)
        block = self._pick_block()
        if reqs:
            with (tr.span("serve/prefill", cat="serving", tick=t, batch=len(reqs))
                  if tr.enabled else obs_trace.NULL.span("")):
                self._admit_finish(self._admit_dispatch(reqs), emitted, finished, admitted)
        if self.scheduler.depth > 0 and self.pool.free_count == 0:
            self.scheduler.record_stall("no_free_slots")

        active_now = self._active.copy()
        if self.paged:
            # grow every active slot's pages to this tick's worst-case end;
            # the reservation guarantees the supply
            for slot in np.nonzero(active_now)[0]:
                self.pool.alloc_to(int(slot), min(self._slot_len[slot] + block,
                                                  self._slot_limit[slot]))
        if active_now.any():
            if tr.enabled:
                args = dict(block=block, active=int(active_now.sum()))
                if self.paged:
                    args["free_blocks"] = self.pool.free_blocks
                span = tr.span("serve/decode", cat="serving", tick=t, **args)
            else:
                span = obs_trace.NULL.span("")
            with span:
                self._decode_finish(self._decode_dispatch(active_now, block), emitted,
                                    finished)

        gauges = dict(tokens_in_flight=int(self._slot_len[self._active].sum()),
                      decode_block=block)
        if self.paged:
            gauges.update(token_capacity=self.pool.token_capacity,
                          kv_bytes_in_use=(self.pool.allocated_blocks * self.page_size
                                           * self._token_bytes),
                          free_blocks=self.pool.free_blocks)
        else:
            gauges.update(token_capacity=self.pool.num_slots * self.max_len,
                          kv_bytes_in_use=(self.pool.active_count * self.max_len
                                           * self._token_bytes))
        self.metrics.record_tick(self.scheduler.depth, self.pool.active_count,
                                 self.pool.num_slots, **gauges)
        self._tick = t + 1
        return StepEvents(emitted, finished, admitted, t)

    def _decode_dispatch(self, active_now, block: int):
        """Run this tick's ``block`` micro-steps on every slot and keep the
        device state; the tokens stay on the card until
        :meth:`_decode_finish` reads them back once."""
        pool = self.pool
        active = torch.as_tensor(active_now).to(self.device)
        table = pool.page_table_device() if self.paged else None
        self._tick_shapes.add((block, tuple(pool.k.shape), str(pool.k.dtype),
                               None if table is None else tuple(table.shape)))
        lengths, cur, gen = pool.lengths, self._cur_tok, self._gen
        toks = []
        for _ in range(block):
            if self.paged:
                _, _, lengths, logits = decode_step_paged(
                    self.params, self.cfg, pool.k, pool.v, table, lengths, cur, active,
                    self._limit)
            else:
                cache, logits = decode_step_ragged(
                    self.params, self.cfg, DecodeCache(pool.k, pool.v, lengths), cur, active)
                lengths = cache.length
            nxt = sample_token(logits, self._rngs, gen, self.temperature, self.top_k)
            cur = torch.where(active, nxt, cur)
            gen = gen + active
            toks.append(cur)
        pool.lengths, self._cur_tok, self._gen = lengths, cur, gen
        # paged writes stop at the slot's limit, fixed ones at max_len
        self._slot_len[active_now] = np.minimum(
            self._slot_len[active_now] + block,
            self._slot_limit[active_now] if self.paged else self.max_len)
        return active_now, torch.stack(toks)

    def _decode_finish(self, state, emitted, finished) -> None:
        """Read the block's tokens back (the tick's one sync) and emit them."""
        active_now, toks = state
        toks_host = toks.cpu().numpy()  # [block, slots]
        for d in range(toks_host.shape[0]):
            for slot in np.nonzero(active_now)[0]:
                req = self._slot_req[slot]
                if req is None:  # retired earlier in this block
                    continue
                self._emit(int(slot), req, int(toks_host[d, slot]), emitted, finished,
                           first=False)

    # -- lifecycle --------------------------------------------------------

    def pop_result(self, request_id: int) -> Tuple[List[int], str]:
        """Remove and return ``(tokens, status)`` of a finished request."""
        return self.results.pop(request_id), self.status.pop(request_id)

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued or running request; a running one's slot (and on
        the paged pool its blocks and reservation) come back at once. The
        partial result stays poppable with status "cancelled". False for an
        unknown or finished id. Not thread-safe: through a server, call
        ``ServingServer.cancel``."""
        tr = self.tracer
        if self.scheduler.cancel(request_id):
            self.status[request_id] = "cancelled"
            self.metrics.record_finish(request_id, "cancelled")
            ts0 = self._req_submit_ts.pop(request_id, None)
            if tr.enabled and ts0 is not None:
                tr.complete("req/queue", ts0, cat="request", rid=request_id,
                            outcome="cancelled", **self._obs_args)
            return True
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.request_id == request_id:
                self._release(slot)
                self.status[request_id] = "cancelled"
                self.metrics.record_finish(request_id, "cancelled")
                ts0 = self._req_admit_ts.pop(request_id, None)
                if tr.enabled and ts0 is not None:
                    tr.complete("req/decode", ts0, cat="request", rid=request_id,
                                outcome="cancelled", **self._obs_args)
                return True
        return False

    def _release(self, slot: int) -> None:
        self._active[slot] = False
        self._slot_req[slot] = None
        self.pool.release(slot)
        self._slot_len[slot] = 0
        self._slot_limit[slot] = 0

    def preempt(self, request_id: int) -> bool:
        raise NotImplementedError(f"Engine.preempt waits for {ADMISSION_ITEM}")

    def reconfigure(self, spec):
        raise NotImplementedError(f"Engine.reconfigure waits for {FLEET_ITEM}")

    def recover(self):
        raise NotImplementedError(f"Engine.recover waits for {RECOVER_ITEM}")

    def run_until_idle(self, max_ticks: int = 100_000) -> List[StepEvents]:
        events = []
        while not self.idle:
            if len(events) >= max_ticks:
                raise RuntimeError(f"engine not idle after {max_ticks} ticks")
            events.append(self.step())
        return events

    def close(self) -> None:
        self._profiler.close()
        self.metrics.flush()

    # -- admission --------------------------------------------------------

    def _bucket_len(self, n: int) -> int:
        b = self.min_prefill_bucket
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _admit_dispatch(self, reqs):
        """Claim slots (and reserve and allocate blocks), then one ragged
        prefill of the batch into them; the first tokens stay on the card."""
        tr = self.tracer
        now = tr.now() if tr.enabled else 0.0
        for r in reqs:
            self.metrics.record_admit(r.request_id)
            ts0 = self._req_submit_ts.pop(r.request_id, None)
            if tr.enabled:
                if ts0 is not None:
                    tr.complete("req/queue", ts0, cat="request", rid=r.request_id,
                                outcome="admitted", **self._obs_args)
                self._req_admit_ts[r.request_id] = now
        slots = self.pool.claim_many(len(reqs))
        assert len(slots) == len(reqs), "scheduler admitted beyond free slots"
        for slot, req in zip(slots, reqs):
            self._slot_req[slot] = req
        lens_host = [r.prompt.size for r in reqs]
        s0 = self._bucket_len(max(lens_host))
        ids = np.zeros((len(reqs), s0), np.int64)
        for i, r in enumerate(reqs):
            ids[i, s0 - r.prompt.size:] = r.prompt
        dev = self.device
        ids_t = torch.as_tensor(ids).to(dev)
        lens = torch.as_tensor(np.asarray(lens_host, np.int64)).to(dev)
        slots_t = torch.as_tensor(np.asarray(slots, np.int64)).to(dev)
        keys = prng.key_data([r.rng_seed for r in reqs], dev)
        pool = self.pool
        if self.paged:
            s0_pages = -(-s0 // self.page_size)
            page_rows = np.full((len(reqs), s0_pages), pool.num_blocks, np.int64)
            limits = np.zeros((len(reqs),), np.int64)
            for i, (slot, r) in enumerate(zip(slots, reqs)):
                budget = r.prompt.size + r.max_new_tokens
                pool.reserve(slot, budget)
                pool.alloc_to(slot, r.prompt.size)
                n = pool.blocks_for(r.prompt.size)
                page_rows[i, :n] = pool.page_table[slot, :n]
                limits[i] = budget
                self._slot_len[slot] = r.prompt.size
                self._slot_limit[slot] = budget
            self._admit_shapes.add((len(reqs), s0, s0_pages))
            _, _, logits = prefill_paged(self.params, self.cfg, ids_t, lens, pool.k, pool.v,
                                         torch.as_tensor(page_rows).to(dev))
            self._limit[slots_t] = torch.as_tensor(limits).to(dev)
        else:
            for slot, r in zip(slots, reqs):
                self._slot_len[slot] = r.prompt.size
            self._admit_shapes.add((len(reqs), s0))
            cache, logits = prefill(self.params, self.cfg, ids_t, self.max_len, lengths=lens)
            pool.k[:, slots_t] = cache.k.to(pool.k.dtype)
            pool.v[:, slots_t] = cache.v.to(pool.v.dtype)
        tok0 = sample_token(logits, keys, torch.zeros_like(lens), self.temperature,
                            self.top_k)
        pool.lengths[slots_t] = lens
        self._cur_tok[slots_t] = tok0
        self._gen[slots_t] = 1
        self._rngs[slots_t] = keys
        for r in reqs:
            self.metrics.record_admission(computed_tokens=r.prompt.size)
            if tr.enabled:
                tr.event("req/admit", cat="request", rid=r.request_id,
                         computed_tokens=int(r.prompt.size), skipped_tokens=0,
                         shared_blocks=0, **self._obs_args)
        return reqs, slots, tok0

    def _admit_finish(self, state, emitted, finished, admitted) -> None:
        """Read the batch's first tokens back, activate the slots, emit."""
        reqs, slots, tok0 = state
        for slot, req, tok in zip(slots, reqs, tok0.cpu().tolist()):
            self._active[slot] = True
            self.status[req.request_id] = "running"
            admitted.append(req.request_id)
            self._emit(slot, req, int(tok), emitted, finished, first=True)

    def _emit(self, slot: int, req: Request, token: int, emitted, finished,
              first: bool) -> None:
        rid = req.request_id
        out = self.results[rid]
        out.append(token)
        emitted.append((rid, token))
        self.metrics.record_token(rid, first=first)
        reason = None
        if req.eos_id is not None and token == req.eos_id:
            reason = "eos"
        elif len(out) >= req.max_new_tokens:
            reason = "length"
        if reason is None:
            return
        self._release(slot)
        self.status[rid] = "done"
        finished.append((rid, reason))
        self.metrics.record_finish(rid, reason)
        tr = self.tracer
        ts0 = self._req_admit_ts.pop(rid, None)
        if tr.enabled and ts0 is not None:
            tr.complete("req/decode", ts0, cat="request", rid=rid, outcome=reason,
                        tokens=len(out), **self._obs_args)


def _tree_to(tree, device):
    """Every tensor of a nested dict on ``device`` (no copy when it is
    there already)."""
    if isinstance(tree, dict):
        return {key: _tree_to(child, device) for key, child in tree.items()}
    return tree.to(device)
