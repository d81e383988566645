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

**Prefix sharing** (``prefix_cache``, paged pool only): a request whose
leading prompt pages match live blocks (``cache_pool.PrefixCache``) maps
its page table onto them, reserves and prefills only its unshared tail;
with ``cow_tails`` a partial tail page is shared too and forked before the
sharer's first write into it. **Speculative decoding** (``speculate_k``):
a draft model proposes ``k`` tokens from its own fixed-layout cache, the
target scores all ``k + 1`` positions in one verify step, and the accept
rule emits up to ``k + 1`` tokens a slot per tick: greedy streams are the
plain engine's, sampled ones follow JAX's rejection sampling draw for draw.

**Admission control** (``admission``): an
:class:`~gradaccum_tpu_torch.serving.admission.AdmissionPolicy` reserves a
length-quantile or one-page budget instead of the worst case, so the paged
pool can run dry mid-stream; allocation then raises ``PoolPressure`` and the
engine preempts the cheapest victim (``pick_victim``, or
``victim_score``), parks it ahead of fresh admissions and resumes it when
blocks free up: from the host store (``swap="host"``, sha-checked), from the
host and disk ladder (``swap="tiered"``, ``memory/tiers.py``), or by
re-prefilling prompt + generated-so-far (``swap="recompute"``). Either way
the stream is the uninterrupted one, token for token. ``preempt(rid)``
does the same on demand. **int8 KV** (``cache_dtype=torch.int8``, paged
only): one float32 scale per head vector (``memory/quant.py``).
**overlap_prefill**: the admission's prefill and the tick's decode are both
queued on the card before either is read back.

**Faults.** The tick fires the serving fault points of
``resilience/faults.py``: ``MID_DECODE_TICK`` between admission and the
decode dispatch (with ``overlap_prefill``, after both dispatches and before
any readback), ``POOL_PAGE_TABLE`` before a paged pool's blocks grow (its
``corrupt`` kind poisons a page-table row, which the upload-time bounds
check turns into ``BlockTableCorruption`` on the same tick), and the
``slow_tick`` kind at either. :meth:`Engine.recover` resets the host
bookkeeping after a failed ``step()`` and hands back the requests that were
in slots; ``ServingServer`` requeues them.

**Live reconfiguration** (:meth:`Engine.reconfigure`,
``serving/reconfig.py``): a pool resize or a checkpoint swap between ticks,
through the same preempt -> park -> resume path; ``replica_id``,
``id_start`` and ``id_stride`` let ``serving/replicated.py`` run several
engines as one fleet.

**The serving mesh** (``mesh=parallel.mesh.serving_mesh(tp)``): tensor-
parallel decode over the ``model`` axis, one process per rank. Each rank
holds its block of the weights under ``gpt_tp_rules`` and its
``num_heads / tp`` heads of the pool (and of the draft cache); the
decode functions issue the collectives (``models/gpt_decode.py``), and
every rank samples the same tokens from the same gathered logits. JAX
runs such an engine as one GSPMD program; here every rank runs the whole
engine, so **the SPMD contract** holds it together: every rank makes the
same public calls (``submit``, ``step``, ``cancel``, ``preempt``,
``recover``, ``reconfigure``) in the same order, with the same arguments,
and an injected fault is scheduled alike on every rank. Every decision
of the engine reads its host bookkeeping and its tick clock, never wall
time or thread timing, so identical calls give identical bookkeeping on
every rank and the collectives pair up. A fault on one rank alone is out
of scope: its peers wait in a collective until the group's timeout.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gradaccum_tpu_torch.interop import params_tree
from gradaccum_tpu_torch.memory.quant import QuantKV, kv_map
from gradaccum_tpu_torch.models.gpt import GPTConfig
from gradaccum_tpu_torch.models.gpt_decode import (
    DecodeCache,
    _top_k_mask,
    decode_step_paged,
    decode_step_ragged,
    gather_blocks,
    init_cache,
    prefill,
    prefill_paged,
    prefill_paged_cow,
    sample_token,
    scatter_blocks,
    verify_step_paged,
    verify_step_ragged,
)
from gradaccum_tpu_torch.obs import trace as obs_trace
from gradaccum_tpu_torch.parallel.mesh import MODEL_AXIS
from gradaccum_tpu_torch.parallel.sharding import gather_params, shard_params
from gradaccum_tpu_torch.parallel.tp import gpt_tp_rules
from gradaccum_tpu_torch.resilience import faults
from gradaccum_tpu_torch.serving import admission as admission_lib
from gradaccum_tpu_torch.serving.cache_pool import (
    CachePool,
    PagedCachePool,
    PoolPressure,
    PrefixCache,
)
from gradaccum_tpu_torch.serving.metrics import ServingMetrics
from gradaccum_tpu_torch.serving.scheduler import QueueFull, Request, Scheduler
from gradaccum_tpu_torch.serving.swap import HostSwapStore, SwapError, to_device, to_host
from gradaccum_tpu_torch.utils import prng
from gradaccum_tpu_torch.utils.platform import resolve_device, upload
from gradaccum_tpu_torch.utils.profiling import StepWindowProfiler
from gradaccum_tpu_torch.utils.tree import map_state


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


def _block_bucket(n: int) -> int:
    """The power-of-two bucket of a swap's block-id count, one definition
    for the gather out and the scatter back."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


@dataclasses.dataclass
class _ParkedState:
    """What resumes a preempted slot token for token: its per-slot card
    state read back at preemption, and (swapped) a record in the swap store.
    ``generated`` is the emitted-token count at preemption."""

    request: Request
    generated: int
    cur_tok: int
    gen_count: int
    rng_key: np.ndarray
    length: int
    limit: int
    swapped: bool     # the swap store holds a record for this request
    page_start: int   # leading pages that were shared-prefix blocks


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
    was BLOCKS) instead of preempting. ``admission`` (a policy or one of
    ``"reserve"``, ``"quantile"``, ``"optimistic"``; the last two paged only)
    admits on a smaller budget and preempts on pressure; ``swap`` picks where
    a victim's K/V waits (``"host"``, ``"tiered"``, or ``"recompute"`` for
    nowhere), ``swap_max_bytes`` caps the host store (the tiered store's host
    rung), ``victim_score`` (``"deadline"`` or ``callable(engine, slot)``)
    ranks victims. ``cache_dtype=torch.int8`` (or ``"int8"``) quantizes the
    paged pool. ``overlap_prefill`` queues the admission's prefill and the
    decode before reading either back.

    ``mesh`` (``parallel.mesh.serving_mesh(tp)``) runs this engine as one
    rank of a tensor-parallel replica (module docstring: the SPMD
    contract). ``params`` is then the whole tree, cut here to this rank's
    block, or this rank's block already (a fleet places its weights once
    for all its replicas). JAX's refusals hold word for word: a mesh
    without a ``model`` axis, heads, intermediate or vocabulary (the
    draft's too) that the axis does not divide, and a ``num_blocks`` it does
    not divide (JAX splits the paged pool on blocks; the port splits every
    pool on heads, which gives the same streams, and keeps the refusal).

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
        if speculate_k > 0:
            if draft_params is None or draft_cfg is None:
                raise ValueError(
                    "speculate_k needs draft_params and draft_cfg "
                    "(models/gpt_decode.truncate_draft_params carves a "
                    "draft from the target's own weights)")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab {draft_cfg.vocab_size} != target vocab "
                                 f"{cfg.vocab_size} — the draft proposes target tokens")
            if decode_block != 1 or decode_block_set is not None:
                raise ValueError(
                    "speculate_k already advances up to k+1 positions per "
                    "dispatch (it IS the block knob); use decode_block=1 "
                    "without decode_block_set")
        admission_policy = admission_lib.resolve_policy(admission)
        if swap not in ("host", "recompute", "tiered"):
            raise ValueError(f"swap must be 'host', 'recompute', or 'tiered', got {swap!r}")
        if isinstance(cache_dtype, str) and cache_dtype == "int8":
            cache_dtype = torch.int8
        self._kv_quant = cache_dtype is not None and cache_dtype == torch.int8
        if self._kv_quant:
            if page_size is None:
                raise ValueError("cache_dtype=int8 needs paged mode (page_size=...): "
                                 "the quantization scales live per pool block vector")
            if speculate_k > 0:
                raise ValueError("cache_dtype=int8 does not compose with speculate_k: the "
                                 "draft cache is fixed-layout (use bf16 for speculative "
                                 "engines)")
        if (admission_policy is not None and admission_policy.mode != "reserve"
                and page_size is None):
            raise ValueError(f"admission mode {admission_policy.mode!r} needs paged mode "
                             "(page_size=...): overcommit is accounted in KV blocks")
        if not (victim_score is None or victim_score == "deadline" or callable(victim_score)):
            raise ValueError(f"victim_score must be None, 'deadline', or a callable; "
                             f"got {victim_score!r}")
        if page_size is not None and num_blocks is None:
            num_blocks = num_slots * max_len // int(page_size)  # the fixed pool's bytes
        tp = 1
        if mesh is not None:
            if MODEL_AXIS not in mesh.axis_names:
                raise ValueError(
                    f"serving mesh needs a '{MODEL_AXIS}' axis, got {mesh.axis_names} "
                    "(parallel.mesh.serving_mesh builds one)")
            tp = int(mesh.shape[MODEL_AXIS])
            for what, dim in (("num_heads", cfg.num_heads),
                              ("intermediate_size", cfg.intermediate_size),
                              ("vocab_size", cfg.vocab_size)):
                if dim % tp:
                    raise ValueError(f"cfg.{what}={dim} not divisible by the model axis "
                                     f"({tp}) — gpt_tp_rules shards it")
            if page_size is not None and num_blocks % tp:
                raise ValueError(f"num_blocks {num_blocks} not divisible by the model axis "
                                 f"({tp}) — the paged pool shards its BLOCK axis")
            if speculate_k > 0:
                for what, dim in (("num_heads", draft_cfg.num_heads),
                                  ("intermediate_size", draft_cfg.intermediate_size),
                                  ("vocab_size", draft_cfg.vocab_size)):
                    if dim % tp:
                        raise ValueError(f"draft_cfg.{what}={dim} not divisible by the model "
                                         f"axis ({tp}) — the draft shards like the target")
        self.mesh = mesh
        self.tp = tp
        # the model axis the decode functions sum and gather over; None runs
        # the whole model in this process (no mesh, or a one-rank one)
        self._model_axis = mesh.axis(MODEL_AXIS) if tp > 1 else None
        # an EMPTY PrefixCache is falsy (len 0) but still asks for sharing
        wants_prefix = bool(prefix_cache) or isinstance(prefix_cache, PrefixCache)
        if wants_prefix and page_size is None:
            raise ValueError("prefix_cache needs paged mode (page_size=...)")
        self.device = resolve_device(device)
        moved: Dict[int, torch.Tensor] = {}  # a draft's leaves that are the target's stay so
        placed: Dict[int, torch.Tensor] = {}
        self.cfg = cfg
        self.params = _tree_to(rank_tree(params, cfg, mesh, placed), self.device, moved)
        self.max_len = max_len
        self.temperature = float(temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.paged = page_size is not None
        self.page_size = None if page_size is None else int(page_size)
        self.cache_dtype = cache_dtype
        self.overlap_prefill = bool(overlap_prefill)
        # None keeps the worst-case gate; a policy brings preempt -> park ->
        # resume with it
        self.admission_policy = admission_policy
        self.victim_score = victim_score
        self.swap_mode = swap
        self.swap_max_bytes = None if swap_max_bytes is None else int(swap_max_bytes)
        if swap == "host":
            self._swap_store = HostSwapStore(max_bytes=self.swap_max_bytes)
        elif swap == "tiered":
            # host overflow demotes to disk; swap_max_bytes caps the host rung
            from gradaccum_tpu_torch.memory.tiers import TieredStore

            self._swap_store = (TieredStore(host_max_bytes=self.swap_max_bytes)
                                if self.swap_max_bytes is not None else TieredStore())
        else:
            self._swap_store = None
        self._parked_state: Dict[int, _ParkedState] = {}  # rid -> resume point
        # rid -> the policy budget this tick's admission gate admitted on
        self._pending_budget: Dict[int, int] = {}
        # the rid re-prefilling through _admit_dispatch as a resume
        self._resuming_rid: Optional[int] = None
        # an attached ServingServer pins its tick watchdog here, so planned
        # long operations (a victim's swap-out, a reconfiguration) can pause
        # the stall clock
        self.watchdog = None
        # live reconfiguration: True while reconfigure() quiesces and
        # rebuilds; the count numbers the MID_RECONFIG fault indices
        self.reconfiguring = False
        self._reconfig_count = 0
        self.last_reconfig = None
        self.speculate_k = int(speculate_k)
        self.draft_cfg = draft_cfg if self.speculate_k else None
        self.draft_params = (_tree_to(rank_tree(draft_params, draft_cfg or cfg, mesh, placed),
                                      self.device, moved) if self.speculate_k else None)
        if self.paged:
            if isinstance(prefix_cache, PrefixCache):
                # an injected cache's own cow flag wins
                self.prefix_cache: Optional[PrefixCache] = prefix_cache
                self.cow_tails = bool(cow_tails) and prefix_cache.cow
            else:
                self.prefix_cache = (PrefixCache(self.page_size, cow=bool(cow_tails))
                                     if wants_prefix else None)
                self.cow_tails = bool(cow_tails) and wants_prefix
            self.num_blocks = int(num_blocks)
            self.pool = PagedCachePool(cfg, num_slots, max_len, self.page_size,
                                       self.num_blocks, prefix_cache=self.prefix_cache,
                                       cache_dtype=cache_dtype, device=self.device, tp=tp)
            if admission_policy is not None and admission_policy.mode != "reserve":
                self.pool.allow_overcommit = True
        else:
            self.prefix_cache = None
            self.cow_tails = False
            self.num_blocks = None
            self.pool = CachePool(cfg, num_slots, max_len, cache_dtype=cache_dtype,
                                  device=self.device, tp=tp)
        # the draft's own cache: the fixed layout whatever the target's pool
        if self.speculate_k:
            dcache = init_cache(draft_cfg, num_slots, max_len, cache_dtype=cache_dtype,
                                device=self.device, tp=tp)
            self._draft_k, self._draft_v = dcache.k, dcache.v
        else:
            self._draft_k = self._draft_v = None
        self.replica_id = None if replica_id is None else int(replica_id)
        self._obs_args: Dict[str, object] = {}
        if self.replica_id is not None:
            self._obs_args["replica"] = self.replica_id
        if mesh is not None:
            self._obs_args["mesh"] = ",".join(f"{n}={mesh.shape[n]}" for n in mesh.axis_names)
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
        # copy-on-write: the absolute shared boundary of a slot's ADOPTED
        # partial tail block, 0 once forked (or never adopted); a write past
        # it forks the block first (_fork_cow)
        self._slot_cow = np.zeros((num_slots,), np.int64)
        # prefix matches found by this tick's admission gate, consumed by
        # _admit_dispatch: request_id -> (full blocks, cow tail block, tokens)
        self._pending_match: Dict[int, Tuple[List[int], Optional[int], int]] = {}
        # (request_id, shared blocks) of the queue head, for _bottleneck
        self._head_match_memo: Optional[Tuple[int, int]] = None

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

    # -- the serving mesh -------------------------------------------------

    def whole_params(self):
        """The whole serving decode tree from this rank's block: on a mesh,
        one all-gather per split leaf, so every rank must call it, in the
        same order (a checkpoint swap's template and ``params_digest`` read
        the whole tree)."""
        if self.tp == 1:
            return self.params
        return gather_params(self.params, self.mesh, gpt_tp_rules(), jax_layout=True)

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
        one per block size used (the speculative cycle is one more), never
        more with traffic (JAX counts its compiled tick programs)."""
        return len(self._tick_shapes)

    def prefill_compile_count(self) -> int:
        """Distinct (batch, bucketed length) signatures of the admission
        prefill, bounded by the bucket set (and the bucketed prefix pages:
        a prefix engine has a second admission family)."""
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
            "prefix_cache": self.prefix_cache is not None,
            "cow_tails": self.cow_tails,
            "victim_score": (None if self.victim_score is None
                             else self.victim_score if isinstance(self.victim_score, str)
                             else "custom"),
            "temperature": self.temperature,
            "top_k": self.top_k,
            "min_prefill_bucket": self.min_prefill_bucket,
            "mesh": (None if self.mesh is None
                     else {n: int(self.mesh.shape[n]) for n in self.mesh.axis_names}),
            "replica_id": self.replica_id,
            "speculate_k": self.speculate_k,
            "draft_num_layers": self.draft_cfg.num_layers if self.speculate_k else None,
            "cache_dtype": None if self.cache_dtype is None else _dtype_name(self.cache_dtype),
            "overlap_prefill": self.overlap_prefill,
            "admission": None if self.admission_policy is None else self.admission_policy.mode,
            "admission_q": (self.admission_policy.q if self.admission_policy is not None
                            and self.admission_policy.mode == "quantile" else None),
            "swap": self.swap_mode,
            "swap_max_bytes": self.swap_max_bytes,
            "memory": {"kv_quant": self._kv_quant, "token_bytes": self._token_bytes,
                       "tiered_swap": self.swap_mode == "tiered"},
            "healer": getattr(self, "healer_knobs", None),
        }

    def memory_stats(self) -> dict:
        """Bytes per token at the pool's storage layout, the bytes the pool
        charges for what is in flight, an int8 pool's saving against the
        model dtype, and under ``swap="tiered"`` the ladder's counters."""
        if self.paged:
            used_tokens = self.pool.allocated_blocks * self.page_size
        else:
            used_tokens = self.pool.active_count * self.max_len
        out = {"kv_quant": self._kv_quant, "token_bytes": self._token_bytes,
               "kv_bytes_in_use": used_tokens * self._token_bytes}
        if self._kv_quant:
            full = 2 * self.cfg.num_layers * self.cfg.hidden_size * self.cfg.dtype.itemsize
            out["kv_bytes_saved"] = used_tokens * (full - self._token_bytes)
        if self.swap_mode == "tiered":
            out["tiers"] = self._swap_store.stats()
        return out

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
            policy = self.admission_policy
            if self.scheduler.parked_depth:
                # preempted requests resume ahead of everything
                return tag + "parked requests ahead (preemption backlog)"
            head = self.scheduler.peek()
            if head is None:
                need = 1
            else:
                # what admission would ask: the policy's budget (the worst
                # case without one), only the head's unshared blocks
                budget = head.prompt.size + head.max_new_tokens
                if policy is not None:
                    budget = policy.budget_tokens(head.prompt.size, head.max_new_tokens,
                                                  self.page_size, self._tick)
                need = self.pool.blocks_for(budget)
                if self.prefix_cache is not None:
                    memo = self._head_match_memo
                    if memo is None or memo[0] != head.request_id:
                        memo = (head.request_id, len(self.prefix_cache.match(head.prompt)))
                        self._head_match_memo = memo
                    need -= memo[1]
            if policy is not None and policy.mode != "reserve":
                # overcommit: the supply is bounded by the free list too
                if need > self.pool.admittable_blocks:
                    if self.pool.free_blocks > 0:
                        return tag + "held by quantile gate"
                    return tag + "no free KV blocks"
            elif need > self.pool.unreserved_blocks:
                return tag + "no free KV blocks"
        return tag + "queue backlog (slots available)"

    @property
    def _token_bytes(self) -> int:
        """Pool bytes per cache position (K and V, all layers) at the pool's
        storage layout: an int8 pool pays one float32 scale per head."""
        if self._kv_quant:
            return 2 * self.cfg.num_layers * (self.cfg.hidden_size + self.cfg.num_heads * 4)
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
        preempted: List[int] = []

        for req in self.scheduler.expire(t):
            # a parked expiry forfeits its resume state, swap record included
            self._parked_state.pop(req.request_id, None)
            if self._swap_store is not None:
                self._swap_store.discard(req.request_id)
            self.status[req.request_id] = "timeout"
            finished.append((req.request_id, "timeout"))
            self.metrics.record_expired(req.request_id)
            self.metrics.record_finish(req.request_id, "timeout")
            ts0 = self._req_submit_ts.pop(req.request_id, None)
            if tr.enabled and ts0 is not None:
                tr.complete("req/queue", ts0, cat="request", rid=req.request_id,
                            outcome="timeout", **self._obs_args)

        # parked requests resume strictly ahead of fresh admissions
        resumed = self._try_resume()

        fits = None
        policy = self.admission_policy
        stall_override = [None]
        if self.paged:
            # reservations of earlier requests in this same admission batch
            # count: they reach the pool only inside _admit_dispatch
            pending = [0]
            self._pending_match.clear()

            def fits(r):
                full = r.prompt.size + r.max_new_tokens
                total = self.pool.blocks_for(full)
                if total > self.pool.max_pages:
                    return False
                match = (self.prefix_cache.match_cow(r.prompt)
                         if self.prefix_cache is not None else ([], None, 0))
                # only FULL shared pages cut the ask: an adopted COW tail
                # needs its fork block once the request writes that page
                if policy is None:
                    budget, need = full, total - len(match[0])
                    supply = self.pool.unreserved_blocks
                else:
                    # the policy's budget is the ask; under overcommit the
                    # free list bounds the supply too
                    budget = policy.budget_tokens(r.prompt.size, r.max_new_tokens,
                                                  self.page_size, t)
                    need = self.pool.blocks_for(budget) - len(match[0])
                    supply = self.pool.admittable_blocks
                if pending[0] + need > supply:
                    if (policy is not None and policy.mode != "reserve"
                            and self.pool.free_blocks > 0):
                        # blocks exist: the policy gate is what refused
                        stall_override[0] = "held_by_quantile_gate"
                    return False
                pending[0] += need
                self._pending_match[r.request_id] = match
                self._pending_budget[r.request_id] = budget
                return True

        if self.scheduler.parked_depth:
            # parked requests not yet resumed hold fresh admission entirely
            reqs = []
            if self.scheduler.depth:
                self.scheduler.record_stall("parked_queue_ahead")
        else:
            reqs = self.scheduler.admit(self.pool.free_count, t, fits=fits)
            if stall_override[0] is not None:
                self._relabel_stall(stall_override[0])
        block = self._pick_block()
        adv = self.speculate_k + 1 if self.speculate_k else block
        if self.overlap_prefill:
            # both dispatches are queued before any readback: the card rolls
            # from the prefill into the decode while the host emits the
            # admission's first tokens. The overlap holds only while nothing
            # between the two dispatches reads the card (no .item(),
            # .tolist(), bool(tensor), numpy conversion or blocking upload):
            # the uploads of both use _to_device. Tokens equal lockstep's.
            astate = None
            if reqs:
                with (tr.span("serve/prefill", cat="serving", tick=t, batch=len(reqs))
                      if tr.enabled else obs_trace.NULL.span("")):
                    astate = self._admit_dispatch(reqs)
                for slot, req in zip(astate[1], astate[0]):
                    self._active[slot] = True
                    self.status[req.request_id] = "running"
                    admitted.append(req.request_id)
            if self.scheduler.depth > 0 and self.pool.free_count == 0:
                self.scheduler.record_stall("no_free_slots")
            active_now = self._active.copy()
            if self.paged:
                self._page_table_fault(t)
                # admitted slots' first tokens are still on the card: they
                # may not be preempted this tick
                protect = (frozenset(int(s) for s in astate[1]) if astate is not None
                           else frozenset())
                active_now = self._ensure_blocks(active_now, adv, preempted, protect=protect)
            with self._decode_span(t, block, active_now):
                dstate = self._decode_dispatch(active_now, block) if active_now.any() else None
                # both dispatches in flight, nothing read back: recover()
                # hands back every request in a slot, the freshly admitted too
                faults.fire(faults.MID_DECODE_TICK, t)
                if astate is not None:
                    self._admit_finish(astate, emitted, finished, admitted, activate=False)
                if dstate is not None:
                    self._decode_finish(dstate, emitted, finished)
        else:
            if reqs:
                with (tr.span("serve/prefill", cat="serving", tick=t, batch=len(reqs))
                      if tr.enabled else obs_trace.NULL.span("")):
                    self._admit_finish(self._admit_dispatch(reqs), emitted, finished, admitted)
            if self.scheduler.depth > 0 and self.pool.free_count == 0:
                self.scheduler.record_stall("no_free_slots")
            # between admission and the decode dispatch: the requests in
            # slots at this instant are what recover() hands back
            faults.fire(faults.MID_DECODE_TICK, t)
            active_now = self._active.copy()
            if self.paged:
                self._page_table_fault(t)
                active_now = self._ensure_blocks(active_now, adv, preempted)
            if active_now.any():
                with self._decode_span(t, block, active_now):
                    self._decode_finish(self._decode_dispatch(active_now, block), emitted,
                                        finished)

        gauges = dict(tokens_in_flight=int(self._slot_len[self._active].sum()),
                      decode_block=block)
        if self.paged:
            gauges.update(token_capacity=self.pool.token_capacity,
                          kv_bytes_in_use=(self.pool.allocated_blocks * self.page_size
                                           * self._token_bytes),
                          free_blocks=self.pool.free_blocks)
            if self.prefix_cache is not None:
                gauges["shared_blocks"] = self.pool.shared_blocks
            if self.cow_tails:
                # distinct blocks shared sub-page (adopted, not forked yet)
                gauges["cow_shared_blocks"] = len({
                    int(self.pool.page_table[s, int(self._slot_cow[s]) // self.page_size])
                    for s in range(self.pool.num_slots) if self._slot_cow[s] > 0})
        else:
            gauges.update(token_capacity=self.pool.num_slots * self.max_len,
                          kv_bytes_in_use=(self.pool.active_count * self.max_len
                                           * self._token_bytes))
        if policy is not None:
            gauges.update(parked=self.scheduler.parked_depth, preemptions=len(preempted))
        if self._swap_store is not None and (policy is not None or self._swap_store.held_bytes
                                             or self.metrics.swap_store_bytes):
            # sampled through the decay back to zero after a storm
            gauges["swap_store_bytes"] = self._swap_store.held_bytes
        if self.swap_mode == "tiered":
            ts = self._swap_store.stats()
            gauges.update(tier_disk_bytes=ts["disk_bytes"], tier_demotions=ts["demotions"],
                          tier_promotions=ts["promotions"])
        self.metrics.record_tick(self.scheduler.depth, self.pool.active_count,
                                 self.pool.num_slots, **gauges)
        self._tick = t + 1
        return StepEvents(emitted, finished, admitted, t, preempted=preempted, resumed=resumed)

    def _relabel_stall(self, key: str) -> None:
        """Rewrite the generic no_free_blocks stall the scheduler just
        recorded into the policy-aware ``key``."""
        stalls, label = self.scheduler.stalls, self.scheduler.label
        generic = "no_free_blocks" if label is None else f"{label}: no_free_blocks"
        named = key if label is None else f"{label}: {key}"
        if stalls.get(generic):
            stalls[generic] -= 1
            if not stalls[generic]:
                del stalls[generic]
            stalls[named] = stalls.get(named, 0) + 1

    def _decode_span(self, t: int, block: int, active_now):
        """The tick's ``serve/decode`` span (a null span when tracing is off
        or no slot decodes)."""
        tr = self.tracer
        if not (tr.enabled and active_now.any()):
            return obs_trace.NULL.span("")
        args = dict(block=block, active=int(active_now.sum()))
        if self.speculate_k:
            args["speculate_k"] = self.speculate_k
        if self.paged:
            args["free_blocks"] = self.pool.free_blocks
        return tr.span("serve/decode", cat="serving", tick=t, **args)

    def _decode_dispatch(self, active_now, block: int):
        """Run this tick's decode on every slot and keep the device state:
        ``block`` micro-steps, or one speculative cycle. The tokens stay on
        the card until :meth:`_decode_finish` reads them back once."""
        pool = self.pool
        active = upload(active_now, self.device)
        table = pool.page_table_device() if self.paged else None
        if self.speculate_k:
            self._tick_shapes.add(("spec", self.speculate_k, tuple(pool.k.shape),
                                   str(pool.k.dtype), tuple(self._draft_k.shape),
                                   None if table is None else tuple(table.shape)))
            # the host length mirror advances at finish: by the accept count
            return "spec", active_now, self._spec_cycle(active, table)
        self._tick_shapes.add((block, tuple(pool.k.shape), str(pool.k.dtype),
                               None if table is None else tuple(table.shape)))
        lengths, cur, gen = pool.lengths, self._cur_tok, self._gen
        toks = []
        for _ in range(block):
            if self.paged:
                _, _, lengths, logits = decode_step_paged(
                    self.params, self.cfg, pool.k, pool.v, table, lengths, cur, active,
                    self._limit, mesh=self._model_axis)
            else:
                cache, logits = decode_step_ragged(
                    self.params, self.cfg, DecodeCache(pool.k, pool.v, lengths), cur, active,
                    mesh=self._model_axis)
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
        return "plain", active_now, torch.stack(toks)

    def _spec_keys(self, index, salt: int):
        """JAX's spec-cycle keys: ``fold_in(fold_in(rng, index), salt)`` for
        each slot's stream (``index`` ``[S]`` or ``[S, n]``)."""
        rngs = self._rngs if index.dim() == 1 else self._rngs[:, None, :]
        return prng.fold_in(prng.fold_in(rngs, index), salt)

    def _spec_mask(self, logits):
        return _top_k_mask(logits, self.top_k) if self.top_k is not None else logits

    def _draft_draw(self, logits, index):
        """One sampled draft column: the draw (salt 1) and the draft's
        distribution it was drawn from, ``[S]`` and ``[S, V]``."""
        t = torch.full((), self.temperature, dtype=torch.float32, device=self.device)
        masked = self._spec_mask(logits)
        return (prng.categorical(self._spec_keys(index, 1), torch.div(masked, t)),
                torch.softmax(torch.div(masked.float(), t), dim=-1))

    def _spec_cycle(self, active, table):
        """One speculative cycle (JAX's ``_make_spec_tick_fn``): the draft
        proposes ``k`` tokens on its own cache (plus one more write, so an
        all-accepted cycle leaves no hole at ``pos + k``), the target scores
        the ``k + 1`` positions in one verify step, and the accept rule
        turns both into up to ``k + 1`` tokens a slot. Greedy accepts the
        longest run of drafts equal to the target's argmaxes and emits the
        argmaxes, the plain engine's stream; sampled mode keeps draft ``d_j``
        with probability ``min(1, p_t / p_d)`` and draws the first rejected
        column from ``max(p_t - p_d, 0)`` renormalized. Every draw folds the
        slot's key with ``pos * (k + 2) + column``, then the salt: 1 for the
        draft's draws, 2 for the accept uniforms, 3 for the final draw.
        Nothing rolls back: lengths advance by the accept count, and what
        lies past them is masked on both caches. Returns ``[S, k + 2]``:
        the ``k + 1`` tokens and the count to emit."""
        k, pool = self.speculate_k, self.pool
        pos, cur = pool.lengths, self._cur_tok
        base = pos * (k + 2)
        sampled = self.temperature > 0
        dcache = DecodeCache(self._draft_k, self._draft_v, pos)
        tok, drafts, p_draft = cur, [], []
        for j in range(k):
            dcache, logits = decode_step_ragged(self.draft_params, self.draft_cfg, dcache, tok,
                                                active, mesh=self._model_axis)
            if sampled:
                nxt, p_d = self._draft_draw(logits, base + j)
                p_draft.append(p_d)
            else:
                nxt = torch.argmax(logits, dim=-1)
            tok = torch.where(active, nxt, tok)
            drafts.append(tok)
        decode_step_ragged(self.draft_params, self.draft_cfg, dcache, tok, active,
                           mesh=self._model_axis)
        d_bt = torch.stack(drafts, dim=1)  # [S, k]
        tokens_in = torch.cat([cur[:, None], d_bt], dim=1)
        if self.paged:
            _, _, logits = verify_step_paged(self.params, self.cfg, pool.k, pool.v, table, pos,
                                             tokens_in, active, self._limit,
                                             mesh=self._model_axis)
        else:
            _, logits = verify_step_ragged(self.params, self.cfg,
                                           DecodeCache(pool.k, pool.v, pos), tokens_in, active,
                                           mesh=self._model_axis)
        rows = torch.arange(pos.shape[0], device=self.device)
        if sampled:
            t = torch.full((), self.temperature, dtype=torch.float32, device=self.device)
            p_t = torch.softmax(torch.div(self._spec_mask(logits).float(), t), dim=-1)
            p_d = torch.stack(p_draft, dim=1)  # [S, k, V]
            pt_d = torch.gather(p_t[:, :k], 2, d_bt[..., None])[..., 0]
            pd_d = torch.gather(p_d, 2, d_bt[..., None])[..., 0]
            cols = base[:, None] + torch.arange(k, device=self.device)[None, :]
            us = prng.uniform(self._spec_keys(cols, 2), ())  # [S, k]
            match = us * pd_d.clamp(min=1e-20) <= pt_d
            acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
            # past the last draft the "draft" distribution is the target's
            # own, so an all-accepted row draws its bonus from p_t
            p_d_ext = torch.cat([p_d, p_t[:, k:]], dim=1)
            p_t_a, p_d_a = p_t[rows, acc], p_d_ext[rows, acc]
            resid = (p_t_a - p_d_a).clamp(min=0.0)
            rs = resid.sum(-1, keepdim=True)
            final_dist = torch.where(rs > 0, torch.div(resid, rs.clamp(min=1e-20)), p_t_a)
            final = prng.categorical(self._spec_keys(base + acc, 3), torch.log(final_dist))
            offs = torch.arange(k + 1, device=self.device)[None, :]
            d_ext = torch.cat([d_bt, final[:, None]], dim=1)
            out = torch.where(offs < acc[:, None], d_ext, final[:, None])
            new_cur = final
        else:
            tgt = torch.argmax(logits, dim=-1)  # [S, k+1]
            acc = torch.cumprod((tgt[:, :k] == d_bt).long(), dim=1).sum(dim=1)
            out, new_cur = tgt, tgt[rows, acc]
        counts = torch.where(active, acc + 1, torch.zeros_like(acc))
        new_len = pos + counts
        if self.paged:
            new_len = torch.minimum(new_len, self._limit)
        pool.lengths = new_len
        self._cur_tok = torch.where(active, new_cur, cur)
        self._gen = self._gen + counts
        return torch.cat([out, counts[:, None]], dim=1)

    def _decode_finish(self, state, emitted, finished) -> None:
        """Read the tick's tokens back (its one sync) and emit them. A
        speculative cycle emits each slot's own run of accept count + 1
        tokens; an eos or the budget inside the run drops the rest."""
        kind, active_now, toks = state
        toks_host = toks.cpu().numpy()
        if kind == "spec":  # [slots, k + 2]: the tokens, then the count
            counts = toks_host[:, -1]
            slots = np.nonzero(active_now)[0]
            self.metrics.record_speculation(
                proposed=int(self.speculate_k * len(slots)),
                accepted=int(np.maximum(counts[slots] - 1, 0).sum()))
            self._slot_len[active_now] = np.minimum(
                self._slot_len[active_now] + counts[active_now],
                self._slot_limit[active_now] if self.paged else self.max_len)
            for d in range(self.speculate_k + 1):
                for slot in slots:
                    req = self._slot_req[slot]
                    if d >= counts[slot] or req is None:  # rejected, or retired
                        continue
                    self._emit(int(slot), req, int(toks_host[slot, d]), emitted, finished,
                               first=False)
            return
        for d in range(toks_host.shape[0]):  # [block, slots]
            for slot in np.nonzero(active_now)[0]:
                req = self._slot_req[slot]
                if req is None:  # retired earlier in this block
                    continue
                self._emit(int(slot), req, int(toks_host[d, slot]), emitted, finished,
                           first=False)

    def _ensure_blocks(self, active_now, advance: int, preempted: List[int],
                       protect=frozenset()):
        """Grow every active slot's pages to this tick's worst-case end
        (``advance`` more positions, clamped at the write limit). Under the
        worst-case gate the supply is guaranteed; under an admission policy
        the pool may run dry (``PoolPressure``): preempt the cheapest victim
        (never the pressured slot, never a ``protect``-ed one) and retry.
        With no victim that frees a block, the pressured slot sits this tick
        out. A slot still riding a shared COW tail forks it first. Returns
        the (possibly narrowed) active mask."""
        tr = self.tracer
        for slot in list(np.nonzero(active_now)[0]):
            slot = int(slot)
            if not active_now[slot]:
                continue  # taken as a victim earlier in this loop
            while True:
                try:
                    if self._slot_cow[slot]:
                        self._fork_cow(slot)
                    self.pool.alloc_to(slot, min(self._slot_len[slot] + advance,
                                                 self._slot_limit[slot]))
                    break
                except PoolPressure as pressure:
                    # every resident slot stays a candidate, one that sat this
                    # tick out too: two pressured slots must not deadlock
                    candidates = [s for s, r in enumerate(self._slot_req)
                                  if r is not None and self._active[s] and s != slot
                                  and s not in protect]
                    victim = admission_lib.pick_victim(self.pool, candidates,
                                                       self.prefix_cache,
                                                       score=self._victim_scorer())
                    if victim is None:
                        active_now[slot] = False
                        if tr.enabled:
                            tr.event("serve/decode_skip", cat="serving", tick=self._tick,
                                     slot=slot, need=pressure.need_blocks, **self._obs_args)
                        break
                    self._preempt(victim, preempted)
                    active_now[victim] = False
        return active_now

    def _page_table_fault(self, t: int) -> None:
        """The ``pool_page_table`` fault point: its ``corrupt`` kind writes
        an out-of-range block id into the first claimed slot's page-table
        row. The pool's upload-time bounds check turns it into
        ``BlockTableCorruption`` on this very tick (no kernel or gather ever
        sees it); recover's release resets the row."""
        if faults.fire(faults.POOL_PAGE_TABLE, t) == faults.KIND_CORRUPT:
            for slot, req in enumerate(self._slot_req):
                if req is not None:
                    self.pool.page_table[slot, 0] = self.pool.num_blocks + 7
                    self.pool._table_device = None
                    break

    def _wd_suspend(self):
        """Suspend the attached server watchdog (a null context when none)
        across a planned long operation: a reconfiguration's preempt-all and
        rebuild, or a victim's swap-out inside a preemption burst, is not a
        wedged dispatch."""
        wd = self.watchdog
        return wd.suspend() if wd is not None else contextlib.nullcontext()

    def _victim_scorer(self):
        """The ``victim_score`` knob as a per-slot cost for ``pick_victim``
        (None: the stock refcount and prefix-liveness cost)."""
        if self.victim_score is None:
            return None
        if callable(self.victim_score):
            return lambda slot: self.victim_score(self, slot)

        def score(slot):
            req = self._slot_req[slot]
            done = len(self.results.get(req.request_id, ()))
            return admission_lib.deadline_victim_cost(
                self.pool, slot, self.prefix_cache,
                progress=done / max(req.max_new_tokens, 1),
                waited=self._tick - req.submit_tick)

        return score

    def _fork_cow(self, slot: int) -> None:
        """Fork the slot's adopted partial tail block before its first write
        past ``cow_limit``: the pool gives the page a private block and the
        card copies the one block (both leaves of an int8 pool); a fork the
        pool elides (the slot held the last reference) only trims the tail
        index past the slot's own extent. Raises ``PoolPressure`` like any
        growth."""
        pool = self.pool
        cow = int(self._slot_cow[slot])
        page = cow // self.page_size
        old = pool.fork_cow(slot, page)
        if old is None:
            if self.prefix_cache is not None:
                self.prefix_cache.trim_tail(int(pool.page_table[slot, page]),
                                            cow % self.page_size)
            self.metrics.record_cow_fork(elided=True)
        else:
            new = int(pool.page_table[slot, page])

            def copy(a):
                a[:, new] = a[:, old]
                return a

            kv_map(copy, pool.k)
            kv_map(copy, pool.v)
            self.metrics.record_cow_fork(elided=False)
        self._slot_cow[slot] = 0
        tr = self.tracer
        if tr.enabled:
            tr.event("serve/cow_fork", cat="serving", tick=self._tick, slot=slot,
                     elided=old is None, **self._obs_args)

    # -- preempt -> park -> resume ------------------------------------------

    def _gather_tail(self, blocks: List[int]):
        """Whole blocks off the card into host numpy, ``(k, v)`` (dicts of
        leaves for an int8 pool) and the dtype names of raw-bit leaves. The
        ids are padded to a power of two with real ids (the gather clamps
        nothing out of range) and the padding is cut before the copy. The
        copy is synchronous: the blocks go back to the free list next."""
        n = len(blocks)
        ids = np.full((_block_bucket(n),), blocks[0], np.int64)
        ids[:n] = blocks
        kb, vb = gather_blocks(self.pool.k, self.pool.v, upload(ids, self.device))
        arrays, dtypes = {}, {}
        for name, blk in (("k", kb), ("v", vb)):
            leaves = ({f"{name}_q": blk.q, f"{name}_scale": blk.scale}
                      if isinstance(blk, QuantKV) else {name: blk})
            for leaf, t in leaves.items():
                arrays[leaf], dtype = to_host(t[:, :n])
                if dtype is not None:
                    dtypes[leaf] = dtype
        return arrays, dtypes

    def _stage_swap_out(self, slot: int, rid: int, length: int) -> Tuple[bool, int, int]:
        """Stage a victim's live PRIVATE blocks (the fixed pool: its slot
        row) in the swap store. Returns ``(swapped, page_start, bytes)``;
        ``page_start`` counts the leading shared pages left in the pool for
        their other users."""
        pool = self.pool
        page_start = 0
        arrays = None
        dtypes: Dict[str, str] = {}
        if self.paged:
            blocks = pool.blocks_of(slot)
            live = min(pool.blocks_for(length), len(blocks))
            for b in blocks[:live]:
                if pool.refcount(b) == 1 and pool.owner_of(b) == slot:
                    break
                page_start += 1
            tail = blocks[page_start:live]
            # sharing is prefix-shaped; anything else re-prefills rather than
            # copying blocks out from under their other users
            if tail and all(pool.refcount(b) == 1 and pool.owner_of(b) == slot for b in tail):
                arrays, dtypes = self._gather_tail(tail)
        else:
            arrays = {}
            for name, t in (("k", pool.k), ("v", pool.v)):
                arrays[name], dtype = to_host(t[:, slot])
                if dtype is not None:
                    dtypes[name] = dtype
        if arrays is None:
            return False, 0, 0
        if self.speculate_k:
            # a speculative victim parks its draft cache rows too
            for name, t in (("draft_k", self._draft_k), ("draft_v", self._draft_v)):
                arrays[name], dtype = to_host(t[:, slot])
                if dtype is not None:
                    dtypes[name] = dtype
        try:
            rec = self._swap_store.put(rid, arrays, page_start, length, dtypes)
            return True, page_start, rec.nbytes
        except OSError:
            # a swap-IO fault, or a record over the store's cap: the request
            # resumes by re-prefill
            self._swap_store.discard(rid)
            self.metrics.record_swap_fallback()
            return False, 0, 0

    def _preempt(self, slot: int, preempted: List[int], stage_swap: bool = True) -> None:
        """Evict the request in ``slot``: read its resume point back, stage
        its live private blocks in the swap store (shared prefix blocks are
        decref'd, never copied), release the slot, blocks and reservation,
        and park the request ahead of all fresh admissions.
        ``stage_swap=False`` parks without the card-to-host copy, for callers
        that know the bytes can never be restored (a weight swap, a replica
        drain that replays the request elsewhere)."""
        req = self._slot_req[slot]
        rid = req.request_id
        tr = self.tracer
        generated = len(self.results[rid])
        cur = int(self._cur_tok[slot])
        gen = int(self._gen[slot])
        key = self._rngs[slot].cpu().numpy().copy()
        length = int(self._slot_len[slot])
        limit = (int(self._slot_limit[slot]) if self.paged
                 else req.prompt.size + req.max_new_tokens)
        swapped, page_start, bytes_out = False, 0, 0
        if self._swap_store is not None and stage_swap:
            with self._wd_suspend():
                swapped, page_start, bytes_out = self._stage_swap_out(slot, rid, length)
        self._parked_state[rid] = _ParkedState(
            request=req, generated=generated, cur_tok=cur, gen_count=gen, rng_key=key,
            length=length, limit=limit, swapped=swapped,
            page_start=page_start if swapped else 0)
        # an unforked COW adoption goes with the slot's other references; the
        # resume re-adopts whatever is still live
        self._release(slot)
        self.scheduler.park(req)
        self.status[rid] = "preempted"
        preempted.append(rid)
        if self.admission_policy is not None:
            self.admission_policy.note_preemption(self._tick)
        self.metrics.record_preemption(swapped=swapped, bytes_out=bytes_out)
        if tr.enabled:
            tr.event("req/preempt", cat="request", rid=rid, swapped=swapped,
                     generated=generated, swap_bytes=bytes_out, **self._obs_args)

    def preempt(self, request_id: int) -> bool:
        """Preempt a RUNNING request: its slot (and private blocks and
        reservation) come back at once, it parks ahead of fresh admissions,
        and its output is the uninterrupted run's, token for token. False for
        an id not running. Not thread-safe: through a server, stop its loop
        or hold its lock."""
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.request_id == request_id and self._active[slot]:
                self._preempt(slot, [])
                return True
        return False

    def _try_resume(self) -> List[int]:
        """Re-admit parked requests, oldest first, as far as resources allow
        (the head blocks those behind it). Returns the ids resumed."""
        resumed: List[int] = []
        while self.scheduler.parked_depth:
            req = self.scheduler.peek_parked()
            pk = self._parked_state.get(req.request_id)
            if pk is None:  # resume state lost: drop the stale entry
                self.scheduler.pop_parked()
                continue
            if self.pool.free_count == 0 or not self._resume_one(req, pk):
                break
            resumed.append(req.request_id)
        return resumed

    def _fetch_swap(self, rid: int):
        """The verified swap record, or None after counting a fallback (a
        fault, a rotted or a missing record)."""
        try:
            return self._swap_store.get(rid)
        except (OSError, SwapError, KeyError):
            self._swap_store.discard(rid)
            self.metrics.record_swap_fallback()
            return None

    def _resume_one(self, req: Request, pk: _ParkedState) -> bool:
        """Try one parked request's re-admission: False, changing nothing,
        when resources are short."""
        rid = req.request_id
        pool = self.pool
        tr = self.tracer
        rec = None
        match: Tuple[List[int], Optional[int], int] = ([], None, 0)
        ext = None
        reserve_tokens = None
        adopt: List[int] = []
        if self.paged:
            # prefix-aware: both restore paths re-adopt what of prompt +
            # generated-so-far still lives in the prefix cache
            if self.prefix_cache is not None:
                prior = np.asarray(self.results[rid][:max(pk.generated - 1, 0)], np.int32)
                ext = np.concatenate([np.asarray(req.prompt, np.int32), prior])
                match = self.prefix_cache.match_cow(ext)
            # a swap restore needs the shared head alive in the prefix cache
            swap_ok = pk.swapped and self._swap_store is not None
            if swap_ok and pk.page_start:
                swap_ok = len(match[0]) >= pk.page_start
            adopt = match[0][:pk.page_start] if swap_ok else []

            def gate(n_adopt):
                """The full remaining worst case when it fits, else (policy
                engines) just enough to keep decoding; None: not yet."""
                tokens = pk.limit
                if pool.blocks_for(tokens) - n_adopt > pool.unreserved_blocks:
                    if not pool.allow_overcommit:
                        return None
                    tokens = min(pk.limit, pk.length + self.page_size)
                    if pool.blocks_for(tokens) - n_adopt > pool.unreserved_blocks:
                        return None
                if pool.blocks_for(pk.length) - n_adopt > pool.free_blocks:
                    return None
                return tokens

            # the re-prefill leg discounts only FULL matched pages, the swap
            # leg exactly its surviving shared head
            reserve_tokens = gate(len(adopt) if swap_ok else len(match[0]))
            if reserve_tokens is None:
                return False
            if swap_ok:
                # fetch and sha-check only once the resume commits
                rec = self._fetch_swap(rid)
                if rec is None:
                    # no reference was taken yet: re-gate for re-prefill
                    pk.swapped = False
                    adopt = []
                    reserve_tokens = gate(len(match[0]))
                    if reserve_tokens is None:
                        return False
        elif pk.swapped and self._swap_store is not None:
            rec = self._fetch_swap(rid)
        # resources committed: the request leaves the parked queue now
        self.scheduler.pop_parked()
        self._parked_state.pop(rid, None)
        if rec is not None:
            if self.paged:
                self._resume_swap_in(req, pk, rec, adopt, reserve_tokens)
            else:
                self._resume_fixed_swap_in(req, pk, rec)
            kind = "swap_in"
        else:
            self._resume_reprefill(req, pk, reserve_tokens,
                                   match=match if self.paged else None, ext=ext)
            kind = "reprefill"
        if self._swap_store is not None:
            self._swap_store.discard(rid)  # consumed, or superseded
        self.status[rid] = "running"
        self.metrics.record_resume(kind, bytes_in=rec.nbytes if rec else 0)
        if tr.enabled:
            tr.event("req/resume", cat="request", rid=rid, kind=kind, generated=pk.generated,
                     **self._obs_args)
        return True

    def _record_leaf(self, rec, name: str) -> torch.Tensor:
        return to_device(rec.arrays[name], rec.dtypes.get(name), self.device)

    def _resume_swap_in(self, req: Request, pk: _ParkedState, rec, adopt: List[int],
                        reserve_tokens: int) -> None:
        """Restore from the swap store: adopt the live shared head, allocate
        fresh private blocks, scatter the checked bytes into them, and
        reinstate the slot's card state."""
        pool = self.pool
        slot = pool.claim()
        self._slot_req[slot] = req
        pool.reserve(slot, reserve_tokens, shared_blocks=len(adopt))
        if adopt:
            pool.adopt_shared(slot, adopt)
        pool.alloc_to(slot, pk.length)
        n_pages = pool.blocks_for(pk.length)
        dst = [int(b) for b in pool.page_table[slot, pk.page_start:n_pages]]
        if self._kv_quant:
            kb = QuantKV(self._record_leaf(rec, "k_q"), self._record_leaf(rec, "k_scale"))
            vb = QuantKV(self._record_leaf(rec, "v_q"), self._record_leaf(rec, "v_scale"))
        else:
            kb, vb = self._record_leaf(rec, "k"), self._record_leaf(rec, "v")
        assert len(dst) == kb.shape[1], "swap record / page-table mismatch"
        # exactly the record's blocks: no padding id reaches the scatter
        scatter_blocks(pool.k, pool.v, upload(np.asarray(dst, np.int64), self.device), kb, vb)
        pool.lengths[slot] = pk.length
        self._restore_slot_state(slot, pk, rec)
        self._slot_len[slot] = pk.length
        self._slot_limit[slot] = pk.limit
        self._active[slot] = True

    def _resume_fixed_swap_in(self, req: Request, pk: _ParkedState, rec) -> None:
        """The fixed pool's restore: the swap unit is the slot's row."""
        pool = self.pool
        slot = pool.claim()
        self._slot_req[slot] = req
        pool.k[:, slot] = self._record_leaf(rec, "k")
        pool.v[:, slot] = self._record_leaf(rec, "v")
        pool.lengths[slot] = pk.length
        self._restore_slot_state(slot, pk, rec)
        self._slot_len[slot] = pk.length
        self._active[slot] = True

    def _restore_slot_state(self, slot: int, pk: _ParkedState, rec) -> None:
        self._cur_tok[slot] = pk.cur_tok
        self._gen[slot] = pk.gen_count
        self._rngs[slot] = torch.from_numpy(pk.rng_key).to(self.device)
        if self.paged:
            self._limit[slot] = pk.limit
        if self.speculate_k and rec is not None and "draft_k" in rec.arrays:
            self._draft_k[:, slot] = self._record_leaf(rec, "draft_k")
            self._draft_v[:, slot] = self._record_leaf(rec, "draft_v")

    def _resume_reprefill(self, req: Request, pk: _ParkedState,
                          reserve_tokens: Optional[int] = None, match=None, ext=None) -> None:
        """Recompute a parked request's K/V: re-prefill ``prompt +
        generated[:-1]`` through the normal admission, then pin the resume
        point (the admission's sampled token is dropped, never emitted, and
        the generation counter restored, so the stream folds the same rng
        indices). ``reserve_tokens`` is the reservation :meth:`_resume_one`
        checked, ``match`` its prefix lookup against the extended prompt."""
        rid = req.request_id
        if reserve_tokens is not None:
            self._pending_budget[rid] = int(reserve_tokens)
        if ext is None:
            prior = np.asarray(self.results[rid][:pk.generated - 1], np.int32)
            ext = np.concatenate([np.asarray(req.prompt, np.int32), prior])
        assert ext.size == pk.length, "resume point drifted from the mirror"
        if match is not None and (match[0] or match[2]):
            self._pending_match[rid] = match
        synth = Request(request_id=rid, prompt=ext, max_new_tokens=pk.limit - int(ext.size),
                        eos_id=req.eos_id, rng_seed=req.rng_seed,
                        deadline_tick=req.deadline_tick, submit_tick=req.submit_tick)
        self._resuming_rid = rid
        try:
            state = self._admit_dispatch([synth])
        finally:
            self._resuming_rid = None
            # the slot map points at the ORIGINAL request: retirement reads
            # its max_new_tokens
            for s, r in enumerate(self._slot_req):
                if r is synth:
                    self._slot_req[s] = req
        slot = int(state[1][0])
        self._cur_tok[slot] = pk.cur_tok
        self._gen[slot] = pk.gen_count
        self._active[slot] = True

    # -- lifecycle --------------------------------------------------------

    def pop_result(self, request_id: int) -> Tuple[List[int], str]:
        """Remove and return ``(tokens, status)`` of a finished request."""
        return self.results.pop(request_id), self.status.pop(request_id)

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued, parked or running request; a running one's slot
        (and on the paged pool its blocks and reservation) come back at once,
        a parked one's swap record goes. The
        partial result stays poppable with status "cancelled". False for an
        unknown or finished id. Not thread-safe: through a server, call
        ``ServingServer.cancel``."""
        tr = self.tracer
        if self.scheduler.cancel(request_id):
            # a parked request takes its resume state and swap record along
            self._parked_state.pop(request_id, None)
            if self._swap_store is not None:
                self._swap_store.discard(request_id)
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
        self._slot_cow[slot] = 0

    def reconfigure(self, spec):
        """Apply a live reconfiguration between ticks (``serving/reconfig.py``
        for the specs and the refuse/degrade contract): quiesce admissions,
        park every running slot, rebuild, and let the parked requests resume
        token for token on the next ticks. Not thread-safe: through a server,
        ``ServingServer.request_reconfig``."""
        from gradaccum_tpu_torch.serving import reconfig as reconfig_lib

        return reconfig_lib.apply(self, spec)

    def recover(self) -> List[Request]:
        """Reset the host bookkeeping after a failed ``step()``.

        Returns the requests that were in slots, running or mid-admission,
        with status "error": their slots, blocks, reservations and COW
        adoptions are released, their parked resume state and swap records
        dropped, their metrics lifecycle closed. Queued and parked requests
        stay where they are: they hold nothing on the card. The front-end
        decides what to do with the returned requests (the bounded requeue
        of :class:`~gradaccum_tpu_torch.serving.server.ServingServer`).

        The pool is never rebuilt (``serve/recover`` reports
        ``pool_rebuilt=False``). JAX rebuilds it when the failed dispatch
        consumed a donated buffer; the port writes its pool, draft cache
        and per-slot tensors in place, so a failed dispatch can leave them
        half written but never gone. Correctness rests on what it rests on
        in JAX: slot lengths gate every read (a released slot's stale K/V,
        in the pool or the draft cache, is masked until a prefill
        overwrites it), and a recovered request re-prefills from scratch.
        A half-done COW fork is safe the same way: the fork's block is in
        the slot's page table once the pool hands it out, so the release
        frees it with the rest. A CUDA error that poisons the context
        cannot be healed in process; the server's bounded
        ``max_engine_faults`` give-up is what catches it.

        On a serving mesh every rank recovers (the SPMD contract). JAX
        re-places the rebuilt pool on the mesh (``_apply_mesh``); the port
        never rebuilds it, so each rank keeps its own heads' pool as it
        was, and nothing is placed again."""
        failed = []
        tr = self.tracer
        self._pending_match.clear()
        self._pending_budget.clear()
        self._resuming_rid = None
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            rid = req.request_id
            failed.append(req)
            # a fault mid-resume: the request is back in the failed set, so
            # no leftover park bookkeeping may shadow the requeue
            self._parked_state.pop(rid, None)
            if self._swap_store is not None:
                self._swap_store.discard(rid)
            self._release(slot)
            self.status[rid] = "error"
            # close the metrics lifecycle, or its timers leak per fault
            self.metrics.record_finish(rid, "error")
            ts0 = self._req_admit_ts.pop(rid, None)
            if tr.enabled and ts0 is not None:
                tr.complete("req/decode", ts0, cat="request", rid=rid, outcome="error",
                            **self._obs_args)
        if tr.enabled:
            tr.event("serve/recover", cat="resilience", tick=self._tick, failed=len(failed),
                     pool_rebuilt=False, **self._obs_args)
        return failed

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
        """Claim slots (on the paged pool: adopt shared prefix blocks,
        reserve the unshared worst case, allocate the prompt's pages), then
        one ragged prefill of the batch into them, of each prompt's
        unshared tail only where a prefix matched; a speculative engine
        prefills the draft's cache beside it. The first tokens stay on the
        card."""
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
        prefix = self.prefix_cache is not None
        no_match = ([], None, 0)
        matches = [self._pending_match.pop(r.request_id, no_match) if prefix else no_match
                   for r in reqs]
        # shared: the whole shared extent (full pages and a COW tail; it may
        # be the whole prompt, whose redundant writes are dropped); start:
        # where recomputing begins, leaving the last prompt token at least
        shared = [len(full) * (self.page_size or 0) + tail_t for full, _, tail_t in matches]
        starts = [min(sh, r.prompt.size - 1) for sh, r in zip(shared, reqs)]
        tails = [r.prompt.size - st for r, st in zip(reqs, starts)]
        s0 = self._bucket_len(max(tails))
        ids = np.zeros((len(reqs), s0), np.int64)
        for i, r in enumerate(reqs):
            ids[i, s0 - tails[i]:] = r.prompt[starts[i]:]
        dev = self.device
        ids_t = upload(ids, dev)
        lens = upload(np.asarray(tails, np.int64), dev)
        slots_t = upload(np.asarray(slots, np.int64), dev)
        keys = upload(prng.key_data([r.rng_seed for r in reqs]), dev)
        full_ids, full_lens = ids_t, lens  # what the draft prefills: whole prompts
        pool = self.pool
        if self.paged:
            logits, signature = self._admit_paged(reqs, slots, matches, shared, starts, s0,
                                                  ids_t, lens)
            if self.speculate_k and any(starts):
                s0f = self._bucket_len(max(r.prompt.size for r in reqs))
                signature += (s0f,)
                full = np.zeros((len(reqs), s0f), np.int64)
                for i, r in enumerate(reqs):
                    full[i, s0f - r.prompt.size:] = r.prompt
                full_ids = upload(full, dev)
                full_lens = upload(np.asarray([r.prompt.size for r in reqs],
                                                       np.int64), dev)
            self._admit_shapes.add(signature)
        else:
            for slot, r in zip(slots, reqs):
                self._slot_len[slot] = r.prompt.size
            self._admit_shapes.add((len(reqs), s0))
            cache, logits = prefill(self.params, self.cfg, ids_t, self.max_len, lengths=lens,
                                    mesh=self._model_axis)
            pool.k[:, slots_t] = cache.k.to(pool.k.dtype)
            pool.v[:, slots_t] = cache.v.to(pool.v.dtype)
        if self.speculate_k:
            dcache, _ = prefill(self.draft_params, self.draft_cfg, full_ids, self.max_len,
                                lengths=full_lens, mesh=self._model_axis)
            self._draft_k[:, slots_t] = dcache.k.to(self._draft_k.dtype)
            self._draft_v[:, slots_t] = dcache.v.to(self._draft_v.dtype)
        tok0 = sample_token(logits, keys, torch.zeros_like(lens), self.temperature,
                            self.top_k)
        pool.lengths[slots_t] = upload(
            np.asarray([r.prompt.size for r in reqs], np.int64), dev)
        self._cur_tok[slots_t] = tok0
        self._gen[slots_t] = 1
        self._rngs[slots_t] = keys
        for i, r in enumerate(reqs):
            # the hit-rate denominator counts only admissions that COULD
            # hit: past one page, or (COW) past one token; a re-prefill
            # resume is billed but never counted as a second miss
            resuming = r.request_id == self._resuming_rid
            eligible = prefix and (r.prompt.size > self.page_size
                                   or (self.cow_tails and r.prompt.size > 1)) and not resuming
            full_m, _, tail_t = matches[i]
            n_shared = len(full_m) + (1 if tail_t else 0)
            self.metrics.record_admission(computed_tokens=tails[i], skipped_tokens=starts[i],
                                          shared_blocks=n_shared,
                                          prefix_hit=(starts[i] > 0) if eligible else None)
            if resuming and self.paged:
                # tokens a prefix-aware resume did not recompute
                self.metrics.record_resume_prefill(computed=tails[i], saved=starts[i])
            if tr.enabled:
                tr.event("req/admit", cat="request", rid=r.request_id,
                         computed_tokens=int(tails[i]), skipped_tokens=int(starts[i]),
                         shared_blocks=int(n_shared), **self._obs_args)
        return reqs, slots, self._read_later(tok0)

    def _read_later(self, t: torch.Tensor):
        """Queue ``t``'s copy to pinned host memory right behind its producer
        and mark it with an event, so a reader after later dispatches waits
        for the producer alone (a plain ``.cpu()`` then would wait for
        everything queued since). Returns ``(host tensor, event)``; on the
        CPU, ``(t, None)``."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _admit_paged(self, reqs, slots, matches, shared, starts, s0, ids_t, lens):
        """The paged half of :meth:`_admit_dispatch`: page bookkeeping, the
        prefill into the pool (plain, suffix or COW), the limits, and the
        prefix index of the new pages. Returns the last-token logits and the
        call's input-shape signature."""
        pool, page_size, dev = self.pool, self.page_size, self.device
        s0_pages = -(-s0 // page_size)
        page_rows = np.full((len(reqs), s0_pages), pool.num_blocks, np.int64)
        # the prefix gather reaches the batch's largest shared region (a COW
        # tail is one more page), bucketed to powers of two
        max_shared = max(len(full) + (1 if tail_t else 0) for full, _, tail_t in matches)
        prefix_pages = 1
        while prefix_pages < max_shared:
            prefix_pages *= 2
        prefix_pages = min(prefix_pages, pool.max_pages)
        read_tables = np.full((len(reqs), prefix_pages), pool.num_blocks, np.int64)
        write_tables = np.full((len(reqs), pool.max_pages), pool.num_blocks, np.int64)
        limits = np.zeros((len(reqs),), np.int64)
        for i, (slot, r) in enumerate(zip(slots, reqs)):
            full_m, tail_b, tail_t = matches[i]
            adopt = full_m + ([tail_b] if tail_t else [])
            budget = r.prompt.size + r.max_new_tokens
            # only FULL shared pages discount the reservation: an adopted
            # COW tail's fork block is paid for up front
            # the reservation is the admission policy's budget; the write
            # limit stays the worst case
            pool.reserve(slot, self._pending_budget.pop(r.request_id, budget),
                         shared_blocks=len(full_m))
            if adopt:
                pool.adopt_shared(slot, adopt)
            if tail_t:
                self._slot_cow[slot] = len(full_m) * page_size + tail_t
                self.metrics.record_cow_adopt(tokens=tail_t)
                if r.prompt.size > self._slot_cow[slot]:
                    # the suffix prefill writes into the shared tail page
                    # now; a fully shared prompt forks at its first decode
                    self._fork_cow(slot)
            pool.alloc_to(slot, r.prompt.size)
            n = pool.blocks_for(r.prompt.size) - len(adopt)
            page_rows[i, :n] = pool.page_table[slot, len(adopt):len(adopt) + n]
            read_tables[i] = pool.page_table[slot, :prefix_pages]
            write_tables[i] = pool.page_table[slot]
            limits[i] = budget
            self._slot_len[slot] = r.prompt.size
            self._slot_limit[slot] = budget
        if any(starts):
            starts_t = upload(np.asarray(starts, np.int64), dev)
            read_t = upload(read_tables, dev)
            signature = ("prefix", len(reqs), s0, prefix_pages)
            if self.cow_tails:
                _, _, logits = prefill_paged_cow(
                    self.params, self.cfg, ids_t, lens, starts_t,
                    upload(np.asarray(shared, np.int64), dev), pool.k, pool.v,
                    read_t, upload(write_tables, dev), mesh=self._model_axis)
            else:
                _, _, logits = prefill_paged(self.params, self.cfg, ids_t, lens, pool.k, pool.v,
                                             upload(page_rows, dev),
                                             start_lens=starts_t, read_tables=read_t,
                                             mesh=self._model_axis)
        else:
            # an all-miss batch (or prefix off): no prefix to gather
            signature = (len(reqs), s0, s0_pages)
            _, _, logits = prefill_paged(self.params, self.cfg, ids_t, lens, pool.k, pool.v,
                                         upload(page_rows, dev), mesh=self._model_axis)
        self._limit[upload(np.asarray(slots, np.int64), dev)] = \
            upload(limits, dev)
        if self.prefix_cache is not None:
            # index the batch's new pages for LATER admissions (after the
            # prefill, so no lookup in this batch could name them)
            for slot, r in zip(slots, reqs):
                full = r.prompt.size // page_size
                self.prefix_cache.insert(r.prompt, [int(b) for b in pool.page_table[slot, :full]])
                if self.cow_tails and r.prompt.size % page_size:
                    self.prefix_cache.insert_tail(r.prompt, int(pool.page_table[slot, full]))
        return logits, signature

    def _admit_finish(self, state, emitted, finished, admitted, activate: bool = True) -> None:
        """Read the batch's first tokens back and emit them; activate the
        slots unless the overlapped tick already did (``activate=False``)."""
        reqs, slots, (tok0, event) = state
        if event is not None:
            event.synchronize()
        for slot, req, tok in zip(slots, reqs, tok0.tolist()):
            if self._slot_req[slot] is not req:
                # the slot changed hands between dispatch and readback
                continue
            if activate:
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
        if self.admission_policy is not None:
            # a completion is the quantile estimator's only food
            self.admission_policy.observe_finish(len(out))
        tr = self.tracer
        ts0 = self._req_admit_ts.pop(rid, None)
        if tr.enabled and ts0 is not None:
            tr.complete("req/decode", ts0, cat="request", rid=rid, outcome=reason,
                        tokens=len(out), **self._obs_args)


def rank_tree(tree, cfg: GPTConfig, mesh, placed: Dict[int, torch.Tensor]):
    """This rank's block of a decode tree (or ``GPTLM``) on a serving mesh
    (JAX's ``shard_params(params, mesh, gpt_tp_rules())``): every leaf cut
    by ``sharding.shard_params`` in JAX's layout. The embedding's rows say
    which tree it is: ``vocab`` rows, the whole tree, is cut; ``vocab / tp``
    rows, this rank's block already (a fleet's shared placement), is kept;
    any other count is refused. A leaf shared by identity (a draft carved
    from the target) is cut once (``placed``). Without a mesh, or on a
    one-rank one, the tree as it is."""
    if isinstance(tree, torch.nn.Module):
        tree = params_tree(tree)
    tp = 1 if mesh is None else int(mesh.shape[MODEL_AXIS])
    if tp == 1:
        return tree
    rows = int(tree["params"]["word_embeddings"]["embedding"].shape[0])
    if rows * tp == cfg.vocab_size:
        return tree
    if rows != cfg.vocab_size:
        raise ValueError(f"the embedding holds {rows} rows: neither the vocab "
                         f"({cfg.vocab_size}) nor its block on one of tp={tp} ranks "
                         f"({cfg.vocab_size // tp})")
    rules = gpt_tp_rules()

    def cut(path, leaf):
        if id(leaf) not in placed:
            placed[id(leaf)] = shard_params({path: leaf}, mesh, rules, jax_layout=True)[path]
        return placed[id(leaf)]

    return map_state(cut, tree)


def _tree_to(tree, device, moved: Dict[int, torch.Tensor]):
    """Every tensor of a nested dict on ``device`` (no copy when it is
    there already); a tensor already in ``moved`` (by identity) is not
    copied twice, so a draft carved from the target shares its copies."""
    if isinstance(tree, dict):
        return {key: _tree_to(child, device, moved) for key, child in tree.items()}
    if id(tree) not in moved:
        moved[id(tree)] = tree.to(device)
    return moved[id(tree)]
