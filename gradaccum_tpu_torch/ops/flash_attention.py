"""Fused flash attention on Hopper: forward, dq and dk/dv kernels.

The port of ``gradaccum_tpu/ops/flash_attention.py``. The three Pallas
kernels of the TPU package (forward ``_fwd_kernel``, ``_dq_kernel`` and
``_dkv_kernel``) become hand-written CUDA kernels on two routes, chosen by
dtype and nothing else:

- ``tc`` (``csrc/flash_attention_tc.cu``): every bfloat16 kernel on the
  tensor cores, all three Hopper designs (a producer warp's TMA copies into
  mbarrier stages, ``wgmma`` from shared memory in consumer warpgroups).
- ``tf32x3`` (``csrc/flash_attention.cu``): every float32 kernel on the
  tensor cores in 3xTF32 (each operand split into two TF32 parts, three
  products per product), which holds float32's tolerances where a single
  TF32 product would not. All three are Hopper designs too (TMA into
  mbarrier stages, a producer warpgroup that splits each tile into its TF32
  parts and transposes, ``wgmma`` on them in a consumer warpgroup).

The design and what bounds each kernel are noted in the sources.
The forward saves only ``o`` and the per-row logsumexp; the backward
recomputes each score from q, k and the logsumexp, never materializing the
[S, S] matrix on the card. The dq kernel also computes the row correction
Δ = rowsum(dO ⊙ O) and hands it to the dk/dv kernel, so no pass runs
before the two.

Beside each kernel is its plain PyTorch version
(:func:`flash_forward_reference`, :func:`flash_backward_reference`): dense
math with the same formulas. :func:`flash_attention` sends CUDA tensors to
the kernels and CPU tensors to the plain versions; there is no fallback
from one to the other. The forward is the dispatcher operator
``gradaccum::flash_fwd`` (``flash_fwd_op``), so ``torch.export`` traces it
and an exported program launches the kernel. ``bwd_impl="xla"`` (JAX's cross-check backward)
keeps the forward kernel and differentiates the blockwise core instead of
launching the dq and dk/dv kernels; it is chosen by the caller, never as a
fallback.

Attention dropout is the JAX package's stateless hash (murmur3 finalizer
over seed, (batch, head) slice, query and key position). It gives the same
keep/drop bits as the TPU kernels for the same uint32 seed, so a test can
hold the port against JAX exactly; :func:`dropout_keep_mask` rebuilds the
mask outside the kernels.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

import torch

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_SUPPORTED_D = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------
# Hash dropout (the kernels' device function, as plain int64 tensor math)
# --------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``: the full product would overflow int64, so multiply the
    16-bit halves of ``x`` separately (each product stays below 2**48)."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _dropout_config(dropout_rate: float):
    keep_prob = 1.0 - dropout_rate
    # clamp: a rate tiny enough that round() hits 2**32 would wrap the
    # uint32 threshold to 0 and drop everything instead of nearly nothing
    threshold = min(round(keep_prob * float(2**32)), 2**32 - 1)
    return threshold, 1.0 / keep_prob


def _heads_total(num_heads: int, head_offset: int, heads_total) -> int:
    """The attention's whole head count (``heads_total``; None or 0: the
    launch's own ``num_heads``), checked against the launch's slice."""
    total = heads_total or num_heads
    if head_offset < 0 or head_offset + num_heads > total:
        raise ValueError(f"heads [{head_offset}, {head_offset + num_heads}) do not lie in "
                         f"the attention's {total} heads")
    if total >= 2**16:
        raise ValueError(f"{total} heads: the kernels key dropout on 16-bit head counts")
    return total


def dropout_keep_mask(seed, batch: int, num_heads: int, seq: int, rate: float,
                      device=None, head_offset: int = 0,
                      heads_total: Optional[int] = None) -> torch.Tensor:
    """The [B, H, S, S] bool keep mask the kernels derive from ``seed`` (an
    int or a one-element integer tensor holding a uint32): slice seed from
    ``seed + (b*heads_total + head_offset + h)·GOLDEN``, row seed from the
    query position, then the key position. With the defaults (0 and H)
    equal, bit for bit, to the JAX package's mask; heads ``[head_offset,
    head_offset + H)`` of a ``heads_total``-head attention (one rank's heads
    under tensor parallelism) draw exactly that slice of its mask."""
    threshold, _ = _dropout_config(rate)
    total = _heads_total(num_heads, head_offset, heads_total)
    if device is None:
        device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(()) & _MASK32
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    bh = (ar(batch)[:, None] * total + head_offset + ar(num_heads)[None, :])[..., None, None]
    slice_seed = _hash_u32((seed + _mul32(bh, _GOLDEN)) & _MASK32)
    row_seed = _hash_u32((ar(seq)[:, None] + _mul32(slice_seed, _GOLDEN)) & _MASK32)
    return _hash_u32((ar(seq) + _mul32(row_seed, _GOLDEN)) & _MASK32) < threshold


# --------------------------------------------------------------------------
# Plain versions (dense PyTorch, float32 math)
# --------------------------------------------------------------------------


def _scores(q, k, mask, causal):
    """float32 S = q·kᵀ/√D + mask, with the causal triangle at -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    if mask is not None:
        s = s + mask.float()
    if causal:
        n = q.shape[-2]
        above = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, _NEG_INF)
    return s


def flash_forward_reference(q, k, v, mask, seed, causal: bool, rate: float,
                            head_offset: int = 0, heads_total: Optional[int] = None):
    """Plain version of the forward kernel: ``(o, lse)`` with ``o`` in the
    input dtype and ``lse`` [B, H, S, 1] float32. The normalizer sums the
    undropped probabilities; the keep mask (keyed on ``head_offset`` and
    ``heads_total``, :func:`dropout_keep_mask`) scales P by 1/keep before
    P·V."""
    s = _scores(q, k, mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    if rate > 0.0:
        b, h, n, _ = q.shape
        _, inv_keep = _dropout_config(rate)
        keep = dropout_keep_mask(seed, b, h, n, rate, device=q.device,
                                 head_offset=head_offset, heads_total=heads_total)
        p = torch.where(keep, p * inv_keep, 0.0)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), m + torch.log(l)


def flash_backward_reference(q, k, v, mask, seed, o, lse, g, causal: bool,
                             rate: float, head_offset: int = 0,
                             heads_total: Optional[int] = None):
    """Plain version of the dq and dk/dv kernels:
    ``(dq, dk, dv, dmask_per_head)``, the last [B, H, 1, S] float32 (None
    without a mask). P = exp(S − lse); dP = dO·Vᵀ dropped like the forward;
    Δ = rowsum(dO ⊙ O); dS = P ⊙ (dP − Δ)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    p = torch.exp(_scores(q, k, mask, causal) - lse)
    gf = g.float()
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    p_dropped = p
    if rate > 0.0:
        b, h, n, _ = q.shape
        _, inv_keep = _dropout_config(rate)
        keep = dropout_keep_mask(seed, b, h, n, rate, device=q.device,
                                 head_offset=head_offset, heads_total=heads_total)
        dp = torch.where(keep, dp * inv_keep, 0.0)
        p_dropped = torch.where(keep, p * inv_keep, 0.0)
    delta = _delta(g, o)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p_dropped.transpose(-1, -2), gf)
    dmask = ds.sum(dim=-2, keepdim=True) if mask is not None else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dmask


def _delta(g, o):
    """Δ_i = Σ_d dO_id·O_id in float32 — equal to rowsum(drop(P) ⊙ dP), the
    softmax-backward row correction, with or without dropout."""
    return torch.sum(g.float() * o.float(), dim=-1, keepdim=True)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_libs: dict = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
# B H S scale causal thr inv drop head_offset heads_total stream
_COMMON_TAIL = [_I, _I, _I, _F, _I, _U, _F, _I, _I, _I, _P]
_ARGTYPES = {
    "flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P] + _COMMON_TAIL,
    "flash_bwd_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P] + _COMMON_TAIL,
    "flash_bwd_dkv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P] + _COMMON_TAIL,
}
# route -> (source under csrc/, {kernel: C function}); a tc function takes
# the same arguments as its float32 twin
_SOURCES = {
    "tf32x3": ("flash_attention", {name: name for name in _ARGTYPES}),
    "tc": ("flash_attention_tc", {name: f"{name}_tc" for name in _ARGTYPES}),
}


# the bf16 library's counts of its tensor-map cache: {count: C function}
_MAP_COUNTS = {"lookups": "flash_tc_map_lookups", "encodes": "flash_tc_map_encodes"}
# and the float32 library's (its three kernels copy with TMA too)
_F32_MAP_COUNTS = {"lookups": "flash_f32_map_lookups", "encodes": "flash_f32_map_encodes"}


def build_kernels() -> dict:
    """Build (at first call) and load both CUDA sources; ``{route: CDLL}``."""
    if not _libs:
        from gradaccum_tpu_torch.utils import cuda_build

        for r, (source, functions) in _SOURCES.items():
            lib = cuda_build.load(source)
            for name, symbol in functions.items():
                fn = getattr(lib, symbol)
                fn.argtypes = _ARGTYPES[name]
                fn.restype = _I
            _libs[r] = lib
        for r, counts in (("tc", _MAP_COUNTS), ("tf32x3", _F32_MAP_COUNTS)):
            for symbol in counts.values():
                getattr(_libs[r], symbol).restype = ctypes.c_longlong
    return _libs


def route(dtype: torch.dtype) -> str:
    """The route a CUDA tensor of ``dtype`` takes through every kernel:
    bfloat16 runs ``tc``, float32 ``tf32x3``. The dtype alone decides."""
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def _launch(name: str, dtype: torch.dtype, t0: int, *args):
    """Call kernel ``name`` on its route, raise on a launch error, count it
    and add the wrapper's host time since ``t0`` (``perf_counter_ns`` at the
    wrapper's entry)."""
    r = route(dtype)
    fn = getattr(build_kernels()[r], _SOURCES[r][1][name])
    err = fn(_DTYPE_CODES[dtype], *args)
    if err != 0:
        raise RuntimeError(f"{name} ({r}) launch failed with cudaError {err}")
    wrapper = KERNELS[name]
    wrapper.launches += 1
    wrapper.route_launches[r] += 1
    wrapper.host_ns += time.perf_counter_ns() - t0


def _check_inputs(q, k, v, mask, *rest):
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got shape {tuple(q.shape)}")
    b, h, s, d = q.shape
    if d not in _SUPPORTED_D:
        raise ValueError(f"head dim {d} not in {_SUPPORTED_D}")
    if s < 1:
        raise ValueError("sequence length must be >= 1")
    for name, t in (("k", k), ("v", v)) + tuple(rest):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q ({tuple(q.shape)}, {q.dtype}, {q.device}); "
                f"got {tuple(t.shape)}, {t.dtype}, {t.device}"
            )
    if mask is not None and (
        mask.shape != (b, 1, 1, s) or mask.dtype != q.dtype or mask.device != q.device
    ):
        raise ValueError(
            f"mask must be [{b}, 1, 1, {s}] {q.dtype} on {q.device}; got "
            f"{tuple(mask.shape)} {mask.dtype} on {mask.device}"
        )
    for t in (q, k, v, mask) + tuple(x for _, x in rest):
        if t is not None and not t.is_contiguous():
            raise ValueError("the flash kernels take contiguous tensors")
    # every kernel copies rows in 16-byte chunks (cp.async), or by TMA, whose
    # tensor maps need a 16-byte aligned start
    if any(t.data_ptr() % 16 for t in (q, k, v) + tuple(x for _, x in rest)):
        raise ValueError("q, k, v, dO and o must start on a 16-byte boundary")


def _check_rows(q, *rows):
    b, h, s, _ = q.shape
    for t in rows:
        if t.shape != (b, h, s, 1) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"lse/delta must be contiguous float32 [{b}, {h}, {s}, 1]; got "
                f"{tuple(t.shape)} {t.dtype}"
            )


def _seed_tensor(seed, rate, device):
    """The dropout seed as a one-element int64 tensor on the card (the
    kernels read it there, so a seed drawn on the card never syncs)."""
    if rate <= 0.0:
        return None
    if seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    t = torch.as_tensor(seed, dtype=torch.int64).reshape(1)
    return t.to(device) if t.device != device else t.contiguous()


def _scalar_args(q, causal, rate, head_offset: int = 0, heads_total: Optional[int] = None):
    b, h, s, d = q.shape
    threshold, inv_keep = _dropout_config(rate) if rate > 0.0 else (0, 1.0)
    return [b, h, s, 1.0 / d ** 0.5, int(causal), threshold, inv_keep,
            int(rate > 0.0), int(head_offset), _heads_total(h, head_offset, heads_total),
            torch.cuda.current_stream(q.device).cuda_stream]


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd_cuda(q, k, v, mask, seed, causal: bool, rate: float, head_offset: int = 0,
                   heads_total: int = 0):
    """K1 on the card: ``(o, lse)`` as :func:`flash_forward_reference`
    (``heads_total`` 0: the launch's own head count)."""
    t0 = time.perf_counter_ns()
    _check_inputs(q, k, v, mask)
    seed_t = _seed_tensor(seed, rate, q.device)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1] + (1,), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.dtype, t0, q.shape[-1], _ptr(q), _ptr(k), _ptr(v), _ptr(mask),
            _ptr(seed_t), _ptr(o), _ptr(lse),
            *_scalar_args(q, causal, rate, head_offset, heads_total))
    return o, lse


def flash_bwd_dq_cuda(q, k, v, mask, seed, g, o, lse, causal: bool,
                      rate: float, head_offset: int = 0, heads_total: int = 0):
    """K2 on the card: ``(dq, delta)``, dq as :func:`flash_backward_reference`
    and delta [B, H, S, 1] float32 as :func:`_delta` (the dk/dv kernel's
    input), both computed by the one kernel from the forward's ``o``."""
    t0 = time.perf_counter_ns()
    _check_inputs(q, k, v, mask, ("dO", g), ("o", o))
    _check_rows(q, lse)
    seed_t = _seed_tensor(seed, rate, q.device)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _launch("flash_bwd_dq", q.dtype, t0, q.shape[-1], _ptr(q), _ptr(k), _ptr(v), _ptr(mask),
            _ptr(seed_t), _ptr(g), _ptr(o), _ptr(lse), _ptr(dq), _ptr(delta),
            *_scalar_args(q, causal, rate, head_offset, heads_total))
    return dq, delta


def flash_bwd_dkv_cuda(q, k, v, mask, seed, g, lse, delta, causal: bool,
                       rate: float, with_dmask: bool = True, head_offset: int = 0,
                       heads_total: int = 0):
    """K3 on the card: ``(dk, dv, dmask_per_head)`` as
    :func:`flash_backward_reference`, given Δ. dmask is None without a mask
    or with ``with_dmask=False``; the kernel then skips writing it."""
    t0 = time.perf_counter_ns()
    _check_inputs(q, k, v, mask, ("dO", g))
    _check_rows(q, lse, delta)
    seed_t = _seed_tensor(seed, rate, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dmask = None
    if mask is not None and with_dmask:
        b, h, s, _ = q.shape
        dmask = torch.empty((b, h, 1, s), dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dkv", q.dtype, t0, q.shape[-1], _ptr(q), _ptr(k), _ptr(v), _ptr(mask),
            _ptr(seed_t), _ptr(g), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
            _ptr(dmask), *_scalar_args(q, causal, rate, head_offset, heads_total))
    return dk, dv, dmask


KERNELS = {
    "flash_fwd": flash_fwd_cuda,
    "flash_bwd_dq": flash_bwd_dq_cuda,
    "flash_bwd_dkv": flash_bwd_dkv_cuda,
}


def reset_launch_counts() -> None:
    """Zero every wrapper's count of launches, in total and per route, and
    its host time."""
    for fn in KERNELS.values():
        fn.launches = 0
        fn.route_launches = {r: 0 for r in _SOURCES}
        fn.host_ns = 0


def tc_map_counts() -> dict:
    """The bf16 kernels' tensor maps since the library was loaded:
    ``lookups`` (one for each map a launch needs) and ``encodes`` (the
    lookups the cache missed, each a host call into libcuda)."""
    lib = build_kernels()["tc"]
    return {name: getattr(lib, symbol)() for name, symbol in _MAP_COUNTS.items()}


def f32_map_counts() -> dict:
    """The float32 kernels' tensor maps since the library was loaded,
    counted as :func:`tc_map_counts` counts the bf16 ones."""
    lib = build_kernels()["tf32x3"]
    return {name: getattr(lib, symbol)() for name, symbol in _F32_MAP_COUNTS.items()}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launch_host_ns() -> dict:
    """``{kernel: ns}`` since the last reset: the wrapper's host time over
    its launches, from its entry (input checks, outputs, the seed) to the
    launch's return (``time.perf_counter_ns``)."""
    return {name: fn.host_ns for name, fn in KERNELS.items()}


def route_counts() -> dict:
    """``{kernel: {route: launches}}`` since the last reset."""
    return {name: dict(fn.route_launches) for name, fn in KERNELS.items()}


reset_launch_counts()


# --------------------------------------------------------------------------
# autograd wiring
# --------------------------------------------------------------------------


# The forward is one operator of the dispatcher, ``gradaccum::flash_fwd``:
# its CUDA implementation launches K1 on the dtype's route, its CPU
# implementation is the plain version, and its fake implementation gives
# torch.export the shapes of o and lse. Training's autograd function, the
# no-grad path and an exported program all reach the kernel through it.
# It is defined with torch.library.Library and called through its
# OpOverload: torch.library.custom_op's own wrapper costs several times
# the dispatch (PERF.md, the flash wrapper's wall time per call).
_OP_LIB = torch.library.Library("gradaccum", "DEF")
_OP_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, Tensor? seed, "
               "bool causal, float rate, int head_offset=0, int heads_total=0) "
               "-> (Tensor, Tensor)")


def _flash_fwd_plain(q, k, v, mask, seed, causal, rate, head_offset=0, heads_total=0):
    # resolved at call time, so a test can substitute the plain version
    return flash_forward_reference(q, k, v, mask, seed, causal, rate, head_offset,
                                   heads_total or None)


def _flash_fwd_fake(q, k, v, mask, seed, causal, rate, head_offset=0, heads_total=0):
    return torch.empty_like(q), q.new_empty(q.shape[:-1] + (1,), dtype=torch.float32)


_OP_LIB.impl("flash_fwd", flash_fwd_cuda, "CUDA")
_OP_LIB.impl("flash_fwd", _flash_fwd_plain, "CPU")
torch.library.register_fake("gradaccum::flash_fwd", _flash_fwd_fake, lib=_OP_LIB)
flash_fwd_op = torch.ops.gradaccum.flash_fwd.default


def _forward(q, k, v, mask, seed, causal, rate, heads=(0, 0)):
    """``(o, lse)`` through the operator: the kernel for CUDA tensors, the
    plain version for CPU tensors; any other device raises. ``heads``:
    ``(head_offset, heads_total)`` of the dropout key, (0, 0) for the
    launch's own heads (the operator's defaults)."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    seed_t = _seed_tensor(seed, rate, q.device)
    if heads == (0, 0):
        return flash_fwd_op(q, k, v, mask, seed_t, causal, rate)
    return flash_fwd_op(q, k, v, mask, seed_t, causal, rate, *heads)


def _backward(q, k, v, mask, seed, o, lse, g, causal, rate, heads, with_dmask):
    if q.device.type == "cuda":
        dq, delta = flash_bwd_dq_cuda(q, k, v, mask, seed, g, o, lse, causal, rate, *heads)
        dk, dv, dmask = flash_bwd_dkv_cuda(q, k, v, mask, seed, g, lse, delta,
                                           causal, rate, with_dmask, *heads)
        return dq, dk, dv, dmask
    dq, dk, dv, dmask = flash_backward_reference(q, k, v, mask, seed, o, lse, g,
                                                 causal, rate, heads[0], heads[1] or None)
    return dq, dk, dv, dmask if with_dmask else None


def _blockwise_backward(q, k, v, mask, g, causal, block_k, with_dmask):
    """``bwd_impl="xla"``: recompute the attention with the blockwise core
    and differentiate it with autograd (plain torch ops, no kernel)."""
    from gradaccum_tpu_torch.parallel.ring_attention import blockwise_attention

    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        m = None if mask is None else mask.detach().requires_grad_(with_dmask)
        if with_dmask:
            inputs.append(m)
        o = blockwise_attention(*inputs[:3], m, block_size=block_k, causal=causal)
        grads = torch.autograd.grad(o, inputs, g)
    return tuple(grads) + (None,) * (4 - len(grads))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, seed, causal, rate, bwd_impl, block_k, heads):
        o, lse = _forward(q, k, v, mask, seed, causal, rate, heads)
        seed_t = seed if isinstance(seed, torch.Tensor) else None
        ctx.save_for_backward(q, k, v, mask, seed_t, o, lse)
        ctx.seed_int = None if seed_t is not None else seed
        ctx.causal, ctx.rate, ctx.bwd_impl, ctx.block_k = causal, rate, bwd_impl, block_k
        ctx.heads = heads
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, seed_t, o, lse = ctx.saved_tensors
        seed = seed_t if seed_t is not None else ctx.seed_int
        # a mask built from the input (BERT's) needs no gradient: then the
        # dk/dv kernel is not asked for its per-head dmask rows
        with_dmask = ctx.needs_input_grad[3]
        if ctx.bwd_impl == "xla":
            dq, dk, dv, dmask = _blockwise_backward(q, k, v, mask, g, ctx.causal,
                                                    ctx.block_k, with_dmask)
            return dq, dk, dv, dmask, None, None, None, None, None, None
        dq, dk, dv, dmask = _backward(q, k, v, mask, seed, o, lse, g.contiguous(),
                                      ctx.causal, ctx.rate, ctx.heads, with_dmask)
        if dmask is not None:
            # the mask broadcasts [B,1,1,S] over heads and queries: its
            # cotangent sums the per-head rows over heads
            dmask = dmask.sum(dim=1, keepdim=True).to(mask.dtype)
        return dq, dk, dv, dmask, None, None, None, None, None, None


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """A uint32 dropout seed (held in int64) drawn from ``generator``, on
    the generator's device, so a seed drawn on the card stays there."""
    return torch.randint(0, 2**32, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)


def flash_attention(q, k, v, mask=None, dropout_fn=None, *,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    generator: Optional[torch.Generator] = None,
                    causal: bool = False, bwd_impl: str = "pallas",
                    block_k: int = 128, head_offset: int = 0,
                    heads_total: Optional[int] = None):
    """Fused attention: drop-in for ``models.bert.dense_attention``.

    ``q, k, v``: [B, heads, S, head_dim]; ``mask``: additive key mask
    [B, 1, 1, S] or None. ``causal=True`` applies the autoregressive
    triangle inside the kernels. Differentiable, and the mask receives its
    gradient. The backward is chosen by ``bwd_impl``, whose strings are the
    JAX package's: ``"pallas"`` runs the dq and dk/dv kernels (CUDA here);
    ``"xla"`` keeps the forward kernel and recomputes the backward by
    autograd through ``parallel.ring_attention.blockwise_attention`` with
    ``block_size=block_k`` (plain torch ops, no dropout). ``block_k`` is
    read by that backward only: the kernels choose their own tiles.

    Attention dropout runs inside the kernels: pass ``dropout_rate`` with
    either ``dropout_seed`` (a uint32 as int or tensor; tests hand the JAX
    package's seed in here) or ``generator``, from which the seed is drawn.
    A ``dropout_fn`` closure cannot apply, since the kernels never
    materialize the probabilities, and is refused. ``head_offset`` and
    ``heads_total`` place these heads in a wider attention for the dropout
    key (a rank's own heads under tensor parallelism draw their slice of
    the whole attention's mask); the defaults are the heads given.
    """
    if dropout_fn is not None:
        raise NotImplementedError(
            "flash_attention never materializes attention probabilities; "
            "pass dropout_rate= with dropout_seed= or generator= for "
            "in-kernel dropout instead of a dropout_fn closure"
        )
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    seed = None
    if dropout_rate > 0.0:
        if dropout_seed is None and generator is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed or generator")
        if bwd_impl == "xla":
            raise NotImplementedError(
                "the blockwise (xla) backward has no in-kernel dropout; use "
                "bwd_impl='pallas' with dropout_rate > 0"
            )
        seed = dropout_seed if dropout_seed is not None else draw_seed(generator)
    if bwd_impl not in ("pallas", "xla"):
        raise ValueError(f"bwd_impl must be 'pallas' or 'xla', got {bwd_impl!r}")
    total = _heads_total(q.shape[1], head_offset, heads_total)
    heads = (0, 0) if (head_offset, total) == (0, q.shape[1]) else (int(head_offset), total)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, mask))
    if not needs_grad:  # inference and export: the operator alone
        return _forward(q, k, v, mask, seed, bool(causal), float(dropout_rate), heads)[0]
    return _FlashAttention.apply(q, k, v, mask, seed, bool(causal),
                                 float(dropout_rate), bwd_impl, int(block_k), heads)


# models pass dropout_rate/generator instead of a dropout_fn closure
flash_attention.inkernel_dropout = True


def causal_flash_attention(q, k, v, mask=None, dropout_fn=None, **kw):
    """``attention_fn`` slot for decoder models: causality lives inside the
    kernels, so the model must not also pass a dense [S, S] causal mask. A
    key padding mask [B, 1, 1, S] still composes."""
    return flash_attention(q, k, v, mask, dropout_fn, causal=True, **kw)


causal_flash_attention.handles_causality = True
causal_flash_attention.inkernel_dropout = True
