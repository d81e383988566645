"""Float32-accurate matrix products on Hopper's bfloat16 tensor cores.

A float32 matrix product with TF32 off runs, through cuBLAS, on the card's
FMA units. This module's kernel (``csrc/gemm_f32.cu``) runs it on the
bfloat16 tensor cores instead: each float32 operand is split, inside the
kernel, into three bfloat16 terms ``hi + mid + lo`` that sum to it exactly
(:func:`split_terms`), and the products of the term pairs (i, j) with
i + j <= 2 (:func:`term_pairs`: 6 for float32 x float32, 3 for float32 x
bfloat16, 1 for bfloat16 x bfloat16) sum into float32. Each such product
is exact; the pairs left out weigh under float32's half ulp. A bfloat16
operand is its own one term, so a product of bfloat16 values held as
float32 (GPT's head) costs one product.

:func:`linear` (``y = x wᵀ + b``) is what the models call where their
compute dtype is float32 (``models/bert.py :: Dense``, GPT's tied head). It
routes by device alone: CUDA tensors go through the kernel, forward and
backward (the input gradient ``dY W`` and the weight gradient ``dYᵀ X``
are the same kernel in other layouts), CPU tensors through the plain
float32 product (:func:`mm_plain`, which is also the operator's CPU
kernel). There is no fallback from one to the other. The product is the dispatcher operator ``gradaccum::mm_f32``
(:data:`mm_f32_op`), so ``torch.export`` traces it as it traces the flash
forward.

The kernel's launches, in all and by the number of term-pair products each
made, are counted here (:func:`launch_counts`, :func:`product_counts`),
apart from the flash kernels' counts.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

TILE_MN = 128  # the kernel's tile of C is TILE_MN x TILE_MN
TILE_K = 32    # and it walks K in tiles of TILE_K
MAX_SPLITS = 8
_DTYPES = (torch.float32, torch.bfloat16)


# --------------------------------------------------------------------------
# The arithmetic, as plain PyTorch
# --------------------------------------------------------------------------


def split_terms(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The kernel's split of float32 ``x`` into bfloat16 terms, each rounded
    to nearest: ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x -
    hi - mid)``. For normal ``|x| >= 2**-103`` they sum to ``x`` exactly. A
    bfloat16 ``x`` is its own one term."""
    if x.dtype == torch.bfloat16:
        return (x,)
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def term_pairs(a_dtype: torch.dtype, b_dtype: torch.dtype) -> List[Tuple[int, int]]:
    """The term pairs (i, j), i + j <= 2, whose products the kernel sums,
    in the order it issues them (the smaller pairs first)."""
    na = 3 if a_dtype == torch.float32 else 1
    nb = 3 if b_dtype == torch.float32 else 1
    order = [(1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)]
    return [(i, j) for i, j in order if i < na and j < nb]


def emulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel forms it, in float32 on any device: the sum
    of the products of the term pairs of :func:`term_pairs`, each term pair
    multiplied in float32 (a product of two bfloat16 values is exact there).
    The kernel sums in another order, with its own rounding; this is the
    arithmetic the tests hold against float64."""
    ta, tb = split_terms(a), split_terms(b)
    out = None
    for i, j in term_pairs(a.dtype, b.dtype):
        p = torch.matmul(ta[i].float(), tb[j].float())
        out = p if out is None else out + p
    return out


def plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int, bool]:
    """``(splits, k_tiles_per_split, m_fastest)`` for a product of C[m, n]
    over k, from the shape and the card's SM count alone. Where the 128 x
    128 tiles of C fill a wave of ``sms`` blocks, K is not split; else it
    is cut into the fewest ranges, each at least 8 K tiles, that leave the
    fewest K tiles on the busiest SM. The tiles are walked along the
    smaller of the grid's two dimensions first, so that a wave shares the
    other operand's rows."""
    tiles_m, tiles_n = -(-m // TILE_MN), -(-n // TILE_MN)
    tiles, nk = tiles_m * tiles_n, max(1, -(-k // TILE_K))
    best = None
    for want in range(1, MAX_SPLITS + 1 if tiles < sms else 2):
        per = -(-nk // want)
        if want > 1 and per < 8:
            break
        splits = -(-nk // per)
        cost = -(-(tiles * splits) // sms) * per
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2], tiles_m <= tiles_n


def mm_plain(a, b, bias=None, a_t: bool = False, b_t: bool = False,
             out_dtype: torch.dtype = torch.float32):
    """The plain version: ``op(a) @ op(b) (+ bias)`` in float32 (``op``
    transposes where ``a_t``/``b_t``), cast to ``out_dtype``. With the bias
    it is ``addmm``, the product ``F.linear`` forms, so a CPU ``Dense``
    keeps its bits."""
    a = a.float().t() if a_t else a.float()
    b = b.float().t() if b_t else b.float()
    y = torch.matmul(a, b) if bias is None else torch.addmm(bias.float(), a, b)
    return y.to(out_dtype)


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------

_lib: list = []
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _I, _I, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I, _I,
             _I, _I, _P]
_SMS: Dict[int, int] = {}


def build_kernels() -> ctypes.CDLL:
    """Build (at first call) and load ``csrc/gemm_f32.cu``."""
    if not _lib:
        from gradaccum_tpu_torch.utils import cuda_build

        lib = cuda_build.load("gemm_f32")
        lib.gemm_bf16x3.argtypes = _ARGTYPES
        lib.gemm_bf16x3.restype = _I
        _lib.append(lib)
    return _lib[0]


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _wide(t: torch.Tensor) -> bool:
    """Rows and start 16-byte aligned: TMA copies the operand (else a float32
    one is copied 4 bytes at a time)."""
    return t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) % 16 == 0


def _padded(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 operand whose rows are not 16-byte aligned, copied into
    rows that are (a view of the first columns of a wider buffer)."""
    rows, cols = t.shape
    out = t.new_empty(rows, -(-cols // 8) * 8)[:, :cols]
    return out.copy_(t)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A 2-D operand with unit column stride (the kernel's row pitch is its
    first stride)."""
    return t if t.stride(-1) == 1 or t.shape[-1] <= 1 else t.contiguous()


def mm_cuda(a, b, bias=None, a_t: bool = False, b_t: bool = False,
            out_dtype: torch.dtype = torch.float32):
    """The kernel: ``op(a) @ op(b) (+ bias)`` as :func:`mm_plain`, float32
    or bfloat16 operands, float32-accurate, written in ``out_dtype``."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mm_cuda takes CUDA tensors on one device, got {a.device}, {b.device}")
    if a.dtype not in _DTYPES or b.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"mm_cuda takes float32 or bfloat16, got {a.dtype}, {b.dtype} -> "
                        f"{out_dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mm_cuda takes 2-D operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    m, k = (a.shape[1], a.shape[0]) if a_t else a.shape
    kb, n = (b.shape[1], b.shape[0]) if b_t else b.shape
    if k != kb:
        raise ValueError(f"op(a) is [{m}, {k}] but op(b) is [{kb}, {n}]")
    if bias is not None and (bias.shape != (n,) or bias.device != a.device):
        raise ValueError(f"bias must be [{n}] on {a.device}, got {tuple(bias.shape)}")
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.copy_(torch.zeros_like(out) if bias is None else bias.expand(m, n))
    bias = None if bias is None else bias.float().contiguous()
    a, b = _rows(a), _rows(b)
    # a bf16 A takes a bf16 B: for bf16 x float32, C^T = op(b)^T op(a)^T
    trans = a.dtype == torch.bfloat16 and b.dtype == torch.float32
    if trans:
        a, a_t, b, b_t, m, n = b, not b_t, a, not a_t, n, m
    wide = [_wide(a), _wide(b)]
    if a.dtype == torch.bfloat16 and not wide[0]:
        a, wide[0] = _padded(a), True
    if b.dtype == torch.bfloat16 and not wide[1]:
        b, wide[1] = _padded(b), True
    splits, per, m_fastest = plan(m, n, k, _sms(a.device))
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=a.device) if splits > 1 else None
    a_f32, b_f32 = a.dtype == torch.float32, b.dtype == torch.float32
    err = build_kernels().gemm_bf16x3(
        int(a_f32), int(b_f32), int(a_t), int(not b_t), a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), a.stride(0), b.stride(0), out.stride(0),
        m, n, k, int(m_fastest), splits, per, int(wide[0]), int(wide[1]),
        int(out_dtype == torch.bfloat16), int(trans),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_bf16x3 launch failed with cudaError {err}")
    products = 6 if a_f32 and b_f32 else 3 if a_f32 else 1
    _COUNTS["launches"] += 1
    _COUNTS["products"][products] += 1
    return out


_COUNTS: dict = {}


def reset_launch_counts() -> None:
    """Zero the kernel's launch counts."""
    _COUNTS.update(launches=0, products={1: 0, 3: 0, 6: 0})


def launch_counts() -> dict:
    """``{"gemm_f32": launches}`` since the last reset."""
    return {"gemm_f32": _COUNTS["launches"]}


def product_counts() -> dict:
    """Launches since the last reset by the term-pair products each made:
    ``{1: bf16 x bf16, 3: float32 x bf16, 6: float32 x float32}``."""
    return dict(_COUNTS["products"])


reset_launch_counts()


# --------------------------------------------------------------------------
# The operator and its gradient
# --------------------------------------------------------------------------

# FRAGMENT: the namespace's one DEF library is the flash module's
_OP_LIB = torch.library.Library("gradaccum", "FRAGMENT")
_OP_LIB.define("mm_f32(Tensor a, Tensor b, Tensor? bias, bool a_t, bool b_t, "
               "ScalarType out_dtype) -> Tensor")


def _mm_fake(a, b, bias, a_t, b_t, out_dtype):
    m = a.shape[1] if a_t else a.shape[0]
    n = b.shape[0] if b_t else b.shape[1]
    return a.new_empty((m, n), dtype=out_dtype)


_OP_LIB.impl("mm_f32", mm_cuda, "CUDA")
_OP_LIB.impl("mm_f32", mm_plain, "CPU")
torch.library.register_fake("gradaccum::mm_f32", _mm_fake, lib=_OP_LIB)
mm_f32_op = torch.ops.gradaccum.mm_f32.default


class _Linear(torch.autograd.Function):
    """``x wᵀ + b`` on the kernel; the backward launches it twice more,
    for ``dY w`` and ``dYᵀ x``, each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x, w, bias, out_dtype):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return mm_f32_op(x, w, bias, False, True, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = mm_f32_op(g, w, None, False, False, x.dtype) if need[0] else None
        dw = mm_f32_op(g, x, None, True, False, w.dtype) if need[1] else None
        db = g.sum(0, dtype=torch.float32).to(ctx.bias_dtype) if need[2] else None
        return dx, dw, db, None


def linear(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x wᵀ + bias`` over the last dim of ``x`` (``w`` is [out, in]),
    float32-accurate, in ``out_dtype``. ``x`` and ``w`` enter in their own
    dtypes (float32 or bfloat16); their gradients come back in them. CUDA
    tensors take the kernel, CPU tensors :func:`mm_plain`."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type != "cuda":
        return mm_plain(x2, w, bias, b_t=True, out_dtype=out_dtype).reshape(*lead, w.shape[0])
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, bias))
    if needs_grad:
        y = _Linear.apply(x2, w, bias, out_dtype)
    else:
        y = mm_f32_op(x2, w, bias, False, True, out_dtype)
    return y.reshape(*lead, w.shape[0])

