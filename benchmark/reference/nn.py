"""Plain layers of the reference, in float32, with one precision knob.

``prec`` names how a matrix product of a Dense layer is computed:

- ``"f32"``: float32 (the caller keeps TF32 off);
- ``"tf32"``: the same call; the caller turns TF32 on around it;
- ``"fp8"``: both operands rounded to float8 e4m3 with a per-tensor
  scale (448 over the tensor's largest magnitude), the output's gradient
  to e5m2 (57344 over its largest) before the two backward products,
  the products then exact and summed in float32 (bfloat16 holds every
  fp8 value, and its products accumulate in float32). This is an fp8
  training step as the tensor cores would run it.

The attention's own products, the LayerNorms, the GELUs, the softmax and
the heads that a configuration computes in float32 stay in float32 at
every ``prec``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.hash_dropout import keep_mask


def _round(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, largest / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).to(torch.float32) / scale)


def round_e4m3(x):
    return _round(x, torch.float8_e4m3fn, 448.0)


def round_e5m2(x):
    return _round(x, torch.float8_e5m2, 57344.0)


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        x8, w8 = round_e4m3(x), round_e4m3(w)
        ctx.save_for_backward(x8, w8)
        y = F.linear(x8.to(torch.bfloat16), w8.to(torch.bfloat16)).float()
        return y + b

    @staticmethod
    def backward(ctx, g):
        x8, w8 = ctx.saved_tensors
        g8 = round_e5m2(g).to(torch.bfloat16)
        dx = (g8 @ w8.to(torch.bfloat16)).float()
        dw = (g8.reshape(-1, g8.shape[-1]).t() @ x8.to(torch.bfloat16).reshape(-1, x8.shape[-1])
              ).float()
        return dx, dw, g.reshape(-1, g.shape[-1]).sum(0)


def dense(x, W, name: str, prec: str):
    """``x Wᵀ + b`` of the layer ``name`` (weight [out, in])."""
    w, b = W[name + ".weight"], W[name + ".bias"]
    if prec == "fp8":
        return _Fp8Linear.apply(x, w, b)
    return F.linear(x, w, b)


def layer_norm(x, W, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], eps)


def drop(x, keep, rate: float):
    """Keep where ``keep``, scaled by 1/(1 - rate); no mask, no dropout."""
    if keep is None:
        return x
    keep_prob = 1.0 - rate
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def draw_keep(generator: torch.Generator, shape, rate: float):
    """A hidden dropout mask, drawn as the program draws it: float32
    uniforms from ``generator``, kept under 1 - rate. At rate 0 the program
    draws nothing, and neither does this (None)."""
    if rate <= 0:
        return None
    return torch.rand(shape, generator=generator, device=generator.device) < 1.0 - rate


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """The attention dropout seed of one launch, drawn as the program draws it."""
    return torch.randint(0, 2**32, (1,), generator=generator, device=generator.device,
                         dtype=torch.int64)


def rows_of(keep, rows: torch.Tensor, seq: int):
    """The block's rows (and first ``seq`` positions) of a micro-batch's
    mask; None stays None."""
    if keep is None:
        return None
    keep = keep[rows]
    return keep[:, :seq] if keep.dim() == 3 else keep


def attention(x, W, prefix: str, heads: int, add_mask, causal: bool, rate: float,
              seed, rows: torch.Tensor, prec: str):
    """Multi-head self-attention of the batch rows ``rows``: softmax in
    float32 over ``q kᵀ / √D`` plus the additive key mask (or the causal
    triangle), the probabilities dropped by the kernels' hash mask."""
    b, s, h = x.shape
    d = h // heads

    def split(t):
        return t.reshape(b, s, heads, d).transpose(1, 2)

    q, k, v = (split(dense(x, W, prefix + n, prec)) for n in ("query", "key", "value"))
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if add_mask is not None:
        scores = scores + add_mask
    if causal:
        above = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(above, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if rate > 0:
        probs = drop(probs, keep_mask(seed, rows, heads, s, rate), rate)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h)
    return dense(ctx, W, prefix + "output", prec)
