"""Mixture-of-Experts FFN, single device (the port of ``gradaccum_tpu/models/moe.py``).

Switch-style routing with a fixed expert capacity, generalised to GShard
top-k:

- router: ``logits = x @ router`` in the compute dtype, softmax gates in
  float32, the top-k experts per token;
- capacity ``C = ceil(top_k·T/E · capacity_factor)``; each choice rank
  claims slots in token order (a cumulative sum) after the slots earlier
  ranks claimed; tokens past an expert's capacity are dropped (the layer
  returns zeros for them, the residual carries them);
- dispatch and combine as einsums against a ``[T, E, C]`` one-hot tensor,
  exact-erf GELU between the stacked expert matrices ``[E, D, H]`` and
  ``[E, H, D]``;
- the Switch load-balancing loss ``E · Σ_e (top-1 token fraction)·(mean
  gate)``, with the dropped fraction and the router entropy beside it.

This was XLA code in JAX, not a Pallas kernel, so it is plain torch ops
here.

**Expert parallelism** (:func:`moe_ep_rules`, and ``bert_tp_ep_rules`` of
``parallel/tp.py`` which also splits each expert's FFN width over
``model``): as under JAX's GSPMD, the batch stays replicated over the
expert axis, so every rank routes all of its tokens with the replicated
router; capacity, drops and the auxiliary losses are the same on every
rank. Each rank runs only its own experts (``moe_apply(ep=...)``), and
their partial combine is summed over the ranks that hold the other experts
(and FFN slices). ``x`` and the gates enter the expert region through
``copy_to``, so the router's gradient from the combine sums over those
ranks once, and the load-balance loss, computed from the replicated gates,
is counted once. ``b_out`` is not split over ``model``: only that axis's
rank 0 adds it, through ``copy_to``, so its gradient is whole on every rank. One-hots are built by comparison, not ``F.one_hot``, which
range-checks its input on the host (a device sync per call on the card).
Ties in the top-k: ``torch.topk`` and ``lax.top_k`` may order equal gates
differently, so parity with JAX holds on inputs without ties.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from gradaccum_tpu_torch.parallel import tp
from gradaccum_tpu_torch.parallel.mesh import EXPERT_AXIS, DataMesh
from gradaccum_tpu_torch.parallel.sharding import P


class ExpertShards(NamedTuple):
    """Where this rank's block of an expert bank lies: its experts start at
    ``first``; ``group`` is the mesh over the ranks whose partial outputs
    sum (the expert axis, with ``model`` when the FFN width is split too);
    ``model`` is that model axis's mesh (its rank 0 alone adds ``b_out``),
    or None."""

    first: int
    group: DataMesh
    model: Optional[DataMesh] = None


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer ``idx`` over ``n`` classes; an index out
    of range gives a row of zeros, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_init(generator: torch.Generator, d_model: int, d_hidden: int,
             num_experts: int) -> Dict[str, torch.Tensor]:
    """float32 parameters from ``generator``: router [D, E] and the expert
    FFNs [E, D, H] / [E, H, D] normal with standard deviations 1/sqrt(D)
    and 1/sqrt(H), zero biases [E, H] / [E, D]."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    scale_in, scale_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
    return {
        "router": normal((d_model, num_experts), scale_in),
        "w_in": normal((num_experts, d_model, d_hidden), scale_in),
        "b_in": torch.zeros(num_experts, d_hidden),
        "w_out": normal((num_experts, d_hidden, d_model), scale_out),
        "b_out": torch.zeros(num_experts, d_model),
    }


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              capacity_factor: float = 1.25, top_k: int = 1,
              ep: Optional[ExpertShards] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE FFN on ``x`` [..., T, D] (leading dims folded into T).

    ``top_k=1`` weights each token by its raw gate (Switch); ``top_k > 1``
    renormalizes the selected gates to sum 1 (GShard). Returns ``(y, aux)``
    with ``y`` zero for dropped tokens and ``aux = {"load_balance_loss",
    "dropped_fraction", "router_entropy"}`` (0-d float32 tensors).

    With ``ep`` the expert leaves of ``params`` are this rank's block
    (``w_in`` [E/ep, D, H/tp], ...; the router whole): the routing is the
    whole bank's, the experts run are this rank's, and ``y`` is summed over
    ``ep.group`` (the module docstring).
    """
    orig_shape = x.shape
    d = orig_shape[-1]
    x2 = x.reshape(-1, d)  # [T, D]
    t = x2.shape[0]
    e = params["router"].shape[-1]
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k={top_k} must be in [1, num_experts={e}]")
    # GShard capacity: top_k·t assignments over e experts
    capacity = int(math.ceil(top_k * t / e * capacity_factor))

    gates = torch.softmax((x2 @ params["router"]).float(), dim=-1)  # [T, E]
    top_gates, top_idx = torch.topk(gates, top_k, dim=-1)  # [T, k]
    x_in = x2
    if ep is not None:
        # the expert region's partial results sum over ep.group: their
        # gradients into x and the gates do too, once
        x_in = tp.copy_to(x2, ep.group)
        top_gates = torch.gather(tp.copy_to(gates, ep.group), -1, top_idx)
    weights = top_gates if top_k == 1 else top_gates / top_gates.sum(dim=-1, keepdim=True)

    dev = x2.device
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    prior = torch.zeros(e, dtype=torch.float32, device=dev)  # slots earlier ranks claimed
    kept = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(top_k):
        onehot = _one_hot(top_idx[:, r], e)  # [T, E]
        # position of each token in its expert's queue, after earlier ranks
        position = (torch.cumsum(onehot, dim=0) + prior[None, :]) * onehot - 1.0
        keep = (position >= 0) & (position < capacity)  # [T, E]; at most one per row
        pos = (position * keep).sum(dim=-1).to(torch.int64)  # [T]
        disp_r = _one_hot(pos, capacity)[:, None, :] * keep.float()[:, :, None]
        dispatch = dispatch + disp_r
        combine = combine + disp_r * weights[:, r, None, None]
        prior = prior + onehot.sum(dim=0)
        kept = kept + disp_r.sum()

    dt = x2.dtype
    b_out = params["b_out"]
    if ep is not None:  # this rank's experts
        local = slice(ep.first, ep.first + params["w_in"].shape[0])
        dispatch, combine = dispatch[:, local], combine[:, local]
        if ep.model is not None:
            b_out = tp.copy_to(b_out, ep.model) * (1.0 if ep.model.rank == 0 else 0.0)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), x_in)  # [E, C, D]
    h = torch.einsum("ecd,edh->ech", expert_in, params["w_in"])
    h = F.gelu(h + params["b_in"][:, None, :])  # exact erf GELU
    out = torch.einsum("ech,ehd->ecd", h, params["w_out"]) + b_out[:, None, :]
    y = torch.einsum("tec,ecd->td", combine.to(dt), out)  # zeros for dropped tokens
    if ep is not None:
        y = tp.reduce_from(y, ep.group)

    token_frac = _one_hot(top_idx[:, 0], e).mean(dim=0)
    aux = {
        "load_balance_loss": e * torch.sum(token_frac * gates.mean(dim=0)),
        "dropped_fraction": 1.0 - kept / (t * top_k),
        "router_entropy": -torch.mean(torch.sum(gates * torch.log(gates + 1e-9), dim=-1)),
    }
    return y.reshape(orig_shape), aux


def moe_ep_rules(axis: str = EXPERT_AXIS):
    """Sharding rules (``parallel/sharding.py :: shard_params``): the
    expert dim of every expert-stacked leaf over the ``expert`` axis; the
    router stays replicated. JAX's patterns."""
    return [
        (r"w_in", P(axis, None, None)),
        (r"b_in", P(axis, None)),
        (r"w_out", P(axis, None, None)),
        (r"b_out", P(axis, None)),
    ]
