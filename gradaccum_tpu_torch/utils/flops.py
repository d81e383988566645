"""Analytic FLOPs and the card's peak, for the MFU the entry point prints
(the port of ``gradaccum_tpu/utils/flops.py``)."""

from __future__ import annotations

from typing import Optional

# dense bf16 tensor-core peak FLOP/s by device-name substring (NVIDIA's data
# sheet, H100 SXM at its 700 W limit; a card set below it peaks lower)
PEAK_BF16_FLOPS = [
    ("h100", 989e12),
]


def peak_flops_for(device_name: str) -> Optional[float]:
    """bf16 peak FLOP/s for a ``torch.cuda.get_device_name`` string; None if
    unknown (the CPU, or another card): callers then omit MFU."""
    name = device_name.lower()
    for sub, peak in PEAK_BF16_FLOPS:
        if sub in name:
            return peak
    return None


def bert_train_flops_per_seq(hidden: int, layers: int, intermediate: int, seq: int,
                             num_classes: int, num_experts: int = 0,
                             moe_top_k: int = 1) -> float:
    """Analytic fwd+bwd matmul FLOPs for one sequence of BERT fine-tuning.

    Per token per layer: QKVO projections ``4*(2*H*H)`` + FFN ``2*(2*H*I)``;
    attention scores and context ``2*(2*S*H)``. Pooler + classifier once per
    sequence. Backward ~= 2x forward, so train = 3x forward. With
    ``num_experts`` (MoE FFN) each token runs ``moe_top_k`` experts of the
    same ``intermediate`` size plus the router, ``2*H*E``.
    """
    ffn = 4 * hidden * intermediate
    if num_experts > 0:
        ffn = ffn * moe_top_k + 2 * hidden * num_experts
    per_tok = layers * (8 * hidden * hidden + ffn + 4 * seq * hidden)
    fwd = seq * per_tok + 2 * hidden * hidden + 2 * hidden * num_classes
    return 3.0 * fwd
