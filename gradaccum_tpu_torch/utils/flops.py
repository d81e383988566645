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
                             num_classes: int) -> float:
    """Analytic fwd+bwd matmul FLOPs for one sequence of BERT fine-tuning.

    Per token per layer: QKVO projections ``4*(2*H*H)`` + FFN ``2*(2*H*I)``;
    attention scores and context ``2*(2*S*H)``. Pooler + classifier once per
    sequence. Backward ~= 2x forward, so train = 3x forward.
    """
    per_tok = layers * (8 * hidden * hidden + 4 * hidden * intermediate + 4 * seq * hidden)
    fwd = seq * per_tok + 2 * hidden * hidden + 2 * hidden * num_classes
    return 3.0 * fwd
