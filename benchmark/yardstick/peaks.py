"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
dense rates at the full power limit; the run records the card's own limit
beside them). Keyed by a substring of ``torch.cuda.get_device_name()``."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {
        "bf16": 989e12,  # dense tensor-core bfloat16
        "f32x3": 495e12 / 3,  # float32 as three TF32 products (495 TFLOP/s) in the tf32x3 kernels
        "hbm": 3.35e12,  # bytes/s
    },
}


def peaks_for(device_name: str) -> Optional[dict]:
    for key, peaks in PEAKS.items():
        if key.lower() in device_name.lower():
            return peaks
    return None
