"""Device selection for the port's entry points.

Entry points run on the card unless the caller names the CPU: asking for
CUDA on a machine without a card raises instead of quietly running the
plain versions on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def upload(array, device: torch.device) -> torch.Tensor:
    """Host data (numpy or a CPU tensor) onto ``device`` without waiting for
    the card: staged through pinned memory and copied with
    ``non_blocking=True``, it queues behind the card's work, where a plain
    ``.to("cuda")`` of pageable memory synchronizes the stream first. The
    caching host allocator keeps the staging buffer until the copy is done.
    On the CPU it is ``torch.as_tensor``."""
    t = torch.as_tensor(array)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
