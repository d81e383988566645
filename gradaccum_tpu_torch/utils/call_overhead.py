"""Wall time per call of the flash-attention wrapper on the card.

A BERT-Small step leaves the card idle most of the time: the host's
dispatch, not the kernels, bounds it. This script times what one call of
``ops/flash_attention.py :: flash_attention`` costs the host at the main
path's shape (bf16 [8, 8, 128, 64], padded mask, dropout 0.1): the training
forward (inputs that need gradients, through the autograd function), the
same forward and its backward, and the inference forward (no gradients).
Each number is the wall time of ``calls`` calls in a row divided by
``calls``, after a warm-up, with one ``torch.cuda.synchronize`` at the end,
so it is the host's cost whenever the host is slower than the kernel (the
kernel's card time, 0.0066 ms, is in ``PERF.md``'s kernel table).

Where the forward is the dispatcher operator ``gradaccum::flash_fwd``, the
same kernel is also registered through ``torch.library.custom_op`` under a
second name and timed, so the two ways of registering compare on one card.

It only uses names every version of the module has, so the same script
times an older checkout of the package: run it from that checkout's root
with this file's path, e.g.

    python3 -m gradaccum_tpu_torch.utils.call_overhead
    cd OLD && python3 ../gradaccum_tpu_torch/utils/call_overhead.py

and it prints one JSON line.
"""

import json
import os
import sys
import time


def _wall_ms(fn, calls: int, warmup: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def _custom_op_variant(fa):
    """The CUDA forward registered with ``torch.library.custom_op`` under
    its own name (for comparison only; the port registers through
    ``torch.library.Library``). Its annotations are evaluated here, where
    ``torch`` is imported, as the schema inference needs."""
    from typing import Optional, Tuple

    import torch

    @torch.library.custom_op("gradaccum_timing::flash_fwd", mutates_args=(),
                             device_types="cuda")
    def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
           seed: Optional[torch.Tensor], causal: bool,
           rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
        return fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)

    return op


def measure(calls: int = 2000) -> dict:
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    fa.build_kernels()
    b, h, s, d = 8, 8, 128, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, device="cuda", dtype=torch.bfloat16, generator=g)
               for _ in range(3))
    mask = torch.zeros(b, 1, 1, s, device="cuda", dtype=torch.bfloat16)
    mask[0, ..., s // 2:] = -1e9
    seed = torch.tensor([1234], device="cuda", dtype=torch.int64)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    do = torch.randn_like(q)
    kw = dict(dropout_rate=0.1, dropout_seed=seed)

    def train_fwd():
        return fa.flash_attention(qg, kg, vg, mask, **kw)

    def train_fwd_bwd():
        train_fwd().backward(do)

    def infer():
        with torch.no_grad():
            return fa.flash_attention(q, k, v, mask, **kw)

    out = {"shape": [b, h, s, d], "dtype": "bfloat16", "calls": calls,
           "device": torch.cuda.get_device_name(0),
           "operator": hasattr(fa, "flash_fwd_op"),
           "train_forward_ms": _wall_ms(train_fwd, calls),
           "train_forward_backward_ms": _wall_ms(train_fwd_bwd, calls // 4),
           "inference_forward_ms": _wall_ms(infer, calls),
           "kernel_wrapper_ms": _wall_ms(lambda: fa.flash_fwd_cuda(q, k, v, mask, seed,
                                                                    False, 0.1), calls)}
    if out["operator"]:
        out["operator_ms"] = _wall_ms(lambda: fa.flash_fwd_op(q, k, v, mask, seed, False, 0.1),
                                      calls)
        custom = _custom_op_variant(fa)
        out["custom_op_ms"] = _wall_ms(lambda: custom(q, k, v, mask, seed, False, 0.1), calls)
    return out


if __name__ == "__main__":
    # the checkout whose package is timed is the working directory; run as
    # a file, this file's own directory must not shadow stdlib modules
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.getcwd()] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    print(json.dumps(measure()))
