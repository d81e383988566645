#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA H100.

    python3 chip_smoke.py     # one card, about three minutes

Phases, each of which fails the run if it fails:

1. build: compile every CUDA source of ``gradaccum_tpu_torch/csrc`` with
   nvcc (one process per source, all started together); print the time and
   each kernel's registers and spills as ptxas reports them, and fail if
   any float32 kernel (forward, dq, dk/dv) spills at any head dim.
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the BERT-Small main-path shape q/k/v [8, 8, 128, 64], in float32
   (``flash_attention.cu``: forward, dq and dk/dv on the tensor cores in
   3xTF32) and bfloat16 (``flash_attention_tc.cu``), with a padded mask
   and without, causal, and with attention dropout 0.1 under a fixed seed;
   in both dtypes also at ragged lengths S = 100 and 200 and at head dim
   128, in float32 also at head dims 16 and 32; and at GPT's shapes,
   causal, no mask, dropout 0.1: [8, 8, 512, 64] in bfloat16 and float32
   (GPT-Small) and [16, 4, 64, 32] in float32 (``gpt_lm``). The dq
   kernel's delta = rowsum(dO * O) is held against the plain one. Read the
   keep mask back out of the forward, dq and dk/dv kernels (float32 and
   bfloat16, both at S = 200, and at both GPT shapes) and require it equal
   to the plain mask bit for bit. Then time each kernel, its plain version
   and the PyTorch call that computes the same function
   (scaled_dot_product_attention's forward, and its backward, which
   computes dq, dk and dv together, for both backward kernels; never used
   by the port), at the main path's conditions in bfloat16 and in float32
   (``bert_finetune``'s default dtype), and at GPT-Small's (bf16 and
   float32 [8, 8, 512, 64], causal: SDPA with is_causal=True) and
   ``gpt_lm``'s (float32 [16, 4, 64, 32], causal).
3. agree: the tiny BERT classifier's loss and gradients on the card (through
   the kernels) against the same model on the CPU (plain versions).
4. main: the entry point ``gradaccum_tpu_torch/examples/bert_finetune.py``
   at BERT-Small width (L-4 H-512 A-8, vocab 30522, seq 128), micro-batch
   8 x K=4, bfloat16 compute, random weights from a seed, scan mode, for a
   few optimizer updates and its evaluations (after the first chunk and at
   the end). The kernels' launch counts are zeroed just before and read
   just after, and must match the path exactly, with every launch on the
   tensor-core route.
5. profile: a torch.profiler window over three more updates of the same
   run: wall and card-busy time per update, idle share, top kernels.
6. streaming: the same entry point in streaming mode (the reference's
   tf.cond train op, first-step quirk on), 8 windows of K=4 = 32 micro-batch
   calls and its evaluations; launch counts exact and all on the tensor
   cores, applies at micro-batch steps 0, 4, ..., 28; then a profile window
   over three of its updates (12 host steps), as in phase 5.
7. stream=scan: BERT-Small bf16 with dropout 0, the same weights and
   batches, 2 windows of quirk-free streaming against 2 scan updates: every
   float32 parameter within 1e-6 (the accumulation order is the same).
8. guard: streaming and scan BERT-Small bf16 with skip_nonfinite and a
   dynamic loss scale; one micro-batch of the first window and all of the
   second have a NaN loss. The skip counts must be exact, the all-bad
   window must leave parameters and moments bitwise unchanged, the scale
   must halve at each dirty window, and every parameter stay finite.
9. mnist / housing: the MNIST entry point, variants 01 (batch 200, K=1) and
   02 (batch 100, K=2), and the housing entry point (batch 59, K=3), in
   streaming mode on synthetic data: finite loss that falls below its first
   value, accuracy or MAE/RMSE and 5 predictions.
10. xla-bwd: ``flash_attention(bwd_impl="xla")`` (the forward kernel, then
    autograd through the blockwise core) against the kernels' backward
    (``"pallas"``) at [8, 8, 128, 64], float32 and bfloat16, with a padded
    mask and without, causal and not: dq, dk, dv and dmask within the TOL
    table (float32) or XLA_BWD_TOL (bfloat16). Per call the forward kernel
    launches once and the dq and dk/dv kernels never.
11. warm start: a BERT-Small HuggingFace directory (config.json,
    model.safetensors from a seeded generator, a 30522-line vocab.txt)
    and train/dev TSVs written here, then the entry point with
    ``--hf-checkpoint DIR --data-dir DIR --bf16``: before the first update
    every parameter equals the file's tensor bit for bit and the classifier
    is zero; then a few updates and the evaluations, launch counts exact
    and on the tensor cores.
12. remat: BERT-Small bf16, dropout 0.1, one scan update with remat and
    one without from the same weights, batch and generator seed: every
    parameter bitwise equal, the forward kernel launched twice as often in
    training (the recompute), the backward kernels as often; peak memory
    of both.
13. sparse embed: BERT-Small bf16, dropout 0, 2 scan updates with the
    word-embedding gradient accumulated as rows against the dense path,
    every parameter within SPARSE_ATOL; then a profile window of the entry
    point with ``--sparse-embed-grad``.
14. MoE: the entry point at BERT-Small width with 8 experts, top-2, bf16,
    scan: finite loss, exact launch counts; the loss is the cross entropy
    plus 0.01 x the mean load-balance loss; the dropped fraction, seq/s and
    MFU (against the MoE FLOPs).

15. GPT-Small ladder: GPT-Small (vocab 50257, L-4 H-512 A-8, FFN 2048),
    seq 512, micro 8 x K=4, dropout 0.1, on the causal flash kernels,
    seeded token ids, scan mode through the Estimator, four updates a leg:
    (a) float32 AdamW, (b) bfloat16 parameters with float32 masters, (c) (b)
    with fused Adam-accumulation, (d) (b) with q8 moments, (e) Adam-mini
    with masters and q8 moments; clip 1.0 except (c). Per leg: optimizer +
    accumulator and parameter bytes per parameter, peak memory above the
    starting state, seq/s and tokens/s, finite losses, launches exactly 16
    per kernel per update (on the float32 route ``tf32x3`` in (a), ``tc``
    otherwise). Then fused against two-pass bitwise at K=1 after one
    update, and 6 updates on one repeated batch with dropout 0: the bf16 +
    master loss within 8 % of the float32 loss at each, both below 0.8x
    their first. Then a profile window over two bf16 + master updates, and
    one over two float32 updates (leg (a)).
16. GPT guard: GPT-Small bf16 + master at depth 2, fused, skip_nonfinite and
    a dynamic loss scale, streaming and scan; NaN loss in one micro-batch of
    the first window and in all of the second: skip counts exact, the
    all-bad window a bitwise no-op over parameters, masters and moments,
    the scale halving at each dirty window.
17. gpt_lm: the entry point with ``--flash`` (float32, route ``tf32x3``),
    scan and streaming, 32 micro-steps and ``--sample 40``: the loss falls,
    token accuracy in [0, 1], launch counts exact from its JSON line.
18. bert f32: the entry point ``bert_finetune`` at its default dtype
    (float32, no ``--bf16``), BERT-Small width, seq 128, micro-batch 8 x
    K=4, scan, 2 updates and its evaluations: the only entry-point run of
    the float32 forward with a padded mask. Launch counts exact, every
    launch on the float32 route ``tf32x3``.

19. dp: data parallelism and ZeRO-1 (``gradaccum_tpu_torch/parallel``) on
    the one card. (a) World size 1 over NCCL: BERT-Small bf16 scan, micro 8
    x K=4, three updates through ``Estimator(mesh=...)``, parameters and
    moments bitwise equal to the no-mesh run from the same weights and
    batches, launch counts exact and on ``tc``, exactly one all-reduce per
    update; the NCCL kernels' card time from a profiler window over two
    more updates, and seq/s beside the no-mesh run's. (b) Two ranks that
    share the card over gloo, spawned here (``python3 chip_smoke.py
    --dp-rank DIR`` is a rank): explicit DP, BERT-Small bf16, micro 4 per
    rank x K=4, dropout 0, two updates, then ZeRO-1 ``"collective"`` on the
    same run; each rank within 1e-5 of the single-process run on the same
    global batches (each rank's micro-batches run on one card, so only the
    order of the sums differs) and ZeRO-1 within 1e-7 of DP; launch counts
    exact per rank; optimizer + accumulator bytes per parameter. (c) GPT-Small
    bf16 + float32 masters + fused + ZeRO-1 (ladder leg (c), ``zero1=True``)
    at the two ranks, two updates: bytes per parameter per rank (JAX's
    accounting: 6), peak memory per rank, a finite loss.

20. resilience (``resilience/``, ``obs/``, the Estimator's hooks), BERT-Small
    bf16 micro 8 x K=4, dropout 0.1, random weights from the run seed:
    (a) streaming, async checkpoints every 3 micro-steps, a crash injected
    after a seeded micro-step inside a window; a fresh Estimator resumes
    from the newest checkpoint (itself mid-window) and its parameters, m, v,
    accumulators and post-resume losses are bitwise those of the
    uninterrupted run; the flight dump holds the fault; the uninterrupted
    run's train/step spans carry the accumulate/apply labels. (b) One byte of
    the newest checkpoint flipped: quarantined, and the restore equals the
    previous checkpoint exactly. (c) The process sends itself SIGTERM: the
    final checkpoint lands at that micro-step with the async writer drained,
    and the resume is bitwise. (d) Two gloo ranks share the card through the
    launcher (``python3 chip_smoke.py --drain-rank DIR`` is a rank), explicit
    DP in scan mode; rank 1 alone is preempted, and DrainConsensus over the
    c10d store stops both at the same micro-step, where the final checkpoint
    lands. (e) A StepWindowProfiler window of 2 updates writes a Chrome trace
    holding K1, K2 and K3 under their kernel names (32 each); the scan spans
    are labelled scan-cycle. (f) Card-busy ms per update and seq/s with obs
    and the async writer on, then both off, a checkpoint every update: a
    finding, printed, not a gate.
21. export: BERT-Small exported in float32 (route ``tf32x3``) and bf16
    (``tc``) through ``Estimator.export_model`` from a one-row sample, and
    ``gpt_lm --flash --export-dir`` and ``housing --export-dir`` after their
    training; one fresh process that imports only
    ``gradaccum_tpu_torch.estimator.export`` loads every artifact and calls
    it at batch 8 and 3: outputs within 1e-6 (float32) / 1e-2 (bf16) of
    ``predict`` on the same weights and batch, classes equal, the flash
    forward launched inside each kernel artifact on the expected route
    (counted by the wrapper and by the profiler), none in housing's, no
    model module imported. Then the native reader (``data/native.py``) is
    built and byte-identical to the numpy readers on a generated idx pair
    and CSV, and the flash wrapper's wall time per call is printed
    (``utils/call_overhead.py``). The exports run before phase 20, and the
    loader process beside it; the checks come after it.

The last three lines of standard output are the card's name and power
limit, a JSON line describing every kernel in each dtype (bfloat16: launches
from the main path; float32: from ``gpt_lm --flash`` in scan mode, and from
phase 18 under ``launches_bert_f32``), and the
result line ``{"ok": true, "device": {...}}``. Without a card, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "gradaccum_tpu_torch"

# the BERT-Small main path: micro-batch 8, 8 heads, seq 128, head dim 64
B, H, S, D = 8, 8, 128, 64
RATE, SEED = 0.1, 0x5EED1234
UPDATES = 8  # optimizer updates on the main path
LAYERS, K = 4, 4  # BERT-Small depth, and K on the main path
# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s and FLOP/s by type.
# float32: the fastest float32-accurate product rate of the card, 3xTF32 on the
# tensor cores (495 TFLOP/s of TF32, three products for each), so that a bound
# is the least time for the work whatever the kernel runs; the 67 TFLOP/s of
# float32 FMA outside the tensor cores is printed beside it.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 495e12 / 3}
F32_FMA_FLOPS = 67e12
# |kernel - plain| <= ATOL + RTOL*|plain|, per output. float32: both sides
# run float32 math in another summation order. bfloat16: both compute in
# float32 from the same bf16 inputs; o/dq/dk/dv round once to bf16 (2^-8
# relative), lse and dmask stay float32. delta (the dq kernel's row
# correction) sums the same float32 products in another order, in both
# dtypes (a product of two bf16 values is exact in float32).
TOL = {
    "torch.float32": {"o": (1e-5, 1e-5), "lse": (1e-5, 1e-5), "dq": (1e-4, 1e-4),
                      "delta": (1e-5, 1e-5), "dk": (1e-4, 1e-4), "dv": (1e-4, 1e-4),
                      "dmask": (1e-4, 1e-4)},
    "torch.bfloat16": {"o": (1e-2, 1e-2), "lse": (1e-4, 1e-4), "dq": (1e-2, 1e-2),
                       "delta": (1e-5, 1e-5), "dk": (1e-2, 1e-2), "dv": (1e-2, 1e-2),
                       "dmask": (1e-3, 1e-3)},
}
REPLACES = {
    "flash_fwd": "gradaccum_tpu/ops/flash_attention.py:127",
    "flash_bwd_dq": "gradaccum_tpu/ops/flash_attention.py:348",
    "flash_bwd_dkv": "gradaccum_tpu/ops/flash_attention.py:399",
}
# the source of each kernel by dtype: bfloat16 (the main path) and float32
SOURCES = {"torch.bfloat16": f"{PACKAGE}/csrc/flash_attention_tc.cu",
           "torch.float32": f"{PACKAGE}/csrc/flash_attention.cu"}
# beside the main shape: the ragged lengths (one key tile with a ragged edge,
# and more than one) and the widest head dim; float32 also the narrow head
# dims, so that it runs every head dim the wrapper accepts
EXTRA_SHAPES = [(B, H, 100, D), (B, H, 200, D), (B, H, S, 128)]
F32_EXTRA_SHAPES = EXTRA_SHAPES + [(B, H, S, 16), (B, H, S, 32)]
# the float32 kernels ptxas must report without spills, at every head dim
NO_SPILL = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
# GPT-Small's attention (micro 8, 8 heads, seq 512, head dim 64: bf16 on the
# tensor cores, and float32 in ladder leg (a)) and gpt_lm's (micro 16,
# 4 heads, seq 64, head dim 32, float32): causal, no mask, dropout 0.1
GPT_SHAPE = (8, 8, 512, 64)
GPT_LM_SHAPE = (16, 4, 64, 32)
# bwd_impl="xla" in bfloat16 against the kernels' backward: the blockwise
# core computes as JAX's does, its scores, P and the autograd cotangents
# rounded to bf16 (2^-8 relative) before each product, where the kernels
# keep them float32: 1-3 % relative on dq/dk/dv. dmask comes back in the
# mask's bf16 on both paths, whose spacing is 0.25 for |dmask| in [32, 64).
XLA_BWD_TOL = {"dq": (3e-2, 3e-2), "dk": (3e-2, 3e-2), "dv": (3e-2, 3e-2),
               "dmask": (0.5, 3e-2)}
# sparse against dense embedding gradients after 2 AdamW updates at lr
# 2e-5: the table's gradient sums the same float32 row cotangents in another
# order (index_add_ on the card adds with atomics), and AdamW without bias
# correction moves a weight by up to 2x a gradient difference (lr/eps·0.1)
SPARSE_ATOL = 1e-6


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# --------------------------------------------------------------------------
# phase 1: build
# --------------------------------------------------------------------------


def phase_build():
    from gradaccum_tpu_torch.utils import cuda_build

    sources = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    # one nvcc per source, all started together (threads wait on subprocesses)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        for future in [pool.submit(cuda_build.build, s) for s in sources]:
            future.result()
    from gradaccum_tpu_torch.ops import flash_attention as fa

    fa.build_kernels()
    print(f"[build] {len(sources)} source(s) in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{s} {cuda_build.build_seconds.get(s, 0.0):.1f} s" for s in sources))
    spilled, seen = [], set()
    for s in sources:
        log = cuda_build.library_path(s).with_suffix(".log")
        for name, regs, stores, loads in _ptxas_summary(log.read_text()):
            print(f"[build] ptxas {s}: {name} {regs} registers, spill stores {stores} B, "
                  f"loads {loads} B")
            seen.add(name)
            if name.split("<")[0] in NO_SPILL and (stores or loads):
                spilled.append(name)
    missing = [f"{k}<{d}>" for k in NO_SPILL for d in (16, 32, 64, 128)
               if f"{k}<{d}>" not in seen]
    check(not missing, f"no ptxas report for {missing}")
    check(not spilled, f"ptxas reports spills in {spilled}")


def _ptxas_summary(text):
    """``(kernel, registers, spill store bytes, spill load bytes)`` for each
    kernel instance in nvcc's ``-Xptxas -v`` report."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            # e.g. ..18flash_dq_tc_kernelILi64EEEv.. -> flash_dq_tc_kernel<64>
            name, spills = entry.group(1), (0, 0)
            m = re.search(r"(flash_[a-z_]+?_kernel)ILi(\d+)EEEv", name)
            if m:
                name = f"{m.group(1)}<{m.group(2)}>"
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append((name, int(regs.group(1))) + spills)
            name = None
    return out


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def _inputs(dtype, masked, seed=0, shape=(B, H, S, D)):
    import torch

    b, _, s, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    mask = None
    if masked:
        # padded keys as BERT builds them: (1 - input_mask) * -1e9
        lengths = torch.randint(s // 4, s + 1, (b,), generator=g, device="cuda")
        pad = torch.arange(s, device="cuda")[None, :] >= lengths[:, None]
        mask = (pad.float() * -1e9).to(dtype).reshape(b, 1, 1, s).contiguous()
    return q, k, v, mask, do


def _err(name, got, want, dtype):
    atol, rtol = TOL[str(dtype)][name]
    got, want = got.float(), want.float()
    check(bool(got.isfinite().all()), f"{name}: non-finite kernel output")
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return float(err.max()), ok, atol, rtol


def phase_kernels():
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    # (padded mask, causal, dropout rate)
    cases = [(True, False, 0.0), (False, False, 0.0), (False, True, 0.0),
             (True, False, RATE), (True, True, RATE)]
    gpt = [(False, True, RATE)]
    runs = [(torch.float32, (B, H, S, D), cases), (torch.bfloat16, (B, H, S, D), cases)]
    runs += [(torch.bfloat16, shape, cases) for shape in EXTRA_SHAPES]
    runs += [(torch.float32, shape, cases) for shape in F32_EXTRA_SHAPES]
    runs += [(torch.bfloat16, GPT_SHAPE, gpt), (torch.float32, GPT_SHAPE, gpt),
             (torch.float32, GPT_LM_SHAPE, gpt)]
    for dtype, shape, shape_cases in runs:
        for masked, causal, rate in shape_cases:
            q, k, v, mask, do = _inputs(dtype, masked, shape=shape)
            seed = SEED if rate else None
            o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)
            o_r, lse_r = fa.flash_forward_reference(q, k, v, mask, seed, causal, rate)
            # each backward kernel gets exactly its plain twin's inputs: dk/dv
            # the plain delta, which the dq kernel's own is held against
            delta = fa._delta(do, o_r)
            dq, delta_k = fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, o_r, lse_r, causal,
                                               rate)
            dk, dv, dm = fa.flash_bwd_dkv_cuda(q, k, v, mask, seed, do, lse_r, delta,
                                               causal, rate)
            dq_r, dk_r, dv_r, dm_r = fa.flash_backward_reference(
                q, k, v, mask, seed, o_r, lse_r, do, causal, rate)
            torch.cuda.synchronize()
            outs = {"o": (o, o_r), "lse": (lse, lse_r), "dq": (dq, dq_r),
                    "delta": (delta_k, delta), "dk": (dk, dk_r), "dv": (dv, dv_r)}
            if masked:
                outs["dmask"] = (dm, dm_r)
            line = []
            for name, (got, want) in outs.items():
                err, ok, atol, rtol = _err(name, got, want, dtype)
                kernel = {"o": "flash_fwd", "lse": "flash_fwd", "dq": "flash_bwd_dq",
                          "delta": "flash_bwd_dq"}.get(name, "flash_bwd_dkv")
                key = (kernel, str(dtype))
                worst[key] = max(worst.get(key, 0.0), err)
                line.append(f"{name}={err:.2e}")
                check(ok, f"{name} disagrees ({dtype}, {shape}, mask={masked}, "
                          f"causal={causal}, rate={rate}): max |err| {err:.3e} > "
                          f"{atol} + {rtol}|ref|")
            print(f"[kernels] {str(dtype)[6:]:8s} {shape} mask={int(masked)} "
                  f"causal={int(causal)} rate={rate}: " + " ".join(line))
    for dtype, shape in ((torch.float32, (B, H, S, D)), (torch.bfloat16, (B, H, S, D)),
                         (torch.bfloat16, (B, H, 200, D)), (torch.float32, (B, H, 200, D)),
                         (torch.bfloat16, GPT_SHAPE),
                         (torch.float32, GPT_SHAPE), (torch.float32, GPT_LM_SHAPE)):
        _check_keep_masks(fa, dtype, shape)
    return worst


def _check_keep_masks(fa, dtype, shape):
    """Read the keep decisions back out of the forward, dq and dk/dv kernels
    and require them equal to the plain mask. With q = k = 0 every
    probability is 1/s, so o[i, d] = keep[i, c*D + d]/(keep_prob*s) when v
    is the one-hot block c; dv[j, d] = keep[c*D + d, j]/(keep_prob*s)
    likewise when dO is the one-hot block c of query rows. For dq, q = 0,
    o = 0 (so delta = 0) and every row of v and dO is e_0 (so dP = 1); with
    k the one-hot block c, dq[i, d] = scale*keep[i, c*D + d]/(keep_prob*s).
    All three are positive (bfloat16 too) exactly where the element is
    kept. The last block of a ragged length is narrower than D."""
    import torch

    b, h, s, d = shape
    want = fa.dropout_keep_mask(SEED, b, h, s, RATE, device="cuda")
    zeros = torch.zeros(shape, dtype=dtype, device="cuda")
    e0 = torch.zeros(shape, dtype=dtype, device="cuda")
    e0[..., 0] = 1
    lse = torch.full((b, h, s, 1), math.log(s), device="cuda")
    delta = torch.zeros(b, h, s, 1, device="cuda")
    got = {name: torch.empty(b, h, s, s, dtype=torch.bool, device="cuda")
           for name in ("forward", "dq", "dk/dv")}
    for c0 in range(0, s, d):
        w = min(d, s - c0)
        onehot = torch.zeros(shape, dtype=dtype, device="cuda")
        onehot[:, :, c0:c0 + w, :w] = torch.eye(w, dtype=dtype, device="cuda")
        o, _ = fa.flash_fwd_cuda(zeros, zeros, onehot, None, SEED, False, RATE)
        got["forward"][..., c0:c0 + w] = o[..., :w] > 0
        dq, _ = fa.flash_bwd_dq_cuda(zeros, onehot, e0, None, SEED, e0, zeros, lse,
                                     False, RATE)
        got["dq"][..., c0:c0 + w] = dq[..., :w] > 0
        _, dv, _ = fa.flash_bwd_dkv_cuda(zeros, zeros, zeros, None, SEED, onehot, lse,
                                         delta, False, RATE)
        got["dk/dv"][:, :, c0:c0 + w, :] = (dv[..., :w] > 0).transpose(-1, -2)
    torch.cuda.synchronize()
    kind = f"{str(dtype)[6:]} {list(shape)}"
    for name, mask in got.items():
        check(torch.equal(mask, want), f"{name} kernel keep mask ({kind}) differs "
                                       f"from the plain mask")
    print(f"[kernels] keep mask exact in flash_fwd, flash_bwd_dq and flash_bwd_dkv, "
          f"{kind} (route {fa.route(dtype)}; rate {RATE}, seed {SEED:#x}, "
          f"kept {want.float().mean().item():.4f})")


def _time_ms(fn, iters=50, warmup=5):
    """Wall time per call (ms) of back-to-back calls, between two CUDA
    events: the card's time when a call's kernels outlast its host
    dispatch, the dispatch's when they do not."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, iters=50, warmup=5, attempts=3):
    """Card time per call (ms): the device time of every kernel, copy and
    memset the calls launched, summed from torch.profiler's device events,
    over the number of calls. Host dispatch is not in it. Returns the time
    and the device events' names, the longest first. A window that records
    no device event at all (seen once, in the first window of a process),
    or an event a number of times that is not a multiple of the calls (a
    window that lost some of its events would read low), is profiled again;
    the last attempt's reading stands, with a note."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        device = sorted(((e.self_device_time_total, e.key) for e in events), reverse=True)
        ragged = [f"{e.key[:40]} x{e.count}" for e in events if e.count % iters]
        if device and (not ragged or attempt + 1 == attempts):
            if ragged:
                print(f"[timing] device events not a multiple of {iters} calls: {ragged}")
            return sum(t for t, _ in device) / iters / 1e3, [key for _, key in device]
        print(f"[timing] profiler window {attempt + 1} of {attempts} saw "
              + (f"device events not a multiple of {iters} calls: {ragged}" if device
                 else "no device event"))
    raise SmokeError("the profiler saw no device time: card times cannot be read")


def _bounds(dtype, masked, shape=(B, H, S, D), causal=False):
    """Least time (ms) for each kernel's work at ``shape``: bytes it must
    move (inputs read once, outputs written once) over the memory rate,
    against its matrix-product FLOPs over the peak for its type. Causal
    attention computes the lower triangle only: half the FLOPs."""
    import torch

    b, h, s, d = shape
    e = torch.finfo(dtype).bits // 8
    act = b * h * s * d * e  # one [B,H,S,D] tensor
    row = b * h * s * 4  # one f32 [B,H,S] row tensor (lse, delta, dmask)
    mask = b * s * e if masked else 0
    seed = 8
    pairs = b * h * s * s * d // (2 if causal else 1)  # (query, key) pairs x D
    work = {
        # q k v mask seed -> o lse; QK^T and PV
        "flash_fwd": (3 * act + mask + seed + act + row, 4 * pairs),
        # q k v dO o lse mask seed -> dq delta; QK^T, dO V^T, dS K
        "flash_bwd_dq": (5 * act + row + mask + seed + act + row, 6 * pairs),
        # q k v dO lse delta mask seed -> dk dv dmask; QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkv": (4 * act + 2 * row + mask + seed + 2 * act + (row if masked else 0),
                          8 * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
    return out


def phase_timing(shape=(B, H, S, D), masked=True, causal=False, label="bert", dtype=None):
    """Each kernel, its plain version and the library yardstick with dropout
    0.1: at the main path's conditions (BERT-Small bf16, padded mask, not
    causal), or at GPT's (no mask, causal: GPT-Small's seq 512 in bf16 and
    float32, gpt_lm's [16, 4, 64, 32] in float32). Every number is card time
    per call (torch.profiler device events); the wall time per call of
    back-to-back calls, dispatch included, is printed beside each
    kernel's."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from gradaccum_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    q, k, v, mask, do = _inputs(dtype, masked, seed=1, shape=shape)
    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda")
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, RATE)
    _, delta = fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, o, lse, causal, RATE)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, mask, seed, causal, RATE),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(
            q, k, v, mask, seed, do, o, lse, causal, RATE),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, mask, seed, do, lse, delta, causal, RATE),
    }
    ms = {name: _device_ms(fn)[0] for name, fn in calls.items()}
    wall = {name: _time_ms(fn) for name, fn in calls.items()}
    # the plain backward computes dq, dk, dv and dmask in one pass: its time
    # stands beside both backward kernels
    plain_bwd = _device_ms(lambda: fa.flash_backward_reference(
        q, k, v, mask, seed, o, lse, do, causal, RATE), iters=20)[0]
    plain = {
        "flash_fwd": _device_ms(lambda: fa.flash_forward_reference(
            q, k, v, mask, seed, causal, RATE), iters=20)[0],
        "flash_bwd_dq": plain_bwd,
        "flash_bwd_dkv": plain_bwd,
    }
    # SDPA's backward computes dq, dk and dv in one call: its time stands
    # beside both backward kernels, so K2 + K3 is the fair comparison. The
    # window holds the backward alone (the forward ran once, before it).
    # The backend is pinned, so every run times the same kernels: the
    # memory-efficient one takes an additive mask and dropout in bfloat16.
    backend = SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        sdpa_fwd, fwd_kernels = _device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=RATE, is_causal=causal))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, dropout_p=RATE,
                                                is_causal=causal)
    sdpa_bwd, bwd_kernels = _device_ms(lambda: torch.autograd.grad(
        o_sdpa, (qg, kg, vg), do, retain_graph=True))
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}
    print(f"[timing] {label} {str(dtype)[6:]} {list(shape)} mask={int(masked)} "
          f"causal={int(causal)}")
    print(f"[timing] sdpa backend {backend.name}: forward {sdpa_fwd:.4f} ms "
          f"({', '.join(n[:60] for n in fwd_kernels[:3])}), backward (dq + dk + dv) "
          f"{sdpa_bwd:.4f} ms ({', '.join(n[:60] for n in bwd_kernels[:3])}); "
          f"flash dq + dk/dv {ms['flash_bwd_dq']:.4f} + {ms['flash_bwd_dkv']:.4f} = "
          f"{ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.4f} ms")
    bounds = _bounds(dtype, masked, shape, causal)
    for name in ms:
        nbytes, flops = bounds[name][2], bounds[name][3]
        fma = ""
        if dtype == torch.float32:
            fma = (f"; {max(nbytes / PEAK_BYTES, flops / F32_FMA_FLOPS) * 1e6:.2f} us at "
                   f"the {F32_FMA_FLOPS / 1e12:.0f} TFLOP/s of float32 FMA")
        print(f"[timing] {name} ({fa.route(dtype)}): {ms[name]:.4f} ms on the card, "
              f"{wall[name]:.4f} ms a call with dispatch (plain {plain[name]:.4f} ms, "
              f"sdpa {library[name]:.4f} ms; bound {bounds[name][0] * 1e3:.2f} us by "
              f"{bounds[name][1]}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP{fma})")
    return ms, plain, library, bounds


# --------------------------------------------------------------------------
# phase 3: the card against the CPU on a small model
# --------------------------------------------------------------------------


def phase_agree():
    import numpy as np
    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.utils.tree import named_parameters

    cfg = BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    rng = np.random.default_rng(7)
    n, s = 4, 16
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int64)
    batch = {"input_ids": rng.integers(5, cfg.vocab_size, size=(n, s)) * mask,
             "input_mask": mask, "segment_ids": np.zeros((n, s), np.int64),
             "label": rng.integers(0, 2, size=n)}
    results = {}
    for device in ("cpu", "cuda"):
        bundle = bert_classifier_bundle(cfg, attention_fn=flash_attention)
        model = bundle.init(0, device)
        params = named_parameters(model)
        tb = {key: torch.as_tensor(val, device=device) for key, val in batch.items()}
        tb["rng"] = torch.Generator(device=device).manual_seed(0)
        loss = bundle.loss(model, tb)
        grads = torch.autograd.grad(loss, list(params.values()))
        results[device] = (loss.item(), {name: g.cpu() for name, g in zip(params, grads)})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results["cuda"]
    check(math.isfinite(l_gpu), "tiny BERT loss on the card is not finite")
    check(abs(l_cpu - l_gpu) <= 1e-5 * max(1.0, abs(l_cpu)),
          f"tiny BERT loss: card {l_gpu} vs cpu {l_cpu}")
    worst = max(float((g_gpu[n_] - g_cpu[n_]).abs().max()) for n_ in g_cpu)
    check(worst <= 1e-4, f"tiny BERT gradients: card vs cpu max |err| {worst:.3e} > 1e-4")
    print(f"[agree] tiny BERT f32 on the card vs the CPU: loss {l_gpu:.6f} vs {l_cpu:.6f}, "
          f"{len(g_cpu)} gradients within 1e-4 (max |err| {worst:.2e})")


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def phase_main(updates: int):
    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.ops import flash_attention as fa

    k, layers = K, LAYERS
    model_dir = os.path.join(ROOT, "build", "chip_smoke_run")
    shutil.rmtree(model_dir, ignore_errors=True)  # a fresh run, not a resume
    argv = ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(k), "--max-steps", str(updates * k),
            "--model-dir", model_dir]
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts = fa.launch_counts()
    routes = fa.route_counts()
    check(math.isfinite(result["loss"]), f"main path loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"ran {result['updates']} updates, wanted {updates}")
    _check_launches("main", counts, routes, layers * k * updates, result, "tc")
    print(f"[main] BERT-Small bf16 micro 8 x K={k}, seq {S}: {updates} updates, "
          f"loss {result['loss']:.4f}, {result['seq/s']:.1f} seq/s, "
          f"mfu {result['mfu']:.4f}, eval accuracy {result['accuracy']:.4f} "
          f"({result['evaluations']} evaluations); launches {counts}, routes {routes}")
    return counts, result


def _check_launches(phase, counts, routes, train_calls, result, route):
    """Each training forward/backward launches every kernel once per layer;
    each eval batch launches the forward once per layer. Every launch on
    ``route``: ``tc`` for bf16, ``tf32x3`` for float32."""
    evals = LAYERS * result["eval_batches"] * result["evaluations"]
    want = {"flash_fwd": train_calls + evals,
            "flash_bwd_dq": train_calls, "flash_bwd_dkv": train_calls}
    check(counts == want, f"{phase}: launch counts {counts} != {want} ({train_calls} "
                          f"per kernel in training, + {LAYERS} forward per eval batch x "
                          f"{result['eval_batches']} batches x {result['evaluations']} "
                          f"evaluations)")
    want_routes = {name: {r: n if r == route else 0 for r in ("tc", "tf32x3")}
                   for name, n in want.items()}
    check(routes == want_routes, f"{phase}: route counts {routes} != {want_routes}")


def phase_profile(updates: int = 3, mode: str = "scan", extra=()):
    """Where the time of the main path (or of its streaming or sparse
    embedding twin, ``extra`` flags) goes: a torch.profiler window over a
    few updates of the same run (after two warm-up updates). Reports wall
    time per update, the card's busy time per update (sum of kernel and copy
    time, one stream), its idle share, and the top kernels."""
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.examples import bert_finetune

    args = bert_finetune.parse_args(
        ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
         "--accum-k", str(K), "--max-steps", "400", "--mode", mode, *extra])
    est, train_fn, _, _, _ = bert_finetune.setup(args)
    host_steps = K if mode == "streaming" else 1  # per update
    it = iter(train_fn())
    est.train(itertools.islice(it, 2 * host_steps), final_save=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.train(itertools.islice(it, updates * host_steps), final_save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # only device-side events (kernels, copies, memsets): the host ops
    # that launched them carry the same device time again
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    kernels = [(e.key, e.self_device_time_total, e.count) for e in device]
    busy = sum(t for _, t, _ in kernels) / 1e6
    per_update = wall / updates
    if busy == 0:
        print("[profile] the profiler saw no device time on this machine")
        return
    flash = sum(t for key, t, _ in kernels if "flash_" in key) / 1e6
    launches = sum(c for _, _, c in kernels) / updates
    print(f"[profile] {' '.join([mode, *extra])}, {updates} updates: "
          f"{per_update * 1e3:.2f} ms/update wall, "
          f"card busy {busy / updates * 1e3:.2f} ms/update "
          f"(idle share {1 - busy / wall:.3f}), {launches:.0f} kernels/update, "
          f"flash kernels {flash / updates * 1e3:.2f} ms/update")
    for key, t, count in sorted(kernels, key=lambda x: -x[1])[:8]:
        print(f"[profile]   {t / updates / 1e3:8.3f} ms/update  {count // updates:5d}x  {key[:90]}")


# --------------------------------------------------------------------------
# phases 6-9: streaming mode, the guard, the MNIST and housing trainers
# --------------------------------------------------------------------------


def phase_streaming(windows: int = 8):
    """The entry point in streaming mode: one micro-batch per host step."""
    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.ops import flash_attention as fa

    steps = windows * K
    argv = ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(K), "--max-steps", str(steps), "--mode", "streaming"]
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts, routes = fa.launch_counts(), fa.route_counts()
    check(math.isfinite(result["loss"]), f"streaming loss is not finite: {result['loss']}")
    check(result["updates"] == windows, f"ran {result['updates']} windows, wanted {windows}")
    _check_launches("streaming", counts, routes, LAYERS * steps, result, "tc")
    want_applies = list(range(0, steps, K))  # the first-step quirk: phase 0
    check(result["apply_steps"] == want_applies,
          f"streaming applied at {result['apply_steps']}, wanted {want_applies}")
    print(f"[streaming] BERT-Small bf16 micro 8, K={K}, quirk on: {steps} micro-batch "
          f"calls, applies at {result['apply_steps']}; launches {counts}, all tc")
    print(f"[streaming] loss {result['loss']:.4f}, {result['seq/s']:.1f} seq/s, "
          f"mfu {result['mfu']:.4f}, eval accuracy {result['accuracy']:.4f}")
    return result


def _bert_small_batches(n, seed, vocab=30522):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(S // 4, S + 1, size=n)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, S)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, S), np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


def phase_stream_scan(windows: int = 2, micro: int = 8):
    """Quirk-free streaming against scan on the card, from the same weights
    on the same batches: the same accumulation order, so the same floats."""
    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay
    from gradaccum_tpu_torch.utils.tree import named_parameters

    cfg = BertConfig.small(dtype=torch.bfloat16, hidden_dropout=0.0, attention_dropout=0.0)
    bundle = bert_classifier_bundle(cfg, attention_fn=flash_attention)
    config = acc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False)
    data = _bert_small_batches(windows * K * micro, seed=3)
    batches = [{key: torch.as_tensor(v[i * micro:(i + 1) * micro], device="cuda")
                for key, v in data.items()} for i in range(windows * K)]
    gen = torch.Generator(device="cuda").manual_seed(0)  # dropout 0: never drawn
    finals = {}
    for mode in ("scan", "streaming"):
        model = bundle.init(19830610, "cuda")
        opt = adamw(warmup_polynomial_decay(2e-5, 16, 2), weight_decay_rate=0.01)
        loss_fn = lambda params, batch, m=model: bundle.loss(m, batch)  # noqa: E731
        if mode == "scan":
            step = acc.accumulate_scan(loss_fn, opt, config, needs_rng=True)
            state = acc.scan_init(named_parameters(model), opt)
            for w in range(windows):
                window = batches[w * K:(w + 1) * K]
                stacked = {key: torch.stack([b[key] for b in window]) for key in data}
                state, _ = step(state, stacked, gen)
        else:
            step = acc.streaming_step(loss_fn, opt, config, needs_rng=True)
            state = acc.streaming_init(named_parameters(model), opt)
            applied = []
            for batch in batches:
                state, aux = step(state, batch, gen)
                applied.append(int(aux["applied"]))
            check(applied == ([0] * (K - 1) + [1]) * windows,
                  f"quirk-free streaming applied {applied}")
        finals[mode] = state
    torch.cuda.synchronize()
    check(finals["scan"].step == finals["streaming"].step == windows * K, "step counts differ")
    a, b = finals["scan"].params, finals["streaming"].params
    with torch.no_grad():
        diff = max(float((a[n] - b[n]).abs().max()) for n in a)
        bitwise = all(torch.equal(a[n], b[n]) for n in a)
        moved = max(float((a[n] - w).abs().max()) for n, w in
                    named_parameters(bundle.init(19830610, "cuda")).items())
    check(all(bool(t.isfinite().all()) for t in a.values()), "stream=scan: non-finite weights")
    check(diff <= 1e-6, f"stream=scan: max |diff| {diff:.3e} > 1e-6")
    check(moved > 1e-6, f"stream=scan: the weights did not move ({moved:.3e})")
    print(f"[stream=scan] BERT-Small bf16, dropout 0, {windows} windows of K={K}: "
          f"{len(a)} float32 parameters, max |streaming - scan| {diff:.3e} "
          f"({'bitwise equal' if bitwise else 'not bitwise'}; weights moved {moved:.3e})")
    return diff


def phase_guard(micro: int = 8):
    """The non-finite guard and dynamic loss scaling on the card, in both
    modes: window 0 has one NaN micro-batch, window 1 only NaN ones, window 2
    none. A batch column ``poison`` multiplies the loss (1.0 or NaN)."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig

    base = bert_classifier_bundle(BertConfig.small(dtype=torch.bfloat16),
                                  attention_fn=flash_attention)
    bundle = base._replace(loss=lambda m, b: base.loss(m, b) * b["poison"].mean())
    init_scale = 2.0 ** 15
    accum = GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False, skip_nonfinite=True,
                            loss_scale=LossScaleConfig(init_scale=init_scale))
    bad = {(0, 1)} | {(1, i) for i in range(K)}  # (window, micro-batch)
    data = _bert_small_batches(3 * K * micro, seed=4)
    data["poison"] = np.ones(3 * K * micro, np.float32)
    for w, i in bad:
        j = (w * K + i) * micro
        data["poison"][j:j + micro] = np.nan
    want_skips = [sum(1 for w, _ in bad if w == win) for win in range(3)]
    want_scales = [init_scale / 2, init_scale / 4, init_scale / 4]  # dirty, dirty, clean
    for mode in ("streaming", "scan"):
        est = Estimator(bundle, adamw(2e-5), accum,
                        RunConfig(log_step_count_steps=1000, save_checkpoints_steps=None),
                        mode=mode, device="cuda")
        host = micro * (K if mode == "scan" else 1)
        rows = K * micro
        skips, snaps = [], []
        for w in range(3):
            window = {key: v[w * rows:(w + 1) * rows] for key, v in data.items()}
            est.train([{key: v[j:j + host] for key, v in window.items()}
                       for j in range(0, rows, host)])
            skips.append(est.nonfinite_skips)
            state = est._state
            snaps.append([t.clone() for t in (*state.params.values(),
                                              *state.opt_state.m.values(),
                                              *state.opt_state.v.values())])
        check(skips == want_skips, f"guard ({mode}): skipped {skips}, wanted {want_skips}")
        unchanged = all(torch.equal(x, y) for x, y in zip(snaps[0], snaps[1]))
        check(unchanged, f"guard ({mode}): the all-bad window changed params or moments")
        check(not all(torch.equal(x, y) for x, y in zip(snaps[1], snaps[2])),
              f"guard ({mode}): the clean window after it did not apply")
        series = dict(est.loss_scale_series)
        scales = [series[(w + 1) * K] for w in range(3)]
        check(scales == want_scales, f"guard ({mode}): scale at window ends {scales}, "
                                     f"wanted {want_scales}")
        check(all(bool(t.isfinite().all()) for t in snaps[2]),
              f"guard ({mode}): a parameter or moment is not finite")
        print(f"[guard] {mode}: skipped {skips} micro-batches per window (NaN loss "
              f"injected), all-bad window bitwise no-op, loss scale at window ends "
              f"{scales}, every parameter finite")


def phase_small_models():
    """The MNIST (variants 01, 02) and housing entry points, streaming."""
    from gradaccum_tpu_torch.examples import housing, mnist

    out = {}
    for variant in ("01", "02"):
        r = mnist.main(["--device", "cuda", "--variant", variant, "--mode", "streaming",
                        "--max-steps", "200"])
        _check_falls(f"mnist {variant}", r)
        print(f"[mnist] variant {variant} (batch {r['micro_batch']}, K={r['accum_k']}, "
              f"streaming): {r['steps']} steps, {r['updates']} updates, loss "
              f"{r['first_loss']:.4f} -> {r['loss']:.4f}, accuracy {r['accuracy']:.4f}, "
              f"{r['ms_per_host_step']:.3f} ms per host step, {r['examples/s']:.0f} examples/s")
        out[f"mnist_{variant}"] = r
    r = housing.main(["--device", "cuda", "--mode", "streaming", "--max-steps", "300"])
    _check_falls("housing", r)
    print(f"[housing] batch {r['micro_batch']}, K={r['accum_k']}, streaming: {r['steps']} "
          f"steps, loss {r['first_loss']:.2f} -> {r['loss']:.2f}, train MAE "
          f"{r['train_mae']:.3f} RMSE {r['train_rmse']:.3f}, test MAE {r['test_mae']:.3f} "
          f"RMSE {r['test_rmse']:.3f}, {r['ms_per_host_step']:.3f} ms per host step")
    print("[housing] predictions " + ", ".join(
        f"{p:.3f} (label {y:.3f})" for p, y in zip(r["predictions"], r["labels"])))
    out["housing"] = r
    return out


def _check_falls(name, r):
    check(math.isfinite(r["loss"]) and math.isfinite(r["first_loss"]),
          f"{name}: non-finite loss {r['first_loss']} -> {r['loss']}")
    check(r["loss"] < r["first_loss"], f"{name}: loss did not fall "
                                       f"({r['first_loss']} -> {r['loss']})")


# --------------------------------------------------------------------------
# phases 10-14: the blockwise backward, warm start, remat, sparse embed, MoE
# --------------------------------------------------------------------------


def _attention_grads(fa, q, k, v, mask, do, causal, **kw):
    """dq, dk, dv (and dmask with a mask) of ``flash_attention`` through
    autograd, and the launch counts of that one call."""
    import torch

    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    m = None if mask is None else mask.clone().requires_grad_()
    fa.reset_launch_counts()
    out = fa.flash_attention(*ins, m, causal=causal, **kw)
    grads = torch.autograd.grad(out, ins + ([m] if m is not None else []), do)
    torch.cuda.synchronize()
    return grads, fa.launch_counts()


def phase_xla_bwd():
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype)] if dtype == torch.float32 else XLA_BWD_TOL
        for masked in (True, False):
            for causal in (False, True):
                q, k, v, mask, do = _inputs(dtype, masked, seed=2)
                want, _ = _attention_grads(fa, q, k, v, mask, do, causal)
                got, counts = _attention_grads(fa, q, k, v, mask, do, causal, bwd_impl="xla")
                check(counts == {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
                      f"xla-bwd launched {counts}: one forward and no backward kernel wanted")
                line = []
                for name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
                    g, w = g.float(), w.float()
                    atol, rtol = tol[name]
                    err = (g - w).abs()
                    check(bool(g.isfinite().all()), f"xla-bwd {name}: non-finite")
                    check(bool((err <= atol + rtol * w.abs()).all()),
                          f"xla-bwd {name} ({dtype}, mask={masked}, causal={causal}): max "
                          f"|xla - pallas| {float(err.max()):.3e} > {atol} + {rtol}|pallas|")
                    line.append(f"{name}={float(err.max()):.2e}")
                print(f"[xla-bwd] {str(dtype)[6:]:8s} mask={int(masked)} causal={int(causal)}: "
                      f"launches {counts}; |xla - pallas| " + " ".join(line))


# chip_smoke's own HF naming (independent of models/bert_checkpoint.py):
# port path segments -> HF module path, and leaf -> HF leaf
_HF_SEGMENTS = {
    "word_embeddings": "embeddings.word_embeddings",
    "position_embeddings": "embeddings.position_embeddings",
    "token_type_embeddings": "embeddings.token_type_embeddings",
    "embeddings_LayerNorm": "embeddings.LayerNorm",
    "attention/query": "attention.self.query", "attention/key": "attention.self.key",
    "attention/value": "attention.self.value", "attention/output": "attention.output.dense",
    "attention_LayerNorm": "attention.output.LayerNorm",
    "intermediate": "intermediate.dense", "ffn_output": "output.dense",
    "output_LayerNorm": "output.LayerNorm", "pooler": "pooler.dense",
}
_HF_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def _hf_name(port_name):
    """``params/bert/layer_1/attention/query/kernel`` ->
    ``encoder.layer.1.attention.self.query.weight``."""
    parts = port_name.split("/")[1:]
    if parts[0] == "bert":
        parts = parts[1:]
    prefix = []
    if parts[0].startswith("layer_"):
        prefix, parts = [f"encoder.layer.{parts[0][6:]}"], parts[1:]
    return ".".join(prefix + [_HF_SEGMENTS["/".join(parts[:-1])], _HF_LEAVES[parts[-1]]])


def _write_hf_dir(path, names_shapes, seed=1234):
    """A BertModel directory in HF's format at BERT-Small width: config.json,
    model.safetensors (float32 from a seeded generator, written by a small
    writer: the card has no safetensors package) and vocab.txt (the special
    tokens, the synthetic corpus's words, then [unused{i}] to 30522 lines),
    plus train.tsv and dev.tsv. Returns ``{HF name: array}``."""
    import numpy as np

    from gradaccum_tpu_torch.examples.bert_finetune import synthetic_text_task

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    tensors = {}
    for port_name, shape in names_shapes.items():
        if port_name.startswith("params/classifier/"):
            continue  # a base model: no head
        tensors[_hf_name(port_name)] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, arr in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for arr in tensors.values():
            f.write(arr.tobytes())
    config = {"architectures": ["BertModel"], "model_type": "bert", "hidden_act": "gelu",
              "vocab_size": 30522, "hidden_size": 512, "num_hidden_layers": LAYERS,
              "num_attention_heads": 8, "intermediate_size": 2048,
              "max_position_embeddings": 512, "type_vocab_size": 2,
              "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
              "layer_norm_eps": 1e-12}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    train = synthetic_text_task(512, seed=1)
    dev = synthetic_text_task(256, seed=2)
    words = sorted({w for text in train[0] + dev[0] for w in text.split()})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    vocab += [f"[unused{i}]" for i in range(30522 - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    for split, (texts, labels) in (("train", train), ("dev", dev)):
        with open(os.path.join(path, f"{split}.tsv"), "w") as f:
            for i, (text, label) in enumerate(zip(texts, labels)):
                f.write(f"{label}\tid{i}\t{text}\n")
    return tensors


def phase_warm_start(updates: int = 4):
    import torch

    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.models.bert import BertConfig, BertClassifier
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.utils.tree import named_parameters

    hf_dir = os.path.join(ROOT, "build", "chip_smoke_hf")
    shutil.rmtree(hf_dir, ignore_errors=True)
    shapes = {name: tuple(p.shape) for name, p in
              named_parameters(BertClassifier(BertConfig.small(num_layers=LAYERS))).items()}
    t0 = time.perf_counter()
    tensors = _write_hf_dir(hf_dir, shapes)
    mb = os.path.getsize(os.path.join(hf_dir, "model.safetensors")) / 1e6
    argv = ["--device", "cuda", "--hf-checkpoint", hf_dir, "--data-dir", hf_dir, "--bf16",
            "--mode", "scan", "--seq-len", str(S), "--accum-k", str(K),
            "--max-steps", str(updates * K),
            "--model-dir", os.path.join(ROOT, "build", "chip_smoke_warm")]
    # the weights before the first update, through the entry point's own setup
    est, _, _, cfg, _ = bert_finetune.setup(bert_finetune.parse_args(argv))
    params = est.train([], final_save=False).params
    check(set(params) == {n for n in shapes}, "warm start: parameter names differ")
    for name, p in params.items():
        if name.startswith("params/classifier/"):
            check(not bool(p.any()), f"warm start: {name} is not zero")
            continue
        want = torch.from_numpy(tensors[_hf_name(name)]).to(p.device)
        check(torch.equal(p.detach(), want), f"warm start: {name} differs from the file's "
                                             f"{_hf_name(name)}")
    print(f"[warm-start] wrote a BERT-Small HF directory ({mb:.1f} MB model.safetensors, "
          f"30522-line vocab.txt) in {time.perf_counter() - t0:.1f} s; before the first "
          f"update all {len(params) - 2} encoder and pooler tensors equal the file's bit for "
          f"bit and the classifier is zero")
    del est, params
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts, routes = fa.launch_counts(), fa.route_counts()
    check(math.isfinite(result["loss"]), f"warm start: loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"warm start: ran {result['updates']} updates")
    check(0.0 <= result["accuracy"] <= 1.0, f"warm start: accuracy {result['accuracy']}")
    _check_launches("warm-start", counts, routes, LAYERS * K * updates, result, "tc")
    print(f"[warm-start] --hf-checkpoint --data-dir --bf16, micro 8 x K={K}: {updates} "
          f"updates, loss {result['first_loss']:.4f} -> {result['loss']:.4f}, eval accuracy "
          f"{result['accuracy']:.4f} ({result['evaluations']} evaluations of "
          f"{result['eval_batches']} batches), {result['seq/s']:.1f} seq/s; launches "
          f"{counts}, all tc")


def _bert_small_step(cfg, micro=8, sparse=False):
    """A fresh BERT-Small model from seed 19830610 and its scan step (flash
    core, clip 1.0, AdamW over the main path's schedule)."""
    from gradaccum_tpu_torch.models.bert import bert_classifier_bundle
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay
    from gradaccum_tpu_torch.ops.sparse_embed import accumulate_scan_sparse_embed
    from gradaccum_tpu_torch.utils.tree import named_parameters

    bundle = bert_classifier_bundle(cfg, attention_fn=flash_attention)
    model = bundle.init(19830610, "cuda")
    opt = adamw(warmup_polynomial_decay(2e-5, 16, 2), weight_decay_rate=0.01)
    config = acc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False)
    if sparse:
        hooks = bundle.sparse_embed._replace(
            loss_with_rows=lambda p, rows, b: bundle.sparse_embed.loss_with_rows(model, rows, b))
        step = accumulate_scan_sparse_embed(hooks, opt, config)
    else:
        step = acc.accumulate_scan(lambda p, b: bundle.loss(model, b), opt, config,
                                   needs_rng=True)
    return step, acc.scan_init(named_parameters(model), opt)


def _stacked(updates, micro, seed):
    import torch

    data = _bert_small_batches(updates * K * micro, seed=seed)
    return [{key: torch.as_tensor(v[u * K * micro:(u + 1) * K * micro], device="cuda")
             .reshape(K, micro, *v.shape[1:]) for key, v in data.items()}
            for u in range(updates)]


def phase_remat():
    import dataclasses

    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig
    from gradaccum_tpu_torch.ops import flash_attention as fa

    (batch,) = _stacked(1, 8, seed=5)
    finals, counts, peak = {}, {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(BertConfig.small(dtype=torch.bfloat16), remat=remat)
        step, state = _bert_small_step(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)  # dropout 0.1 draws here
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()  # both runs' states: measure above it
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        state, aux = step(state, batch, gen)
        torch.cuda.synchronize()
        counts[remat] = fa.launch_counts()
        peak[remat] = torch.cuda.max_memory_allocated() - held
        finals[remat] = (state, float(aux["loss"]), gen.get_state())
        check(math.isfinite(finals[remat][1]), f"remat={remat}: loss is not finite")
    per_layer = LAYERS * K
    check(counts[False] == {"flash_fwd": per_layer, "flash_bwd_dq": per_layer,
                            "flash_bwd_dkv": per_layer}, f"remat off: launches {counts[False]}")
    check(counts[True] == {"flash_fwd": 2 * per_layer, "flash_bwd_dq": per_layer,
                           "flash_bwd_dkv": per_layer}, f"remat on: launches {counts[True]}")
    a, b = finals[False][0].params, finals[True][0].params
    with torch.no_grad():
        diff = max(float((a[n] - b[n]).abs().max()) for n in a)
    check(all(torch.equal(a[n], b[n]) for n in a),
          f"remat: parameters after one update differ from no remat (max |diff| {diff:.3e})")
    check(finals[False][1] == finals[True][1], "remat: the losses differ")
    check(torch.equal(finals[False][2], finals[True][2]),
          "remat: the generator ended in another state")
    print(f"[remat] BERT-Small bf16, dropout 0.1, micro 8 x K={K}, one update: all {len(a)} "
          f"float32 parameters and the loss ({finals[True][1]:.6f}) bitwise equal with and "
          f"without remat, the generator in the same state; launches {counts[False]} without, "
          f"{counts[True]} with; the update's peak memory above the state it started "
          f"from (torch.cuda.max_memory_allocated) {peak[False] / 2**20:.1f} MiB without, "
          f"{peak[True] / 2**20:.1f} MiB with")
    return peak


def phase_sparse_embed(updates: int = 2):
    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig

    cfg = BertConfig.small(dtype=torch.bfloat16, hidden_dropout=0.0, attention_dropout=0.0)
    batches = _stacked(updates, 8, seed=6)
    finals = {}
    for sparse in (False, True):
        step, state = _bert_small_step(cfg, sparse=sparse)
        gen = torch.Generator(device="cuda").manual_seed(0)  # dropout 0: never drawn
        for batch in batches:
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        finals[sparse] = state
    a, b = finals[False].params, finals[True].params
    with torch.no_grad():
        diffs = {n: float((a[n] - b[n]).abs().max()) for n in a}
        moved = float((a["params/bert/word_embeddings/embedding"]
                       - _bert_small_step(cfg)[1].params[
                           "params/bert/word_embeddings/embedding"]).abs().max())
    worst = max(diffs, key=diffs.get)
    check(all(bool(t.isfinite().all()) for t in b.values()), "sparse embed: non-finite weights")
    check(diffs[worst] <= SPARSE_ATOL, f"sparse embed: {worst} differs from the dense path by "
                                       f"{diffs[worst]:.3e} > {SPARSE_ATOL}")
    check(moved > 1e-6, f"sparse embed: the table did not move ({moved:.3e})")
    print(f"[sparse-embed] BERT-Small bf16, dropout 0, {updates} updates of micro 8 x K={K}: "
          f"{len(a)} float32 parameters within {SPARSE_ATOL} of the dense path (max |diff| "
          f"{diffs[worst]:.3e} in {worst}; table {diffs['params/bert/word_embeddings/embedding']:.3e}"
          f", moved {moved:.3e})")


def phase_moe(updates: int = 4, experts: int = 8, top_k: int = 2):
    import numpy as np
    import torch

    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention

    # the loss is the cross entropy plus 0.01 x the mean load-balance loss
    cfg = BertConfig.small(dtype=torch.bfloat16, num_experts=experts, moe_top_k=top_k)
    bundle = bert_classifier_bundle(cfg, attention_fn=flash_attention)
    model = bundle.init(7, "cuda")
    batch = {key: torch.as_tensor(v, device="cuda")
             for key, v in _bert_small_batches(8, seed=8).items()}
    with torch.no_grad():
        batch["rng"] = torch.Generator(device="cuda").manual_seed(3)
        loss = float(bundle.loss(model, batch))
        batch["rng"] = torch.Generator(device="cuda").manual_seed(3)
        logits, aux = model.logits_and_aux(batch["input_ids"], batch["input_mask"],
                                           batch["segment_ids"], False, batch["rng"])
        ce = float(torch.nn.functional.cross_entropy(logits, batch["label"].long()))
    check(math.isfinite(float(aux)) and float(aux) > 0, f"MoE: load balance {float(aux)}")
    check(abs(loss - (ce + 0.01 * float(aux))) <= 1e-5,
          f"MoE: loss {loss} != ce {ce} + 0.01 x load balance {float(aux)}")
    del model

    argv = ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(K), "--max-steps", str(updates * K), "--mode", "scan",
            "--num-experts", str(experts), "--moe-top-k", str(top_k)]
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts, routes = fa.launch_counts(), fa.route_counts()
    check(math.isfinite(result["loss"]), f"MoE: loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"MoE: ran {result['updates']} updates")
    _check_launches("moe", counts, routes, LAYERS * K * updates, result, "tc")
    check(np.isfinite(result["moe_dropped_fraction"]), "MoE: dropped fraction not finite")
    print(f"[moe] BERT-Small bf16, {experts} experts, top-{top_k}, micro 8 x K={K}: loss = ce "
          f"{ce:.6f} + 0.01 x load balance {float(aux):.6f} on one batch; {updates} updates, "
          f"loss {result['loss']:.4f}, eval accuracy {result['accuracy']:.4f}, dropped "
          f"fraction {result['moe_dropped_fraction']:.4f} (router entropy "
          f"{result['moe_router_entropy']:.4f}), {result['seq/s']:.1f} seq/s, mfu "
          f"{result['mfu']:.4f} (MoE FLOPs); launches {counts}, all tc")


# --------------------------------------------------------------------------
# phases 15-17: GPT-Small mixed precision, the fused guard, gpt_lm
# --------------------------------------------------------------------------

GPT_SEQ, GPT_MICRO, GPT_K, GPT_LAYERS = 512, 8, 4, 4
GPT_VOCAB = 50257
LADDER_UPDATES = 4
TRACK_LR, TRACK_IDS = 2e-3, 512  # the loss-tracking check: rate, token id range


def _gpt_batches(n, seed, vocab=None):
    """``n`` host batches of K x micro seeded token-id rows (seq 512), ids
    below ``vocab`` (default: the whole vocabulary)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = GPT_K * GPT_MICRO
    return [{"input_ids": rng.integers(0, vocab or GPT_VOCAB, size=(rows, GPT_SEQ))
             .astype(np.int32)} for _ in range(n)]


def _gpt_estimator(compute_dtype, opt, fused=False, clip=1.0, dropout=0.1, layers=GPT_LAYERS,
                   k=GPT_K, mode="scan", guard=None, loss=None, mesh=None, zero1=False):
    """GPT-Small (vocab 50257, H 512, A 8, FFN 2048, 512 positions) on the
    causal flash kernels, through the Estimator; ``guard``: a loss scale
    config (skip_nonfinite on); ``loss``: a wrapper of the bundle's loss;
    ``mesh``/``zero1``: a rank of a data-parallel run."""
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.flash_attention import causal_flash_attention

    bundle = gpt_lm_bundle(GPTConfig.small(dropout=dropout, num_layers=layers),
                           attention_fn=causal_flash_attention, compute_dtype=compute_dtype)
    if loss is not None:
        bundle = bundle._replace(loss=loss(bundle.loss))
    accum = GradAccumConfig(k, clip_norm=clip, fused_adam=fused, first_step_quirk=False,
                            skip_nonfinite=guard is not None, loss_scale=guard)
    return Estimator(bundle, opt, accum,
                     RunConfig(log_step_count_steps=1000, save_checkpoints_steps=None),
                     mode=mode, device="cuda", mesh=mesh, zero1=zero1)


def _state_tensors(state):
    """Every tensor of a train state: parameters, then the optimizer state
    (q8 moments as their codes and scales), in a fixed order."""
    from gradaccum_tpu_torch.memory.quant import QuantTensor

    out = list(state.params.values())
    for value in state.opt_state:
        for t in (value.values() if isinstance(value, dict) else [value]):
            out.extend([t.q, t.scale] if isinstance(t, QuantTensor) else [t])
    return out


def _nbytes(t):
    return t.nbytes if hasattr(t, "q") else t.numel() * t.element_size()


def _release():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _gpt_leg(name, compute_dtype, opt, fused=False, clip=1.0):
    """One rung of the ladder: LADDER_UPDATES scan updates at micro 8 x K=4,
    dropout 0.1. Returns the row printed for it."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    est = _gpt_estimator(compute_dtype, opt, fused=fused, clip=clip)
    state = est.train([], final_save=False)  # weights and optimizer state
    n = sum(p.numel() for p in state.params.values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    state = est.train(_gpt_batches(LADDER_UPDATES, seed=15), final_save=False)
    torch.cuda.synchronize()
    counts, routes = fa.launch_counts(), fa.route_counts()
    peak = torch.cuda.max_memory_allocated() - held
    opt_bytes = sum(_nbytes(t) for field in state.opt_state
                    for t in (field.values() if isinstance(field, dict) else [field]))
    # two-pass: the float32 accumulator the scan step allocates; fused: none
    accum_bytes = 0 if fused else 4 * n
    param_bytes = sum(_nbytes(p) for p in state.params.values())
    first, last = float(est.first_loss), float(est.last_loss)
    check(math.isfinite(first) and math.isfinite(last), f"ladder {name}: loss {first} -> {last}")
    per_update = GPT_LAYERS * GPT_K
    want = {kname: per_update * LADDER_UPDATES for kname in counts}
    route = "tf32x3" if compute_dtype is None else "tc"
    check(counts == want, f"ladder {name}: launches {counts} != {want}")
    check(all(routes[kname][route] == want[kname] for kname in want),
          f"ladder {name}: routes {routes}, all on {route} wanted")
    seq_s = est.examples_per_sec()
    row = {"leg": name, "params": n, "opt_plus_accum_B_per_param": (opt_bytes + accum_bytes) / n,
           "opt_B_per_param": opt_bytes / n, "accum_B_per_param": accum_bytes / n,
           "param_B_per_param": param_bytes / n, "peak_above_state_MiB": peak / 2**20,
           "seq/s": seq_s, "tokens/s": seq_s * GPT_SEQ, "first_loss": first, "loss": last,
           "launches_per_update": per_update, "route": route}
    print(f"[ladder] {name:24s} opt+accum {row['opt_plus_accum_B_per_param']:6.3f} B/param "
          f"(optimizer {row['opt_B_per_param']:.3f}, accumulator {row['accum_B_per_param']:.0f})"
          f", params {row['param_B_per_param']:.0f} B/param, peak above state "
          f"{row['peak_above_state_MiB']:.1f} MiB, {seq_s:.1f} seq/s = "
          f"{row['tokens/s']:.0f} tokens/s, loss {first:.4f} -> {last:.4f}; "
          f"{per_update} launches per kernel per update, all {route}")
    del est, state
    _release()
    return row


def phase_gpt_ladder():
    """GPT-Small seq 512, micro 8 x K=4, dropout 0.1, scan mode, through the
    Estimator: the mixed-precision ladder, then fused against two-pass
    bitwise at K=1, then the bf16 + master loss against the f32 loss."""
    import torch

    from gradaccum_tpu_torch.ops.adamw import adam_mini, adamw

    f32, bf16 = torch.float32, torch.bfloat16
    legs = [
        ("(a) f32", None, adamw(1e-4, weight_decay_rate=0.01), False, 1.0),
        ("(b) bf16+master", bf16, adamw(1e-4, weight_decay_rate=0.01, master_dtype=f32),
         False, 1.0),
        ("(c) bf16+master+fused", bf16,
         adamw(1e-4, weight_decay_rate=0.01, master_dtype=f32), True, None),
        ("(d) bf16+master+q8", bf16,
         adamw(1e-4, weight_decay_rate=0.01, master_dtype=f32, moment_dtype="q8"), False, 1.0),
        ("(e) adam_mini+master+q8", bf16, adam_mini(1e-4, master_dtype=f32, moment_dtype="q8"),
         False, 1.0),
    ]
    rows = [_gpt_leg(*leg) for leg in legs]
    print("[ladder] " + json.dumps(rows))

    # fused against two-pass at K=1 over one update: bitwise
    batch = _gpt_batches(1, seed=16)[0]
    finals = []
    for fused in (False, True):
        est = _gpt_estimator(bf16, adamw(1e-4, weight_decay_rate=0.01, master_dtype=f32),
                             fused=fused, clip=None, k=1)
        state = est.train([{"input_ids": batch["input_ids"][:GPT_MICRO]}], final_save=False)
        torch.cuda.synchronize()
        finals.append([t.clone() for t in _state_tensors(state)])
        del est, state
        _release()
    same = all(torch.equal(a, b) for a, b in zip(*finals))
    check(len(finals[0]) == len(finals[1]) and same,
          "ladder: fused differs from two-pass at K=1 after one update")
    print(f"[ladder] fused equals two-pass bit for bit at K=1 after one update "
          f"({len(finals[0])} tensors: bf16 params, f32 masters, m, v)")
    del finals

    # one repeated batch, dropout 0: the bf16 + master loss tracks f32
    track = _gpt_batches(1, seed=17, vocab=TRACK_IDS)[0]
    curves = {}
    for name, dtype, opt in (("f32", None, adamw(TRACK_LR, weight_decay_rate=0.01)),
                             ("bf16+master", bf16, adamw(TRACK_LR, weight_decay_rate=0.01,
                                                         master_dtype=f32))):
        est = _gpt_estimator(dtype, opt, clip=None, dropout=0.0)
        curves[name] = []
        for _ in range(6):
            est.train([track], final_save=False)
            curves[name].append(float(est.last_loss))
        del est
        _release()
    a, b = curves["f32"], curves["bf16+master"]
    rel = [abs(x - y) / max(abs(x), 1e-6) for x, y in zip(a, b)]
    check(a[-1] < 0.8 * a[0] and b[-1] < 0.8 * b[0],
          f"loss tracking: a loss did not fall below 0.8x its first: f32 {a}, bf16 {b}")
    check(max(rel) < 0.08, f"loss tracking: bf16 + master off f32 by {max(rel):.4f} (f32 {a}, "
                           f"bf16 {b})")
    print(f"[ladder] one repeated batch (ids < {TRACK_IDS}), dropout 0, AdamW lr {TRACK_LR}: "
          f"f32 {[round(x, 4) for x in a]}, bf16+master {[round(x, 4) for x in b]}; "
          f"largest relative gap {max(rel):.4f} (gate 0.08)")
    return rows


def phase_gpt_profile(updates=2, f32=False):
    """Where the time of a GPT-Small bf16 + master update (or, with
    ``f32``, a float32 update: ladder leg (a)) goes: a torch.profiler window
    over ``updates`` scan updates after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.ops.adamw import adamw

    if f32:
        name = "f32 (ladder leg (a))"
        est = _gpt_estimator(None, adamw(1e-4, weight_decay_rate=0.01))
    else:
        name = "bf16+master"
        est = _gpt_estimator(torch.bfloat16, adamw(1e-4, weight_decay_rate=0.01,
                                                   master_dtype=torch.float32))
    batches = _gpt_batches(1 + updates, seed=18)
    est.train(batches[:1], final_save=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.train(batches[1:], final_save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels) / 1e6
    if busy == 0:
        print("[gpt-profile] the profiler saw no device time on this machine")
        return
    flash = sum(t for key, t, _ in kernels if "flash_" in key) / 1e6
    bwd = sum(t for key, t, _ in kernels if "flash_dq" in key or "flash_dkv" in key) / 1e6
    # the only float32 matrix products of a bf16 update are the tied head's
    head = sum(t for key, t, _ in kernels if "gemm" in key.lower()
               and "bf16" not in key.lower() and "16816" not in key) / 1e6
    gemms = "float32 GEMMs" if f32 else "float32 GEMMs (the tied head)"
    print(f"[gpt-profile] GPT-Small {name}, micro 8 x K=4, seq 512, {updates} updates: "
          f"{wall / updates * 1e3:.2f} ms/update wall, card busy {busy / updates * 1e3:.2f} "
          f"ms/update (idle share {1 - busy / wall:.3f}), "
          f"{sum(c for _, _, c in kernels) / updates:.0f} kernels/update, flash kernels "
          f"{flash / updates * 1e3:.2f} ms/update ({flash / busy:.3f} of busy; dq + dk/dv "
          f"{bwd / updates * 1e3:.2f}), {gemms} {head / updates * 1e3:.2f} ms/update "
          f"({head / busy:.3f} of busy)")
    for key, t, count in sorted(kernels, key=lambda x: -x[1])[:10]:
        print(f"[gpt-profile]   {t / updates / 1e3:8.3f} ms/update  {count // updates:5d}x  "
              f"{key[:90]}")
    del est
    _release()


def phase_gpt_guard(micro: int = GPT_MICRO):
    """The fused guard: GPT-Small bf16 + master at depth 2, fused_adam,
    skip_nonfinite and a dynamic loss scale, streaming and scan; window 0
    has one NaN micro-batch, window 1 only NaN ones, window 2 none. A batch
    column ``poison`` multiplies the loss (1.0 or NaN)."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig

    init_scale = 2.0 ** 15
    bad = {(0, 1)} | {(1, i) for i in range(GPT_K)}
    rows = 3 * GPT_K * micro
    data = {"input_ids": np.random.default_rng(19).integers(
        0, GPT_VOCAB, size=(rows, GPT_SEQ)).astype(np.int32),
        "poison": np.ones(rows, np.float32)}
    for w, i in bad:
        j = (w * GPT_K + i) * micro
        data["poison"][j:j + micro] = np.nan
    want_skips = [sum(1 for w, _ in bad if w == win) for win in range(3)]
    want_scales = [init_scale / 2, init_scale / 4, init_scale / 4]
    for mode in ("streaming", "scan"):
        est = _gpt_estimator(torch.bfloat16, adamw(1e-4, master_dtype=torch.float32),
                             fused=True, clip=None, layers=2, mode=mode,
                             guard=LossScaleConfig(init_scale=init_scale),
                             loss=lambda base: lambda m, b: base(m, b) * b["poison"].mean())
        host = micro * (GPT_K if mode == "scan" else 1)
        per_window = GPT_K * micro
        skips, snaps = [], []
        for w in range(3):
            window = {key: v[w * per_window:(w + 1) * per_window] for key, v in data.items()}
            est.train([{key: v[j:j + host] for key, v in window.items()}
                       for j in range(0, per_window, host)])
            skips.append(est.nonfinite_skips)
            state = est._state
            if mode == "streaming":
                check(state.accum_grads == (), "fused guard: the streaming state carries "
                                               "an accumulator")
            snaps.append([t.clone() for t in _state_tensors(state)])
        check(skips == want_skips, f"fused guard ({mode}): skipped {skips}, wanted {want_skips}")
        check(all(torch.equal(x, y) for x, y in zip(snaps[0], snaps[1])),
              f"fused guard ({mode}): the all-bad window changed params, masters or moments")
        check(not all(torch.equal(x, y) for x, y in zip(snaps[1], snaps[2])),
              f"fused guard ({mode}): the clean window after it did not apply")
        series = dict(est.loss_scale_series)
        scales = [series[(w + 1) * GPT_K] for w in range(3)]
        check(scales == want_scales, f"fused guard ({mode}): scale at window ends {scales}, "
                                     f"wanted {want_scales}")
        check(all(bool(t.isfinite().all()) for t in snaps[2] if t.is_floating_point()),
              f"fused guard ({mode}): a parameter, master or moment is not finite")
        print(f"[gpt-guard] {mode}, GPT-Small bf16+master depth 2, fused: skipped {skips} "
              f"micro-batches per window (NaN loss injected), all-bad window bitwise no-op over "
              f"{len(snaps[0])} tensors (params, masters, m, v), loss scale at window ends "
              f"{scales}")
        del est, snaps
        _release()


def phase_gpt_lm(steps: int = 32):
    """The gpt_lm entry point with --flash (float32: every launch on the
    float32 route ``tf32x3``) in scan and streaming mode, with --sample 40."""
    from gradaccum_tpu_torch.examples import gpt_lm
    from gradaccum_tpu_torch.ops import flash_attention as fa

    layers = 4  # gpt_lm's model
    out = {}
    for mode in ("scan", "streaming"):
        fa.reset_launch_counts()
        r = gpt_lm.main(["--device", "cuda", "--flash", "--mode", mode, "--max-steps",
                         str(steps), "--sample", "40"])
        counts, routes = fa.launch_counts(), fa.route_counts()
        check(math.isfinite(r["loss"]) and math.isfinite(r["first_loss"]),
              f"gpt_lm {mode}: loss {r['first_loss']} -> {r['loss']}")
        check(r["loss"] < r["first_loss"], f"gpt_lm {mode}: the loss did not fall "
                                           f"({r['first_loss']} -> {r['loss']})")
        check(0.0 <= r["token_accuracy"] <= 1.0, f"gpt_lm {mode}: accuracy {r['token_accuracy']}")
        train = layers * r["steps"]
        forward = train + layers * (r["eval_batches"] * r["evaluations"] + r["sample_steps"])
        want = {"flash_fwd": forward, "flash_bwd_dq": train, "flash_bwd_dkv": train}
        check(counts == want, f"gpt_lm {mode}: launches {counts} != {want}")
        check(all(routes[k]["tf32x3"] == n and routes[k]["tc"] == 0 for k, n in want.items()),
              f"gpt_lm {mode}: routes {routes}, all tf32x3 wanted")
        print(f"[gpt_lm] --flash --mode {mode}: {r['steps']} micro-steps, {r['updates']} "
              f"updates, loss {r['first_loss']:.4f} -> {r['loss']:.4f}, token accuracy "
              f"{r['token_accuracy']:.4f} ({r['evaluations']} evaluations of "
              f"{r['eval_batches']} batches), {r['examples/s']:.1f} seq/s, decode "
              f"{r['decode_tokens_per_sec']:.1f} tokens/s (recompute); launches {counts}, all "
              f"tf32x3; sample {r['sample']!r}")
        out[mode] = dict(r, launches=counts)
    return out


def phase_bert_f32(updates: int = 2):
    """The entry point at its default dtype, float32 (no --bf16): BERT-Small,
    seq 128, micro 8 x K=4, scan, ``updates`` updates and its evaluations.
    The only entry-point run of the float32 forward with a padded mask;
    every launch on the float32 route ``tf32x3``."""
    from gradaccum_tpu_torch.examples import bert_finetune
    from gradaccum_tpu_torch.ops import flash_attention as fa

    argv = ["--device", "cuda", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(K), "--max-steps", str(updates * K)]
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts, routes = fa.launch_counts(), fa.route_counts()
    check(result["dtype"] == "float32", f"bert f32: ran in {result['dtype']}")
    check(math.isfinite(result["loss"]), f"bert f32: loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"bert f32: ran {result['updates']} updates, "
                                        f"wanted {updates}")
    _check_launches("bert f32", counts, routes, LAYERS * K * updates, result, "tf32x3")
    print(f"[bert-f32] BERT-Small float32 micro 8 x K={K}, seq {S}: {updates} updates, "
          f"loss {result['first_loss']:.4f} -> {result['loss']:.4f}, {result['seq/s']:.1f} "
          f"seq/s, eval accuracy {result['accuracy']:.4f} ({result['evaluations']} "
          f"evaluations of {result['eval_batches']} batches); launches {counts}, all tf32x3")
    return counts


# --------------------------------------------------------------------------
# phase 19: data parallelism and ZeRO-1
# --------------------------------------------------------------------------

DP_UPDATES_A, DP_UPDATES_B, DP_UPDATES_C = 3, 2, 2
DP_MICRO_B = 4  # rows per rank in leg (b): a global micro-batch of 8
DP_ATOL, ZERO1_ATOL = 1e-5, 1e-7
NORM_RTOL = 1e-4  # the gradient norm's relative gap (order of sums only)
DP_DIR = os.path.join(ROOT, "build", "chip_smoke_dp")


def _bert_dp_estimator(mesh=None, zero1=False, dropout=0.1, k=K, lr=None, mode="scan",
                       **run):
    """BERT-Small bf16 (vocab 30522, seq 128) on the flash kernels through
    the Estimator, random weights from the run seed; ``lr``: a constant
    rate (else the main path's schedule); ``run``: more RunConfig fields."""
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay

    import torch

    cfg = BertConfig.small(dtype=torch.bfloat16, hidden_dropout=dropout,
                           attention_dropout=dropout)
    rate = lr if lr is not None else warmup_polynomial_decay(2e-5, 400, 40)
    return Estimator(bert_classifier_bundle(cfg, attention_fn=flash_attention),
                     adamw(rate, weight_decay_rate=0.01),
                     GradAccumConfig(k, clip_norm=1.0, first_step_quirk=False),
                     RunConfig(**dict(dict(log_step_count_steps=1000,
                                           save_checkpoints_steps=None), **run)),
                     mode=mode, device="cuda", mesh=mesh, zero1=zero1)


def _host_batches(updates, rows, seed):
    data = _bert_small_batches(updates * rows, seed=seed)
    return [{key: v[u * rows:(u + 1) * rows] for key, v in data.items()} for u in range(updates)]


def _state_bytes(state, n, accum_bytes):
    """Optimizer + accumulator bytes per parameter held by this rank: the
    optimizer state's tensors, plus ``accum_bytes``, the buffers the scan
    step allocated for its window (none under fused accumulation)."""
    opt = sum(_nbytes(t) for field in state.opt_state
              for t in (field.values() if isinstance(field, dict) else [field]))
    return (opt + accum_bytes) / n


def _spy_window(acc):
    """Record the bytes of every window accumulator the scan step
    allocates (``accumulation._window_accum``) and each update's gradient
    norm before clipping; returns ``(accum_bytes, wrap)``, where
    ``wrap(est, norms)`` makes ``est``'s built step append to ``norms``."""
    window = acc._window_accum
    held = []

    def measured(params, n_stats=0):
        out = window(params, n_stats)
        held.append(sum(_nbytes(b) for b in out[1]))
        return out

    acc._window_accum = measured

    def wrap(est, norms):
        inner = est._train_step

        def step(state, batch, *rng):
            state, aux = inner(state, batch, *rng)
            norms.append(float(aux["grad_norm"]))
            return state, aux

        est._train_step = step

    return held, wrap


def _launches_per_kernel(updates, k=K, layers=LAYERS):
    return {name: layers * k * updates for name in REPLACES}


def _dp_leg_a():
    """World size 1 over NCCL against the no-mesh run: bitwise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.examples.common import free_port
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    batches = _host_batches(DP_UPDATES_A + 2, K * B, seed=21)
    ref = _bert_dp_estimator()
    ref_state = ref.train(batches[:DP_UPDATES_A], final_save=False)
    torch.cuda.synchronize()
    ref_seq = ref.examples_per_sec()
    ref_state = ref_state._replace(params={n: p.detach().clone()
                                           for n, p in ref_state.params.items()})
    mesh_lib.initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = mesh_lib.data_parallel_mesh()
        check(mesh.backend == "nccl", f"dp (a): backend {mesh.backend}, wanted nccl")
        est = _bert_dp_estimator(mesh=mesh)
        est.train([], final_save=False)  # weights, optimizer state, the broadcast
        fa.reset_launch_counts()
        mesh.reset_calls()
        state = est.train(batches[:DP_UPDATES_A], final_save=False)
        torch.cuda.synchronize()
        counts, routes, calls = fa.launch_counts(), fa.route_counts(), dict(mesh.calls)
        seq = est.examples_per_sec()
        with torch.no_grad():
            same = [name for name in ref_state.params
                    if torch.equal(state.params[name], ref_state.params[name])
                    and torch.equal(state.opt_state.m[name], ref_state.opt_state.m[name])
                    and torch.equal(state.opt_state.v[name], ref_state.opt_state.v[name])]
        check(len(same) == len(ref_state.params),
              f"dp (a): {len(ref_state.params) - len(same)} parameters or moments differ from "
              f"the no-mesh run at world 1")
        want = _launches_per_kernel(DP_UPDATES_A)
        check(counts == want, f"dp (a): launches {counts} != {want}")
        check(all(routes[n]["tc"] == want[n] for n in want), f"dp (a): routes {routes}")
        check(calls.get("all_reduce") == DP_UPDATES_A
              and calls.get("all_reduce:grads") == DP_UPDATES_A,
              f"dp (a): collectives {calls}, wanted one all-reduce per update")
        print(f"[dp] (a) BERT-Small bf16 micro 8 x K={K}, world 1 over NCCL, "
              f"{DP_UPDATES_A} updates: {len(same)} parameters and their m, v bitwise equal "
              f"to the no-mesh run; launches {counts}, all tc; collectives {calls} "
              f"(one all-reduce per update); {seq:.1f} seq/s against {ref_seq:.1f} "
              f"without the mesh")
        # seq/s in turns (no mesh, mesh, mesh, no mesh), two updates each
        turns = []
        for name, e in (("no mesh", ref), ("mesh", est), ("mesh", est), ("no mesh", ref)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.train(batches[DP_UPDATES_A:], final_save=False)
            torch.cuda.synchronize()
            turns.append(f"{name} {2 * K * B / (time.perf_counter() - t0):.1f}")
        print(f"[dp] (a) seq/s in turns of 2 updates: {', '.join(turns)}")
        # a profiler window of two updates each: the NCCL kernels, the card's
        # busy time, and the host ops that take the most time
        for name, e in (("mesh", est), ("no mesh", ref)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                e.train(batches[DP_UPDATES_A:], final_save=False)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / 2 * 1e3
            events = prof.key_averages()
            device = [(ev.key, ev.self_device_time_total, ev.count) for ev in events
                      if ev.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(t for _, t, _ in device) / 2 / 1e3
            line = (f"[dp] (a) profile, {name}: {wall:.2f} ms/update wall, card busy "
                    f"{busy:.2f} ms/update")
            if e is est:
                nccl = [row for row in device if "nccl" in row[0].lower()]
                seen = ", ".join(f"{key[:60]} x{c}" for key, _, c in nccl) or "none"
                line += (f", NCCL card time {sum(t for _, t, _ in nccl) / 2 / 1e3:.4f} "
                         f"ms/update (kernels: {seen})")
            host = sorted((ev for ev in events
                           if ev.device_type == torch.autograd.DeviceType.CPU),
                          key=lambda ev: -ev.self_cpu_time_total)[:6]
            print(line + "; host ops by self time per update: " + ", ".join(
                f"{ev.key[:40]} {ev.self_cpu_time_total / 2 / 1e3:.2f} ms x{ev.count // 2}"
                for ev in host))
    finally:
        mesh_lib.shutdown()
    del ref, est
    _release()


def _dp_rank(outdir):
    """One rank of legs (b) and (c): gloo on the shared card."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    from gradaccum_tpu_torch.ops import accumulation as acc

    fa.build_kernels()  # the parent built them: loads the libraries
    mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=300)
    out = {}
    window_bytes, wrap = _spy_window(acc)
    try:
        mesh = mesh_lib.data_parallel_mesh()
        rows = DP_MICRO_B * mesh.world * K
        batches = _host_batches(DP_UPDATES_B, rows, seed=22)
        for tag, zero1 in (("dp", False), ("zero1", "collective")):
            est = _bert_dp_estimator(mesh=mesh, zero1=zero1, dropout=0.0, lr=2e-5)
            est.train([], final_save=False)
            norms = []
            wrap(est, norms)
            fa.reset_launch_counts()
            window_bytes.clear()
            t0 = time.perf_counter()
            state = est.train(batches, final_save=False)
            torch.cuda.synchronize()
            n = sum(p.numel() for p in state.params.values())
            out[tag] = {"params": {k: v.detach().cpu() for k, v in state.params.items()},
                        "launches": fa.launch_counts(), "routes": fa.route_counts(),
                        "bytes": _state_bytes(state, n, max(window_bytes)), "grad_norms": norms,
                        "seconds": time.perf_counter() - t0}
            del est, state
            _release()
        # (c) GPT-Small bf16 + master + fused + ZeRO-1 (ladder leg (c))
        est = _gpt_estimator(torch.bfloat16, adamw(1e-4, weight_decay_rate=0.01,
                                                   master_dtype=torch.float32),
                             fused=True, clip=None, mesh=mesh, zero1=True)
        state = est.train([], final_save=False)
        n = sum(p.numel() for p in state.params.values())
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        mesh.reset_calls()
        window_bytes.clear()
        import numpy as np

        ids = np.concatenate([_gpt_batches(1, seed=23 + u)[0]["input_ids"]
                              for u in range(mesh.world)])  # K x micro rows per rank
        rng = np.random.default_rng(24)
        more = [{"input_ids": rng.permutation(ids)} for _ in range(DP_UPDATES_C - 1)]
        t0 = time.perf_counter()
        state = est.train([{"input_ids": ids}] + more, final_save=False)
        torch.cuda.synchronize()
        out["gpt"] = {"bytes": _state_bytes(state, n, max(window_bytes, default=0)), "params": n,
                      "peak_MiB": (torch.cuda.max_memory_allocated() - held) / 2**20,
                      "held_MiB": held / 2**20, "launches": fa.launch_counts(),
                      "routes": fa.route_counts(), "first_loss": float(est.first_loss),
                      "loss": float(est.last_loss), "seconds": time.perf_counter() - t0,
                      "calls": dict(mesh.calls)}
        out["gloo_cuda"] = _probe_gloo_cuda()
        torch.save(out, os.path.join(outdir, f"rank{mesh.rank}.pt"))
        rank = mesh.rank
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _probe_gloo_cuda():
    """Which collectives this torch's gloo runs on CUDA tensors, asked
    directly in a group of its own with a short timeout: the port stages
    none through host memory (``parallel/mesh.py``), so a refusal here
    names the op that would fail."""
    import datetime

    import torch
    import torch.distributed as dist

    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=30))
    x = torch.ones(4, device="cuda")
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x,
                                              group=group),
    }
    found = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            found[name] = "runs on CUDA tensors"
        except (RuntimeError, ValueError) as e:
            found[name] = f"refused: {str(e).splitlines()[0][:120]}"
    return found


def _dp_legs_bc():
    """Two ranks on the one card over gloo, spawned here."""
    import torch

    from gradaccum_tpu_torch.examples.common import spawn_ranks
    from gradaccum_tpu_torch.ops import accumulation as acc
    from gradaccum_tpu_torch.utils.tree import named_parameters

    world = 2
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    # the single-process reference on the same global batches: one card
    # runs each rank's K micro-batches of 4 rows (the same products, so
    # only the order of the sums differs), denominator K x 2, one update
    # each, at the ranks' constant rate
    rows = DP_MICRO_B * world * K
    est = _bert_dp_estimator(dropout=0.0, lr=2e-5, k=K * world)
    state = est.train([], final_save=False)
    step = est._step_fn()
    ref_norms = []
    for batch in _host_batches(DP_UPDATES_B, rows, seed=22):
        stacked = acc.stack_micro_batches(est._to_device(batch), K)  # [K, 8, ...]
        local = {key: x.reshape(K, world, DP_MICRO_B, *x.shape[2:]).transpose(0, 1)
                 .reshape(K * world, DP_MICRO_B, *x.shape[2:]) for key, x in stacked.items()}
        state, aux = step(state, local, torch.Generator(device="cuda"))
        ref_norms.append(float(aux["grad_norm"]))
    torch.cuda.synchronize()
    ref = {name: p.detach().cpu() for name, p in named_parameters(est.module).items()}
    del est, state, step
    _release()
    t0 = time.perf_counter()
    spawn_ranks("chip_smoke", ["--dp-rank", DP_DIR], world, "cuda", deadline_s=600)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt")) for r in range(world)]
    want_b = _launches_per_kernel(DP_UPDATES_B)
    for r, out in enumerate(ranks):
        for tag in ("dp", "zero1"):
            check(out[tag]["launches"] == want_b,
                  f"dp (b) rank {r} {tag}: launches {out[tag]['launches']} != {want_b}")
            check(all(out[tag]["routes"][n]["tc"] == want_b[n] for n in want_b),
                  f"dp (b) rank {r} {tag}: routes {out[tag]['routes']}")
        err = max(float((out["dp"]["params"][n] - ref[n]).abs().max()) for n in ref)
        zerr = max(float((out["zero1"]["params"][n] - out["dp"]["params"][n]).abs().max())
                   for n in ref)
        moved = max(float((out["dp"]["params"][n] - w).abs().max()) for n, w in
                    named_parameters(_bert_dp_estimator(dropout=0.0).model.init(
                        19830610, "cpu")).items())
        # clipping and Adam hide the gradient's scale from the parameters:
        # the norm of the averaged gradient before clipping shows it
        norm_err = max(abs(a / b - 1.0) for tag in ("dp", "zero1")
                       for a, b in zip(out[tag]["grad_norms"], ref_norms))
        check(len(out["dp"]["grad_norms"]) == len(out["zero1"]["grad_norms"]) == DP_UPDATES_B
              and norm_err <= NORM_RTOL,
              f"dp (b) rank {r}: gradient norms {out['dp']['grad_norms']} (DP), "
              f"{out['zero1']['grad_norms']} (ZeRO-1) against {ref_norms}")
        check(err <= DP_ATOL, f"dp (b) rank {r}: DP off the single-process run by {err:.3e}")
        check(zerr <= ZERO1_ATOL, f"dp (b) rank {r}: ZeRO-1 off DP by {zerr:.3e}")
        check(moved > 10 * DP_ATOL, f"dp (b) rank {r}: the weights did not move ({moved:.3e})")
        print(f"[dp] (b) rank {r}/2, gloo on the shared card, BERT-Small bf16 micro "
              f"{DP_MICRO_B} per rank x K={K}, dropout 0, {DP_UPDATES_B} updates: max |DP - "
              f"single process| {err:.3e} (limit {DP_ATOL:g}), max |ZeRO-1 - DP| {zerr:.3e} "
              f"(limit {ZERO1_ATOL:g}), weights moved {moved:.3e}; gradient norms before "
              f"clipping {out['dp']['grad_norms']} against {ref_norms} single-process "
              f"(max relative gap {norm_err:.3e}, limit {NORM_RTOL:g}); launches "
              f"{out['dp']['launches']} per run, all tc; optimizer + accumulator "
              f"{out['dp']['bytes']:.3f} B/param (DP) and {out['zero1']['bytes']:.3f} "
              f"(ZeRO-1); {out['dp']['seconds']:.2f} s and {out['zero1']['seconds']:.2f} s "
              f"for the {DP_UPDATES_B} updates")
    want_c = _launches_per_kernel(DP_UPDATES_C, k=GPT_K, layers=GPT_LAYERS)
    for r, out in enumerate(ranks):
        g = out["gpt"]
        check(math.isfinite(g["first_loss"]) and math.isfinite(g["loss"]),
              f"dp (c) rank {r}: loss {g['first_loss']} -> {g['loss']}")
        check(g["launches"] == want_c, f"dp (c) rank {r}: launches {g['launches']} != {want_c}")
        print(f"[dp] (c) rank {r}/2, GPT-Small bf16 + f32 masters + fused + ZeRO-1 "
              f"(ladder leg (c)), micro {GPT_MICRO} per rank x K={GPT_K}, seq {GPT_SEQ}, "
              f"{DP_UPDATES_C} updates: optimizer + accumulator {g['bytes']:.3f} B/param "
              f"({g['params']} parameters; JAX's accounting: 6), peak {g['peak_MiB']:.1f} MiB "
              f"above the {g['held_MiB']:.1f} MiB state, loss {g['first_loss']:.4f} -> "
              f"{g['loss']:.4f}, {g['seconds']:.2f} s; launches {g['launches']}; "
              f"collectives {g['calls']}")
    print(f"[dp] legs (b) and (c): the two ranks took {spawn_s:.1f} s, process start included")
    print(f"[dp] gloo with CUDA tensors on this torch (asked directly): {ranks[0]['gloo_cuda']}")


def phase_dp():
    """Data parallelism and ZeRO-1 on the one card: (a) world 1 over NCCL,
    (b) and (c) two ranks sharing the card over gloo."""
    _dp_leg_a()
    _dp_legs_bc()


# --------------------------------------------------------------------------
# phase 20: resilience and observability on the card
# --------------------------------------------------------------------------

RES_DIR = os.path.join(ROOT, "build", "chip_smoke_resilience")
RES_STEPS = 16  # micro-steps of the streaming runs: 4 windows of K=4
RES_SAVE = 3  # checkpoint cadence: never a window boundary (K=4)
COST_UPDATES = 3  # updates of each leg of (f)


def _res_estimator(model_dir, mode="streaming", **run):
    """BERT-Small bf16, dropout 0.1, micro 8 x K=4, on the flash kernels,
    checkpointing into ``model_dir`` every RES_SAVE micro-steps."""
    run = dict(dict(model_dir=model_dir, save_checkpoints_steps=RES_SAVE,
                    keep_checkpoint_max=5), **run)
    return _bert_dp_estimator(mode=mode, lr=2e-5, **run)


def _res_batches(n, rows=8):
    return _host_batches(n, rows, seed=31)


def _flat_equal(fa, fb):
    """The first leaf of two flat states (``checkpoint.flatten``, or a
    checkpoint's payload) that differs, else None."""
    import torch

    if fa.keys() != fb.keys():
        return f"leaves {sorted(fa.keys() ^ fb.keys())[:3]}"
    for key in fa:
        x, y = fa[key], fb[key]
        if isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                return key
        elif x != y:
            return key
    return None


def _losses(model_dir):
    with open(os.path.join(model_dir, "loss_vs_step.csv")) as f:
        next(f)
        return dict(line.strip().split(",") for line in f)


def _res_crash_resume():
    """(a) crash inside a window, resume from a mid-window checkpoint with
    the async writer, bitwise against the uninterrupted run; (b) a flipped
    byte in the newest checkpoint is caught and the previous one restored."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.obs import flight, trace
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.resilience import faults

    batches = _res_batches(RES_STEPS)
    ref_dir, crash_dir = (os.path.join(RES_DIR, d) for d in ("ref", "crash"))
    tracer = trace.Tracer(capacity=None)
    with trace.installed(tracer):  # the reference needs its final state only
        est = _res_estimator(ref_dir, async_checkpoint=True, save_checkpoints_steps=None)
        ref = est.train(batches, max_steps=RES_STEPS)
    branches = [e["args"]["branch"] for e in tracer.snapshot() if e["name"] == "train/step"]
    # no first-step quirk: the window applies at step % K == K - 1
    want = (["accumulate"] * (K - 1) + ["apply"]) * (RES_STEPS // K)
    check(branches == want, f"resilience (a): train/step labels {branches}")
    ref_flat = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in ckpt_lib.flatten(ref).items()}
    del est, ref
    _release()

    crash_at = int(np.random.default_rng(0xC0FFEE).integers(7, 12))
    check(crash_at % K != 0, f"resilience (a): crash step {crash_at} on a window edge")
    inj = faults.FaultInjector(faults.FaultSchedule([faults.FaultSpec(
        faults.POST_TRAIN_STEP, at=crash_at)]))
    est = _res_estimator(crash_dir, async_checkpoint=True)
    crashed = False
    with trace.installed(trace.Tracer()), faults.installed(inj):
        try:
            est.train(batches, max_steps=RES_STEPS)
        except faults.InjectedCrash:
            crashed = True
    check(crashed and inj.fired == [(faults.POST_TRAIN_STEP, crash_at, "crash")],
          f"resilience (a): the crash did not fire ({inj.fired})")
    check(est._res.async_ckpt is None, "resilience (a): the crash left the writer open")
    dumps = flight.list_dumps(crash_dir)
    seen = flight.fault_events(flight.load_dump(dumps[-1])["events"]) if dumps else []
    check(seen == inj.fired, f"resilience (a): flight dump faults {seen} != {inj.fired}")
    del est
    _release()
    ckpt_step = ckpt_lib.latest_checkpoint(crash_dir)[0]
    check(0 < ckpt_step < crash_at and ckpt_step % K, f"resilience (a): resumed from "
          f"step {ckpt_step}, not inside a window before the crash at {crash_at}")
    est = _res_estimator(crash_dir, async_checkpoint=True)
    fa.reset_launch_counts()
    resumed = est.train(batches[ckpt_step:], max_steps=RES_STEPS)
    counts = fa.launch_counts()
    want_counts = {n: LAYERS * (RES_STEPS - ckpt_step) for n in REPLACES}
    check(counts == want_counts, f"resilience (a): launches {counts} != {want_counts}")
    diff = _flat_equal(ref_flat, ckpt_lib.flatten(resumed))
    check(diff is None, f"resilience (a): the resumed state differs from the "
          f"uninterrupted run at {diff}")
    loss_ref, loss_res = _losses(ref_dir), _losses(crash_dir)
    after = sorted(int(s) for s in loss_res if int(s) > ckpt_step)
    check(after and all(loss_res[str(s)] == loss_ref[str(s)] for s in after),
          "resilience (a): post-resume losses differ from the uninterrupted run")
    print(f"[resilience] (a) BERT-Small bf16 streaming, micro 8 x K={K}, dropout 0.1, async "
          f"checkpoints every {RES_SAVE} micro-steps: crash at micro-step {crash_at} "
          f"(seeded), resumed in a fresh Estimator from the mid-window checkpoint at "
          f"{ckpt_step}; parameters, m, v, accumulators, good count and step bitwise equal "
          f"to the uninterrupted run after {RES_STEPS} micro-steps, {len(after)} "
          f"post-resume losses bitwise equal; flight dump holds {seen}; launches after "
          f"the resume {counts}; train/step labels {branches[:K]} per window")

    # (b) one flipped byte in the newest checkpoint
    (prev_step, prev_path), (new_step, new_path) = ckpt_lib.all_checkpoints(crash_dir)[-2:]
    data = bytearray(open(new_path, "rb").read())
    data[len(data) // 2] ^= 0x01
    with open(new_path, "wb") as f:
        f.write(bytes(data))
    want = torch.load(prev_path, map_location="cpu", weights_only=True)
    restored = ckpt_lib.restore(crash_dir, resumed)
    diff = _flat_equal(want, ckpt_lib.flatten(restored))
    check(diff is None and os.path.exists(new_path + ".corrupt")
          and not os.path.exists(new_path),
          f"resilience (b): restore after a bit flip in ckpt-{new_step} differs from "
          f"ckpt-{prev_step} at {diff}, or the file was not quarantined")
    print(f"[resilience] (b) one byte flipped in ckpt-{new_step}.pt: the manifest's sha256 "
          f"caught it, the file was quarantined as .corrupt, and the restore equals "
          f"ckpt-{prev_step}.pt exactly")
    del est, resumed, restored
    _release()
    return ref_flat


def _res_sigterm(ref_flat):
    """(c) the process sends itself SIGTERM mid-train: the final checkpoint
    lands at that micro-step with the async writer drained, and the resume
    is bitwise."""
    import signal

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.resilience import manifest, preemption

    batches = _res_batches(RES_STEPS)
    d = os.path.join(RES_DIR, "sigterm")
    sig_at = 9

    def stream():
        for i, b in enumerate(batches):
            if i == sig_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    # no periodic saves: the drain's own checkpoint is the one resumed from
    est = _res_estimator(d, async_checkpoint=True, save_checkpoints_steps=None)
    with preemption.PreemptionHandler():
        state = est.train(stream(), max_steps=RES_STEPS)
    stopped = est.drained_at_step
    newest = ckpt_lib.latest_checkpoint(d)
    check(stopped == state.step == sig_at + 1 and newest[0] == stopped
          and manifest.verify(d, newest[1]) is True and not preemption.requested(),
          f"resilience (c): drained at {stopped} (state {state.step}), newest checkpoint "
          f"{newest}, signal at batch {sig_at}")
    del est, state
    _release()
    resumed = _res_estimator(d, async_checkpoint=True, save_checkpoints_steps=None).train(
        batches[stopped:], max_steps=RES_STEPS)
    diff = _flat_equal(ref_flat, ckpt_lib.flatten(resumed))
    check(diff is None, f"resilience (c): the resume after SIGTERM differs at {diff}")
    print(f"[resilience] (c) SIGTERM sent while batch {sig_at} was read: the loop stopped "
          f"at micro-step {stopped}, the async writer drained and ckpt-{stopped}.pt "
          f"verifies against the manifest before train() returned; the resume to "
          f"{RES_STEPS} is bitwise equal to the uninterrupted run")
    del resumed
    _release()


DRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_drain")
DRAIN_UPDATES = 4  # host steps offered to each rank (scan, K micro-batches each)


def _drain_rank(outdir):
    """One rank of phase 20 (d): explicit DP over gloo on the shared card,
    the drain agreed over the c10d store; rank 1 alone is preempted."""
    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.resilience.preemption import DrainConsensus

    fa.build_kernels()  # the parent built them: loads the libraries
    mesh_lib.initialize_multihost(device="cuda:0", backend="gloo", timeout_s=300)
    try:
        mesh = mesh_lib.data_parallel_mesh()
        consensus = DrainConsensus(timeout_ms=60_000)
        est = _bert_dp_estimator(mesh=mesh, dropout=0.1, lr=2e-5,
                                 model_dir=os.path.join(outdir, "ckpt"),
                                 drain_consensus=consensus)
        batches = _host_batches(DRAIN_UPDATES, DP_MICRO_B * mesh.world * K, seed=41)

        def stream():
            for i, b in enumerate(batches):
                if mesh.rank == 1 and i == 1:
                    consensus.request()  # this rank alone sees the preemption
                yield b

        state = est.train(stream())
        out = {"rank": mesh.rank, "drained_at_step": est.drained_at_step, "step": state.step,
               "multiprocess": consensus.multiprocess, "rounds": consensus._round}
        with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
        rank = mesh.rank
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))
    return 0


def _start_drain_ranks():
    """(d), started: two gloo ranks on the card through the launcher, in a
    thread, so that they run while the parent's legs (a)-(c) and (e) do."""
    import threading

    from gradaccum_tpu_torch.examples.common import spawn_ranks

    shutil.rmtree(DRAIN_DIR, ignore_errors=True)
    os.makedirs(DRAIN_DIR)
    job = {"t0": time.perf_counter()}

    def run():
        try:
            spawn_ranks("chip_smoke", ["--drain-rank", DRAIN_DIR], 2, "cuda", deadline_s=600)
        except BaseException as e:  # noqa: BLE001 — reported by _res_drain_ranks
            job["error"] = e
        job["took"] = time.perf_counter() - job["t0"]

    job["thread"] = threading.Thread(target=run, daemon=True)
    job["thread"].start()
    return job


def _res_drain_ranks(job):
    """(d), checked: the drain was agreed over the c10d store and both
    ranks landed the same final step."""
    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib

    job["thread"].join()
    check("error" not in job, f"resilience (d): the ranks failed: {job.get('error')}")
    ranks = []
    for r in range(2):
        with open(os.path.join(DRAIN_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    steps = {r["drained_at_step"] for r in ranks}
    newest = ckpt_lib.latest_checkpoint(os.path.join(DRAIN_DIR, "ckpt"))
    check(len(steps) == 1 and None not in steps and all(r["multiprocess"] for r in ranks)
          and 0 < ranks[0]["drained_at_step"] < DRAIN_UPDATES * K
          and newest is not None and newest[0] == ranks[0]["drained_at_step"],
          f"resilience (d): ranks {ranks}, newest checkpoint {newest}")
    print(f"[resilience] (d) two gloo ranks sharing the card, explicit DP, BERT-Small bf16 "
          f"micro {DP_MICRO_B} per rank x K={K}: rank 1 alone preempted while reading its "
          f"second host batch; DrainConsensus over the c10d store stopped both ranks at "
          f"micro-step {ranks[0]['drained_at_step']} ({ranks[0]['rounds']} store rounds), "
          f"the final checkpoint is ckpt-{newest[0]}.pt; {job['took']:.1f} s with process "
          f"start, beside legs (a)-(c) and (e)")


def _trace_kernels(path):
    """``{kernel name: count}`` of the card's kernel events in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _res_profiler():
    """(e) a StepWindowProfiler window of 2 updates holds K1-K3 under their
    kernel names; the scan spans carry their label."""
    from gradaccum_tpu_torch.obs import trace

    prof_dir = os.path.join(RES_DIR, "profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    tracer = trace.Tracer(capacity=None)
    est = _bert_dp_estimator(profile_dir=prof_dir, profile_start_step=K,
                             profile_num_steps=2 * K)
    with trace.installed(tracer):
        est.train(_res_batches(4, rows=8 * K))
    files = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    check(files == ["trace-0001.json"], f"resilience (e): profile dir holds {files}")
    kernels = _trace_kernels(os.path.join(prof_dir, files[0]))
    want = {"flash_fwd_tc_kernel": 2 * K * LAYERS, "flash_dq_tc_kernel": 2 * K * LAYERS,
            "flash_dkv_tc_kernel": 2 * K * LAYERS}
    got = {short: sum(c for name, c in kernels.items() if short in name) for short in want}
    check(got == want, f"resilience (e): kernels in the trace {got} != {want}")
    labels = [e["args"]["branch"] for e in tracer.snapshot() if e["name"] == "train/step"]
    check(labels == ["scan-cycle"] * 4, f"resilience (e): span labels {labels}")
    print(f"[resilience] (e) StepWindowProfiler window of 2 updates: {files[0]} holds "
          f"{got} CUDA kernel events (K1-K3 under their names, {len(kernels)} kernel names "
          f"in all); train/step spans {labels}")
    del est
    _release()


def _cost_leg(on: bool):
    """Card-busy ms and seq/s per update of BERT-Small bf16 scan with a
    checkpoint every update: obs and the async writer on, or both off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.obs import trace

    d = os.path.join(RES_DIR, "cost-on" if on else "cost-off")
    shutil.rmtree(d, ignore_errors=True)
    batches = _res_batches(2 * COST_UPDATES + 1, rows=8 * K)
    timed, profiled = batches[1:COST_UPDATES + 1], batches[COST_UPDATES + 1:]
    est = _bert_dp_estimator(model_dir=d, save_checkpoints_steps=K, async_checkpoint=on)
    with trace.installed(trace.Tracer() if on else trace.NULL):
        est.train(batches[:1])  # warm-up: its first step is never timed
        est.train_stats.update(host_steps=0, examples=0, seconds=0.0)
        est.train(timed)
        seq_s = est.examples_per_sec()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            est.train(profiled)
            torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    del est
    _release()
    return busy / len(profiled), seq_s


def _res_cost():
    """(f) the machinery's cost: a finding, not a gate."""
    on_busy, on_seq = _cost_leg(True)
    off_busy, off_seq = _cost_leg(False)
    print(f"[resilience] (f) BERT-Small bf16 scan, micro 8 x K={K}, a checkpoint every "
          f"update: obs + async writer ON {on_busy:.3f} card-busy ms/update, "
          f"{on_seq:.1f} seq/s; OFF (obs off, synchronous saves) {off_busy:.3f} card-busy "
          f"ms/update, {off_seq:.1f} seq/s")
    return {"on": [on_busy, on_seq], "off": [off_busy, off_seq]}


def phase_resilience():
    """Phase 20: crash and resume, corruption, SIGTERM, the drain across
    ranks (its two processes run beside the other legs), the profiler
    window and spans, then the cost of the machinery, alone on the card."""
    t0 = time.perf_counter()
    shutil.rmtree(RES_DIR, ignore_errors=True)
    os.makedirs(RES_DIR)
    drain = _start_drain_ranks()
    try:
        ref_flat = _res_crash_resume()
        _res_sigterm(ref_flat)
        _res_profiler()
    finally:
        drain["thread"].join()  # the launcher ends its ranks, by its deadline at the latest
    _res_drain_ranks(drain)
    cost = _res_cost()
    print(f"[resilience] phase 20 took {time.perf_counter() - t0:.1f} s")
    return cost


# --------------------------------------------------------------------------
# phase 21: export, and the native reader
# --------------------------------------------------------------------------

EXPORT_DIR = os.path.join(ROOT, "build", "chip_smoke_export")
EXPORT_TOL = {"float32": 1e-6, "bfloat16": 1e-2}  # loaded artifact against predict

# a fresh process that imports only the export module: loads every artifact,
# calls it at each batch, counts the flash forward launches (the wrapper's
# count, per route, and the profiler's kernel events) and the port's modules
_LOADER = r"""
import json, os, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from gradaccum_tpu_torch.estimator.export import load_exported
root = sys.argv[1]
report = {}
for name in sorted(os.listdir(root)):
    d = os.path.join(root, name)
    if not os.path.exists(os.path.join(d, "model.pt2")):
        continue
    fn = load_exported(d)
    fa = sys.modules["gradaccum_tpu_torch.ops.flash_attention"]  # imported by load_exported
    outs = {}
    fa.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for rows in (8, 3):
            batch = dict(np.load(os.path.join(d, f"batch{rows}.npz")))
            out = fn(batch)
            for key, v in out.items():
                outs[f"{key}{rows}"] = v.float().cpu().numpy()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "flash_fwd" in e.key)
    np.savez(os.path.join(d, "loaded.npz"), **outs)
    report[name] = {"routes": fa.route_counts()["flash_fwd"], "kernel_events": kernels}
report["modules"] = sorted(m for m in sys.modules if m.startswith("gradaccum_tpu_torch"))
print(json.dumps(report))
"""


def _export_bert(dtype_name):
    """BERT-Small (random weights from the run seed) exported from one row."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention

    d = os.path.join(EXPORT_DIR, f"bert_{dtype_name}")
    cfg = BertConfig.small(dtype=getattr(torch, dtype_name))
    est = Estimator(bert_classifier_bundle(cfg, attention_fn=flash_attention), adamw(2e-5),
                    GradAccumConfig(K), RunConfig(), mode="scan", device="cuda")
    strip = lambda b: {k: v for k, v in b.items() if k != "label"}  # noqa: E731
    t0 = time.perf_counter()
    est.export_model(d, strip(_bert_small_batches(1, seed=51)))
    took = time.perf_counter() - t0
    want = {}
    for rows in (8, 3):
        batch = strip(_bert_small_batches(rows, seed=52 + rows))
        np.savez(os.path.join(d, f"batch{rows}.npz"), **batch)
        preds = list(est.predict([batch]))
        for key in preds[0]:
            want[f"{key}{rows}"] = np.stack([p[key] for p in preds]).astype(np.float32)
    del est
    _release()
    return want, took


def _export_entry(name, argv, rebuild):
    """Run an entry point with --export-dir and --model-dir; ``rebuild``
    gives ``(bundle, batches)``: the model the entry trained (its weights
    come from its final checkpoint) and the batches to call."""
    import importlib

    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
    from gradaccum_tpu_torch.utils.tree import named_parameters

    d = os.path.join(EXPORT_DIR, name)
    model_dir = os.path.join(EXPORT_DIR, f"{name}-model")
    module = importlib.import_module(f"gradaccum_tpu_torch.examples.{name}")
    t0 = time.perf_counter()
    out = module.main([*argv, "--export-dir", d, "--model-dir", model_dir])
    took = time.perf_counter() - t0
    check(out["export"] == os.path.join(d, "model.pt2"), f"export: {name} wrote {out}")
    bundle, batches = rebuild()
    model = bundle.init(19830610, "cuda")
    ckpt_lib.restore_params(model_dir, named_parameters(model))
    want = {}
    for rows, batch in batches.items():
        np.savez(os.path.join(d, f"batch{rows}.npz"), **batch)
        with torch.no_grad():
            got = bundle.predict(model, {k: torch.as_tensor(v).cuda() for k, v in batch.items()})
        for key, v in got.items():
            want[f"{key}{rows}"] = v.float().cpu().numpy()
    del model
    _release()
    return want, took


def _gpt_lm_rebuild():
    import numpy as np

    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu_torch.ops.flash_attention import causal_flash_attention

    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=4, num_heads=4,
                    max_position_embeddings=64, dropout=0.1)
    rng = np.random.default_rng(61)
    return (gpt_lm_bundle(cfg, attention_fn=causal_flash_attention),
            {rows: {"input_ids": rng.integers(0, 256, size=(rows, 64)).astype(np.int32)}
             for rows in (8, 3)})


def _housing_rebuild():
    import numpy as np

    from gradaccum_tpu_torch.models.housing_mlp import housing_mlp_bundle

    rng = np.random.default_rng(62)
    return housing_mlp_bundle(), {rows: {"x": rng.normal(size=(rows, 14)).astype(np.float32),
                                         "y": np.zeros((rows, 1), np.float32)}
                                  for rows in (8, 3)}


def _native_check():
    """The native reader builds on this machine and gives the numpy
    readers' bytes on a generated idx pair and a numeric CSV."""
    import gzip
    import struct

    import numpy as np

    from gradaccum_tpu_torch.data import csv as csv_lib
    from gradaccum_tpu_torch.data import mnist, native

    check(native.available(), f"export: the native reader did not build: "
          f"{native.build_error}")
    d = os.path.join(EXPORT_DIR, "native")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(63)
    images = rng.integers(0, 256, size=(100, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=100, dtype=np.uint8)
    img, lab, table = (os.path.join(d, n) for n in ("img-idx3.gz", "lab-idx1.gz", "t.csv"))
    with gzip.open(img, "wb") as f:
        f.write(struct.pack(">iiii", mnist.IMAGE_MAGIC, 100, 28, 28) + images.tobytes())
    with gzip.open(lab, "wb") as f:
        f.write(struct.pack(">ii", mnist.LABEL_MAGIC, 100) + labels.tobytes())
    with open(table, "w") as f:
        f.write("a,b,c\n" + "".join(",".join(repr(float(v)) for v in row) + "\n"
                                     for row in rng.normal(0, 30, size=(200, 3))))
    fast = (mnist.read_images(img), mnist.read_labels(lab),
            csv_lib.read_csv(table, columns=["a", "b", "c"]))
    get_lib = native.get_lib
    native.get_lib = lambda: None  # the numpy readers
    try:
        slow = (mnist.read_images(img), mnist.read_labels(lab),
                csv_lib.read_csv(table, columns=["a", "b", "c"]))
    finally:
        native.get_lib = get_lib
    same = (fast[0].tobytes() == slow[0].tobytes() and fast[1].tobytes() == slow[1].tobytes()
            and all(fast[2][c].tobytes() == slow[2][c].tobytes() for c in "abc"))
    check(same, "export: the native reader's bytes differ from the numpy readers'")
    print("[export] native reader: built into build/native/ on this machine, available; "
          "idx images/labels (gzip) and a numeric CSV byte-identical to the numpy readers")


def phase_export():
    """Phase 21, started: BERT-Small exported in float32 and bf16, gpt_lm
    and housing through --export-dir, and the loader process started on
    them (it runs beside phase 20); returns what ``phase_export_check``
    holds the loaded artifacts against."""
    t0 = time.perf_counter()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    want, took = {}, {}
    for dt in ("float32", "bfloat16"):
        want[f"bert_{dt}"], took[f"bert_{dt}"] = _export_bert(dt)
    want["gpt_lm"], took["gpt_lm"] = _export_entry(
        "gpt_lm", ["--flash", "--max-steps", "8", "--sample", "0"], _gpt_lm_rebuild)
    want["housing"], took["housing"] = _export_entry(
        "housing", ["--max-steps", "60"], _housing_rebuild)
    loader = subprocess.Popen([sys.executable, "-c", _LOADER, EXPORT_DIR],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    return {"want": want, "took": took, "loader": loader, "t0": t0,
            "seconds": time.perf_counter() - t0}


def phase_export_check(job):
    """Phase 21, checked: every artifact, loaded in one fresh process that
    imports only the export module, against predict; the flash forward
    launched inside it on the expected route; the native reader; the
    wrapper's wall time per call (measured with the card to itself)."""
    import numpy as np

    from gradaccum_tpu_torch.utils import call_overhead

    t0 = time.perf_counter()
    want, took = job["want"], job["took"]
    try:
        out, err = job["loader"].communicate(timeout=600)
    except subprocess.TimeoutExpired:
        job["loader"].kill()
        raise SmokeError("export: the loader did not finish in 600 s")
    check(job["loader"].returncode == 0, f"export: the loader failed: {err[-3000:]}")
    report = json.loads(out.strip().splitlines()[-1])
    check(not any(".models" in m or ".examples" in m for m in report["modules"]),
          f"export: the loader imported model code: {report['modules']}")
    routes = {"bert_float32": "tf32x3", "bert_bfloat16": "tc", "gpt_lm": "tf32x3",
              "housing": None}
    tol = {"bert_float32": 1e-6, "bert_bfloat16": 1e-2, "gpt_lm": 1e-6, "housing": 1e-6}
    launches = {}
    for name, route in routes.items():
        got = dict(np.load(os.path.join(EXPORT_DIR, name, "loaded.npz")))
        check(got.keys() == want[name].keys(), f"export {name}: outputs {sorted(got)}")
        err = 0.0
        for key, w in want[name].items():
            if key.startswith(("classes", "next_token")):
                check(np.array_equal(got[key], w), f"export {name}: {key} differ")
            else:
                err = max(err, float(np.abs(got[key] - w).max()))
        check(err <= tol[name], f"export {name}: loaded artifact off predict by {err:.3e} "
              f"(limit {tol[name]:g})")
        r = report[name]
        n = sum(r["routes"].values())
        if route is None:
            check(n == 0 and r["kernel_events"] == 0, f"export {name}: launches {r}")
        else:
            check(n > 0 and r["routes"][route] == n and r["kernel_events"] == n,
                  f"export {name}: flash forward launches {r} (route {route})")
        launches[name] = r
        print(f"[export] {name}: exported in {took[name]:.1f} s from a one-row sample; "
              f"loaded in a fresh process (imports {len(report['modules'])} port modules, "
              f"no model code) and called at batch 8 and 3: max |artifact - predict| "
              f"{err:.3e} (limit {tol[name]:g}), classes equal; flash forward launches "
              f"inside the artifact {r['routes']} ({r['kernel_events']} kernel events under "
              f"the profiler)")
    _native_check()
    overhead = call_overhead.measure()
    print(f"[export] flash wrapper wall time per call (bf16 [8, 8, 128, 64], dropout 0.1): "
          f"training forward {overhead['train_forward_ms']:.4f} ms, forward + backward "
          f"{overhead['train_forward_backward_ms']:.4f} ms, inference forward "
          f"{overhead['inference_forward_ms']:.4f} ms, the kernel wrapper alone "
          f"{overhead['kernel_wrapper_ms']:.4f} ms, the operator "
          f"{overhead['operator_ms']:.4f} ms, the same kernel as a custom_op "
          f"{overhead['custom_op_ms']:.4f} ms")
    print(f"[export] phase 21 took {job['seconds'] + time.perf_counter() - t0:.1f} s (the "
          f"loader ran beside phase 20)")
    return launches, overhead


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def kernels_line(counts, worst, timing, timing_f32, timing_gpt, timing_gpt_f32,
                 timing_gpt_lm, ladder, gpt_lm_runs, bert_f32_counts):
    """The ``{"kernels": [...]}`` entries: each kernel in bfloat16 and in
    float32, with its launches, largest error against the plain version,
    and its card, plain, bound and library times (phase_timing's tuples)."""
    lm_per_update = 4 * gpt_lm_runs["scan"]["accum_k"]  # gpt_lm's layers x K
    lm_counts = gpt_lm_runs["scan"]["launches"]

    def at(timed, name, per_update=None):
        t_ms, t_plain, t_library, t_bounds = timed
        out = {"ms": t_ms[name], "plain_ms": t_plain[name], "bound_ms": t_bounds[name][0],
               "bound_by": t_bounds[name][1], "library_ms": t_library[name]}
        if per_update is not None:
            out["launches_per_update"] = per_update
        return out

    kernels = []
    for name in REPLACES:
        # bfloat16 (tc): launches from the main path, times at its shape
        # (BERT-Small, padded mask) and at GPT-Small's causal [8, 8, 512, 64]
        kernels.append({
            "name": name, "dtype": "bfloat16", "route": "cuda",
            "source": SOURCES["torch.bfloat16"], "replaces": REPLACES[name],
            "launches": counts[name], "max_abs_err": worst[(name, "torch.bfloat16")],
            **at(timing, name),
            "gpt_causal": at(timing_gpt, name, ladder[1]["launches_per_update"])})
    for name in REPLACES:
        # float32 (route tf32x3): launches from gpt_lm --flash in scan mode,
        # the float32 path whose counts were zeroed before it, and from
        # bert_finetune at its float32 default; times at the BERT shape in
        # float32, GPT-Small's and gpt_lm's
        kernels.append({
            "name": f"{name}_f32", "dtype": "float32", "route": "cuda",
            "source": SOURCES["torch.float32"], "replaces": REPLACES[name],
            "launches": lm_counts[name], "launches_from": "gpt_lm --flash --mode scan",
            "launches_bert_f32": bert_f32_counts[name],
            "max_abs_err": worst[(name, "torch.float32")],
            **at(timing_f32, name),
            "gpt_causal": at(timing_gpt_f32, name, ladder[0]["launches_per_update"]),
            "gpt_lm_causal": at(timing_gpt_lm, name, lm_per_update)})
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("[chip_smoke] torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this smoke test needs one card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"[chip_smoke] {PACKAGE}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    t_start = time.perf_counter()
    export_job = None
    try:
        phase_build()  # every other phase needs the kernels
        worst = phase_kernels()
        timing = phase_timing()
        timing_f32 = phase_timing(dtype=torch.float32)  # bert_finetune's default dtype
        timing_gpt = phase_timing(GPT_SHAPE, masked=False, causal=True, label="gpt")
        timing_gpt_f32 = phase_timing(GPT_SHAPE, masked=False, causal=True, label="gpt",
                                      dtype=torch.float32)
        timing_gpt_lm = phase_timing(GPT_LM_SHAPE, masked=False, causal=True,
                                     label="gpt_lm", dtype=torch.float32)
        phase_agree()
        counts, scan_result = phase_main(UPDATES)
        phase_profile()
        streaming = phase_streaming()
        print(f"[streaming] seq/s streaming {streaming['seq/s']:.1f} (mfu "
              f"{streaming['mfu']:.4f}) against scan {scan_result['seq/s']:.1f} (mfu "
              f"{scan_result['mfu']:.4f}) in this run")
        phase_profile(mode="streaming")
        phase_stream_scan()
        phase_guard()
        phase_small_models()
        phase_xla_bwd()
        phase_warm_start()
        phase_remat()
        phase_sparse_embed()
        phase_profile(extra=["--sparse-embed-grad"])
        phase_moe()
        ladder = phase_gpt_ladder()
        phase_gpt_profile()
        phase_gpt_profile(f32=True)
        phase_gpt_guard()
        gpt_lm_runs = phase_gpt_lm()
        bert_f32_counts = phase_bert_f32()
        phase_dp()
        export_job = phase_export()  # its loader process runs beside phase 20
        phase_resilience()
        phase_export_check(export_job)
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if export_job is not None and export_job["loader"].poll() is None:
            export_job["loader"].kill()  # a phase failed before the loader was read
            export_job["loader"].wait()
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = kernels_line(counts, worst, timing, timing_f32, timing_gpt, timing_gpt_f32,
                           timing_gpt_lm, ladder, gpt_lm_runs, bert_f32_counts)
    print(_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 19, spawned by phase_dp
        sys.path.insert(0, ROOT)
        sys.exit(_dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--drain-rank"]:  # a rank of phase 20 (d)
        sys.path.insert(0, ROOT)
        sys.exit(_drain_rank(sys.argv[2]))
    sys.exit(main())
