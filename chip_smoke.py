#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA H100.

    python3 chip_smoke.py     # one card, about three minutes (two of them nvcc)

Phases, each of which fails the run if it fails:

1. build: compile every CUDA source of ``gradaccum_tpu_torch/csrc`` with
   nvcc (one process per source, all started together) and print the time.
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the BERT-Small main-path shape q/k/v [8, 8, 128, 64], in float32 and
   bfloat16, with a padded mask and without, causal, and with attention
   dropout 0.1 under a fixed seed; read the keep mask back out of the
   forward and dk/dv kernels and require it equal to the plain mask bit for
   bit. Then time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (never used by the port).
3. agree: the tiny BERT classifier's loss and gradients on the card (through
   the kernels) against the same model on the CPU (plain versions).
4. main: the entry point ``gradaccum_tpu_torch/examples/bert_finetune.py``
   at BERT-Small width (L-4 H-512 A-8, vocab 30522, seq 128), micro-batch
   8 x K=4, bfloat16 compute, random weights from a seed, for a few
   optimizer updates and one evaluation. The kernels' launch counts are
   zeroed just before and read just after, and must match the path exactly.
5. profile: a torch.profiler window over three more updates of the same
   run: wall and card-busy time per update, idle share, top kernels.

The last three lines of standard output are the card's name and power
limit, a JSON line describing every kernel, and the result line
``{"ok": true, "device": {...}}``. Without a card, or without the package
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
# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s and FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# |kernel - plain| <= ATOL + RTOL*|plain|, per output. float32: both sides
# run float32 math in another summation order. bfloat16: both compute in
# float32 from the same bf16 inputs; o/dq/dk/dv round once to bf16 (2^-8
# relative), lse and dmask stay float32.
TOL = {
    "torch.float32": {"o": (1e-5, 1e-5), "lse": (1e-5, 1e-5), "dq": (1e-4, 1e-4),
                      "dk": (1e-4, 1e-4), "dv": (1e-4, 1e-4), "dmask": (1e-4, 1e-4)},
    "torch.bfloat16": {"o": (1e-2, 1e-2), "lse": (1e-4, 1e-4), "dq": (1e-2, 1e-2),
                       "dk": (1e-2, 1e-2), "dv": (1e-2, 1e-2), "dmask": (1e-3, 1e-3)},
}
REPLACES = {
    "flash_fwd": "gradaccum_tpu/ops/flash_attention.py:127",
    "flash_bwd_dq": "gradaccum_tpu/ops/flash_attention.py:348",
    "flash_bwd_dkv": "gradaccum_tpu/ops/flash_attention.py:399",
}
SOURCES = {name: f"{PACKAGE}/csrc/flash_attention.cu" for name in REPLACES}


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


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def _inputs(dtype, masked, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    mask = None
    if masked:
        # padded keys as BERT builds them: (1 - input_mask) * -1e9
        lengths = torch.randint(S // 4, S + 1, (B,), generator=g, device="cuda")
        pad = torch.arange(S, device="cuda")[None, :] >= lengths[:, None]
        mask = (pad.float() * -1e9).to(dtype).reshape(B, 1, 1, S).contiguous()
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
    for dtype in (torch.float32, torch.bfloat16):
        for masked, causal, rate in cases:
            q, k, v, mask, do = _inputs(dtype, masked)
            seed = SEED if rate else None
            o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)
            o_r, lse_r = fa.flash_forward_reference(q, k, v, mask, seed, causal, rate)
            # each backward kernel gets exactly its plain twin's inputs
            delta = fa._delta(do, o_r)
            dq = fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, lse_r, delta, causal, rate)
            dk, dv, dm = fa.flash_bwd_dkv_cuda(q, k, v, mask, seed, do, lse_r, delta,
                                               causal, rate)
            dq_r, dk_r, dv_r, dm_r = fa.flash_backward_reference(
                q, k, v, mask, seed, o_r, lse_r, do, causal, rate)
            torch.cuda.synchronize()
            outs = {"o": (o, o_r), "lse": (lse, lse_r), "dq": (dq, dq_r),
                    "dk": (dk, dk_r), "dv": (dv, dv_r)}
            if masked:
                outs["dmask"] = (dm, dm_r)
            line = []
            for name, (got, want) in outs.items():
                err, ok, atol, rtol = _err(name, got, want, dtype)
                kernel = {"o": "flash_fwd", "lse": "flash_fwd", "dq": "flash_bwd_dq"}.get(
                    name, "flash_bwd_dkv")
                key = (kernel, str(dtype))
                worst[key] = max(worst.get(key, 0.0), err)
                line.append(f"{name}={err:.2e}")
                check(ok, f"{name} disagrees ({dtype}, mask={masked}, causal={causal}, "
                          f"rate={rate}): max |err| {err:.3e} > {atol} + {rtol}|ref|")
            print(f"[kernels] {str(dtype)[6:]:8s} mask={int(masked)} causal={int(causal)} "
                  f"rate={rate}: " + " ".join(line))
    _check_keep_masks(fa)
    return worst


def _check_keep_masks(fa):
    """Read the keep decisions back out of the forward and dk/dv kernels and
    require them equal to the plain mask. With q = k = 0 every probability
    is 1/S, so o[i, d] = keep[i, c*D + d]/(keep_prob*S) when v is the
    one-hot block c; dv[j, d] = keep[c*D + d, j]/(keep_prob*S) likewise
    when dO is the one-hot block c of query rows."""
    import torch

    want = fa.dropout_keep_mask(SEED, B, H, S, RATE, device="cuda")
    zeros = torch.zeros(B, H, S, D, device="cuda")
    lse = torch.full((B, H, S, 1), math.log(S), device="cuda")
    delta = torch.zeros(B, H, S, 1, device="cuda")
    got_fwd = torch.empty(B, H, S, S, dtype=torch.bool, device="cuda")
    got_bwd = torch.empty_like(got_fwd)
    for c in range(S // D):
        onehot = torch.zeros(B, H, S, D, device="cuda")
        onehot[:, :, c * D:(c + 1) * D, :] = torch.eye(D, device="cuda")
        o, _ = fa.flash_fwd_cuda(zeros, zeros, onehot, None, SEED, False, RATE)
        got_fwd[..., c * D:(c + 1) * D] = o > 0
        _, dv, _ = fa.flash_bwd_dkv_cuda(zeros, zeros, zeros, None, SEED, onehot, lse,
                                         delta, False, RATE)
        got_bwd[:, :, c * D:(c + 1) * D, :] = (dv > 0).transpose(-1, -2)
    torch.cuda.synchronize()
    check(torch.equal(got_fwd, want), "forward kernel keep mask differs from the plain mask")
    check(torch.equal(got_bwd, want), "dk/dv kernel keep mask differs from the plain mask")
    print(f"[kernels] keep mask exact in flash_fwd and flash_bwd_dkv "
          f"(rate {RATE}, seed {SEED:#x}, kept {want.float().mean().item():.4f})")


def _time_ms(fn, iters=50, warmup=5):
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


def _bounds(dtype, masked):
    """Least time (ms) for each kernel's work at the main-path shape: bytes
    it must move (inputs read once, outputs written once) over the memory
    rate, against its matrix-product FLOPs over the peak for its type."""
    import torch

    e = torch.finfo(dtype).bits // 8
    act = B * H * S * D * e  # one [B,H,S,D] tensor
    row = B * H * S * 4  # one f32 [B,H,S] row tensor (lse, delta, dmask)
    mask = B * S * e if masked else 0
    seed = 8
    work = {
        # q k v mask seed -> o lse; QK^T and PV
        "flash_fwd": (3 * act + mask + seed + act + row, 4 * B * H * S * S * D),
        # q k v dO lse delta mask seed -> dq; QK^T, dO V^T, dS K
        "flash_bwd_dq": (4 * act + 2 * row + mask + seed + act, 6 * B * H * S * S * D),
        # q k v dO lse delta mask seed -> dk dv dmask; QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkv": (4 * act + 2 * row + mask + seed + 2 * act + (row if masked else 0),
                          8 * B * H * S * S * D),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
    return out


def phase_timing():
    """Each kernel, its plain version and the library yardstick at the
    main-path conditions: bf16, padded mask, dropout 0.1, not causal."""
    import torch
    import torch.nn.functional as F

    from gradaccum_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16
    q, k, v, mask, do = _inputs(dtype, True, seed=1)
    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda")
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, False, RATE)
    delta = fa._delta(do, o)
    ms = {
        "flash_fwd": _time_ms(lambda: fa.flash_fwd_cuda(q, k, v, mask, seed, False, RATE)),
        "flash_bwd_dq": _time_ms(lambda: fa.flash_bwd_dq_cuda(
            q, k, v, mask, seed, do, lse, delta, False, RATE)),
        "flash_bwd_dkv": _time_ms(lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, mask, seed, do, lse, delta, False, RATE)),
    }
    # the plain backward computes dq, dk, dv and dmask in one pass: its time
    # stands beside both backward kernels
    plain_bwd = _time_ms(lambda: fa.flash_backward_reference(
        q, k, v, mask, seed, o, lse, do, False, RATE), iters=20)
    plain = {
        "flash_fwd": _time_ms(lambda: fa.flash_forward_reference(
            q, k, v, mask, seed, False, RATE), iters=20),
        "flash_bwd_dq": plain_bwd,
        "flash_bwd_dkv": plain_bwd,
    }
    library = {
        "flash_fwd": _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=RATE)),
        "flash_bwd_dq": None,
        "flash_bwd_dkv": None,
    }
    bounds = _bounds(dtype, True)
    for name in ms:
        lib_ms = library[name]
        print(f"[timing] {name}: {ms[name]:.4f} ms (plain {plain[name]:.4f} ms"
              + (f", sdpa {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f"; bound {bounds[name][0] * 1e3:.2f} us by {bounds[name][1]}: "
              f"{bounds[name][2] / 1e6:.2f} MB, {bounds[name][3] / 1e9:.3f} GFLOP)")
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

    k, layers = 4, 4
    model_dir = os.path.join(ROOT, "build", "chip_smoke_run")
    shutil.rmtree(model_dir, ignore_errors=True)  # a fresh run, not a resume
    argv = ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
            "--accum-k", str(k), "--max-steps", str(updates * k),
            "--model-dir", model_dir]
    fa.reset_launch_counts()
    result = bert_finetune.main(argv)
    counts = fa.launch_counts()
    check(math.isfinite(result["loss"]), f"main path loss is not finite: {result['loss']}")
    check(result["updates"] == updates, f"ran {result['updates']} updates, wanted {updates}")
    train = layers * k * updates
    want = {"flash_fwd": train + layers * result["eval_batches"],
            "flash_bwd_dq": train, "flash_bwd_dkv": train}
    check(counts == want, f"launch counts {counts} != {want} "
                          f"({layers} layers x K={k} x {updates} updates per kernel, "
                          f"+ {layers} forward per eval batch)")
    print(f"[main] BERT-Small bf16 micro 8 x K={k}, seq {S}: {updates} updates, "
          f"loss {result['loss']:.4f}, {result['seq/s']:.1f} seq/s, "
          f"mfu {result['mfu']:.4f}, eval accuracy {result['accuracy']:.4f}; "
          f"launches {counts}")
    return counts


def phase_profile(updates: int = 3):
    """Where the main path's time goes: a torch.profiler window over a few
    updates of the same run (after two warm-up updates). Reports wall time
    per update, the card's busy time per update (sum of kernel and copy
    time, one stream), its idle share, and the top kernels."""
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gradaccum_tpu_torch.examples import bert_finetune

    args = bert_finetune.build_parser().parse_args(
        ["--device", "cuda", "--bf16", "--vocab-size", "30522", "--seq-len", str(S),
         "--accum-k", "4", "--max-steps", "400"])
    est, train_fn, _, _ = bert_finetune.setup(args)
    it = iter(train_fn())
    est.train(itertools.islice(it, 2), final_save=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.train(itertools.islice(it, updates), final_save=False)
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
    print(f"[profile] {updates} updates: {per_update * 1e3:.2f} ms/update wall, "
          f"card busy {busy / updates * 1e3:.2f} ms/update "
          f"(idle share {1 - busy / wall:.3f}), {launches:.0f} kernels/update, "
          f"flash kernels {flash / updates * 1e3:.2f} ms/update")
    for key, t, count in sorted(kernels, key=lambda x: -x[1])[:8]:
        print(f"[profile]   {t / updates / 1e3:8.3f} ms/update  {count // updates:5d}x  {key[:90]}")


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


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
    try:
        phase_build()  # every other phase needs the kernels
        worst = phase_kernels()
        timing = phase_timing()
        phase_agree()
        counts = phase_main(UPDATES)
        phase_profile()
    except SmokeError as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")

    ms, plain, library, bounds = timing
    kernels = []
    for name in REPLACES:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": worst[(name, "torch.bfloat16")], "ms": ms[name],
            "plain_ms": plain[name], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": library[name]})
    print(_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
