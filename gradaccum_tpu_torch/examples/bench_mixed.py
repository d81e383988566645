"""Memory and step time across the mixed-precision ladder.

The port of ``tools/bench_mixed.py``: JAX's four training configurations of
its tiny GPT (vocab 512, H 128, L 2, A 4, FFN 256, 64 positions; K=4 scan
of micro-batch 8), measured for (a) per-replica optimizer-state +
gradient-accumulator bytes per parameter and (b) the median wall time of a
scan step:

- ``f32``: f32 params, AdamW moments, one f32 gradient accumulator
  (m + v + accum = 12 B/param);
- ``bf16+master``: bf16 params, f32 masters in the optimizer state
  (m + v + master + accum = 16 B/param);
- ``bf16+fused``: fused Adam-accumulation, no accumulator (12 B/param);
- ``bf16+fused+zero1``: the same on a data mesh of two gloo ranks, the
  optimizer state sharded (6 B/param per replica).

Memory is read from the real train state the ``Estimator`` holds on a rank
(each rank of the ZeRO-1 leg holds its block of every sharded leaf), plus
JAX's accumulator term: one f32 tree for the two-pass legs, none when
fused. The acceptance is JAX's: >= 1.8x lower bytes/param for
bf16+fused+zero1 than for f32, every leg's loss falling.

Usage: python -m gradaccum_tpu_torch.examples.bench_mixed [--out FILE]
[--steps N] [--device cpu]. It runs on the card unless ``--device cpu``
(the ZeRO-1 leg's two ranks share the card over gloo) and writes the
artifact only to ``--out``. ``--zero1-rank`` is one rank of that leg.
"""

import argparse
import json
import sys
import time

K = 4
MICRO = 8
SEQ = 64
SEED = 20260803
GATE = 1.8
LEGS = [
    ("f32", dict()),
    ("bf16+master", dict(bf16=True)),
    ("bf16+fused", dict(bf16=True, fused=True)),
    ("bf16+fused+zero1", dict(bf16=True, fused=True, zero1=True)),
]


def _gpt_cfg():
    from gradaccum_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256, max_position_embeddings=SEQ, dropout=0.0)


def _batches(seed: int, leg: int):
    """JAX's draws: one ``[K * MICRO, SEQ]`` batch per leg from one stream."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for _ in range(leg + 1):
        ids = rng.integers(0, 512, size=(K * MICRO, SEQ)).astype(np.int32)
    return {"input_ids": ids}


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` as this rank holds it."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "q") and hasattr(tree, "scale"):  # a q8 tensor
        return _tensor_bytes(tree.q) + _tensor_bytes(tree.scale)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def run_config(name, steps, bf16=False, fused=False, zero1=False, device="cuda", mesh=None,
               seed=SEED, leg=0):
    """One leg on this process (a rank of ``mesh`` for ZeRO-1): its bytes
    per parameter, median step time and losses, as JAX's ``run_config``."""
    import numpy as np
    import torch

    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.gpt import gpt_lm_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw

    dtype = torch.bfloat16 if bf16 else None
    bundle = gpt_lm_bundle(_gpt_cfg(), compute_dtype=dtype)
    opt = adamw(1e-3, weight_decay_rate=0.01, master_dtype=torch.float32 if bf16 else None)
    est = Estimator(bundle, opt, GradAccumConfig(K, fused_adam=fused),
                    RunConfig(log_step_count_steps=10_000, save_checkpoints_steps=None),
                    mode="scan", device=device, mesh=mesh, zero1=zero1)
    batch = _batches(seed, leg)
    times = []
    sync = torch.cuda.synchronize if str(est.device).startswith("cuda") else (lambda: None)
    state = est.train([batch], final_save=False)  # step 1
    first_loss = float(est.last_loss)
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        state = est.train([batch], final_save=False)
        sync()
        times.append(time.perf_counter() - t0)
    n_params = sum(p.numel() for p in state.params.values())
    opt_bytes = _tensor_bytes(state.opt_state)
    accum_bytes = 0 if fused else 4 * n_params
    param_bytes = _tensor_bytes(state.params)
    return {
        "first_loss": round(first_loss, 5),
        "config": name,
        "n_params": int(n_params),
        "param_bytes_per_param": round(param_bytes / n_params, 4),
        "optimizer_bytes_per_param": round(opt_bytes / n_params, 4),
        "accumulator_bytes_per_param": round(accum_bytes / n_params, 4),
        "opt_plus_accum_bytes_per_param": round((opt_bytes + accum_bytes) / n_params, 4),
        "step_time_ms_median": round(1e3 * float(np.median(times)), 2) if times else None,
        "final_loss": round(float(est.last_loss), 5),
    }


def _zero1_rank(steps: int, device: str) -> None:
    """One rank of the ZeRO-1 leg (``--zero1-rank``): rank 0 prints the row."""
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    dev = "cuda:0" if device.startswith("cuda") else "cpu"  # the ranks share one card
    mesh_lib.initialize_multihost(device=dev, backend="gloo", timeout_s=300)
    try:
        mesh = mesh_lib.data_parallel_mesh()
        name, kw = LEGS[-1]
        row = run_config(name, steps, device=dev, mesh=mesh, leg=len(LEGS) - 1, **kw)
        rank = mesh.rank
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps(row))


def zero1_row(steps: int, device: str) -> dict:
    """The ZeRO-1 leg on two spawned gloo ranks: rank 0's row."""
    from gradaccum_tpu_torch.examples.common import spawn_ranks

    return spawn_ranks("gradaccum_tpu_torch.examples.bench_mixed",
                       ["--zero1-rank", "--steps", str(steps), "--device", str(device)],
                       2, str(device), deadline_s=600)


def run(steps: int = 16, device="cuda", log=print) -> dict:
    """Every leg (the last on two ranks); returns the artifact."""
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    rows = []
    for leg, (name, kw) in enumerate(LEGS):
        if kw.get("zero1"):
            row = zero1_row(steps, device.type)
        else:
            row = run_config(name, steps, device=device, leg=leg, **kw)
        rows.append(row)
        log(f"[{row['config']:>17}] opt+accum {row['opt_plus_accum_bytes_per_param']:5.2f} "
            f"B/param  params {row['param_bytes_per_param']:4.2f} B/param  "
            f"step {row['step_time_ms_median']} ms  loss {row['final_loss']}")
    base = rows[0]["opt_plus_accum_bytes_per_param"]
    reduction = base / rows[-1]["opt_plus_accum_bytes_per_param"]
    all_train = all(r["final_loss"] < r["first_loss"] for r in rows)
    passed = reduction >= GATE and all_train
    log(f"[mixed] reduction {reduction:.2f}x ({'PASS' if passed else 'FAIL'})")
    return {
        "bench": f"mixed-precision memory ladder (tiny GPT, K=4 scan, 2 gloo ranks for "
                 f"zero1, {device.type})",
        "headline": f"{reduction:.2f}x lower per-replica optimizer+accumulator bytes/param "
                    "(bf16+fused+zero1 vs f32 two-pass)",
        "device": str(device),
        "rows": rows,
        "reduction_vs_f32": round(reduction, 3),
        "all_legs_train": bool(all_train),
        "acceptance": {
            "required": f">={GATE}x reduction in per-replica optimizer+accumulator "
                        "bytes/param for bf16+fused+zero1 (2 replicas) vs the f32 baseline, "
                        "every leg's loss decreasing over the run",
            "measured": round(reduction, 3),
            "passed": bool(passed),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="artifact path (none written without it)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--zero1-rank", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.zero1_rank:
        _zero1_rank(args.steps, args.device)
        return 0
    result = run(args.steps, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0 if result["acceptance"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
