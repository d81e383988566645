"""Long-context attention scaling: dense vs flash vs ring vs ulysses.

The port of ``examples/bench_longcontext.py``. It trains BERT-Small
(forward, backward and AdamW, bfloat16, dropout 0) one micro-batch per
step across sequence lengths, at a fixed number of tokens per step, with
four attention cores:

- ``dense``: the [S, S] materialized core, one process;
- ``flash``: the port's flash kernels (``ops/flash_attention.py``: K1 to
  K3 on the card; their plain versions on the CPU), one process;
- ``ring``: sequence-parallel blockwise attention over a ``seq`` axis,
  k and v passed round the ranks (``parallel/ring_attention.py``);
- ``ulysses``: the all-to-all head-parallel core (``parallel/ulysses.py``).

The sharded legs run on ``SEQ_RANKS`` (2) ranks spawned here
(``examples/common.py :: spawn_ranks``; ``python -m
gradaccum_tpu_torch.examples.bench_longcontext --sp-rank ...`` is one),
all of them on one spawn; on one card the ranks share it over gloo, so
their collectives are gloo's host round trips.

Each row: ms per step and tokens per second (the two-point difference of
``utils/timing.py :: time_device_steps`` over ``--iters`` steps after
three warm-up steps, the card synchronized), ``peak_temp_mb`` (on the
card: ``torch.cuda.max_memory_allocated`` during the timed steps above
what was allocated when they began, rank 0's for the sharded legs; on the
CPU: None), and for the flash leg the kernels' launches per step. A leg
that runs out of card memory is a row with ``error`` (data, as in JAX);
any other exception propagates.

Writes a CSV (``--out``) and prints one JSON line per row.

    python -m gradaccum_tpu_torch.examples.bench_longcontext --device cpu --seqs 64 \\
        --tokens 256
    python -m gradaccum_tpu_torch.examples.bench_longcontext --seqs 512 2048 8192
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SEQS = [512, 1024, 2048, 4096, 8192]
TOKENS_PER_STEP = 16384
VOCAB = 30522
CORES = ["dense", "flash", "ring", "ulysses"]
SP_CORES = ("ring", "ulysses")
SEQ_RANKS = 2  # ranks of the ``seq`` axis of the ring and ulysses legs
FIELDS = ["device", "seq", "core", "remat", "micro_batch", "ms_per_step", "tokens_per_sec",
          "peak_temp_mb", "iters", "launches_per_step", "error"]


def _example_text_batch(micro, seq):
    import numpy as np

    rng = np.random.default_rng(0)
    return {
        "input_ids": rng.integers(0, VOCAB, size=(micro, seq)).astype(np.int32),
        "input_mask": np.ones((micro, seq), np.int32),
        "segment_ids": np.zeros((micro, seq), np.int32),
        "label": rng.integers(0, 2, size=(micro,)).astype(np.int32),
    }


def _model_cfg(seq, remat):
    import torch

    from gradaccum_tpu_torch.models.bert import BertConfig

    return BertConfig.small(vocab_size=VOCAB, dtype=torch.bfloat16, remat=remat,
                            max_position_embeddings=max(512, seq),
                            hidden_dropout=0.0, attention_dropout=0.0)


def _timed_row(build_step, bundle, micro, seq, iters, device, label, core, remat):
    """Shared tail of every leg: the state, three warm-up steps, the timed
    steps and their peak memory; the row."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa
    from gradaccum_tpu_torch.ops.accumulation import scan_init, stack_micro_batches
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay
    from gradaccum_tpu_torch.utils.timing import time_device_steps
    from gradaccum_tpu_torch.utils.tree import named_parameters

    opt = adamw(warmup_polynomial_decay(2e-5, 10000, 1000), weight_decay_rate=0.01)
    model = bundle.init(0, device)
    step = build_step(lambda params, batch: bundle.loss(model, batch), opt)
    state = scan_init(named_parameters(model), opt)
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in _example_text_batch(micro, seq).items()}
    stacked = stack_micro_batches(batch, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for _ in range(3):
        state, aux = step(state, stacked, gen)
    float(aux["loss"])
    cuda = torch.device(device).type == "cuda"
    held = 0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    fa.reset_launch_counts()
    per_step, state = time_device_steps(step, state, (stacked, gen), iters)
    n_small = max(1, iters // 5)  # time_device_steps' second, shorter run
    steps = iters + (n_small if iters > n_small else 0)
    row = {"device": label, "seq": seq, "core": core, "remat": remat, "micro_batch": micro,
           "ms_per_step": per_step * 1e3, "tokens_per_sec": micro * seq / per_step,
           "peak_temp_mb": ((torch.cuda.max_memory_allocated(device) - held) / 2**20
                            if cuda else None),
           "iters": iters}
    if core == "flash" and cuda:
        row["launches_per_step"] = {k: v / steps for k, v in fa.launch_counts().items()}
    del state, model
    if cuda:
        torch.cuda.empty_cache()
    return row


def _device_label(device, ranks=1):
    import torch

    from gradaccum_tpu_torch.utils.platform import device_name

    name = device_name(torch.device(device))
    return name if ranks == 1 else f"{name} x{ranks} ranks"


def measure_one(seq, core, remat, iters, tokens_per_step, device):
    """A one-process leg (dense or flash)."""
    from gradaccum_tpu_torch.models.bert import bert_classifier_bundle, dense_attention
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig, accumulate_scan
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention

    micro = max(1, tokens_per_step // seq)
    attention_fn = flash_attention if core == "flash" else dense_attention
    bundle = bert_classifier_bundle(_model_cfg(seq, remat), num_classes=2,
                                    attention_fn=attention_fn)

    def build(loss_fn, opt):
        return accumulate_scan(loss_fn, opt, GradAccumConfig(num_micro_batches=1),
                               needs_rng=True)

    return _timed_row(build, bundle, micro, seq, iters, device, _device_label(device),
                      core, remat)


def measure_sp(seq, core, iters, tokens_per_step, mesh):
    """A sequence-parallel leg on this rank of a (data=1, seq=N) mesh."""
    from gradaccum_tpu_torch.models.bert import bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.parallel.ring_attention import make_ring_attention_fn
    from gradaccum_tpu_torch.parallel.sp import make_dp_sp_train_step
    from gradaccum_tpu_torch.parallel.ulysses import make_ulysses_attention_fn

    n = mesh.shape["seq"]
    if seq % n:
        raise ValueError(f"seq {seq} not divisible by {n} seq ranks")
    micro = max(1, tokens_per_step // seq)
    attention_fn = (make_ulysses_attention_fn("seq") if core == "ulysses"
                    else make_ring_attention_fn("seq"))
    bundle = bert_classifier_bundle(_model_cfg(seq, False), num_classes=2,
                                    attention_fn=attention_fn, seq_axis="seq")

    def build(loss_fn, opt):
        return make_dp_sp_train_step(loss_fn, opt, GradAccumConfig(num_micro_batches=1),
                                     mesh, needs_rng=True)

    return _timed_row(build, bundle, micro, seq, iters, mesh.device,
                      _device_label(mesh.device, n), core, False)


def _oom_row(seq, core, remat, micro, error):
    return {"device": None, "seq": seq, "core": core, "remat": remat, "micro_batch": micro,
            "ms_per_step": None, "tokens_per_sec": None, "error": type(error).__name__}


def sp_rank(argv) -> int:
    """One rank of the sharded legs: every (seq, core) pair of ``argv``;
    rank 0 prints each row as a JSON line and then ``{"ok": true}``."""
    import torch

    from gradaccum_tpu_torch.examples.common import DP_TIMEOUT_S
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    args = build_parser().parse_args(argv)
    world = int(os.environ["WORLD_SIZE"])
    device = "cuda:0" if args.device.startswith("cuda") else "cpu"
    mesh_lib.initialize_multihost(device=device, backend="gloo", timeout_s=DP_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_mesh(data=1, seq=world)
        for seq in args.seqs:
            for core in [c for c in args.cores if c in SP_CORES]:
                try:
                    row = measure_sp(seq, core, args.iters, args.tokens, mesh)
                except torch.cuda.OutOfMemoryError as e:  # data, as in JAX
                    row = _oom_row(seq, core, False, max(1, args.tokens // seq), e)
                if mesh.rank == 0:
                    print(json.dumps(row), flush=True)
        mesh.barrier()
    finally:
        mesh_lib.shutdown()
    if mesh.rank == 0:
        print(json.dumps({"ok": True}), flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="long-context attention scaling on BERT-Small")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[2] / "build"
                                         / "longcontext.csv"))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seqs", type=int, nargs="*", default=SEQS)
    ap.add_argument("--tokens", type=int, default=TOKENS_PER_STEP,
                    help="tokens per step (micro_batch = tokens // seq)")
    ap.add_argument("--remat-legs", choices=["auto", "none"], default="auto",
                    help="'auto' adds remat=True legs at the two longest lengths; "
                         "'none' skips them")
    ap.add_argument("--cores", nargs="*", default=CORES, choices=CORES,
                    help="which attention cores to measure")
    ap.add_argument("--append", action="store_true",
                    help="merge into an existing --out instead of overwriting: rows whose "
                         "(seq, core, remat) is re-measured are replaced, others kept")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def _sp_rows(args, argv):
    """Every sharded leg, on one spawn of ``SEQ_RANKS`` ranks."""
    from gradaccum_tpu_torch.examples.common import spawn_ranks

    lines = []
    spawn_ranks("gradaccum_tpu_torch.examples.bench_longcontext", ["--sp-rank", *argv],
                SEQ_RANKS, args.device, output=lines)
    return [json.loads(line) for line in lines if line.startswith("{") and '"seq"' in line]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--sp-rank"]:
        return sp_rank(argv[1:])
    args = build_parser().parse_args(argv)

    import torch

    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu: raises
    print(f"[longctx] device: {_device_label(device)}", file=sys.stderr)
    rows = []
    # remat matters once activations dominate memory: the two longest lengths
    remat_cutoff = sorted(args.seqs)[-2] if len(args.seqs) > 1 else args.seqs[0]
    if args.remat_legs == "none":
        remat_cutoff = float("inf")
    for seq in args.seqs:
        for core in [c for c in args.cores if c not in SP_CORES]:
            for remat in [False, True] if seq >= remat_cutoff else [False]:
                try:
                    row = measure_one(seq, core, remat, args.iters, args.tokens, device)
                except torch.cuda.OutOfMemoryError as e:  # data, as in JAX
                    row = _oom_row(seq, core, remat, max(1, args.tokens // seq), e)
                    print(f"[longctx] seq={seq} core={core} remat={remat}: "
                          f"{type(e).__name__}: {str(e)[:200]}", file=sys.stderr)
                rows.append(row)
                print(json.dumps(row), flush=True)
    if any(c in SP_CORES for c in args.cores):
        rows += _sp_rows(args, argv)  # rank 0 printed them

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.append and out.exists():
        fresh = {(str(r["seq"]), r["core"], str(r.get("remat"))) for r in rows}
        with open(out, newline="") as f:
            kept = [r for r in csv.DictReader(f)
                    if (r["seq"], r["core"], r["remat"]) not in fresh]
        rows = kept + rows
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k) for k in FIELDS})
    print(f"[longctx] wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
