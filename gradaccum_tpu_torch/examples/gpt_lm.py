"""Byte-level GPT language modeling on the card.

The port of the single-device path of ``examples/gpt_lm.py``: a GPT decoder
(vocab 256, H 128, L 4, A 4, dropout 0.1) on a deterministic synthetic
corpus of patterned sentences (or ``--text-file``), byte-tokenized and cut
into windows of ``--seq-len``, 90 % for training and 10 % for evaluation;
micro-batch ``--batch`` x K=``--accum-k`` accumulation, AdamW (weight decay
0.01) with linear warmup over a tenth of the run and polynomial decay, clip
1.0 after averaging; ``train_and_evaluate``, then next-token accuracy.

    python -m gradaccum_tpu_torch.examples.gpt_lm --flash --max-steps 200
    python -m gradaccum_tpu_torch.examples.gpt_lm --device cpu --max-steps 8 --flash

``--flash`` makes the hand-written causal flash kernels the attention core
(``causal_flash_attention``: the kernels cut the triangle, attention
dropout inside them); without it the dense core runs with a [S, S] causal
mask. ``--sample N`` then decodes N bytes greedily after a prompt of half a
window with ``models/gpt.py :: greedy_generate``, which re-runs the prefix
for every token (JAX's example decodes with the KV cache of
``gpt_decode.generate_cached``, part of the serving stack, not ported yet;
JAX's tests pin both to the same tokens). It runs on the card unless
``--device cpu`` is given and prints one JSON line.

``--dp N`` trains on N data-parallel ranks (``examples/common.py``), each
on ``--batch`` rows of every host batch of ``batch x N`` (x K in scan
mode); ``--zero1`` (needs ``--dp >= 2``) shards the Adam moments over them.
``--flash --dp`` runs (JAX refuses it only on the CPU, for its compiled
kernel; the port's CPU route is the plain version). ``--export-dir DIR``
writes the trained predict function and weights as a ``torch.export``
serving artifact, traced from one eval window. Not ported: ``--tp``
(ROADMAP.md).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gradaccum_tpu_torch.examples.common import (  # noqa: E402
    available_devices,
    example_argparser,
    in_rank,
    prepare_model_dir,
    rank_mesh,
    run_summary,
    spawn_ranks,
)

CORPUS_SEED = 19830610


def synthetic_corpus(n_chars: int, seed: int) -> str:
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["the", "cat", "sat", "on", "a", "mat", "dog", "runs", "fast",
             "birds", "fly", "high", "sun", "rises", "early"]
    parts = []
    total = 0
    while total < n_chars:
        s = " ".join(rng.choice(words, size=int(rng.integers(4, 9)))) + ". "
        parts.append(s)
        total += len(s)
    return "".join(parts)[:n_chars]


def build_parser():
    p = example_argparser("GPT char-LM (decoder-only causal model)", default_steps=200)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--batch", type=int, default=16, help="per-device micro-batch")
    p.add_argument("--accum-k", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--text-file", default=None, help="real corpus (else synthetic)")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--flash", action="store_true",
                   help="the causal flash kernels (the triangle cut inside them, "
                        "attention dropout inside them)")
    p.add_argument("--export-dir", default=None)
    p.add_argument("--sample", type=int, default=40,
                   help="greedy-decode this many bytes after training")
    return p


def windows_of(text: str, seq_len: int):
    """Byte tokens cut into ``seq_len`` windows: ``(train, eval)``, 90/10."""
    import numpy as np

    data = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)
    n_seq = len(data) // seq_len
    windows = data[:n_seq * seq_len].reshape(n_seq, seq_len)
    cut = max(1, int(0.9 * n_seq))
    return windows[:cut], windows[cut:]


def parse_args(argv=None):
    """Parse ``argv`` and refuse what JAX's example refuses."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.dp < 1:
        parser.error("--dp/--tp must be >= 1")
    if args.zero1 and args.dp < 2:
        parser.error("--zero1 needs --dp >= 2 (moments shard over 'data')")
    avail = available_devices(args.device)
    if args.dp > 1 and avail is not None and args.dp > avail:
        parser.error(f"mesh needs {args.dp} devices, have {avail}")
    return args


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.dp > 1 and not in_rank():
        return spawn_ranks("gradaccum_tpu_torch.examples.gpt_lm", argv, args.dp, args.device)
    with rank_mesh(args.dp, args.device, want_mesh=False) as mesh:
        return _main(args, mesh)


def _main(args, mesh) -> dict:
    import torch

    from gradaccum_tpu_torch.data.pipeline import Dataset
    from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle, greedy_generate
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import causal_flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay
    from gradaccum_tpu_torch.utils.platform import resolve_device, synchronize

    # no card and no --device cpu: raise; a rank runs on its mesh device
    device = mesh.device if mesh is not None else resolve_device(args.device)
    chief = mesh is None or mesh.rank == 0
    model_dir = prepare_model_dir(args, mesh)
    if args.text_file:
        text = Path(args.text_file).read_text(encoding="utf-8", errors="replace")
    else:
        text = synthetic_corpus(200_000, seed=CORPUS_SEED)
    s = args.seq_len
    train, evald = windows_of(text, s)

    cfg = GPTConfig(
        vocab_size=256, hidden_size=128, num_layers=4, num_heads=4,
        # sampling appends --sample tokens past the S//2 prompt: size the
        # position table for the longest sequence the run will see
        max_position_embeddings=max(64, s, s // 2 + args.sample),
        dropout=0.1,
    )
    if args.flash:
        bundle = gpt_lm_bundle(cfg, attention_fn=causal_flash_attention)
    else:
        bundle = gpt_lm_bundle(cfg)
    schedule = warmup_polynomial_decay(args.lr, num_train_steps=args.max_steps,
                                       num_warmup_steps=max(args.max_steps // 10, 1))
    est = Estimator(
        bundle,
        adamw(schedule, weight_decay_rate=0.01),
        GradAccumConfig(num_micro_batches=args.accum_k, clip_norm=1.0),
        RunConfig(model_dir=model_dir, log_step_count_steps=max(args.max_steps // 10, 1)),
        mode=args.mode,
        device=device,
        mesh=mesh,
        zero1=args.zero1,
    )
    if mesh is not None and chief:
        print(f"[mesh] {mesh.shape}")
    dp = mesh.world if mesh is not None else 1
    host_batch = args.batch * dp * (args.accum_k if args.mode == "scan" else 1)
    evaluations = []  # one entry per evaluation: each opens the eval input once

    def train_fn():
        return (Dataset.from_arrays({"input_ids": train})
                .shuffle(2 * args.batch + 1, seed=CORPUS_SEED)
                .repeat()
                .batch(host_batch, drop_remainder=True))

    def eval_fn():
        evaluations.append(1)
        return Dataset.from_arrays({"input_ids": evald}).batch(64)

    state, results = est.train_and_evaluate(TrainSpec(train_fn, max_steps=args.max_steps),
                                            EvalSpec(eval_fn, throttle_secs=60))
    if chief:
        print(f"gpt_lm: next-token accuracy {results['token_accuracy']:.4f}")
    out = dict(run_summary(est, state), flash=args.flash, seq_len=s,
               micro_batch=args.batch, accum_k=args.accum_k, dp=dp, zero1=args.zero1,
               token_accuracy=results["token_accuracy"],
               eval_batches=results["_num_batches"], evaluations=len(evaluations),
               sample_steps=args.sample)
    if args.sample > 0:
        prompt = torch.as_tensor(train[0][:s // 2])
        synchronize(device)
        t0 = time.perf_counter()
        ids = greedy_generate(est.module, prompt, args.sample)
        synchronize(device)
        dt = time.perf_counter() - t0
        sample = bytes(int(t) for t in ids[0].tolist()).decode("utf-8", "replace")
        if chief:
            print(f"sample: {sample!r}")
            print(f"decode: {args.sample / dt:.1f} tokens/sec (recompute: the whole "
                  f"prefix per token, prompt {len(prompt)} + {args.sample} steps)")
        out.update(sample=sample, decode_tokens_per_sec=args.sample / dt)
    if args.export_dir and chief:
        out["export"] = est.export_model(args.export_dir, {"input_ids": evald[:1]},
                                         state=state)
        print(f"exported serving artifact: {out['export']}")
    if chief:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
