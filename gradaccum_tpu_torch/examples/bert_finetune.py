"""BERT-Small fine-tuning on the card: the port's flagship entry point.

The port of the single-device ``--flash`` path of
``examples/bert_finetune.py``: BERT-Small (L-4 H-512 A-8) on the synthetic
CoLA-shaped sentence task, micro-batch 8 x K=4 gradient accumulation, lr
2e-5 with linear warmup and polynomial decay keyed to the micro-batch count,
clip 1.0 after averaging, AdamW with decay excluded from LayerNorm and
biases, and the hand-written flash-attention kernels as the attention core
(attention dropout 0.1 inside the kernels).

    python -m gradaccum_tpu_torch.examples.bert_finetune --bf16 --max-steps 400

``--mode scan`` (the default, as in JAX's example) runs K micro-batches per
host step; ``--mode streaming`` runs the reference's ``tf.cond`` train op,
one micro-batch per host step, with the first-step quirk. It runs on the
card unless ``--device cpu`` is given, and prints one JSON line with
throughput (``seq/s``, over every host step after the first) and ``mfu``
against the card's bf16 peak.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

TASKS = {
    # per-device micro-batch, K, synthetic corpus sizes
    "cola": dict(batch=8, k=4, num_train=2048, num_eval=512),
}


def synthetic_text_task(num_examples: int, seed: int):
    """Label-correlated synthetic sentences (a zero-egress CoLA stand-in)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    good = ["the cat sat on the mat", "a dog runs fast", "birds fly high",
            "she reads a good book", "the sun rises early"]
    bad = ["mat the on sat cat the", "fast runs dog a", "high fly birds",
           "book good a reads she", "early rises sun the"]
    texts, labels = [], []
    for _ in range(num_examples):
        label = int(rng.integers(0, 2))
        pool = good if label else bad
        texts.append(" ".join(rng.choice(pool, size=int(rng.integers(1, 4)))))
        labels.append(label)
    return texts, np.asarray(labels, np.int32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BERT-Small fine-tune on the card (CoLA shapes)")
    p.add_argument("--task", choices=sorted(TASKS), default="cola")
    p.add_argument("--max-steps", type=int, default=400,
                   help="training length in micro-batches (the reference's global_step)")
    p.add_argument("--accum-k", type=int, default=None,
                   help="override the task's accumulation multiplier K")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--warmup-frac", type=float, default=0.1)
    p.add_argument("--vocab-size", type=int, default=None,
                   help="embedding rows (default: the corpus vocab, at least 128; "
                        "30522 is BERT's uncased vocab)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--mode", choices=["scan", "streaming"], default="scan",
                   help="K micro-batches per host step (scan) or one (streaming, "
                        "the reference's tf.cond train op with its first-step quirk)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--model-dir", default=None,
                   help="checkpoint directory (resumes from its newest checkpoint)")
    return p


def setup(args):
    """The run ``args`` describe, ready to train: ``(estimator, train_fn,
    eval_fn, config)``. Raises without a card unless ``--device cpu``."""
    import torch

    from gradaccum_tpu_torch.data.pipeline import Dataset
    from gradaccum_tpu_torch.data.tokenization import build_vocab
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay
    from gradaccum_tpu_torch.utils.flops import bert_train_flops_per_seq
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu: raise
    t = TASKS[args.task]
    train_texts, train_labels = synthetic_text_task(t["num_train"], seed=1)
    eval_texts, eval_labels = synthetic_text_task(t["num_eval"], seed=2)
    tok = build_vocab(train_texts)
    train = dict(tok.encode_batch(train_texts, max_seq_length=args.seq_len),
                 label=train_labels)
    evald = dict(tok.encode_batch(eval_texts, max_seq_length=args.seq_len),
                 label=eval_labels)

    micro = t["batch"]
    k = args.accum_k if args.accum_k is not None else t["k"]
    cfg = BertConfig.small(
        vocab_size=args.vocab_size or max(len(tok.vocab), 128),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        max_position_embeddings=max(512, args.seq_len),
    )
    schedule = warmup_polynomial_decay(
        args.lr, num_train_steps=args.max_steps,
        num_warmup_steps=int(args.max_steps * args.warmup_frac))
    est = Estimator(
        bert_classifier_bundle(cfg, num_classes=2, attention_fn=flash_attention),
        adamw(schedule, weight_decay_rate=0.01),
        # the first-step quirk is a streaming-mode semantic; say False on the
        # scan path so the config states what runs
        GradAccumConfig(num_micro_batches=k, clip_norm=1.0,
                        first_step_quirk=(args.mode == "streaming")),
        RunConfig(model_dir=args.model_dir,
                  log_step_count_steps=max(args.max_steps // 20, 1),
                  flops_per_example=bert_train_flops_per_seq(
                      cfg.hidden_size, cfg.num_layers, cfg.intermediate_size,
                      args.seq_len, 2)),
        mode=args.mode,
        device=device,
    )
    host_batch = micro * (k if args.mode == "scan" else 1)

    def train_fn():
        return (Dataset.from_arrays(train)
                .shuffle(2 * micro + 1, seed=19830610)
                .repeat()
                .batch(host_batch, drop_remainder=True)
                .prefetch(2))

    def eval_fn():
        return Dataset.from_arrays(evald).batch(64)

    return est, train_fn, eval_fn, cfg


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from gradaccum_tpu_torch.estimator.config import EvalSpec, TrainSpec
    from gradaccum_tpu_torch.utils.platform import device_name

    est, train_fn, eval_fn, cfg = setup(args)
    k = est.accum.num_micro_batches
    evaluations = []  # one entry per evaluation: each opens the eval input once

    def counted_eval_fn():
        evaluations.append(1)
        return eval_fn()

    state, results = est.train_and_evaluate(
        TrainSpec(train_fn, max_steps=args.max_steps),
        EvalSpec(counted_eval_fn, throttle_secs=60),
    )
    seq_per_sec = est.examples_per_sec()
    out = {
        "task": args.task, "mode": args.mode, "device": device_name(est.device),
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "micro_batch": TASKS[args.task]["batch"],
        "accum_k": k, "seq_len": args.seq_len, "vocab_size": cfg.vocab_size,
        "updates": state.step // k, "timed_host_steps": est.train_stats["host_steps"],
        "loss": float(est.last_loss), "accuracy": results["accuracy"],
        "eval_batches": results["_num_batches"], "evaluations": len(evaluations),
        "seq/s": seq_per_sec, "mfu": est.mfu(),
    }
    if args.mode == "streaming":
        out["apply_steps"] = est.apply_steps
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
