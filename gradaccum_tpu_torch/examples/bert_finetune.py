"""BERT-Small fine-tuning on the card: the port's flagship entry point.

The port of the single-device ``--flash`` path of
``examples/bert_finetune.py``: BERT-Small (L-4 H-512 A-8) on a
CoLA/Yelp-shaped sentence task, micro-batch 8 x K=4 gradient accumulation,
lr 2e-5 with linear warmup and polynomial decay keyed to the micro-batch
count, clip 1.0 after averaging, AdamW with decay excluded from LayerNorm
and biases, and the hand-written flash-attention kernels as the attention
core (attention dropout 0.1 inside the kernels).

    python -m gradaccum_tpu_torch.examples.bert_finetune --bf16 --max-steps 400
    python -m gradaccum_tpu_torch.examples.bert_finetune \\
        --hf-checkpoint DIR --data-dir DIR --bf16      # the reference's chain

``--hf-checkpoint`` warm-starts from a saved HuggingFace BERT directory
(``models/bert_checkpoint.py``; its ``vocab.txt`` unless ``--vocab``);
``--data-dir`` reads ``train.tsv``/``dev.tsv`` (``label<TAB>...<TAB>text``),
else a synthetic corpus with the task's shapes is generated; ``--full``
sizes the run to the reference's 3 epochs (``--quick`` then trains only 40
micro-steps of that schedule). ``--remat``, ``--sparse-embed-grad`` and
``--num-experts``/``--moe-top-k`` are the JAX example's model and
accumulator options. ``--model-dir`` is emptied first unless ``--resume``.

``--mode scan`` (the default, as in JAX's example) runs K micro-batches per
host step; ``--mode streaming`` runs the reference's ``tf.cond`` train op,
one micro-batch per host step, with the first-step quirk. It runs on the
card unless ``--device cpu`` is given, and prints one JSON line with
throughput (``seq/s``, over every host step after the first) and ``mfu``
against the card's bf16 peak.

``--dp N`` trains on N data-parallel ranks (``examples/common.py``: spawned
here, or by ``torchrun --nproc-per-node N``), each on its own ``micro``
rows of every host batch of ``micro x N`` (x K in scan mode), through the
explicit DP step: one all-reduce per update in scan mode. ``--zero1`` (needs
``--dp >= 2``) shards the Adam moments over the ranks (``zero1=True``, the
placement path). JAX's ``--flash --dp`` refusal comes from the CPU's missing
compiled kernel; the port's CPU route is the kernels' plain version, so it
runs.

``--tp N`` and ``--ep N`` add the ``model`` and ``expert`` axes (a
data x model [x expert] mesh of ``--dp x --tp x --ep`` ranks, the
launcher's) with JAX's rules: ``bert_tp_rules`` for ``--tp``,
``moe_ep_rules`` for ``--ep`` (data x expert), ``bert_tp_ep_rules`` for
both. Each rank attends its own heads through the flash kernels: JAX
refuses ``--flash --tp`` because GSPMD cannot partition a Pallas call, and
the port issues the collectives itself.

``--sp N`` trains sequence-parallel over a ``seq`` axis (a data x seq mesh
of ``--dp x --sp`` ranks): each rank holds ``--seq-len / N`` tokens of
every sequence and attends through ``--sp-core`` (``ring``: k and v pass
round the ranks; ``ulysses``: an all-to-all to whole sequences of
``heads / N`` heads); evaluation runs the dense twin. ``--pp N`` runs the
GPipe schedule over a ``pipe`` axis (pipe x data, ``--pp x --dp`` ranks),
``L / N`` encoder layers per stage, the K micro-batches as the pipeline's.
Both set dropout to 0 and attend with the plain dense core in their
stages and evaluations, as JAX's example does (it refuses ``--flash``
there).

``--export-dir DIR`` writes the trained predict function and weights as a
``torch.export`` serving artifact after training (its flash forward is the
operator ``gradaccum::flash_fwd``, the kernel on the card); reload it
without the model code with ``estimator/export.py :: load_exported``.
``--export-best-dir DIR`` refreshes such an artifact at every evaluation
that improves the accuracy (BestExporter, ``best_metric.json`` beside it).

    python -m gradaccum_tpu_torch.examples.bert_finetune --device cpu --dp 2 \
        --max-steps 8 --seq-len 32 --accum-k 2
    python -m gradaccum_tpu_torch.examples.bert_finetune --device cpu --tp 2 --ep 2 \
        --num-experts 4 --max-steps 8 --seq-len 32 --accum-k 2
    python -m gradaccum_tpu_torch.examples.bert_finetune --device cpu --sp 2 \
        --sp-core ulysses --max-steps 4 --seq-len 32 --accum-k 2
    python -m gradaccum_tpu_torch.examples.bert_finetune --device cpu --pp 2 \
        --max-steps 4 --seq-len 32 --accum-k 2
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gradaccum_tpu_torch.examples.common import (  # noqa: E402
    available_devices,
    in_rank,
    prepare_model_dir,
    rank_mesh,
    spawn_ranks,
)

TASKS = {
    # per-device micro-batch, K, synthetic corpus sizes; full_train/full_eval
    # = the reference's Yelp-polarity corpus after its 0.99/0.01 split, so
    # --task yelp --full gives the published 554,400 x 3 / 8 = 207,900 steps
    "cola": dict(batch=8, k=4, num_train=2048, num_eval=512),
    "yelp": dict(batch=8, k=4, num_train=8192, num_eval=1024,
                 full_train=554_400, full_eval=5_600),
}
QUICK_STEPS = 40  # --full --quick: micro-steps actually trained
FLIP_SEED = 19830610  # --label-noise flips


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


def load_tsv(path):
    """``label<TAB>...<TAB>text`` rows. A row that does not parse (too few
    columns, a label that is not an integer) is skipped, and a warning
    counts them; a file with no valid row raises."""
    import numpy as np

    texts, labels = [], []
    skipped = 0
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                skipped += 1
                continue
            try:
                label = int(parts[0])
            except ValueError:
                skipped += 1
                continue
            labels.append(label)
            texts.append(parts[-1])
    if skipped:
        print(f"[warn] {path}: skipped {skipped} malformed row(s) ({len(texts)} kept)",
              file=sys.stderr)
    if not texts:
        raise ValueError(f"{path}: no parseable 'label<TAB>text' rows")
    return texts, np.asarray(labels, np.int32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BERT-Small fine-tune on the card (CoLA/Yelp shapes)")
    p.add_argument("--task", choices=sorted(TASKS), default="cola")
    p.add_argument("--max-steps", type=int, default=400,
                   help="training length in micro-batches (the reference's global_step)")
    p.add_argument("--accum-k", type=int, default=None,
                   help="override the task's accumulation multiplier K")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--warmup-frac", type=float, default=0.1)
    p.add_argument("--vocab-size", type=int, default=None,
                   help="embedding rows (default: the vocab's size, at least 128; "
                        "30522 is BERT's uncased vocab)")
    p.add_argument("--vocab", default=None, help="vocab.txt (else built from the corpus)")
    p.add_argument("--hf-checkpoint", default=None,
                   help="saved HuggingFace BERT model directory: fine-tune from its "
                        "weights (vocab from its vocab.txt unless --vocab)")
    p.add_argument("--data-dir", default=None,
                   help="directory with train.tsv and dev.tsv (else synthetic data)")
    p.add_argument("--full", action="store_true",
                   help="reference scale: 3 epochs over the corpus (synthetic data is "
                        "sized to the task's full corpus)")
    p.add_argument("--quick", action="store_true",
                   help=f"with --full: train only {QUICK_STEPS} micro-steps of the full "
                        "run's schedule")
    p.add_argument("--train-size", type=int, default=None,
                   help="override the synthetic training corpus size")
    p.add_argument("--label-noise", type=float, default=0.0,
                   help="flip this fraction of the training labels (fixed seed)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--remat", action="store_true",
                   help="recompute each encoder layer's activations in the backward")
    p.add_argument("--sparse-embed-grad", action="store_true",
                   help="accumulate the word-embedding gradient as token rows, one "
                        "scatter-add per update (ops/sparse_embed.py); --mode scan only")
    p.add_argument("--num-experts", type=int, default=0,
                   help="replace each FFN with a routed expert bank (0 = dense)")
    p.add_argument("--moe-top-k", type=int, default=1,
                   help="experts per token: 1 = Switch routing, 2 = GShard top-2")
    p.add_argument("--mode", choices=["scan", "streaming"], default="scan",
                   help="K micro-batches per host step (scan) or one (streaming, "
                        "the reference's tf.cond train op with its first-step quirk)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks (the reference's worker count, 03:76)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: shard QKV/FFN kernels and the vocab "
                        "embedding over a 'model' axis (bert_tp_rules)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel width: shard the MoE expert bank over an "
                        "'expert' axis (moe_ep_rules; requires --num-experts)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel width: shard the token dim over a 'seq' axis "
                        "(long-context training; composes with --dp, forces dropout=0, "
                        "excludes --tp/--ep)")
    p.add_argument("--sp-core", choices=["ring", "ulysses"], default="ring",
                   help="sequence-parallel attention layout: ring (ppermute K/V hops) or "
                        "ulysses (all_to_all seq<->heads repartition)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages: GPipe over a 'pipe' axis, the K "
                        "accumulation micro-batches doubling as pipeline micro-batches "
                        "(composes with --dp; forces dropout=0, excludes --tp/--ep/--sp)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the Adam moments over the data ranks "
                        "(optimizer memory per rank / dp; needs --dp >= 2, composes "
                        "with --tp/--ep)")
    p.add_argument("--export-dir", default=None,
                   help="after training, write predict + weights to this dir as a "
                        "torch.export serving artifact (estimator/export.py)")
    p.add_argument("--export-best-dir", default=None,
                   help="BestExporter slot: every improving eval during training "
                        "refreshes a serving export here (best accuracy)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--model-dir", default=None,
                   help="checkpoint directory with loss_vs_step.csv, emptied first "
                        "unless --resume")
    p.add_argument("--resume", action="store_true",
                   help="keep --model-dir and resume from its newest checkpoint")
    return p


def parse_args(argv=None):
    """Parse ``argv`` and refuse the combinations JAX's example refuses."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.quick and not args.full:
        parser.error("--quick is a modifier of --full (it smoke-tests the full-preset "
                     "wiring); without --full just lower --max-steps")
    if args.hf_checkpoint and args.num_experts:
        parser.error("--num-experts cannot combine with --hf-checkpoint (pretrained "
                     "dense FFN weights have no expert bank)")
    if args.hf_checkpoint and args.vocab_size:
        parser.error("--vocab-size cannot combine with --hf-checkpoint (the checkpoint "
                     "fixes the vocab size)")
    if min(args.dp, args.tp, args.ep, args.sp, args.pp) < 1:
        parser.error("--dp/--tp/--ep/--sp/--pp must be >= 1")
    if args.ep > 1 and (args.num_experts == 0 or args.num_experts % args.ep):
        parser.error("--ep requires --num-experts divisible by it")
    if args.moe_top_k < 1 or (args.num_experts and args.moe_top_k > args.num_experts):
        parser.error("--moe-top-k must be in [1, --num-experts]")
    if args.moe_top_k > 1 and args.num_experts == 0:
        parser.error("--moe-top-k needs --num-experts")
    if args.sp > 1 and (args.tp > 1 or args.ep > 1):
        parser.error("--sp composes with --dp only (shard_map path)")
    if args.sp > 1 and args.mode != "scan":
        parser.error("--sp requires --mode scan")
    if args.sp > 1 and args.seq_len % args.sp:
        parser.error(f"--seq-len {args.seq_len} not divisible by --sp {args.sp}")
    if args.pp > 1 and (args.tp > 1 or args.ep > 1 or args.sp > 1):
        parser.error("--pp composes with --dp only")
    if args.pp > 1 and args.mode != "scan":
        parser.error("--pp requires --mode scan")
    if args.pp > 1 and not args.hf_checkpoint:
        layers = _small_layers()  # a checkpoint's depth is checked once it is read
        if layers % args.pp:
            parser.error(f"{layers} layers do not split over --pp {args.pp}")
    if args.zero1 and args.dp < 2:
        parser.error("--zero1 needs --dp >= 2 (moments shard over 'data')")
    if args.zero1 and (args.sp > 1 or args.pp > 1):
        parser.error("--zero1 runs on the GSPMD path (no --sp/--pp)")
    if args.sparse_embed_grad:
        if args.mode != "scan":
            parser.error("--sparse-embed-grad requires --mode scan")
        if args.sp > 1 or args.pp > 1:
            parser.error("--sparse-embed-grad composes with scan/dp/tp/ep, not --sp/--pp")
    avail = available_devices(args.device)
    n_mesh = world_size(args)
    if n_mesh > 1 and avail is not None and n_mesh > avail:
        parser.error(f"mesh needs {n_mesh} devices, have {avail}")
    return args


def _small_layers() -> int:
    from gradaccum_tpu_torch.models.bert import BertConfig

    return BertConfig.small().num_layers


def world_size(args) -> int:
    """The ranks the run takes: the product of the mesh's axes."""
    return args.dp * args.tp * args.ep * args.sp * args.pp


def mesh_axes(args):
    """``(axes, rules)`` of the run's mesh, as JAX's example picks them:
    pipe x data for ``--pp``, data x seq for ``--sp``, data x model x expert
    with ``bert_tp_ep_rules``, data x model with ``bert_tp_rules``, data x
    expert with ``moe_ep_rules``; None and None for the data-parallel (or
    single-rank) run."""
    from gradaccum_tpu_torch.models.moe import moe_ep_rules
    from gradaccum_tpu_torch.parallel.tp import bert_tp_ep_rules, bert_tp_rules

    if args.pp > 1:
        return [("pipe", args.pp), ("data", args.dp)], None
    if args.sp > 1:
        return [("data", args.dp), ("seq", args.sp)], None
    if args.tp > 1 and args.ep > 1:
        return [("data", args.dp), ("model", args.tp), ("expert", args.ep)], bert_tp_ep_rules()
    if args.tp > 1:
        return [("data", args.dp), ("model", args.tp)], bert_tp_rules()
    if args.ep > 1:
        return [("data", args.dp), ("expert", args.ep)], moe_ep_rules()
    return None, None


def _load_data(args, t):
    """``(train_texts, train_labels, eval_texts, eval_labels)``."""
    import numpy as np

    if args.data_dir:
        train_texts, train_labels = load_tsv(str(Path(args.data_dir) / "train.tsv"))
        eval_texts, eval_labels = load_tsv(str(Path(args.data_dir) / "dev.tsv"))
    else:
        n_train = args.train_size or (
            t.get("full_train", t["num_train"]) if args.full else t["num_train"])
        n_eval = t.get("full_eval", t["num_eval"]) if args.full else t["num_eval"]
        train_texts, train_labels = synthetic_text_task(n_train, seed=1)
        eval_texts, eval_labels = synthetic_text_task(n_eval, seed=2)
    if args.label_noise > 0:
        flip = np.random.default_rng(FLIP_SEED).random(len(train_labels)) < args.label_noise
        train_labels = np.where(flip, 1 - train_labels, train_labels).astype(np.int32)
    return train_texts, train_labels, eval_texts, eval_labels


def _bundles(args, cfg):
    """``(train bundle, eval bundle or None, pipeline spec or None)``: the
    flash kernels as the attention core; under ``--sp`` the sequence-parallel
    model with its core and its dense twin for evaluation; under ``--pp``
    the dense model and its pipeline spec (JAX's example runs neither on the
    flash core)."""
    from gradaccum_tpu_torch.models.bert import bert_classifier_bundle, dense_attention
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention

    if args.sp > 1:
        from gradaccum_tpu_torch.parallel.ring_attention import make_ring_attention_fn
        from gradaccum_tpu_torch.parallel.ulysses import make_ulysses_attention_fn

        core = (make_ring_attention_fn("seq") if args.sp_core == "ring"
                else make_ulysses_attention_fn("seq"))
        return (bert_classifier_bundle(cfg, num_classes=2, attention_fn=core, seq_axis="seq"),
                bert_classifier_bundle(cfg, num_classes=2, attention_fn=dense_attention),
                None)
    if args.pp > 1:
        from gradaccum_tpu_torch.models.bert_pp import bert_pipeline_spec

        return (bert_classifier_bundle(cfg, num_classes=2, attention_fn=dense_attention),
                None, bert_pipeline_spec(cfg, n_stages=args.pp))
    return bert_classifier_bundle(cfg, num_classes=2, attention_fn=flash_attention), None, None


def setup(args, mesh=None):
    """The run ``args`` (from :func:`parse_args`) describe, ready to train:
    ``(estimator, train_fn, eval_fn, config, run)``, ``run`` holding the
    step counts, the corpus size and the model directory. Raises without a
    card unless ``--device cpu``. ``mesh``: this rank's ``DataMesh`` (a
    world of ``--dp`` ranks) or multi-axis ``Mesh`` (:func:`mesh_axes`),
    or None on one device."""
    import dataclasses

    import torch

    from gradaccum_tpu_torch.data.pipeline import Dataset
    from gradaccum_tpu_torch.data.tokenization import build_vocab, load_vocab
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw
    from gradaccum_tpu_torch.ops.schedule import warmup_polynomial_decay
    from gradaccum_tpu_torch.utils.flops import bert_train_flops_per_seq
    from gradaccum_tpu_torch.utils.platform import resolve_device

    error = build_parser().error
    # no card and no --device cpu: raise; a rank runs on its mesh device
    device = mesh.device if mesh is not None else resolve_device(args.device)
    dp = mesh.shape.get("data", 1) if mesh is not None else 1
    t = TASKS[args.task]
    model_dir = prepare_model_dir(args, mesh)
    train_texts, train_labels, eval_texts, eval_labels = _load_data(args, t)

    vocab_path = args.vocab
    if args.hf_checkpoint and not vocab_path:
        # pretrained embeddings are indexed by the checkpoint's vocabulary;
        # a corpus-built vocab would scramble them silently
        candidate = Path(args.hf_checkpoint) / "vocab.txt"
        if not candidate.exists():
            error(f"--hf-checkpoint has no vocab.txt ({candidate}); pass --vocab with "
                  "the checkpoint's vocabulary file")
        vocab_path = str(candidate)
    tok = load_vocab(vocab_path) if vocab_path else build_vocab(train_texts)
    train = dict(tok.encode_batch(train_texts, max_seq_length=args.seq_len),
                 label=train_labels)
    evald = dict(tok.encode_batch(eval_texts, max_seq_length=args.seq_len),
                 label=eval_labels)

    micro = t["batch"]
    k = args.accum_k if args.accum_k is not None else t["k"]
    if args.full:
        # 3 epochs in micro-batch steps; each consumes micro rows per rank
        max_steps = len(train_labels) * 3 // (micro * dp)
        print(f"[preset] {args.task} --full: corpus={len(train_labels)}, 3 epochs -> "
              f"{max_steps} micro-steps (micro {micro} x dp {dp}, K={k})")
    else:
        max_steps = args.max_steps
    full_max_steps = max_steps
    if args.quick:
        max_steps = min(QUICK_STEPS, max_steps)
        print(f"[preset] --quick smoke: running {max_steps} of {full_max_steps} "
              "micro-steps (the schedule still spans the full run)")

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    pretrained = None
    if args.hf_checkpoint:
        from gradaccum_tpu_torch.models.bert_checkpoint import load_hf_checkpoint

        cfg, pretrained = load_hf_checkpoint(args.hf_checkpoint, num_classes=2, dtype=dtype)
        if len(tok.vocab) != cfg.vocab_size:
            error(f"tokenizer vocab ({len(tok.vocab)} entries) does not match the "
                  f"checkpoint vocab_size ({cfg.vocab_size}); pass the checkpoint's own "
                  "vocab.txt via --vocab")
        if args.seq_len > cfg.max_position_embeddings:
            # the checkpoint's position table keeps its row count: positions
            # past it would train on rows it does not have
            error(f"--seq-len {args.seq_len} exceeds the checkpoint's position table "
                  f"({cfg.max_position_embeddings} rows); long sequences need a model "
                  "trained with a larger position embedding")
    else:
        cfg = BertConfig.small(
            vocab_size=args.vocab_size or max(len(tok.vocab), 128), dtype=dtype,
            max_position_embeddings=max(512, args.seq_len),
            num_experts=args.num_experts, moe_top_k=args.moe_top_k)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    if args.pp > 1 and cfg.num_layers % args.pp:
        error(f"{cfg.num_layers} layers do not split over --pp {args.pp}")
    if args.sp > 1 or args.pp > 1:
        # sequence- and pipeline-parallel BERT run deterministic layers
        cfg = dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)
    bundle, eval_bundle, pipeline = _bundles(args, cfg)
    # full_max_steps, not the --quick cap: the smoke runs the full run's
    # warmup and decay
    schedule = warmup_polynomial_decay(
        args.lr, num_train_steps=full_max_steps,
        num_warmup_steps=int(full_max_steps * args.warmup_frac))
    est = Estimator(
        bundle,
        adamw(schedule, weight_decay_rate=0.01),
        # the first-step quirk is a streaming-mode semantic; say False on the
        # scan path so the config states what runs
        GradAccumConfig(num_micro_batches=k, clip_norm=1.0,
                        first_step_quirk=(args.mode == "streaming")),
        RunConfig(model_dir=model_dir,
                  log_step_count_steps=max(max_steps // 20, 1),
                  flops_per_example=bert_train_flops_per_seq(
                      cfg.hidden_size, cfg.num_layers, cfg.intermediate_size,
                      args.seq_len, 2, num_experts=cfg.num_experts,
                      moe_top_k=cfg.moe_top_k)),
        mode=args.mode,
        device=device,
        warm_start=pretrained,
        sparse_embed=args.sparse_embed_grad,
        mesh=mesh,
        zero1=args.zero1,
        sharding_rules=mesh_axes(args)[1],
        eval_model=eval_bundle,
        pipeline=pipeline,
    )
    if mesh is not None and mesh.rank == 0:
        kind = {(True, True): "tp+ep", (True, False): "tp", (False, True): "ep"}.get(
            (args.tp > 1, args.ep > 1))
        kind = "pp" if args.pp > 1 else f"sp[{args.sp_core}]" if args.sp > 1 else kind
        print(f"[mesh] {mesh.shape}" + (f" rules={kind}" if kind else ""))
    # the per-rank micro-batch x the data-parallel width (each worker sees
    # its own micro rows) x K in scan mode
    host_batch = micro * dp * (k if args.mode == "scan" else 1)

    def train_fn():
        return (Dataset.from_arrays(train)
                .shuffle(2 * micro + 1, seed=19830610)
                .repeat()
                .batch(host_batch, drop_remainder=True)
                .prefetch(2))

    def eval_fn():
        return Dataset.from_arrays(evald).batch(64)

    run = {"max_steps": max_steps, "full_max_steps": full_max_steps,
           "corpus": len(train_labels), "model_dir": model_dir,
           # one row of the eval set without its label: the export signature
           "export_sample": {key: v[:1] for key, v in evald.items() if key != "label"}}
    return est, train_fn, eval_fn, cfg, run


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    world = world_size(args)
    if world > 1 and not in_rank():
        return spawn_ranks("gradaccum_tpu_torch.examples.bert_finetune", argv, world,
                           args.device)
    with rank_mesh(world, args.device, want_mesh=False, axes=mesh_axes(args)[0]) as mesh:
        return _main(args, mesh)


def _main(args, mesh) -> dict:
    from gradaccum_tpu_torch.estimator.config import EvalSpec, TrainSpec
    from gradaccum_tpu_torch.utils.platform import device_name

    est, train_fn, eval_fn, cfg, run = setup(args, mesh)
    k = est.accum.num_micro_batches
    micro = TASKS[args.task]["batch"]
    evaluations = []  # one entry per evaluation: each opens the eval input once

    def counted_eval_fn():
        evaluations.append(1)
        return eval_fn()

    state, results = est.train_and_evaluate(
        TrainSpec(train_fn, max_steps=run["max_steps"]),
        EvalSpec(counted_eval_fn, throttle_secs=60,
                 export_best_dir=args.export_best_dir, best_metric="accuracy",
                 best_mode="max", export_sample=run["export_sample"]),
    )
    out = {
        "task": args.task, "mode": args.mode, "device": device_name(est.device),
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "micro_batch": micro, "accum_k": k, "seq_len": args.seq_len,
        "vocab_size": cfg.vocab_size, "warm_start": args.hf_checkpoint,
        "remat": cfg.remat, "sparse_embed_grad": args.sparse_embed_grad,
        "num_experts": cfg.num_experts, "moe_top_k": cfg.moe_top_k,
        "dp": est.mesh.shape.get("data", 1) if est.mesh is not None else 1,
        "tp": args.tp, "ep": args.ep, "zero1": args.zero1, "sp": args.sp,
        "sp_core": args.sp_core if args.sp > 1 else None, "pp": args.pp,
        "steps": state.step, "updates": state.step // k,
        "timed_host_steps": est.train_stats["host_steps"],
        "first_loss": float(est.first_loss), "loss": float(est.last_loss),
        "accuracy": results["accuracy"],
        "eval_batches": results["_num_batches"], "evaluations": len(evaluations),
        "seq/s": est.examples_per_sec(), "mfu": est.mfu(),
    }
    if cfg.num_experts:
        # the routing of the final evaluation's last batch (it ran on the
        # training module), averaged over layers
        stats = [getattr(est.module.bert, f"layer_{i}").moe.last_aux
                 for i in range(cfg.num_layers)]
        for key in ("dropped_fraction", "router_entropy"):
            out[f"moe_{key}"] = sum(float(st[key]) for st in stats) / len(stats)
    if args.mode == "streaming":
        out["apply_steps"] = est.apply_steps
    if args.full:
        out["preset"] = {
            "task": args.task, "corpus": run["corpus"], "micro_batch": micro,
            "accum_k": k, "dp": out["dp"], "epochs": 3, "full_max_steps": run["full_max_steps"],
            "ran_steps": run["max_steps"], "quick": args.quick, "lr": args.lr,
            "seq_len": args.seq_len, "final_eval_accuracy": round(float(results["accuracy"]), 4),
        }
        if run["model_dir"] and (mesh is None or mesh.rank == 0):
            with open(Path(run["model_dir"]) / "preset.json", "w") as f:
                json.dump(out["preset"], f, indent=2)
    if args.export_dir and (mesh is None or mesh.rank == 0 or est.sharding_rules):
        # under sharding rules every rank gathers, rank 0 writes
        out["export"] = est.export_model(args.export_dir, run["export_sample"], state=state)
        if out["export"] is not None:
            print(f"exported serving artifact: {out['export']}")
    if mesh is None or mesh.rank == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
