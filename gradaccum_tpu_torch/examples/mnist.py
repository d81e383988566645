"""MNIST on the card: the reference's distributedExample variants 01 and 02.

The port of ``examples/mnist.py``. The reference's matrix, effective batch
200 in all four (README.md:135-139):

  variant 01: 1 worker,  batch 200, no accumulation   (01:72-73)
  variant 02: 1 worker,  batch 100, K=2               (02:101-110)
  variant 03: 2 workers, batch 100/worker, no accum   (03:80-81)
  variant 04: 2 workers, batch 50/worker,  K=2        (04:110-121)

Shared config: Adam lr 1e-4 (``tf.train.AdamOptimizer``), the first-step
quirk on, shuffle buffer 2·batch+1 with seed 19830610, synthetic
MNIST-shaped data unless ``--data-dir`` holds the idx files. Variants 03
and 04 run on two workers: two ranks of a ``data`` mesh (``examples/common.py``
spawns them, or ``torchrun --nproc-per-node 2`` does), each reading the
same host batch of ``batch x 2`` rows (``x K`` in scan mode) and training
on its half. With fewer cards than workers the variant runs on as many
ranks as there are cards, with JAX's ``[warn]``: on one card, at world 1.

    python -m gradaccum_tpu_torch.examples.mnist --variant 02 --mode streaming
    python -m gradaccum_tpu_torch.examples.mnist --variant 04 --device cpu

It runs on the card unless ``--device cpu`` is given, and prints one JSON
line: first and last loss, eval accuracy, examples/s and time per host step.
"""

from __future__ import annotations

import json
import sys
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

VARIANTS = {
    "01": dict(workers=1, batch=200, k=1),
    "02": dict(workers=1, batch=100, k=2),
    "03": dict(workers=2, batch=100, k=1),
    "04": dict(workers=2, batch=50, k=2),
}


def build_parser():
    p = example_argparser("MNIST with gradient accumulation", default_steps=1500)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="02")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eval-batch", type=int, default=10000)  # 02:128
    p.add_argument("--label-noise", type=float, default=0.0,
                   help="fraction of TRAIN labels flipped to a uniform other class")
    p.add_argument("--train-size", type=int, default=None,
                   help="synthetic train-set size; ignored with --data-dir")
    return p


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    v = VARIANTS[args.variant]
    n = v["workers"]
    if n > 1:
        from gradaccum_tpu_torch.utils.platform import resolve_device

        resolve_device(args.device)  # no card and no --device cpu: raise
        avail = available_devices(args.device)
        n = n if avail is None else min(n, avail)
        if n < v["workers"] and not in_rank():
            print(f"[warn] only {n} device(s); running variant on {n}-wide mesh")
        if n > 1 and not in_rank():
            return spawn_ranks("gradaccum_tpu_torch.examples.mnist", argv, n, args.device)
    with rank_mesh(n, args.device, want_mesh=v["workers"] > 1) as mesh:
        return _run(args, v, mesh)


def _run(args, v, mesh) -> dict:
    from gradaccum_tpu_torch.data.mnist import flip_labels, load
    from gradaccum_tpu_torch.data.pipeline import Dataset
    from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.mnist_cnn import mnist_cnn_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adam
    from gradaccum_tpu_torch.utils.platform import resolve_device

    # no card and no --device cpu: raise; a rank runs on its mesh device
    device = mesh.device if mesh is not None else resolve_device(args.device)
    model_dir = prepare_model_dir(args, mesh)
    data = load(args.data_dir, num_train=args.train_size)
    train_images, train_labels = data["train"]
    test_images, test_labels = data["test"]
    if args.label_noise > 0:
        train_labels = flip_labels(train_labels, args.label_noise)

    est = Estimator(
        mnist_cnn_bundle(),
        adam(args.lr),  # tf.train.AdamOptimizer (02:58)
        GradAccumConfig(num_micro_batches=v["k"], first_step_quirk=True),
        RunConfig(model_dir=model_dir, log_step_count_steps=100),
        mode=args.mode,
        device=device,
        mesh=mesh,
    )
    per_host_batch = v["batch"] * (mesh.world if mesh is not None else 1)
    host_batch = per_host_batch * (v["k"] if args.mode == "scan" else 1)

    def train_fn():
        return (Dataset.from_arrays({"image": train_images, "label": train_labels})
                .shuffle(2 * v["batch"] + 1, seed=19830610)  # 01:16
                .repeat()
                .batch(host_batch, drop_remainder=True)
                .prefetch(2))

    def eval_fn():
        return Dataset.from_arrays({"image": test_images, "label": test_labels}).batch(
            args.eval_batch)

    state, results = est.train_and_evaluate(TrainSpec(train_fn, max_steps=args.max_steps),
                                            EvalSpec(eval_fn, throttle_secs=30))
    out = {"variant": args.variant, "micro_batch": v["batch"], "accum_k": v["k"],
           "workers": mesh.world if mesh is not None else 1,
           **run_summary(est, state), "accuracy": results["accuracy"]}
    if mesh is None or mesh.rank == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
