"""Housing regression on the card: the reference's another-example.py.

The port of ``examples/housing.py``. Config per another-example.py:267-277:
batch 59, K=3 accumulation, MLP hidden [16, 8, 4], seed 19830610, MSE loss
with MAE/RMSE eval metrics, a 70/30 train/test split, Adam lr 1e-3 with
the first-step quirk on. Training ends with evaluate-on-train,
evaluate-on-test and a 5-example predict (another-example.py:361-389).
``--data-dir`` names a housing CSV (``tests/fixtures/housing_tiny.csv`` has
the schema); without it a synthetic stand-in of 506 rows is generated.
``--export-dir`` (a serving export) is not ported yet and raises.

    python -m gradaccum_tpu_torch.examples.housing --mode streaming

It runs on the card unless ``--device cpu`` is given, and prints one JSON
line: first and last loss, MAE and RMSE on both splits, the 5 predictions
beside their labels, examples/s and time per host step.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gradaccum_tpu_torch.examples.common import (  # noqa: E402
    example_argparser,
    prepare_model_dir,
    run_summary,
)


def build_parser():
    p = example_argparser("Housing regression with K=3 accumulation", default_steps=3000)
    p.add_argument("--batch", type=int, default=59)
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--export-dir", default=None,
                   help="serving export of predict + weights (not ported yet)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.export_dir:
        raise NotImplementedError("--export-dir (Estimator.export_model) is not ported "
                                  "yet; see ROADMAP.md")
    import numpy as np

    from gradaccum_tpu_torch.data.csv import load_housing
    from gradaccum_tpu_torch.data.pipeline import Dataset
    from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.housing_mlp import housing_mlp_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adam
    from gradaccum_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu: raise
    model_dir = prepare_model_dir(args)
    X, y = load_housing(args.data_dir)
    # 70/30 split with the reference's seed (another-example.py:244)
    perm = np.random.default_rng(19830610).permutation(len(X))
    cut = int(0.7 * len(X))
    tr, te = perm[:cut], perm[cut:]

    est = Estimator(
        housing_mlp_bundle(),
        adam(args.lr),
        GradAccumConfig(num_micro_batches=args.k, first_step_quirk=True),
        RunConfig(model_dir=model_dir, log_step_count_steps=1000),  # another-example.py:284
        mode=args.mode,
        device=device,
    )
    host_batch = args.batch * (args.k if args.mode == "scan" else 1)

    def train_fn():
        return (Dataset.from_arrays({"x": X[tr], "y": y[tr]})
                .shuffle(2 * args.batch + 1, seed=19830610)  # another-example.py:44
                .repeat()
                .batch(host_batch, drop_remainder=True))

    def eval_fn(rows):
        return lambda: Dataset.from_arrays({"x": X[rows], "y": y[rows]}).batch(len(rows))

    state, _ = est.train_and_evaluate(TrainSpec(train_fn, max_steps=args.max_steps),
                                      EvalSpec(eval_fn(te), throttle_secs=30))
    train_res = est.evaluate(eval_fn(tr), state=state, name="final/train")
    test_res = est.evaluate(eval_fn(te), state=state, name="final/test")
    preds = list(est.predict(  # predict 5 (another-example.py:385-389)
        lambda: Dataset.from_arrays({"x": X[te][:5], "y": y[te][:5]}).batch(5), state=state))
    out = {"micro_batch": args.batch, "accum_k": args.k, **run_summary(est, state),
           "train_mae": train_res["mae"], "train_rmse": train_res["rmse"],
           "test_mae": test_res["mae"], "test_rmse": test_res["rmse"],
           "predictions": [float(p["predictions"][0]) for p in preds],
           "labels": [float(v) for v in y[te][:5, 0]]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
