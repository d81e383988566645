"""Reproduce the reference's published loss-curve evidence with the port.

The port of ``examples/reproduce_results.py``. The reference validates
gradient accumulation with two figures:

1. ``Loss_Step.png`` — BERT fine-tuning with and without accumulation at
   the same micro-batch: the K=4 run's loss is visibly less noisy.
2. ``Loss_Step_multiWorker.png`` — the 4-way MNIST matrix holding the
   effective batch at 200: (1w,200,K1), (1w,100,K2), (2w,100,K1),
   (2w,50,K2) all converge to a similar loss; the K=2 arms take twice the
   steps.

This script runs the same matrix through the port's entry points, each in a
subprocess on ``--device`` (the card by default; the two-worker MNIST
variants spawn their two ranks, and on one card they run at world 1, as
``examples/mnist.py`` says), plus JAX's BERT warm-start chain on the
committed HF fixture and the housing regression. It copies each run's
``loss_vs_step.csv`` into ``--out``, renders the two overlay figures
(matplotlib) and writes ``summary.json``, derived only from the CSVs in
``--out`` with JAX's ``curve_stats``. Synthetic data unless the data-dir
flags name real datasets. ``--out`` defaults to ``build/results``, so
nothing lands beside JAX's committed ``results/``.

    python -m gradaccum_tpu_torch.examples.reproduce_results --quick --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if __package__ in (None, ""):  # run as a script: make the package importable
    sys.path.insert(0, str(REPO))

from gradaccum_tpu_torch.examples.plot_loss import read_curve_file  # noqa: E402

# JAX's tables: every MNIST arm consumes 300,000 samples (effective batch
# 200 x 1,500 updates) with 10 % label noise, an entropy floor no arm can
# memorize below; both BERT arms the same 3,200 micro-steps of a fresh
# stream with 15 % label noise
MNIST_NOISE = ["--label-noise", "0.10", "--train-size", "300000"]
MNIST_RUNS = [
    ("mnist_01_1w_b200_k1", ["--variant", "01", "--max-steps", "1500"] + MNIST_NOISE),
    ("mnist_02_1w_b100_k2", ["--variant", "02", "--max-steps", "3000"] + MNIST_NOISE),
    ("mnist_03_2w_b100_k1", ["--variant", "03", "--max-steps", "1500"] + MNIST_NOISE),
    ("mnist_04_2w_b50_k2", ["--variant", "04", "--max-steps", "3000"] + MNIST_NOISE),
]
BERT_RUNS = [
    ("bert_cola_k4_eff32",
     ["--task", "cola", "--accum-k", "4", "--max-steps", "3200",
      "--label-noise", "0.15", "--train-size", "25600"]),
    ("bert_cola_k1_eff8",
     ["--task", "cola", "--accum-k", "1", "--max-steps", "3200",
      "--label-noise", "0.15", "--train-size", "25600"]),
]
# the reference's flagship chain (pretrained checkpoint -> warm start ->
# fine-tune -> evaluate) on the committed HF fixture
BERT_HF_RUN = (
    "bert_cola_hf_warmstart",
    ["--task", "cola", "--hf-checkpoint", "tests/fixtures/bert_hf_tiny",
     "--data-dir", "tests/fixtures/bert_hf_tiny", "--seq-len", "32", "--accum-k", "4",
     "--max-steps", "4000", "--lr", "3e-4"],
)
HOUSING_RUN = ("housing_b59_k3", ["--max-steps", "3000"])


def _drop_flags(extra, flags):
    """Remove ``--flag value`` pairs from an argument list."""
    out, skip = [], False
    for a in extra:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        else:
            out.append(a)
    return out


def run_one(module, name, extra, run_root, quick, device, run_timeout=1800):
    """Run ``gradaccum_tpu_torch.examples.<module>`` into its own model_dir;
    returns ``(model_dir, its JSON line)``. ``quick`` cuts the steps 10x."""
    model_dir = str(Path(run_root) / name)
    cmd = [sys.executable, "-m", f"gradaccum_tpu_torch.examples.{module}",
           "--model-dir", model_dir, "--device", device] + list(extra)
    if quick:  # keep the matrix's shape, 10x fewer steps
        i = cmd.index("--max-steps")
        cmd[i + 1] = str(max(int(cmd[i + 1]) // 10, 20))
    print(f"[run] {name}: {' '.join(cmd[2:])}", flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, cwd=str(REPO),
                          timeout=run_timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-2000:])
        raise RuntimeError(f"{name} failed (rc={proc.returncode})")
    return model_dir, json.loads(proc.stdout.strip().splitlines()[-1])


def tail_mean(losses, frac=0.1):
    n = max(1, int(len(losses) * frac))
    return sum(losses[-n:]) / n


def curve_stats(steps, losses):
    """The summary entry derivable from a loss CSV alone (JAX's)."""
    import numpy as np

    return {"steps": steps[-1], "tail_loss_mean": round(tail_mean(losses), 4),
            "tail_loss_std": round(float(np.std(losses[-max(1, len(losses) // 10):])), 4)}


def overlay(out_png, curves, title, smooth=25):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, ax = plt.subplots(figsize=(9, 5))
    for name, (steps, losses) in curves.items():
        if len(losses) > smooth:  # a running mean, like the reference's smoothing
            (raw,) = ax.plot(steps, losses, linewidth=0.6, alpha=0.25)
            sm = np.convolve(losses, np.ones(smooth) / smooth, mode="valid")
            ax.plot(steps[smooth - 1:], sm, linewidth=1.4, label=name, color=raw.get_color())
        else:
            ax.plot(steps, losses, linewidth=1.4, label=name)
    ax.set_xlabel("step (micro-batches, reference global_step semantics)")
    ax.set_ylabel("training loss")
    ax.set_title(title)
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    print(f"[plot] wrote {out_png}")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(REPO / "build" / "results"))
    ap.add_argument("--quick", action="store_true", help="10x fewer steps (smoke)")
    ap.add_argument("--only", choices=["all", "mnist", "bert", "warmstart", "housing"],
                    default="all",
                    help="rerun one group; the other groups' curves reload from --out")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--run-timeout", type=int, default=1800,
                    help="per-run subprocess timeout in seconds")
    ap.add_argument("--mnist-data-dir", default=None,
                    help="real MNIST idx-gz directory for every matrix arm")
    ap.add_argument("--bert-data-dir", default=None,
                    help="real CoLA train.tsv/dev.tsv directory for the K4-vs-K1 arms")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    run_root = Path(tempfile.mkdtemp(prefix="gradaccum_results_", dir=out))
    summary_path = out / "summary.json"
    prior_runs = {}
    if summary_path.exists():
        with open(summary_path) as f:
            prior_runs = json.load(f).get("runs", {})
    fresh_metrics = {}  # {name: fields from the run, merged into its entry}

    def ran(name, value, metric_key="final_accuracy"):
        fresh_metrics[name] = {metric_key: value, **({"quick": True} if args.quick else {})}

    def run(module, name, extra):
        model_dir, result = run_one(module, name, extra, run_root, args.quick, args.device,
                                    args.run_timeout)
        shutil.copy(os.path.join(model_dir, "loss_vs_step.csv"), out / f"{name}.csv")
        return result

    try:
        for name, extra in MNIST_RUNS:
            if args.only in ("all", "mnist"):
                if args.mnist_data_dir:
                    extra = extra + ["--data-dir", args.mnist_data_dir]
                ran(name, run("mnist", name, extra)["accuracy"])
        for name, extra in BERT_RUNS + [BERT_HF_RUN]:
            warm = name == BERT_HF_RUN[0]
            if args.only not in (("all", "bert", "warmstart") if warm else ("all", "bert")):
                continue
            if args.bert_data_dir and not warm:
                extra = _drop_flags(extra, ("--train-size", "--label-noise"))
                extra = extra + ["--data-dir", args.bert_data_dir]
            ran(name, run("bert_finetune", name, extra)["accuracy"])
        if args.only in ("all", "housing"):
            name, extra = HOUSING_RUN
            ran(name, run("housing", name, extra)["test_rmse"], metric_key="final_test_rmse")
    finally:
        shutil.rmtree(run_root, ignore_errors=True)

    # the summary and the plots derive only from the CSVs now in --out
    summary = {"quick": args.quick, "runs": {}}
    mnist_curves, bert_curves = {}, {}
    groups = ([(n, mnist_curves) for n, _ in MNIST_RUNS]
              + [(n, bert_curves) for n, _ in BERT_RUNS]
              + [(BERT_HF_RUN[0], None), (HOUSING_RUN[0], None)])
    for name, curves in groups:
        path = out / f"{name}.csv"
        if not path.exists():
            print(f"[results] no curve for {name} ({path}); skipping")
            continue
        steps, losses = read_curve_file(path)
        if curves is not None:
            curves[name] = (steps, losses)
        entry = curve_stats(steps, losses)
        if name in fresh_metrics:
            entry.update(fresh_metrics[name])
        else:  # a group this call did not run: keep its measured metric only
            entry.update({k: prior_runs[name][k]
                          for k in ("final_accuracy", "final_test_rmse", "quick")
                          if k in prior_runs.get(name, {})})
        summary["runs"][name] = entry
    suffix = " — QUICK SMOKE (10x fewer steps)" if args.quick else ""
    overlay(out / "mnist_matrix.png", mnist_curves,
            f"MNIST effective-batch-200 matrix (reference Loss_Step_multiWorker.png){suffix}")
    overlay(out / "bert_accumulation.png", bert_curves,
            f"BERT-Small micro-batch 8: K=4 accumulation vs none (reference "
            f"Loss_Step.png){suffix}")
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
