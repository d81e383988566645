"""Overlay loss-vs-step curves: the reference's comparison plots.

The port of ``examples/plot_loss.py``. The reference validates gradient
accumulation with two PNGs (BERT with and without accumulation; the 4-way
MNIST effective-batch-200 matrix). Every Estimator run writes
``loss_vs_step.csv`` into its model_dir; this tool overlays any number of
them into the same kind of figure (matplotlib, imported only to draw).

    python -m gradaccum_tpu_torch.examples.plot_loss out.png run1_dir run2_dir ...
"""

from __future__ import annotations

import csv
import os
import sys


def read_curve(model_dir):
    return read_curve_file(os.path.join(model_dir, "loss_vs_step.csv"))


def read_curve_file(path):
    steps, losses = [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            steps.append(int(row["step"]))
            losses.append(float(row["loss"]))
    return steps, losses


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 1
    out, run_dirs = argv[0], argv[1:]

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 5))
    for d in run_dirs:
        steps, losses = read_curve(d)
        ax.plot(steps, losses, label=os.path.basename(os.path.normpath(d)),
                linewidth=1.0, alpha=0.85)
    ax.set_xlabel("step (micro-batches, reference global_step semantics)")
    ax.set_ylabel("training loss")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out} ({len(run_dirs)} curves)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
