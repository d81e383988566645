"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 benchmark/calibrate.py --workload bert-large.seq512 \\
        --seeds 11 12 13 --control-seeds 21 22 23 --fault-seeds 31 32 33 \\
        --out calibrate.jsonl

For each of ``--seeds`` a run whose window is empty (the program's first
steps against the reference); for each of ``--control-seeds`` the control,
the reference itself computed one precision below the cell's (fp8
products for bfloat16, TF32 for float32), against the float32 reference;
for each of ``--fault-seeds`` the program with each of ``--faults`` planted
(``half_batch``: half of each micro-batch left out, the mean over the
rest; ``altered``: the loss altered by 1 % where it is produced;
``stale_copy``: the working copy of bfloat16 parameters left unwritten
while the float32 masters move). A step that returns its state unchanged
(``frozen``) reads 1 on the change and needs no run. One JSON line per
reading goes to ``--out`` and to standard output. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL = {"bf16": "fp8", "f32": "tf32"}


def _looks(side: dict, ref: dict) -> dict:
    """What to look at beside the numbers: both sides' losses and the
    three leaves with the widest gap in each norm."""
    import statistics

    out = {"losses": side["losses"], "ref_losses": ref["losses"]}
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        gaps = sorted(((abs(side[key][n] - v) / max(v, med), n) for n, v in ref[key].items()),
                      reverse=True)
        out[f"worst_{key}"] = [[n, g, side[key][n] / med, ref[key][n] / med] for g, n in gaps[:3]]
        out[f"median_leaf_{key}"] = statistics.median(g for g, _ in gaps)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=["half_batch", "altered"])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness, spec
    from benchmark.yardstick import compare

    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    out = open(args.out, "a")

    def emit(**row):
        row.update(workload=args.workload, at=time.time())
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    try:
        runs = [(s, None) for s in args.seeds] + \
            [(s, f) for s in args.fault_seeds for f in args.faults]
        for seed, fault in runs:
            t = time.perf_counter()
            detail = {}
            r = harness.run(args.workload, seed, 0.0, False, device=str(dev), cell=cell,
                            fault=fault, detail=detail)
            emit(kind=fault or "program", seed=seed, correct=r["correct"],
                 numbers={k: v["value"] for k, v in r["checks"].items()},
                 seconds=time.perf_counter() - t, **_looks(detail["prog"], detail["ref"]))
        control = CONTROL[cell["work"]["precision"]]
        for seed in args.control_seeds:
            t = time.perf_counter()
            low = harness.reference(cell, seed, dev, control)
            ref = harness.reference(cell, seed, dev, "f32")
            numbers = compare.gaps(low, ref, cell["mix"]["num_micro_batches"])
            emit(kind=f"control:{control}", seed=seed, numbers=numbers,
                 correct=compare.verdict(numbers, cell["work"]["limits"]),
                 seconds=time.perf_counter() - t, **_looks(low, ref))
    finally:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
