"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload bert-large.seq512 --seed 1 --seconds 20 --trace 0

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``: the
numbers compared, each with its limit); the same numbers close standard
error. Without a CUDA card, or with fewer than the cell asks for, it
exits 2 and prints no result. Kernel builds and caches stay inside the
checkout (``build/``).
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _process_start() -> float:
    """The wall time this process started (Linux), else this file's start."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return T_START


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache of a build or a compile at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_process=_process_start())
    except harness.NoCard as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] the run loaded {found}: the benchmark may load neither JAX nor the "
              f"JAX package", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(harness.check_lines(result), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
