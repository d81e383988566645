"""Shared plumbing for the port's entry points (the port of
``examples/common.py``): the MNIST and housing trainers' common flags, the
model directory every entry point prepares, the numbers the small
trainers report, and the data-parallel launcher.

**Data-parallel ranks.** An entry point asked for N > 1 workers (``--dp N``,
MNIST variants 03 and 04) runs as N processes, one per rank. Under
``torchrun --nproc-per-node N`` each process joins the group from the
variables torchrun sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``: the ``initialize_multihost`` slot);
otherwise the command spawns the N ranks itself (:func:`spawn_ranks`), so
that one command runs a variant, as JAX's example does. Rank r trains on
``cuda:r`` (NCCL) or on the CPU (gloo); rank 0 prints the JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
from pathlib import Path
from typing import Optional, Sequence


def example_argparser(description: str, default_steps: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model-dir", default=None,
                   help="checkpoint directory, with loss_vs_step.csv (default: none)")
    p.add_argument("--max-steps", type=int, default=default_steps,
                   help="micro-batch steps (the reference's global_step)")
    p.add_argument("--data-dir", default=None, help="real dataset (else synthetic)")
    p.add_argument("--resume", action="store_true",
                   help="keep --model-dir and resume from its newest checkpoint "
                        "(else it starts fresh, as the reference's examples do)")
    p.add_argument("--mode", choices=["scan", "streaming"], default="scan",
                   help="K micro-batches per host step (scan) or one (streaming, "
                        "the reference's tf.cond train op)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def prepare_model_dir(args, mesh=None) -> Optional[str]:
    """``--model-dir``, emptied first unless ``--resume``; None without one.
    Under a ``mesh`` rank 0 alone empties it, and every rank waits for it
    before going on."""
    if args.model_dir is None:
        return None
    if mesh is None or mesh.rank == 0:
        if not args.resume and os.path.isdir(args.model_dir):
            shutil.rmtree(args.model_dir)
        os.makedirs(args.model_dir, exist_ok=True)
    if mesh is not None:
        mesh.barrier()
    return args.model_dir


def run_summary(est, state) -> dict:
    """The training numbers each entry point's JSON line carries."""
    from gradaccum_tpu_torch.utils.platform import device_name

    stats = est.train_stats
    return {
        "mode": est.mode, "device": device_name(est.device), "steps": state.step,
        "updates": state.step // est.accum.num_micro_batches,
        "first_loss": float(est.first_loss), "loss": float(est.last_loss),
        "examples/s": est.examples_per_sec(),
        "ms_per_host_step": (1e3 * stats["seconds"] / stats["host_steps"]
                             if stats["host_steps"] else None),
    }


# --------------------------------------------------------------------------
# Data-parallel ranks: torchrun, or N local processes spawned here
# --------------------------------------------------------------------------

# seconds a collective waits for its peers, and (x4) the spawning parent's
# deadline for the whole run
DP_TIMEOUT_S = 600.0


def in_rank() -> bool:
    """This process is one rank of a launched group (``torchrun``, or a
    process :func:`spawn_ranks` started)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous store."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def available_devices(device: str) -> Optional[int]:
    """How many ranks the device kind can hold one each: the cards for
    CUDA, no limit (None) for CPU processes."""
    import torch

    if str(device).startswith("cuda"):
        return torch.cuda.device_count()
    return None


@contextlib.contextmanager
def rank_mesh(world: int, device: str, want_mesh: bool, axes=None):
    """The ``DataMesh`` this process trains on, or None; with ``axes``
    (``[(name, size)]``, e.g. data x model x expert) the multi-axis
    ``Mesh`` of ``parallel/mesh.py :: make_mesh`` over them.

    Under ``torchrun`` or :func:`spawn_ranks` (``RANK``/``WORLD_SIZE`` set)
    it joins that group, whose size must be ``world``. Otherwise, with
    ``want_mesh`` (a multi-worker variant narrowed to one rank), it forms a
    one-rank group in this process. The group is left on exit."""
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    if in_rank():
        mesh_lib.initialize_multihost(device=device, timeout_s=DP_TIMEOUT_S)
    elif want_mesh:
        mesh_lib.initialize_multihost(f"localhost:{free_port()}", 1, 0, device=device,
                                      timeout_s=DP_TIMEOUT_S)
    else:
        yield None
        return
    try:
        mesh = mesh_lib.make_mesh(axes) if axes else mesh_lib.data_parallel_mesh()
        if mesh.world != world:
            raise ValueError(f"the launched group has {mesh.world} ranks, the run "
                             f"asks for {world}")
        yield mesh
    finally:
        mesh_lib.shutdown()


def spawn_ranks(module: str, argv: Sequence[str], world: int, device: str,
                deadline_s: Optional[float] = None, output: Optional[list] = None) -> dict:
    """Run ``python -m module argv`` as ``world`` local ranks (the
    variables ``torchrun`` would set), echo rank 0's output and return its
    last line, the entry point's JSON (``output``, when given, receives
    every line). A rank that fails, or a run past the deadline (default 4 x
    ``DP_TIMEOUT_S``), kills every rank and raises."""
    import json
    import subprocess
    import threading
    import time

    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world),
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    if not str(device).startswith("cuda") and "OMP_NUM_THREADS" not in env:
        env["OMP_NUM_THREADS"] = str(max(1, min(4, (os.cpu_count() or 1) // world)))
    procs = []
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL, text=True))
    lines = []

    def relay():  # rank 0's lines, live, and kept for the result
        for line in procs[0].stdout:
            lines.append(line)
            sys.stdout.write(line)
            sys.stdout.flush()

    reader = threading.Thread(target=relay, daemon=True)
    reader.start()
    deadline = time.monotonic() + (deadline_s if deadline_s is not None else 4 * DP_TIMEOUT_S)
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [(r, p.returncode) for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0][0]} exited with code {bad[0][1]}"
                break
            if time.monotonic() > deadline:
                failed = f"the {world} ranks did not finish within the deadline"
                break
            time.sleep(0.1)
        if failed is None:
            bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0][0]} exited with code {bad[0][1]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        reader.join(timeout=10)
    if failed is not None:
        raise RuntimeError(f"data-parallel run of {module}: {failed}")
    if output is not None:
        output.extend(lines)
    return json.loads(lines[-1])
