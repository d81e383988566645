"""Shared plumbing for the port's entry points (the port of
``examples/common.py``): the MNIST and housing trainers' common flags, the
model directory every entry point prepares, and the numbers the small
trainers report."""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional


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


def prepare_model_dir(args) -> Optional[str]:
    """``--model-dir``, emptied first unless ``--resume``; None without one."""
    if args.model_dir is None:
        return None
    if not args.resume and os.path.isdir(args.model_dir):
        shutil.rmtree(args.model_dir)
    os.makedirs(args.model_dir, exist_ok=True)
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
