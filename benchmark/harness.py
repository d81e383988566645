"""One run of one cell: set-up, the first steps checked, the window, the
reference, the metrics and the result line.

Set-up builds ONE training object, the port's ``Estimator`` in scan mode
with AdamW (float32 masters under bfloat16), the global-norm clip and the
cell's K, on weights the benchmark makes on the device from the seed. It
drives that object through its first updates (the cell's ``check_steps``) on host
batches that all differ, reading what the comparison needs (each
micro-batch's loss, the first moment after one step, the parameters the
model computes with after the last), and hands the same object to the
window. The window feeds the same ``Estimator.train`` from a pool of
further batches until ``--seconds`` have passed, waits for the last update
and stops. After it, the program is freed and the plain reference follows
the first steps on the same batches, weights and dropout seeds, keeping
float32 masters under a bfloat16 working copy as the program does.

With ``--trace 1`` the window is ``TRACE_UPDATES`` updates under
``torch.profiler`` (CUDA activity alone on the card) and the run reports
the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Optional

import torch

from benchmark import families, spec, traffic, weights
from benchmark.reference import steps as ref_steps
from benchmark.yardstick import compare, flops, peaks, profile

POOL = 8  # distinct batches the window cycles through
TRACE_UPDATES = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "gradaccum_tpu")
FAULTS = ("frozen", "stale_copy", "half_batch", "altered")
# the type the program stores its parameters in under float32 masters,
# by the cell's precision (None: the parameters are their own masters)
WORKING_COPY = {"bf16": torch.bfloat16, "f32": None}


class NoCard(RuntimeError):
    """The cell asks for more CUDA cards than this machine has."""


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is one the
    benchmark may not load, compared whole (``gradaccum_tpu_torch`` is
    not ``gradaccum_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class _Recorder:
    """The bundle's loss, recording each micro-batch's value while ``on``,
    and with the loss's faults of ``FAULTS`` planted for the tests of the
    check."""

    def __init__(self, loss, fault: Optional[str]):
        self.loss, self.fault = loss, fault
        self.on, self.values = False, []

    def __call__(self, model, batch):
        if self.fault == "half_batch":
            rows = len(batch["input_ids"])
            batch = {k: (v[:rows // 2] if torch.is_tensor(v) else v) for k, v in batch.items()}
        value = self.loss(model, batch)
        if self.fault == "altered":
            value = value * 1.01
        if self.on:
            self.values.append(value.detach())
        return value


def _stale_copy(update):
    """``update`` with the parameters the model computes with left as they
    were: the masters and moments move, the working copy is not written."""
    def stale(grads, state, params, step):
        before = {n: p.detach().clone() for n, p in params.items()}
        params, state = update(grads, state, params, step)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(before[n])
        return params, state
    return stale


def _feed(pool, stop, ledger):
    """Batches from ``pool`` in turn until ``stop()``; each one given is
    appended to ``ledger``."""
    i = 0
    while not stop():
        batch = pool[i % len(pool)]
        ledger.append(batch)
        yield batch
        i += 1


def run(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        t_process: Optional[float] = None, cell: Optional[dict] = None,
        fault: Optional[str] = None, log=sys.stderr, detail: Optional[dict] = None) -> dict:
    """One run; returns the result object (the caller prints it). ``detail``,
    when given, receives both sides' readings."""
    t_process = time.time() if t_process is None else t_process
    marks = [("interpreter and imports", time.time())]
    cell = spec.cell(name) if cell is None else cell
    work, mix = cell["work"], cell["mix"]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["entry"]["chips"]:
            raise NoCard(f"cell {name} needs {cell['entry']['chips']} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
        marks.append(("CUDA context", time.time()))
        from gradaccum_tpu_torch.ops.flash_attention import build_kernels

        build_kernels()
        marks.append(("kernel libraries (built on a checkout's first run)", time.time()))
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw

    fam = families.load(cell["config"]["family"])
    ref_model = fam.reference
    rcfg = fam.model_cfg(cell["config"])
    specs = ref_model.param_specs(rcfg)
    run_seed = int(seed) % 2**63
    k, precision, steps = mix["num_micro_batches"], work["precision"], work["check_steps"]
    batches = traffic.updates(mix, run_seed, steps + POOL)
    made = [weights.make(specs, rcfg["std"], run_seed, dev)]
    bundle = fam.program_bundle(rcfg, precision, made.pop)
    recorder = _Recorder(bundle.loss, fault)
    bundle = bundle._replace(loss=recorder)
    opt = adamw(work["learning_rate"], weight_decay_rate=work["weight_decay"],
                master_dtype=torch.float32 if precision == "bf16" else None)
    if fault == "frozen":
        opt = opt._replace(update=lambda grads, state, params, step: (params, state))
    elif fault == "stale_copy":
        opt = opt._replace(update=_stale_copy(opt.update))
    est = Estimator(bundle, opt,
                    GradAccumConfig(k, clip_norm=work["clip_norm"], first_step_quirk=False),
                    RunConfig(seed=run_seed, save_checkpoints_steps=None),
                    mode="scan", device=dev)

    marks.append(("traffic, weights and the Estimator", time.time()))

    # -- the first steps, checked: same object, the window's own call and feed
    recorder.on = True
    state = est.train(iter(batches[:1]))
    marks.append(("first update", time.time()))
    names = families.state_names(est.module)  # {state name: reference name}
    with torch.no_grad():
        # AdamW's first moment after one step is (1 - beta_1) = 0.1 times the
        # gradient it got
        first = torch.stack([state.opt_state.m[n].double().norm() for n in names]) / 0.1
    state = est.train(iter(batches[1:steps]))
    recorder.on = False
    with torch.no_grad():
        # the change of the parameters the model computes with (the working
        # copy under float32 masters), from the weights as they held them
        start = weights.make(specs, rcfg["std"], run_seed, dev)
        now = state.params
        change = torch.stack([
            (now[n].double() - start[names[n]].to(now[n].dtype).double()).norm()
            for n in names])
        del start
    prog = {"losses": torch.stack(recorder.values).double().tolist(),
            "grad": dict(zip(names.values(), first.tolist())),
            "change": dict(zip(names.values(), change.tolist()))}
    recorder.values.clear()

    # -- the window
    pool, fed = batches[steps:], []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window, launched = None, None
    marks.append(("checked updates and their readings", time.time()))
    setup_s = time.time() - t_process
    if not trace:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        est.train(_feed(pool, lambda: time.perf_counter() >= deadline, fed))
        t1 = time.perf_counter()
    else:
        from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

        from gradaccum_tpu_torch.ops import flash_attention

        # on the card CUDA activity alone: recording every host op would slow
        # the host and inflate the idle time (the CPU tests trace the host)
        acts = [ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU]
        # the first profiler window of a process can record no device event
        with torch_profile(activities=acts):
            torch.ones(8, device=dev).add_(1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        launched = flash_attention.launch_counts()
        with torch_profile(activities=acts) as prof:
            with record_function(profile.WINDOW):
                setup_s = time.time() - t_process
                t0 = time.perf_counter()
                est.train(_feed(pool, lambda: len(fed) >= TRACE_UPDATES, fed))
                t1 = time.perf_counter()
        window = profile.reduce(prof)
        del prof
        launched = {k: v - launched[k] for k, v in flash_attention.launch_counts().items()}
        if window is not None:
            print(f"[bench] trace: {len(window.kernels)} kernels, {len(window.other)} copies "
                  f"and memsets, {len(window.host)} host events; flash launches counted "
                  f"{launched}", file=log)
    last_loss = float(est.last_loss)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    name_of_card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    del est, state, bundle, opt, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference, after the window, on the same inputs
    t_ref = time.perf_counter()
    ref = reference(cell, run_seed, dev, "f32", batches[:steps])
    ref_s = time.perf_counter() - t_ref
    if detail is not None:
        detail.update(prog=prog, ref=ref)
    numbers = compare.gaps(prog, ref, k)
    limits = work["limits"]
    correct = compare.verdict(numbers, limits)
    gc.collect()

    # -- metrics
    fl = ref_model.flop_layers(rcfg)
    micro = mix["micro_batch"]
    window_flops, lengths = 0.0, []
    for batch in fed:
        rows = traffic.row_lengths(batch)
        window_flops += flops.train_flops(fl, rows)
        lengths += [rows[i * micro:(i + 1) * micro] for i in range(k)]
    ctx = SimpleNamespace(
        cell=cell, rcfg=rcfg, precision=precision, updates=len(fed),
        tokens=sum(traffic.real_tokens(mix, b) for b in fed), window_s=t1 - t0,
        setup_s=setup_s, peak_bytes=peak, model_flops=window_flops, micro_lengths=lengths,
        seq=mix["seq_len"], causal=fl["causal"], masked=mix["rows"] == "padded",
        window=window, flash_launched=launched,
        peaks=peaks.peaks_for(name_of_card), log=log)
    metrics = spec.read_metrics(cell["per_layer"] if trace else cell["end_to_end"], ctx)

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name_of_card,
                   "count": 1, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device_info["power"] = _power_limit()
    if window is not None:
        device_info["busy_s"] = window.busy_ns() / 1e9
        device_info["window_s"] = window.window_ns / 1e9
    result = {"correct": correct, "attempted": steps + len(fed),
              "failed": sum(not math.isfinite(v) for v in prog["losses"])
              + (not math.isfinite(last_loss)),
              "metrics": metrics, "device": device_info}
    if window is not None:
        result["breakdown"] = window.breakdown()
    split = [(label, t - prev) for (label, t), prev in
             zip(marks, [t_process] + [t for _, t in marks[:-1]])]
    print("[bench] set-up split (s): " + "; ".join(f"{label} {sec:.3f}" for label, sec in split),
          file=log)
    print(f"[bench] {name} seed={seed} updates={len(fed)} window_s={t1 - t0:.3f} "
          f"setup_s={setup_s:.3f} reference_s={ref_s:.3f} "
          f"tokens/s={ctx.tokens / (t1 - t0):.1f}", file=log)
    result["checks"] = {key: {"value": numbers[key], "limit": limits[key]} for key in limits}
    return result


def reference(cell: dict, seed: int, device, prec: str, batches=None) -> dict:
    """The reference's readings of the cell's first steps at ``prec`` (f32,
    tf32, fp8; ``nn.py``), TF32 switched off unless ``prec`` is tf32; the
    batches are made again from the seed unless given."""
    work, mix = cell["work"], cell["mix"]
    ref_model = families.load(cell["config"]["family"]).reference
    rcfg = ref_model.model_cfg(cell["config"])
    run_seed = int(seed) % 2**63
    steps = work["check_steps"]
    if batches is None:
        batches = traffic.updates(mix, run_seed, steps)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = prec == "tf32"
    try:
        return ref_steps.follow(ref_model, rcfg,
                                weights.make(ref_model.param_specs(rcfg), rcfg["std"], run_seed,
                                             device),
                                batches, run_seed, mix["num_micro_batches"],
                                work["learning_rate"], work["weight_decay"], work["clip_norm"],
                                prec, work["reference_block_rows"], steps,
                                WORKING_COPY[work["precision"]])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def check_lines(result: dict) -> str:
    """The numbers compared, each beside its limit, for the end of stderr."""
    return "\n".join(f"check {key}: {c['value']!r} (limit {c['limit']!r})"
                     for key, c in result["checks"].items())
