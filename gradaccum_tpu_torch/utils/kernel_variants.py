"""Time variants of the flash kernels against the checkout's, on the card.

Two kinds of variant:

- A float32 variant is ``csrc/flash_attention.cu`` with a few exact text
  substitutions (each must match the source exactly once), so a design
  choice can be measured without a switch in the kernel. Each variant's
  forward, dq and dk/dv outputs are held against the checkout's, and all
  three kernels are timed at the float32 shapes below (``--f32-source``'s).
- A whole source given by path, for example an earlier commit's, written
  with ``git show`` into a directory that ``.gitignore`` lists: a
  bfloat16 ``flash_attention_tc.cu`` (``--tc-source``) or a float32
  ``flash_attention.cu`` (``--f32-source``). It is built beside the
  checkout's (with the shared headers of its own directory where it has
  them, else the checkout's). The checkout's forward, dq and dk/dv outputs
  (o, lse, dq, delta, dk, dv, dmask) are held against the variant's, and
  all three kernels are timed, each through the package's wrapper with the
  variant's library swapped in. bfloat16: at every bfloat16 shape
  ``chip_smoke.py`` times, BERT-Small [8, 8, 128, 64] padded mask,
  GPT-Small [8, 8, 512, 64] causal (both dropout 0.1), and the
  long-context shapes [32, 8, 512, 64], [8, 8, 2048, 64] and
  [2, 8, 8192, 64] with a padded mask (dropout 0). float32: BERT-Small,
  GPT-Small and gpt_lm [16, 4, 64, 32] causal (dropout 0.1), and
  [2, 8, 8192, 64] with a padded mask (dropout 0), where the products bound
  the kernels; there SDPA's time (EFFICIENT_ATTENTION, as
  ``chip_smoke.py``'s timing pins it) stands beside them. Beside each card
  time stand the kernel's bound and the wrapper's wall time per call with
  its dispatch (CUDA events over back-to-back calls); a closing line per
  kernel gives its card times at every shape in the order of the turns.

Every source is built with the package's nvcc flags (a variant into
``build/variants/<name>/``). Card time per call is the device time of the
kernel in torch.profiler's events over 50 back-to-back calls, taken in
turns: the checkout, each variant, each variant again in reverse order,
the checkout.

    python3 -m gradaccum_tpu_torch.utils.kernel_variants fwd_pv_waited
    git show REV:gradaccum_tpu_torch/csrc/flash_attention_tc.cu \
        > build/parent/flash_attention_tc.cu
    git show REV:gradaccum_tpu_torch/csrc/flash_attention.cu \
        > build/parent/flash_attention.cu
    python3 -m gradaccum_tpu_torch.utils.kernel_variants \
        --tc-source build/parent/flash_attention_tc.cu \
        --f32-source build/parent/flash_attention.cu

prints one line per shape (and kernel) and one JSON object as its last
line.
"""

from __future__ import annotations

import json
import shutil
import sys

from gradaccum_tpu_torch.utils import cuda_build

# The float32 kernels' design choices, each undone: the exact exp and
# cvt.rna.tf32 roundings in the element-wise work of all three (expf_cvt);
# K1's P V waited for within its stage, which is released there, so that
# the next stage's S no longer runs beside it (fwd_pv_waited); K3's dV and
# dK products left in flight while the next stage's S^T and dP^T are
# issued, the stage released only after them (dkv_in_flight); K2's loop
# written so that it may run no time, which makes ptxas serialize every
# wgmma of the kernel (loop_may_skip, C7515 in the build log).
_ELEMENTWISE_EXP = ("          float pt = exp_fast(sT[4 * n + e] * p.scale",
                    "          float pt = exp_fast(s[4 * n + e] * p.scale",
                    "          float pt = exp_fast(x[4 * n + e] - (e < 2 ? base_a : base_b));",
                    "      const float corr_a = exp_fast(m_a - base_a), "
                    "corr_b = exp_fast(m_b - base_b);")
_DKV_SS_WAIT = ("    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs<kRows / 2>(sT);\n"
                "    fence_regs<kRows / 2>(dpT);\n")
_DKV_RS_WAIT = ("    wgmma_commit();\n"
                "    // waited for here, not with the next stage's products: the stage is then\n"
                "    // released a stage earlier, and with two stages the producer has the\n"
                "    // whole next stage's time to copy and split into it\n"
                "    wgmma_wait_all();\n    fence_regs<D / 2>(dv);\n    fence_regs<D / 2>(dk);\n"
                "    mbar_arrive(&bars.empty[st]);\n  } while (++tile < n_tiles);\n")
_FWD_RELEASE = ("    fence_regs<D / 2>(acc);\n"
                "    if (tile > 0) mbar_arrive(&bars.empty[(tile - 1) % L::kStages]);\n")
_FWD_PV = ("      mma3_rs<D, kKeys>(acc, pa[c], stage + 3 * L::kTile, stage + 4 * L::kTile, c);\n"
           "    wgmma_commit();\n")
VARIANTS = {}
VARIANTS["expf_cvt"] = [
    *((old, old.replace("exp_fast(", "expf(")) for old in _ELEMENTWISE_EXP),
    ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n", "  return to_tf32(x);\n"),
]
VARIANTS["fwd_pv_waited"] = [
    (_FWD_RELEASE, "    fence_regs<D / 2>(acc);\n"),
    (_FWD_PV, _FWD_PV + "    wgmma_wait_all();\n    fence_regs<D / 2>(acc);\n"
                        "    mbar_arrive(&bars.empty[st]);\n"),
]
VARIANTS["dkv_in_flight"] = [
    (_DKV_SS_WAIT, _DKV_SS_WAIT + "    fence_regs<D / 2>(dv);\n    fence_regs<D / 2>(dk);\n"
                   "    if (tile > 0) mbar_arrive(&bars.empty[(tile - 1) % L::kStages]);\n"),
    (_DKV_RS_WAIT, "    wgmma_commit();\n  } while (++tile < n_tiles);\n  wgmma_wait_all();\n"
                   "  fence_regs<D / 2>(dv);\n  fence_regs<D / 2>(dk);\n"),
]
VARIANTS["loop_may_skip"] = [
    ("  int tile = 0;  // every block has a stage: a do loop, as in K3\n  do {\n",
     "  for (int tile = 0; tile < n_tiles; ++tile) {\n"),
    ("    wgmma_commit();\n  } while (++tile < n_tiles);\n"
     "  wgmma_wait_all();\n  fence_regs<D / 2>(dq);\n",
     "    wgmma_commit();\n  }\n  wgmma_wait_all();\n  fence_regs<D / 2>(dq);\n"),
]
SOURCE = "flash_attention"
RATE, SEED = 0.1, 0x5EED1234


def variant_source(name: str) -> str:
    text = (cuda_build.CSRC_DIR / f"{SOURCE}.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build_variant(name: str):
    """The variant's library (its path), compiled beside copies of the
    shared headers."""
    out = cuda_build.BUILD_DIR.parent / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    source = out / f"{SOURCE}.cu"
    source.write_text(variant_source(name))
    lib = out / f"lib{SOURCE}.so"
    cuda_build.compile_source(source, lib)
    return lib


def _inputs(shape, masked):
    import torch

    b, _, s, _ = shape
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(*shape, generator=g, device="cuda") for _ in range(3))
    mask = None
    if masked:
        lengths = torch.randint(s // 4, s + 1, (b,), generator=g, device="cuda")
        pad = torch.arange(s, device="cuda")[None, :] >= lengths[:, None]
        mask = (pad.float() * -1e9).reshape(b, 1, 1, s).contiguous()
    return q, k, v, mask


def _kernel_ms(fn, kernel="flash_fwd_kernel", iters=50, warmup=5, tries=3):
    """Device time (ms) per call of the events whose name holds ``kernel``
    (every device event of the window when ``kernel`` is empty). A late
    profiler window sometimes records no device event (PERF.md §7): after
    ``tries`` such windows the time is CUDA events' over the same calls, and
    a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and kernel in e.key)
        if total:
            return total / iters / 1e3
    print(f"[variants] the profiler saw no {kernel or 'device'} event in {tries} windows: "
          f"CUDA events over {iters} calls")
    return _wall_ms(fn, iters, warmup=0)


def _wall_ms(fn, iters=50, warmup=5):
    """Wall time per call (ms) of back-to-back calls between two CUDA events:
    the host's dispatch where it is slower than the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def parse_args(argv):
    """``(float32 variant names, bf16 source path or None, float32 source
    path or None)``; raises ValueError on a name that is not in VARIANTS, a
    source that is not a ``.cu`` file, or nothing given."""
    import argparse

    parser = argparse.ArgumentParser(prog="kernel_variants", add_help=False)
    parser.add_argument("names", nargs="*")
    parser.add_argument("--tc-source", default=None)
    parser.add_argument("--f32-source", default=None)
    args, unknown = parser.parse_known_args(list(argv))
    if unknown:
        raise ValueError(f"unknown arguments {unknown}")
    bad = [name for name in args.names if name not in VARIANTS]
    if bad:
        raise ValueError(f"no float32 variant {bad} (of {', '.join(VARIANTS)})")
    for flag, path in (("--tc-source", args.tc_source), ("--f32-source", args.f32_source)):
        if path is not None and not path.endswith(".cu"):
            raise ValueError(f"{flag} takes a .cu file, got {path}")
    if not args.names and args.tc_source is None and args.f32_source is None:
        raise ValueError("name a float32 variant or give --tc-source or --f32-source")
    return args.names, args.tc_source, args.f32_source


def stage_source(path, out_dir, name):
    """Copy the source at ``path`` into ``out_dir`` as ``<name>.cu``, beside
    the shared headers it includes: those of its own directory where it has
    them, else the checkout's. Returns the staged source's path."""
    from pathlib import Path

    path, out_dir = Path(path), Path(out_dir)
    if not path.is_file():
        raise FileNotFoundError(f"no source at {path}")
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC_DIR.glob("*.cuh"):
        own = path.parent / header.name
        shutil.copy(own if own.is_file() else header, out_dir / header.name)
    staged = out_dir / f"{name}.cu"
    if path.resolve() != staged.resolve():
        shutil.copy(path, staged)
    return staged


TC_SOURCE = "flash_attention_tc"
# (label, shape, padded mask, causal, dropout rate): chip_smoke.py's bf16 timings
TC_SHAPES = [("bert", (8, 8, 128, 64), True, False, RATE),
             ("gpt", (8, 8, 512, 64), False, True, RATE),
             ("long512", (32, 8, 512, 64), True, False, 0.0),
             ("long2048", (8, 8, 2048, 64), True, False, 0.0),
             ("long8192", (2, 8, 8192, 64), True, False, 0.0)]
# chip_smoke.py's float32 timings, and the long shape where products bound
# the kernels
F32_SHAPES = [("bert", (8, 8, 128, 64), True, False, RATE),
              ("gpt", (8, 8, 512, 64), False, True, RATE),
              ("gpt_lm", (16, 4, 64, 32), False, True, RATE),
              ("long8192", (2, 8, 8192, 64), True, False, 0.0)]
# the profiler's name of each kernel, by route
TC_KERNELS = {"flash_fwd": "flash_fwd_tc_kernel", "flash_bwd_dq": "flash_dq_tc_kernel",
              "flash_bwd_dkv": "flash_dkv_tc_kernel"}
F32_KERNELS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_dq_kernel",
               "flash_bwd_dkv": "flash_dkv_kernel"}
# |checkout - variant| <= ATOL + RTOL*|variant|: each side is within
# chip_smoke.py's TOL of the plain version, so twice that
TC_TOL = {"o": (2e-2, 2e-2), "lse": (2e-4, 2e-4), "dq": (2e-2, 2e-2), "delta": (2e-5, 2e-5),
          "dk": (2e-2, 2e-2), "dv": (2e-2, 2e-2), "dmask": (2e-3, 2e-3)}
F32_TOL = {"o": (2e-5, 2e-5), "lse": (2e-5, 2e-5), "dq": (2e-4, 2e-4), "delta": (2e-5, 2e-5),
           "dk": (2e-4, 2e-4), "dv": (2e-4, 2e-4), "dmask": (2e-4, 2e-4)}
# route -> (source name, dtype name, shapes, tolerances, profiler names)
ROUTES = {"tc": (TC_SOURCE, "bfloat16", TC_SHAPES, TC_TOL, TC_KERNELS),
          "tf32x3": (SOURCE, "float32", F32_SHAPES, F32_TOL, F32_KERNELS)}
# H100 SXM data-sheet peaks, as chip_smoke.py's bounds take them: bytes/s,
# and FLOP/s by dtype (float32: 3xTF32's 495 TFLOP/s of TF32 over three)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}


def bound_ms(name, shape, dtype, masked, causal):
    """``(ms, "bytes" or "operations")``: the least time for kernel
    ``name``'s work at ``shape``, chip_smoke.py's ``_bounds``: the bytes it
    must move (inputs read once, outputs written once) over the memory
    rate, against its matrix-product FLOPs (half when causal) over the
    dtype's peak."""
    b, h, s, d = shape
    e = 2 if dtype == "bfloat16" else 4
    act, row = b * h * s * d * e, b * h * s * 4
    mask = b * s * e if masked else 0
    pairs = b * h * s * s * d // (2 if causal else 1)
    nbytes, flops = {
        "flash_fwd": (3 * act + mask + 8 + act + row, 4 * pairs),
        "flash_bwd_dq": (5 * act + row + mask + 8 + act + row, 6 * pairs),
        "flash_bwd_dkv": (4 * act + 2 * row + mask + 8 + 2 * act + (row if masked else 0),
                          8 * pairs),
    }[name]
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library(route, path):
    """The library at ``path`` with the functions of ``route`` bound."""
    import ctypes

    from gradaccum_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(str(path))
    for name, symbol in fa._SOURCES[route][1].items():
        fn = getattr(lib, symbol)
        fn.argtypes = fa._ARGTYPES[name]
        fn.restype = fa._I
    return lib


def build_source_variant(route, path):
    """The library of the ``route`` source at ``path``, built into
    ``build/variants/<route>/``."""
    name = ROUTES[route][0]
    out = cuda_build.BUILD_DIR.parent / "variants" / route
    staged = stage_source(path, out, name)
    lib = out / f"lib{name}.so"
    cuda_build.compile_source(staged, lib)
    return lib


def _compare(fa, route, libs, label, shape, masked, causal, rate):
    """The checkout's forward, dq and dk/dv outputs against each other
    library's in ``libs`` on one case, within the route's tolerances; the
    backward kernels of all take the checkout's o and lse and the delta of
    that o. Returns the largest differences, by library, and the inputs, for
    the timing."""
    import torch

    _, dtype, _, tol, _ = ROUTES[route]
    q, k, v, mask, do, seed = _variant_inputs(shape, masked, rate, getattr(torch, dtype))
    fa._libs[route] = libs["checkout"]
    o_in, lse_in = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)
    delta_in = fa._delta(do, o_in)
    outs = {}
    for key in libs:
        fa._libs[route] = libs[key]
        o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)
        dq, delta = fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, o_in, lse_in, causal, rate)
        dk, dv, dm = fa.flash_bwd_dkv_cuda(q, k, v, mask, seed, do, lse_in, delta_in, causal,
                                           rate)
        outs[key] = {"o": o, "lse": lse, "dq": dq, "delta": delta, "dk": dk, "dv": dv}
        if masked:
            outs[key]["dmask"] = dm
    torch.cuda.synchronize()
    diffs = {}
    for key in libs:
        if key == "checkout":
            continue
        for name, got in outs["checkout"].items():
            want = outs[key][name].float()
            err = (got.float() - want).abs()
            atol, rtol = tol[name]
            diffs.setdefault(key, {})[name] = float(err.max())
            if not bool(got.isfinite().all()) or not bool((err <= atol + rtol * want.abs()).all()):
                raise RuntimeError(f"{label}: the checkout's {name} differs from {key}'s by "
                                   f"{float(err.max()):.3e} (> {atol} + {rtol}|{key}|)")
    return diffs, (q, k, v, mask, do, seed, o_in, lse_in, delta_in)


def _variant_inputs(shape, masked, rate, dtype):
    import torch

    q, k, v, mask = _inputs(shape, masked)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    mask = None if mask is None else mask.to(dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    do = torch.randn(*shape, generator=g, device="cuda").to(dtype)
    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda") if rate else None
    return q, k, v, mask, do, seed


def _sdpa_ms(q, k, v, mask, do, causal, rate):
    """SDPA's forward and backward (dq + dk + dv in one call) card ms,
    EFFICIENT_ATTENTION pinned as chip_smoke.py's timing pins it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        fwd = _kernel_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, is_causal=causal), "", iters=10)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, dropout_p=rate,
                                           is_causal=causal)
    bwd = _kernel_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True), "",
                     iters=10)
    return fwd, bwd


def run_source(route, source) -> dict:
    """The checkout's kernels of ``route`` against the variant at
    ``source``, on the card: outputs held against each other, then card and
    wall time of each kernel in turns (checkout, variant, variant,
    checkout), each beside its bound."""
    from gradaccum_tpu_torch.ops import flash_attention as fa

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc each
        variant = pool.submit(build_source_variant, route, source)
        fa.build_kernels()
        libs = {"checkout": fa._libs[route], "variant": _library(route, variant.result())}
    return _run_turns(route, libs, ["checkout", "variant", "variant", "checkout"])


def _run_turns(route, libs, order) -> dict:
    """At every shape of ``route``: the libraries' outputs held against the
    checkout's, then each kernel's card and wall time with each library
    swapped into the wrapper in ``order``, beside its bound."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    _, dtype, shapes, _, kernels = ROUTES[route]
    result = {}
    try:
        for label, shape, masked, causal, rate in shapes:
            diffs, (q, k, v, mask, do, seed, o, lse, delta) = _compare(
                fa, route, libs, label, shape, masked, causal, rate)
            calls = {
                "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, o, lse,
                                                             causal, rate),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(q, k, v, mask, seed, do, lse,
                                                               delta, causal, rate),
            }
            ms = {name: {key: [] for key in libs} for name in calls}
            wall = {name: {key: [] for key in libs} for name in calls}
            for name, fn in calls.items():
                for key in order:
                    fa._libs[route] = libs[key]
                    ms[name][key].append(_kernel_ms(fn, kernels[name]))
                    wall[name][key].append(_wall_ms(fn))
            bounds = {name: bound_ms(name, shape, dtype, masked, causal) for name in calls}
            row = {"shape": list(shape), "mask": masked, "causal": causal, "rate": rate,
                   "max_abs_diff": diffs, "ms": ms, "wall_ms": wall,
                   "bound_ms": {name: b[0] for name, b in bounds.items()}}
            sdpa = ""
            if dtype == "float32" and label == "long8192":
                fwd, bwd = _sdpa_ms(q, k, v, mask, do, causal, rate)
                row["sdpa_ms"] = {"forward": fwd, "backward": bwd}
                sdpa = f"; sdpa EFFICIENT_ATTENTION forward {fwd:.4f} ms, backward {bwd:.4f} ms"
            result[label] = row
            for name in calls:
                print(f"[variants] {label} {dtype} {list(shape)} mask={int(masked)} "
                      f"causal={int(causal)} rate={rate} {name}: card ms " + ", ".join(
                          f"{key} {' '.join(f'{t:.4f}' for t in ts)}"
                          for key, ts in ms[name].items())
                      + f" (bound {bounds[name][0]:.5f} ms by {bounds[name][1]})"
                      + "; wall ms a call " + ", ".join(
                          f"{key} {' '.join(f'{t:.4f}' for t in ts)}"
                          for key, ts in wall[name].items()))
            print(f"[variants] {label}: checkout against each, max |diff| {diffs}{sdpa}")
            del q, k, v, mask, do, o, lse, delta, calls
            torch.cuda.empty_cache()
    finally:
        fa._libs[route] = libs["checkout"]
    _print_turns(result, order, kernels)
    return result


def _print_turns(result, order, kernels=TC_KERNELS):
    """One line per kernel: its card ms at every shape in the order the
    turns were taken, and the variant's time over the checkout's."""
    for name in kernels:
        cells = []
        for label, row in result.items():
            taken = {key: iter(ts) for key, ts in row["ms"][name].items()}
            turns = " ".join(f"{next(taken[key]):.4f}" for key in order)
            base = sum(row["ms"][name]["checkout"]) / len(row["ms"][name]["checkout"])
            ratios = ", ".join(f"{key}/checkout {sum(ts) / len(ts) / base:.2f}"
                               for key, ts in row["ms"][name].items() if key != "checkout")
            cells.append(f"{label} {turns} ({ratios})")
        print(f"[variants] {name} card ms in turns ({', '.join(order)}): " + "; ".join(cells))


def run_f32(names) -> dict:
    """The checkout's float32 kernels against each text variant in
    ``names``: outputs held against the checkout's, then every kernel timed
    in turns (the checkout, each variant, each again in reverse order, the
    checkout) at F32_SHAPES."""
    from gradaccum_tpu_torch.ops import flash_attention as fa

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:  # one nvcc each
        builds = {name: pool.submit(build_variant, name) for name in names}
        fa.build_kernels()
        libs = {"checkout": fa._libs["tf32x3"]}
        libs.update((name, _library("tf32x3", future.result()))
                    for name, future in builds.items())
    return _run_turns("tf32x3", libs, ["checkout", *names, *reversed(names), "checkout"])


def _power_limit():
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    import torch

    try:
        names, tc_source, f32_source = parse_args(sys.argv[1:] if argv is None else argv)
    except ValueError as e:
        print(f"usage: kernel_variants [VARIANT...] [--tc-source PATH] [--f32-source PATH]: {e} "
              f"(float32 variants: {', '.join(VARIANTS)})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants needs a card", file=sys.stderr)
        return 2
    card = _power_limit()
    print(f"[variants] {card}")
    out = {"device": torch.cuda.get_device_name(0), "card": card}
    if names:
        out.update(variants=names, shapes=run_f32(names))
    if tc_source is not None:
        out.update(tc_source=tc_source, tc_shapes=run_source("tc", tc_source))
    if f32_source is not None:
        out.update(f32_source=f32_source, f32_shapes=run_source("tf32x3", f32_source))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
