"""Time variants of the flash kernels against the checkout's, on the card.

Two kinds of variant:

- A float32 variant is ``csrc/flash_attention.cu`` with a few exact text
  substitutions (each must match the source exactly once), so a design
  choice can be measured without a switch in the kernel. Each variant's o
  and lse are held against the checkout's, and ``flash_fwd`` of each is
  timed at the float32 shapes ``chip_smoke.py`` times (dropout 0.1):
  BERT-Small [8, 8, 128, 64] with a padded mask, GPT-Small
  [8, 8, 512, 64] causal, gpt_lm [16, 4, 64, 32] causal.
- A bfloat16 variant is a whole ``flash_attention_tc.cu`` given by path
  (``--tc-source``), for example an earlier commit's, written with
  ``git show`` into a directory that ``.gitignore`` lists. It is built
  beside the checkout's (with the shared headers of its own directory where
  it has them, else the checkout's). The checkout's forward, dq and dk/dv
  outputs are held against the variant's, and all three kernels are timed,
  each through the package's wrapper with the variant's library swapped in,
  at every bfloat16 shape ``chip_smoke.py`` times: BERT-Small
  [8, 8, 128, 64] padded mask, GPT-Small [8, 8, 512, 64] causal (both
  dropout 0.1), and the long-context shapes [32, 8, 512, 64],
  [8, 8, 2048, 64] and [2, 8, 8192, 64] with a padded mask (dropout 0).
  Beside each card time stands the wrapper's wall time per call with its
  dispatch (CUDA events over back-to-back calls); a closing line per
  kernel gives its card times at every shape in the order of the turns.

Every source is built with the package's nvcc flags (a variant into
``build/variants/<name>/``). Card time per call is the device time of the
kernel in torch.profiler's events over 50 back-to-back calls, taken in
turns: the checkout, each variant, each variant again in reverse order,
the checkout.

    python3 -m gradaccum_tpu_torch.utils.kernel_variants q_twin_tile
    git show REV:gradaccum_tpu_torch/csrc/flash_attention_tc.cu \
        > build/parent/flash_attention_tc.cu
    python3 -m gradaccum_tpu_torch.utils.kernel_variants \
        --tc-source build/parent/flash_attention_tc.cu

prints one line per shape (and kernel) and one JSON object as its last
line.
"""

from __future__ import annotations

import json
import shutil
import sys

from gradaccum_tpu_torch.utils import cuda_build

_LOAD_A_SPLIT = """// The same A fragment from a tile that split_tile has split: the big parts
// in the tile, the small parts `small` floats after it
template <int D>
__device__ __forceinline__ void load_a_split(Split<4>& a, const float* tile, int small,
                                             int row0, int col0, int g, int t) {
  const float* r = tile + (row0 + g) * (D + kPad) + col0 + t;
  constexpr int kB = 8 * (D + kPad);
  a.big[0] = __float_as_uint(r[0]);
  a.small[0] = __float_as_uint(r[small]);
  a.big[1] = __float_as_uint(r[kB]);
  a.small[1] = __float_as_uint(r[small + kB]);
  a.big[2] = __float_as_uint(r[4]);
  a.small[2] = __float_as_uint(r[small + 4]);
  a.big[3] = __float_as_uint(r[kB + 4]);
  a.small[3] = __float_as_uint(r[small + kB + 4]);
}

"""
_B_ANCHOR = "// The B operands come from streamed tiles that split_tile has split: the"
_WAIT = "    cp_async_wait<1>();  // this stage (and Q) landed; the next may be in flight\n"
_Q_AT_USE = ("        Split<4> qa;\n"
             "        load_a<D>(qa, q_s, warp * 16, kk * 8, g, t);\n")
VARIANTS = {
    # K1 splits its Q rows once, when they land with the first stage, into a
    # twin tile of small parts (twice the shared memory for Q), and reads its
    # A fragments already split, instead of splitting each where it is used
    "q_twin_tile": [
        (_B_ANCHOR, _LOAD_A_SPLIT + _B_ANCHOR),
        ("  float* kv_s = q_s + kBlockRows * kStride;",
         "  float* kv_s = q_s + 2 * kBlockRows * kStride;"),
        (_WAIT, _WAIT + "    if (stage == 0) split_tile<D, kBlockRows>(q_s, kBlockRows * "
                        "(D + kPad));\n"),
        (_Q_AT_USE, _Q_AT_USE.replace(
            "load_a<D>(qa, q_s,", "load_a_split<D>(qa, q_s, kBlockRows * (D + kPad),")),
        ("((kBlockRows + 8 * kStage) * (D + kPad) + 2 * kStage)",
         "((2 * kBlockRows + 8 * kStage) * (D + kPad) + 2 * kStage)"),
    ],
}
SOURCE = "flash_attention"
# (label, shape, padded mask, causal)
SHAPES = [("bert", (8, 8, 128, 64), True, False),
          ("gpt", (8, 8, 512, 64), False, True),
          ("gpt_lm", (16, 4, 64, 32), False, True)]
RATE, SEED = 0.1, 0x5EED1234


def variant_source(name: str) -> str:
    text = (cuda_build.CSRC_DIR / f"{SOURCE}.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build_variant(name: str):
    """The variant's library, compiled beside copies of the shared headers."""
    import ctypes

    out = cuda_build.BUILD_DIR.parent / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    source = out / f"{SOURCE}.cu"
    source.write_text(variant_source(name))
    lib = out / f"lib{SOURCE}.so"
    cuda_build.compile_source(source, lib)
    return ctypes.CDLL(str(lib))


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


def _forward(lib, q, k, v, mask, seed, causal):
    """``flash_fwd`` of ``lib`` as the wrapper calls it: ``(o, lse)``."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1] + (1,), device=q.device)
    err = lib.flash_fwd(0, q.shape[-1], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        None if mask is None else mask.data_ptr(), seed.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), *fa._scalar_args(q, causal, RATE))
    if err != 0:
        raise RuntimeError(f"flash_fwd failed with cudaError {err}")
    return o, lse


def _kernel_ms(fn, kernel="flash_fwd_kernel", iters=50, warmup=5):
    """Device time (ms) per call of the events whose name holds ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key)
    if total == 0:
        raise RuntimeError(f"the profiler saw no {kernel} event")
    return total / iters / 1e3


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
    """``(float32 variant names, bf16 source path or None)``; raises
    ValueError on a name that is not in VARIANTS, a source that is not a
    ``.cu`` file, or neither given."""
    import argparse

    parser = argparse.ArgumentParser(prog="kernel_variants", add_help=False)
    parser.add_argument("names", nargs="*")
    parser.add_argument("--tc-source", default=None)
    args, unknown = parser.parse_known_args(list(argv))
    if unknown:
        raise ValueError(f"unknown arguments {unknown}")
    bad = [name for name in args.names if name not in VARIANTS]
    if bad:
        raise ValueError(f"no float32 variant {bad} (of {', '.join(VARIANTS)})")
    if args.tc_source is not None and not args.tc_source.endswith(".cu"):
        raise ValueError(f"--tc-source takes a .cu file, got {args.tc_source}")
    if not args.names and args.tc_source is None:
        raise ValueError("name a float32 variant or give --tc-source")
    return args.names, args.tc_source


def stage_tc_source(path, out_dir):
    """Copy the bf16 source at ``path`` into ``out_dir`` as
    ``flash_attention_tc.cu``, beside the shared headers it includes: those
    of its own directory where it has them, else the checkout's. Returns
    the staged source's path."""
    from pathlib import Path

    path, out_dir = Path(path), Path(out_dir)
    if not path.is_file():
        raise FileNotFoundError(f"no bf16 source at {path}")
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC_DIR.glob("*.cuh"):
        own = path.parent / header.name
        shutil.copy(own if own.is_file() else header, out_dir / header.name)
    staged = out_dir / f"{TC_SOURCE}.cu"
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
# the profiler's name of each bf16 kernel
TC_KERNELS = {"flash_fwd": "flash_fwd_tc_kernel", "flash_bwd_dq": "flash_dq_tc_kernel",
              "flash_bwd_dkv": "flash_dkv_tc_kernel"}
# |checkout - variant| <= ATOL + RTOL*|variant|: each side is within
# chip_smoke.py's bf16 TOL of the plain version, so twice that
TC_TOL = {"o": (2e-2, 2e-2), "lse": (2e-4, 2e-4), "dq": (2e-2, 2e-2), "delta": (2e-5, 2e-5),
          "dk": (2e-2, 2e-2), "dv": (2e-2, 2e-2), "dmask": (2e-3, 2e-3)}


def _tc_library(path):
    import ctypes

    from gradaccum_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(str(path))
    for name, symbol in fa._SOURCES["tc"][1].items():
        fn = getattr(lib, symbol)
        fn.argtypes = fa._ARGTYPES[name]
        fn.restype = fa._I
    return lib


def build_tc_variant(path):
    """The library of the bf16 source at ``path``, built into
    ``build/variants/tc/``."""
    out = cuda_build.BUILD_DIR.parent / "variants" / "tc"
    staged = stage_tc_source(path, out)
    lib = out / f"lib{TC_SOURCE}.so"
    cuda_build.compile_source(staged, lib)
    return lib


def _tc_compare(fa, libs, label, shape, masked, causal, rate):
    """The checkout's forward, dq and dk/dv outputs against the variant's on
    one case, within TC_TOL; the backward kernels of both take the
    checkout's o and lse and the delta of that o. Returns the largest
    differences and the inputs, for the timing."""
    import torch

    q, k, v, mask, do, seed = _tc_inputs(shape, masked, rate)
    fa._libs["tc"] = libs["checkout"]
    o_in, lse_in = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)
    delta_in = fa._delta(do, o_in)
    outs = {}
    for key in ("checkout", "variant"):
        fa._libs["tc"] = libs[key]
        o, lse = fa.flash_fwd_cuda(q, k, v, mask, seed, causal, rate)
        dq, delta = fa.flash_bwd_dq_cuda(q, k, v, mask, seed, do, o_in, lse_in, causal, rate)
        dk, dv, dm = fa.flash_bwd_dkv_cuda(q, k, v, mask, seed, do, lse_in, delta_in, causal,
                                           rate)
        outs[key] = {"o": o, "lse": lse, "dq": dq, "delta": delta, "dk": dk, "dv": dv}
        if masked:
            outs[key]["dmask"] = dm
    torch.cuda.synchronize()
    diffs = {}
    for name, got in outs["checkout"].items():
        want = outs["variant"][name].float()
        err = (got.float() - want).abs()
        atol, rtol = TC_TOL[name]
        diffs[name] = float(err.max())
        if not bool(got.isfinite().all()) or not bool((err <= atol + rtol * want.abs()).all()):
            raise RuntimeError(f"{label}: the checkout's {name} differs from the variant's "
                               f"by {diffs[name]:.3e} (> {atol} + {rtol}|variant|)")
    return diffs, (q, k, v, mask, do, seed, o_in, lse_in, delta_in)


def _tc_inputs(shape, masked, rate):
    import torch

    q, k, v, mask = _inputs(shape, masked)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    mask = None if mask is None else mask.to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    do = torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda") if rate else None
    return q, k, v, mask, do, seed


def run_tc(source) -> dict:
    """The checkout's bf16 kernels against the variant at ``source``, on
    the card: outputs held against each other, then card and wall time of
    each kernel in turns (checkout, variant, variant, checkout)."""
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc each
        variant = pool.submit(build_tc_variant, source)
        fa.build_kernels()
        libs = {"checkout": fa._libs["tc"], "variant": _tc_library(variant.result())}
    order = ["checkout", "variant", "variant", "checkout"]
    result = {}
    try:
        for label, shape, masked, causal, rate in TC_SHAPES:
            diffs, (q, k, v, mask, do, seed, o, lse, delta) = _tc_compare(
                fa, libs, label, shape, masked, causal, rate)
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
                    fa._libs["tc"] = libs[key]
                    ms[name][key].append(_kernel_ms(fn, TC_KERNELS[name]))
                    wall[name][key].append(_wall_ms(fn))
            result[label] = {"shape": list(shape), "mask": masked, "causal": causal,
                             "rate": rate, "max_abs_diff": diffs, "ms": ms, "wall_ms": wall}
            for name in calls:
                print(f"[variants] {label} {list(shape)} mask={int(masked)} causal={int(causal)} "
                      f"rate={rate} {name}: card ms " + ", ".join(
                          f"{key} {' '.join(f'{t:.4f}' for t in ts)}"
                          for key, ts in ms[name].items())
                      + "; wall ms a call " + ", ".join(
                          f"{key} {' '.join(f'{t:.4f}' for t in ts)}"
                          for key, ts in wall[name].items()))
            print(f"[variants] {label}: checkout against variant, max |diff| {diffs}")
            del q, k, v, mask, do, o, lse, delta, calls
            torch.cuda.empty_cache()
    finally:
        fa._libs["tc"] = libs["checkout"]
    _print_turns(result, order)
    return result


def _print_turns(result, order):
    """One line per kernel: its card ms at every shape in the order the
    turns were taken, and the variant's time over the checkout's."""
    for name in TC_KERNELS:
        cells = []
        for label, row in result.items():
            taken = {key: iter(ts) for key, ts in row["ms"][name].items()}
            turns = " ".join(f"{next(taken[key]):.4f}" for key in order)
            ratio = (sum(row["ms"][name]["variant"]) / sum(row["ms"][name]["checkout"]))
            cells.append(f"{label} {turns} (variant/checkout {ratio:.2f})")
        print(f"[variants] {name} card ms in turns ({', '.join(order)}): " + "; ".join(cells))


def run_f32(names) -> dict:
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:  # one nvcc each
        builds = {name: pool.submit(build_variant, name) for name in names}
        libs = {"checkout": cuda_build.load(SOURCE)}
        libs.update((name, future.result()) for name, future in builds.items())
    for lib in libs.values():
        lib.flash_fwd.argtypes = fa._ARGTYPES["flash_fwd"]
        lib.flash_fwd.restype = fa._I
    seed = torch.tensor([SEED], dtype=torch.int64, device="cuda")
    order = ["checkout", *names, *reversed(names), "checkout"]
    result = {}
    for label, shape, masked, causal in SHAPES:
        q, k, v, mask = _inputs(shape, masked)
        o_a, lse_a = _forward(libs["checkout"], q, k, v, mask, seed, causal)
        diffs = {}
        for name in names:
            o_b, lse_b = _forward(libs[name], q, k, v, mask, seed, causal)
            torch.cuda.synchronize()
            diffs[name] = max(float((o_a - o_b).abs().max()),
                              float((lse_a - lse_b).abs().max()))
            if not diffs[name] <= 1e-5:
                raise RuntimeError(f"{name} at {label}: o/lse differ by {diffs[name]:.3e}")
        times = {key: [] for key in libs}
        for key in order:
            times[key].append(_kernel_ms(
                lambda lib=libs[key]: _forward(lib, q, k, v, mask, seed, causal)))
        result[label] = {"shape": list(shape), "max_abs_diff": diffs, "ms": times}
        print(f"[variants] {label} {list(shape)} mask={int(masked)} causal={int(causal)}: "
              + ", ".join(f"{key} {' '.join(f'{t:.4f}' for t in ts)} ms"
                          for key, ts in times.items())
              + f" (o/lse max |diff| against the checkout {diffs})")
    return result


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
        names, tc_source = parse_args(sys.argv[1:] if argv is None else argv)
    except ValueError as e:
        print(f"usage: kernel_variants [VARIANT...] [--tc-source PATH]: {e} "
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
        out.update(tc_source=tc_source, tc_shapes=run_tc(tc_source))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
