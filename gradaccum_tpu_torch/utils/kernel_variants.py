"""Time variants of the float32 forward kernel against the checkout's, on the card.

A variant is ``csrc/flash_attention.cu`` with a few exact text
substitutions (each must match the source exactly once), so a design
choice can be measured without a switch in the kernel. Every source is
built with the package's nvcc flags (a variant into
``build/variants/<name>/``), each variant's o and lse are held against the
checkout's, and ``flash_fwd`` of each is timed at the float32 shapes
``chip_smoke.py`` times (dropout 0.1): BERT-Small [8, 8, 128, 64] with a
padded mask, GPT-Small [8, 8, 512, 64] causal, gpt_lm [16, 4, 64, 32]
causal. Card time per call is the device time of the kernel in
torch.profiler's events over 50 back-to-back calls, taken in turns: the
checkout, each variant, each variant again in reverse order, the checkout.

    python3 -m gradaccum_tpu_torch.utils.kernel_variants q_twin_tile

prints one line per shape and one JSON object as its last line.
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


def _kernel_ms(fn, iters=50, warmup=5):
    """Device time (ms) per call of the events named flash_fwd_kernel."""
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
                and "flash_fwd_kernel" in e.key)
    if total == 0:
        raise RuntimeError("the profiler saw no flash_fwd_kernel event")
    return total / iters / 1e3


def main(argv=None) -> int:
    import torch

    from gradaccum_tpu_torch.ops import flash_attention as fa

    names = sys.argv[1:] if argv is None else list(argv)
    if not names or any(name not in VARIANTS for name in names):
        print(f"usage: kernel_variants VARIANT... (of {', '.join(VARIANTS)})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants needs a card", file=sys.stderr)
        return 2
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
    print(json.dumps({"variants": names, "device": torch.cuda.get_device_name(0),
                      "shapes": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
