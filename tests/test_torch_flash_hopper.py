"""The Hopper designs of the bf16 forward (K1), dq (K2) and dk/dv (K3)
kernels, on the CPU.

No compiler and no card run here, so this file holds what the CPU can:

- the launch geometry that ``csrc/flash_attention_tc.cu`` chooses in C,
  written out here as :func:`tc_geometry` (its constants read back out of
  the source): every supported head dim and sequence length fits a
  block's shared memory, every tensor map's box fits its swizzle, K2's
  maps are maps K1 and K3 already use, and BERT-Small's [8, 8, 128, 64]
  still launches a block per SM;
- that the three kernels issue ``wgmma.mma_async`` and TMA copies
  (``cp.async.bulk.tensor``) on mbarrier stages, following the source's
  calls from each kernel down to the PTX it reaches, and that no
  ``mma.sync``, ``ldmatrix`` or ``cp.async`` of the design they replaced
  is left in the source;
- that the library exports the counts of its tensor-map cache that the
  wrapper reads;
- the arguments of ``utils/kernel_variants.py`` that time a whole bf16
  source (an earlier commit's) against the checkout's on the card.
"""

import re

import pytest

from gradaccum_tpu_torch.ops import flash_attention as fa
from gradaccum_tpu_torch.utils import cuda_build, kernel_variants

pytestmark = pytest.mark.torch

# The launch geometry of the bf16 forward (K1), dq (K2) and dk/dv (K3)
# kernels as csrc/flash_attention_tc.cu chooses it in C: its constants
# (kWgRows, kMaxConsumers, kFwdKeys, kDkvStages, kDqKeys, kDqStages,
# max_consumers, fwd_stages, dkv_rows, kSmemLimit; read back out of the
# source below) and its rule (consumers_for, FwdLayout, DqLayout,
# DkvLayout), written out here
TC_WG_ROWS = 64  # rows of one consumer warpgroup: wgmma's M
TC_MAX_CONSUMERS = 2  # consumer warpgroups per block, at most
TC_FWD_KEYS = 128  # keys per K1 stage
TC_DKV_STAGES = 3  # query stages of K3
TC_DQ_KEYS = 64  # keys per K2 stage
TC_DQ_STAGES = 3  # key/value stages of K2
TC_SMEM_LIMIT = 232448  # dynamic shared memory an H100 block may opt into


def tc_max_consumers(d: int) -> int:
    return 1 if d == 128 else TC_MAX_CONSUMERS


def tc_fwd_stages(d: int) -> int:
    return 2 if d == 128 else 3


def tc_dkv_rows(d: int) -> int:
    return 32 if d == 128 else 64


def tc_geometry(kernel: str, shape, sm_count: int = 132, causal: bool = False) -> dict:
    """How the bf16 ``flash_fwd``, ``flash_bwd_dq`` or ``flash_bwd_dkv`` kernel launches on
    q of ``shape`` [B, H, S, D] on a card of ``sm_count`` SMs: consumer
    warpgroups per block (two, 128 rows, when the kernel has room for two,
    as it has below D = 128, and the grid of 128-row blocks fills every SM
    at least once; else one, 64 rows), threads (a producer warpgroup
    beside them), grid (row blocks, H, B), or (H, B, row blocks)
    when ``causal``, and blocks, stages and rows per stage, the
    dynamic shared memory asked for (1024 bytes of alignment slack
    included), and the box of each tensor map: (columns, rows) of one
    panel of min(D, 64) columns, swizzled over 2·min(D, 64) bytes."""
    b, h, s, d = shape
    most = tc_max_consumers(d)
    big = TC_MAX_CONSUMERS * TC_WG_ROWS
    consumers = TC_MAX_CONSUMERS if most > 1 and b * h * -(-s // big) >= sm_count else 1
    rows = consumers * TC_WG_ROWS
    room = most * TC_WG_ROWS  # the rows the kernel instance's layout holds
    panel = min(d, 64)
    if kernel == "flash_fwd":
        stages, stream = tc_fwd_stages(d), TC_FWD_KEYS
        fixed = room * d * 2  # Q
        per_stage = 2 * stream * d * 2 + stream * 4  # K, V, the mask row
        barriers = 1 + 4 * stages
        boxes = {"q": (panel, TC_WG_ROWS), "k": (panel, stream), "v": (panel, stream)}
    elif kernel == "flash_bwd_dq":
        stages, stream = TC_DQ_STAGES, TC_DQ_KEYS
        fixed = 2 * room * d * 2  # Q, dO
        per_stage = 2 * stream * d * 2 + stream * 4  # K, V, the mask row
        barriers = 1 + 3 * stages
        # dO in K3's boxes (two a warpgroup at D = 128), so that K2 shares its map
        boxes = {"q": (panel, TC_WG_ROWS), "k": (panel, stream), "v": (panel, stream),
                 "dout": (panel, tc_dkv_rows(d))}
    elif kernel == "flash_bwd_dkv":
        stages, stream = TC_DKV_STAGES, tc_dkv_rows(d)
        fixed = 2 * room * d * 2 + room * 4  # K, V, the key mask
        per_stage = 2 * stream * d * 2 + 3 * stream * 4  # Q, dO, lse, delta, seeds
        barriers = 2 + 3 * stages
        boxes = {"k": (panel, TC_WG_ROWS), "v": (panel, TC_WG_ROWS),
                 "q": (panel, stream), "dout": (panel, stream)}
    else:
        raise ValueError(f"{kernel}: the bf16 kernels are flash_fwd, flash_bwd_dq and "
                         f"flash_bwd_dkv")
    grid = (h, b, -(-s // rows)) if causal else (-(-s // rows), h, b)
    return {"consumers": consumers, "threads": 128 * (consumers + 1), "rows_per_block": rows,
            "grid": grid, "blocks": grid[0] * grid[1] * grid[2], "stages": stages,
            "stream_rows": stream, "smem_bytes": fixed + stages * per_stage + 8 * barriers + 1024,
            "boxes": boxes, "swizzle_bytes": 2 * panel}


SOURCE = cuda_build.CSRC_DIR / "flash_attention_tc.cu"
# the Hopper primitives (mbarriers, TMA, wgmma's fences and descriptors, the
# tensor-map cache) that the bf16 and float32 sources share
HEADER = cuda_build.CSRC_DIR / "hopper.cuh"
HOPPER = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _with_header(source=SOURCE):
    """A source's text with the shared Hopper header's after it: the
    functions a kernel reaches."""
    return source.read_text() + HEADER.read_text()
SEQS = (1, 16, 64, 100, 128, 129, 200, 256, 512, 1000, 2048, 8192, 16384)


def _blank(text):
    """``text`` with the insides of string literals and comments replaced
    by spaces (same length, newlines kept), so that braces and parentheses
    can be matched."""
    out, i, n = list(text), 0, len(text)
    while i < n:
        if text.startswith("//", i):
            start, end = i, text.find("\n", i) % (n + 1)
        elif text.startswith("/*", i):
            start, end = i, text.index("*/", i) + 2
        elif text[i] in "\"'":
            end = i + 1
            while text[end] != text[i]:
                end += 2 if text[end] == "\\" else 1
            start, end = i + 1, end  # the quotes stay
        else:
            i += 1
            continue
        for k in range(start, end):
            if out[k] != "\n":
                out[k] = " "
        i = end + 1
    return "".join(out)


def _functions(text):
    """``{name: body}`` of every __device__ or __global__ function."""
    blank = _blank(text)
    found = {}
    for m in re.finditer(r"\b(__device__|__global__)\b", blank):
        # the function's parameter list is the last top-level (...) before
        # its body; its name the identifier in front of it
        depth, i, last_open = 0, m.end(), None
        while True:
            ch = blank[i]
            if ch == "(":
                if depth == 0:
                    last_open = i
                depth += 1
            elif ch == ")":
                depth -= 1
            elif depth == 0 and ch in "{;":
                break
            i += 1
        if ch == ";":
            continue
        name = re.search(r"(\w+)\s*$", blank[:last_open]).group(1)
        depth, j = 0, i
        while True:
            depth += {"{": 1, "}": -1}.get(blank[j], 0)
            j += 1
            if depth == 0:
                break
        found[name] = (text[i:j], blank[i:j])
    return found


def _reached(text, kernel):
    """The PTX text of ``kernel`` and of every function it reaches."""
    funcs = _functions(text)
    seen, todo = set(), [kernel]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        calls = re.findall(r"\b(\w+)\s*(?:<[^;(){}]*>)?\s*\(", funcs[name][1])
        todo += [c for c in calls if c in funcs]
    return "".join(funcs[name][0] for name in seen), seen


@pytest.mark.parametrize("kernel", ["flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                                    "flash_dkv_tc_kernel"])
def test_hopper_kernels_issue_wgmma_on_tma_stages(kernel):
    """K1, K2 and K3 reach wgmma from shared-memory descriptors, TMA copies
    completing on mbarriers, the named barriers of the consumers' turns
    and setmaxnreg; none of the mma.sync design's instructions; one __syncthreads
    (after the barriers' init), none in the loop. The PTX helpers they reach
    live in the shared header hopper.cuh."""
    text = _with_header()
    ptx, reached = _reached(text, kernel)
    for instruction in ("wgmma.mma_async", "wgmma.fence", "wgmma.commit_group",
                        "wgmma.wait_group", "cp.async.bulk.tensor", "mbarrier.try_wait",
                        "mbarrier.arrive.expect_tx", "bar.sync", "bar.arrive",
                        "setmaxnreg.inc", "setmaxnreg.dec"):
        assert instruction in ptx, (kernel, instruction)
    for instruction in ("mma.sync", "ldmatrix", "cp.async.cg", "cp.async.commit_group"):
        assert instruction not in ptx, (kernel, instruction, sorted(reached))
    body = _functions(text)[kernel][1]
    assert body.count("__syncthreads()") == 1


def _code(text):
    """``text`` without its comments: the code and its string literals (the
    asm templates among them)."""
    return re.sub(r"//[^\n]*", "", re.sub(r"/\*.*?\*/", "", text, flags=re.S))


@pytest.mark.parametrize("instruction", ["mma.sync", "ldmatrix", "cp.async.cg",
                                         "cp.async.commit_group", "cp.async.wait_group"])
def test_no_instruction_of_the_mma_sync_design_is_left(instruction):
    """The mma.sync design is gone from the whole bf16 source, not only
    from the kernels' reach: no code names its instructions (the header's
    comment still tells of it), so no switch or fallback can reach it."""
    assert instruction not in _code(SOURCE.read_text())


def test_every_kernel_of_the_source_is_a_hopper_kernel():
    """Each __global__ function of the bf16 source is one of the three
    Hopper kernels, launched through launch_hopper with its tensor maps,
    and nothing launches through flash::launch (the mma.sync kernels'
    launch, gone with them)."""
    code = _code(SOURCE.read_text())
    kernels = set(re.findall(r"__global__\s[^;{]*?(\w+)\(const Params\b", code))
    assert kernels == {"flash_fwd_tc_kernel", "flash_dq_tc_kernel", "flash_dkv_tc_kernel"}
    for kernel in kernels:
        assert re.search(rf"launch_hopper<\w+, {kernel}<D>>", code), kernel
    assert "flash::launch" not in code


def test_source_reader_finds_every_kernel():
    funcs = _functions(_with_header())
    assert {"flash_fwd_tc_kernel", "flash_dq_tc_kernel", "flash_dkv_tc_kernel"} <= set(funcs)
    assert "wgmma.mma_async" in funcs["wgmma_ss"][0]
    assert "cp.async.bulk.tensor" in funcs["tma_load"][0]


def test_geometry_constants_are_the_sources():
    """tc_geometry's constants and stage rules are the ones the kernels
    are compiled with."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kWgRows") == TC_WG_ROWS
    assert const("kMaxConsumers") == TC_MAX_CONSUMERS
    assert const("kFwdKeys") == TC_FWD_KEYS
    assert const("kDkvStages") == TC_DKV_STAGES
    assert const("kDqKeys") == TC_DQ_KEYS
    assert const("kDqStages") == TC_DQ_STAGES
    assert const("kSmemLimit") == TC_SMEM_LIMIT
    for name, rule in (("max_consumers", tc_max_consumers),
                       ("fwd_stages", tc_fwd_stages), ("dkv_rows", tc_dkv_rows)):
        d, a, b = map(int, re.search(
            rf"{name}\(\) \{{ return D == (\d+) \? (\d+) : (\d+); \}}", text).groups())
        assert [rule(x) for x in fa._SUPPORTED_D] == [a if x == d else b
                                                       for x in fa._SUPPORTED_D]


@pytest.mark.parametrize("kernel", HOPPER)
@pytest.mark.parametrize("d", fa._SUPPORTED_D)
def test_every_head_dim_and_length_fits_a_block(kernel, d):
    """At every supported D and at every S, one or two consumer
    warpgroups: the block's shared memory within the 227 KiB an H100 block
    may opt into, every box inside its swizzle span (TMA: at most the
    swizzle's bytes per box row, at most 256 rows), whole k16 steps per
    stage, and 1024-byte aligned tiles for the swizzle atoms."""
    for s in SEQS:
        for b, h in ((1, 1), (2, 8), (8, 8), (32, 8), (64, 16)):
            geo = tc_geometry(kernel, (b, h, s, d))
            assert geo["smem_bytes"] <= TC_SMEM_LIMIT, (s, geo)
            assert 1 <= geo["consumers"] <= tc_max_consumers(d)
            assert geo["threads"] == 128 * (geo["consumers"] + 1) <= 384
            assert geo["grid"][0] * geo["rows_per_block"] >= s
            causal = tc_geometry(kernel, (b, h, s, d), causal=True)
            assert causal["grid"] == (h, b, geo["grid"][0]) and causal["blocks"] == geo["blocks"]
            assert geo["stream_rows"] % 16 == 0
            for cols, rows in geo["boxes"].values():
                assert 2 * cols == geo["swizzle_bytes"] <= 128
                assert rows <= 256 and rows % 8 == 0
                assert (rows * 2 * cols) % 1024 == 0


def test_bert_shape_keeps_a_block_per_sm():
    """BERT-Small's [8, 8, 128, 64] launches 128 blocks of one consumer
    warpgroup (64 rows) in all three kernels, as the mma.sync kernels did;
    the long-context shapes launch 128-row blocks of two."""
    for kernel in HOPPER:
        geo = tc_geometry(kernel, (8, 8, 128, 64))
        assert geo["blocks"] >= 128 and geo["consumers"] == 1, geo
        for shape in ((32, 8, 512, 64), (8, 8, 2048, 64), (2, 8, 8192, 64), (8, 8, 512, 64)):
            assert tc_geometry(kernel, shape)["consumers"] == 2, shape


@pytest.mark.parametrize("kernel", ["flash_bwd", "flash_dq_tc_kernel", ""])
def test_geometry_rejects_an_unknown_kernel(kernel):
    with pytest.raises(ValueError):
        tc_geometry(kernel, (8, 8, 128, 64))


@pytest.mark.parametrize("d", fa._SUPPORTED_D)
def test_dq_kernel_adds_no_tensor_map(d):
    """The map cache keys a map on (tensor, box rows) at a given D: each
    map K2 asks for is one K1 or K3 already asks for in the same layer, so
    a layer's backward holds no more maps than before K2 used TMA."""
    def maps(kernel):
        return {(name, rows) for name, (_, rows) in
                tc_geometry(kernel, (8, 8, 512, d))["boxes"].items()}

    assert maps("flash_bwd_dq") <= maps("flash_fwd") | maps("flash_bwd_dkv")


def test_map_counts_are_exported():
    """The wrapper's tc_map_counts reads two functions of the bf16 library;
    the source exports both, taking no argument and returning a count of
    the shared header's cache."""
    exported = set(re.findall(r'extern "C" long long (\w+)\(\)', SOURCE.read_text()))
    assert set(fa._MAP_COUNTS.values()) == exported
    assert re.search(r"static constexpr int kSize = (\d+);", HEADER.read_text())


@pytest.mark.parametrize("argv, want", [
    (["--tc-source", "build/parent/flash_attention_tc.cu"],
     ([], "build/parent/flash_attention_tc.cu", None)),
    (["fwd_pv_waited"], (["fwd_pv_waited"], None, None)),
    (["fwd_pv_waited", "--tc-source", "x/flash_attention_tc.cu"],
     (["fwd_pv_waited"], "x/flash_attention_tc.cu", None)),
    (["--f32-source", "build/parent/flash_attention.cu"],
     ([], None, "build/parent/flash_attention.cu")),
    (["--tc-source", "p/flash_attention_tc.cu", "--f32-source", "p/flash_attention.cu"],
     ([], "p/flash_attention_tc.cu", "p/flash_attention.cu")),
])
def test_kernel_variants_arguments(argv, want):
    assert kernel_variants.parse_args(argv) == want


@pytest.mark.parametrize("argv", [[], ["no_such_variant"], ["--tc-source", "x.cuh"],
                                  ["--tc-source"], ["--bogus"], ["--f32-source", "x.cuh"],
                                  ["--f32-source"]])
def test_kernel_variants_refuses_bad_arguments(argv):
    with pytest.raises((ValueError, SystemExit)):
        kernel_variants.parse_args(argv)


def test_kernel_variants_main_prints_usage_on_bad_arguments(capsys):
    assert kernel_variants.main(["no_such_variant"]) == 2
    assert "usage" in capsys.readouterr().err


@pytest.mark.parametrize("own_header", [False, True])
def test_tc_source_is_staged_beside_its_headers(tmp_path, own_header):
    """A bf16 source given by path is copied under the library's name
    beside the shared headers: its own directory's where it has them (an
    earlier commit's), else the checkout's."""
    parent = tmp_path / "parent"
    parent.mkdir()
    src = parent / "flash_attention_tc.cu"
    src.write_text('#include "flash_common.cuh"\n// the parent\n')
    if own_header:
        (parent / "flash_common.cuh").write_text("// the parent's header\n")
    staged = kernel_variants.stage_source(src, tmp_path / "out", kernel_variants.TC_SOURCE)
    assert staged.name == "flash_attention_tc.cu"
    assert staged.read_text() == src.read_text()
    header = (tmp_path / "out" / "flash_common.cuh").read_text()
    checkout = (cuda_build.CSRC_DIR / "flash_common.cuh").read_text()
    assert header == ("// the parent's header\n" if own_header else checkout)
    with pytest.raises(FileNotFoundError):
        kernel_variants.stage_source(parent / "missing.cu", tmp_path / "out2",
                                     kernel_variants.TC_SOURCE)


def test_turns_are_printed_in_the_order_taken(capsys):
    """The closing line of a bf16 comparison gives each kernel's card ms at
    every shape in the order the turns ran, and the variant over the
    checkout."""
    order = ["checkout", "variant", "variant", "checkout"]
    ms = {name: {"checkout": [1.0, 1.2], "variant": [2.0, 2.4]}
          for name in kernel_variants.TC_KERNELS}
    kernel_variants._print_turns({"long8192": {"ms": ms}}, order)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(kernel_variants.TC_KERNELS)
    assert "flash_bwd_dq" in lines[1]
    assert "long8192 1.0000 2.0000 2.4000 1.2000 (variant/checkout 2.00)" in lines[1]


def test_map_encoder_binds_the_context_first():
    """cuTensorMapEncodeTiled is a driver call that fails with
    CUDA_ERROR_INVALID_CONTEXT in a thread where the runtime has not yet
    made the device's context current (autograd's device thread, when the
    attention's backward is the first node it runs): the cache binds it,
    once per thread, before its first encode. The cache is the shared
    header's, and the bf16 source encodes through it alone."""
    assert "cuTensorMapEncodeTiled" not in _code(SOURCE.read_text())
    assert "tensor_map(&args.q, p.q, kBf16," in _code(SOURCE.read_text())
    code = _code(HEADER.read_text())
    body = code[code.index("bool tensor_map("):]
    body = body[:body.index("\n}\n")]
    assert "thread_local const bool bound" in body
    assert body.index("cudaSetDevice(dev)") < body.index("encode(&cache.maps[slot]")
