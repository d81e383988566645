"""The Hopper designs of the float32 forward (K1), dq (K2) and dk/dv (K3)
kernels, on the CPU.

``flash_fwd_kernel``, ``flash_dq_kernel`` and ``flash_dkv_kernel`` in
``csrc/flash_attention.cu`` run only on the card: a producer warpgroup
copies stages with TMA, splits each float32 tile into TF32 big and small
parts and writes the transposes that TF32 ``wgmma`` needs (it reads float32
operands K-major only), and a consumer warpgroup multiplies in 3xTF32. No
compiler and no card run here, so this file holds what the CPU can:

- the launch geometry the source chooses (its constants read back out of
  it): every supported head dim fits a block's shared memory, whole k8
  steps per stage, and BERT-Small's [8, 8, 128, 64] keeps 128 blocks;
- the addresses: the split pass's writes of a 128-byte-swizzled K-major
  float32 panel (64- and 32-byte at narrow tiles), read back through the
  wgmma descriptor's layout, give the raw tiles and their transposes Vᵀ,
  Qᵀ, dOᵀ and Kᵀ element for element, in the k order in which the
  accumulator of S becomes the register A of the next product; K1's V pass
  writes only the transposes and leaves V raw; and the transposed stores
  meet no bank conflict;
- a numpy walk of the three kernels' schedules (blocks of 64 rows, stages
  with rows past S zero, edge stages masked per warp, K1's online softmax
  rescaled once a stage, the keep bits at each (query, key), Δ and dmask,
  every product in 3xTF32 in wgmma's k-by-8 order) held against JAX's
  ``_flash_forward`` and ``_flash_backward`` in float32 (their Pallas
  kernels in interpret mode) at ``chip_smoke.py``'s tolerances, 1e-5 +
  1e-5·|ref| for o and lse, 1e-4 + 1e-4·|ref| for the gradients; the same
  walks with one TF32 product per product, or with a wrong edge rule, miss
  them;
- the source: the three kernels issue ``cp.async.bulk.tensor`` and TF32
  ``wgmma``, nothing of the ``mma.sync`` design is left in the file, and
  the float32 library encodes its tensor maps through the shared cache,
  which binds the device's context first.
"""

import importlib
import re
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_dq_tiles import _hash
from test_torch_flash_hopper import HEADER, _code, _functions, _reached

from gradaccum_tpu_torch.ops import flash_attention as fa
from gradaccum_tpu_torch.utils import cuda_build

pytestmark = pytest.mark.torch

jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")

SOURCE = cuda_build.CSRC_DIR / "flash_attention.cu"
TEXT = SOURCE.read_text()
WG_ROWS = 64  # rows a consumer warpgroup owns: wgmma's M, a block's rows
THREADS = 256  # the consumer warpgroup and the producer warpgroup
SMEM_LIMIT = 232448  # dynamic shared memory an H100 block may opt into
TOL = dict(atol=1e-4, rtol=1e-4)  # chip_smoke.py's float32 TOL for dq, dk, dv, dmask
FWD_TOL = dict(atol=1e-5, rtol=1e-5)  # and for o and lse
BLOCK = 50  # JAX's tiles: a divisor of every S below
RATE = 0.1
SEED = 0x3C1A5EED
GOLDEN = 0x9E3779B9


def _rule(name):
    """The source's ``name<D>()``: ``return D == x ? a : b;``."""
    d, a, b = map(int, re.search(
        rf"{name}\(\) \{{ return D == (\d+) \? (\d+) : (\d+); \}}", TEXT).groups())
    return lambda x: a if x == d else b


dkv_rows, dkv_stages = _rule("dkv_rows"), _rule("dkv_stages")
dq_keys, dq_stages = _rule("dq_keys"), _rule("dq_stages")
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def f32_geometry(kernel, d):
    """Rows per stage, stages and dynamic shared memory (1024 bytes of
    alignment slack included) of K1 (``flash_fwd``), K3 (``flash_bwd_dkv``)
    or K2 (``flash_bwd_dq``) at head dim ``d``, as FwdLayout, DkvLayout and
    DqLayout lay it out: two own tiles of 64 rows (Q, big and small) and per
    stage five tiles (K big and small, V raw, Vᵀ big and small) and the mask
    row (K1); or four own tiles (K, V or Q, dO, each big and small), then
    per stage eight tiles (Q, dO and their transposes, big and small) and
    lse, delta and row seeds (K3), or six (K, V, Kᵀ) and the mask row (K2);
    then the key mask (K3) and 2 + 3 per stage barriers."""
    own = 4 * WG_ROWS * d * 4
    if kernel == "flash_fwd":  # K2's key stages
        rows, stages = dq_keys(d), dq_stages(d)
        per_stage = 5 * rows * d * 4 + rows * 4
        fixed = own // 2
    elif kernel == "flash_bwd_dkv":
        rows, stages = dkv_rows(d), dkv_stages(d)
        per_stage = 8 * rows * d * 4 + 3 * rows * 4
        fixed = own + WG_ROWS * 4
    elif kernel == "flash_bwd_dq":
        rows, stages = dq_keys(d), dq_stages(d)
        per_stage = 6 * rows * d * 4 + rows * 4
        fixed = own
    else:
        raise ValueError(kernel)
    return {"rows": rows, "stages": stages,
            "smem": fixed + stages * per_stage + 8 * (2 + 3 * stages) + 1024}


def test_geometry_constants_are_the_sources():
    assert int(re.search(r"constexpr int kWgRows = (\d+);", TEXT).group(1)) == WG_ROWS
    assert int(re.search(r"constexpr int kThreads = (\d+);", TEXT).group(1)) == THREADS
    assert int(re.search(r"constexpr int kSmemLimit = (\d+);", TEXT).group(1)) == SMEM_LIMIT
    assert [dkv_rows(d) for d in fa._SUPPORTED_D] == [32, 32, 32, 8]
    assert [dq_keys(d) for d in fa._SUPPORTED_D] == [32, 32, 32, 16]
    assert [dq_stages(d) for d in fa._SUPPORTED_D] == [3, 3, 3, 2]
    # K1 streams K2's key stages
    assert "kKeys = dq_keys<D>();\n  static constexpr int kStages = dq_stages<D>();" in TEXT
    code = _code(TEXT)
    for layout, kernel in (("FwdLayout", "K1"), ("DkvLayout", "K3"), ("DqLayout", "K2")):
        assert f'static_assert(kSmem <= kSmemLimit, "{kernel}\'s shared memory' in code
        assert f"struct {layout} {{" in code


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("d", fa._SUPPORTED_D)
def test_every_head_dim_fits_a_block(kernel, d):
    """At every supported D the block's shared memory is within the 227 KiB
    a block may opt into, with at least two stages; a stage holds whole k8
    steps, and its tiles start on 1024 bytes (the swizzle's period)."""
    geo = f32_geometry(kernel, d)
    assert geo["smem"] <= SMEM_LIMIT, geo
    assert geo["stages"] >= 2 and geo["rows"] % 8 == 0
    assert (geo["rows"] * d * 4) % 1024 == 0 and (WG_ROWS * d * 4) % 1024 == 0


def test_bert_shape_keeps_a_block_per_sm():
    """[8, 8, 128, 64] launches (S/64, H, B) blocks of 64 rows: 128 blocks
    on 132 SMs, one block an SM (shared memory above half the SM's)."""
    b, h, s, d = 8, 8, 128, 64
    assert -(-s // WG_ROWS) * h * b == 128
    for kernel in KERNELS:
        assert f32_geometry(kernel, d)["smem"] > SMEM_LIMIT // 2


# --------------------------------------------------------------------------
# Addresses: TMA's swizzled panels, the split pass, the wgmma descriptor
# --------------------------------------------------------------------------


def tile32(k):
    """(P, R, panels, k8 steps a panel) of a float32 tile of K columns."""
    p = min(k, 32)
    return p, 4 * p, k // p, p // 8


def tile_off(k, rows, row, col):
    """The source's tile_off<K>: byte offset of (row, col) in a tile of
    ``rows`` rows and ``k`` columns, chunks swizzled over R bytes."""
    p, r, _, _ = tile32(k)
    off = (col // p) * rows * r + row * r + (col % p) * 4
    return off ^ (((off >> 7) & (r // 16 - 1)) << 4)


def k_slot(r):
    return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3)


def descriptor_read(mem, k, rows, row0, kk, n):
    """The n x 8 operand that desc32<K>(tile 0, rows, row0, kk) names, read
    from ``mem`` (float32 words) as the hardware reads a K-major swizzled
    operand: rows 8 R bytes apart by groups of 8 (SBO), R bytes apart in a
    group, the step's 32 bytes from the start address, and the swizzle
    applied to the whole address."""
    _, r, _, steps = tile32(k)
    start = (kk // steps) * rows * r + row0 * r + (kk % steps) * 32
    out = np.empty((n, 8), np.float32)
    for i in range(n):
        for j in range(8):
            a = start + (i // 8) * 8 * r + (i % 8) * r + 4 * j
            a ^= ((a >> 7) & (r // 16 - 1)) << 4
            out[i, j] = mem[a // 4]
    return out


def split_pass(raw, d, rows, transpose, keep_rows=True):
    """The source's split_pass over a raw tile (``raw``: float32 words as
    TMA landed them), thread by thread: returns the big tile, the small twin
    (with ``keep_rows``; without, the tile stays raw and the twin unwritten,
    as K1's pass over V), with ``transpose`` the big and small transposes,
    each as float32 words, and the transposed stores' word addresses per
    (warp, iteration, element) for the bank test."""
    n_words = rows * d
    big, small = raw.copy(), np.full(n_words, np.nan, np.float32)
    t_big, t_small = np.full(n_words, np.nan, np.float32), np.full(n_words, np.nan, np.float32)
    k_it, cols = rows * d // 512, 512 // rows
    stores = {}
    for tid in range(128):
        r, c0 = tid % rows, 4 * (tid // rows)
        for it in range(k_it):
            c = c0 + it * cols
            off = tile_off(d, rows, r, c) // 4
            x = raw[off:off + 4]
            hi, lo = _split(x)
            if keep_rows:
                assert np.isnan(small[off:off + 4]).all(), "a chunk written twice"
                big[off:off + 4], small[off:off + 4] = hi, lo
            if transpose:
                for e in range(4):
                    t = tile_off(rows, d, c + e, k_slot(r)) // 4
                    assert np.isnan(t_big[t]), "a transposed element written twice"
                    t_big[t], t_small[t] = hi[e], lo[e]
                    stores.setdefault((tid // 32, it, e), []).append(t)
    return big, small, t_big, t_small, stores


def _land(x):
    """TMA's landing of a [rows, d] tile: every element at tile_off."""
    rows, d = x.shape
    mem = np.full(rows * d, np.nan, np.float32)
    for r in range(rows):
        for c in range(d):
            mem[tile_off(d, rows, r, c) // 4] = x[r, c]
    assert not np.isnan(mem).any()
    return mem


# (head dim, stage rows): K3's query stages, K1's and K2's key stages and
# the own tiles of all three, at every supported D
SPLIT_CASES = sorted({(d, dkv_rows(d)) for d in fa._SUPPORTED_D}
                     | {(d, dq_keys(d)) for d in fa._SUPPORTED_D}
                     | {(d, WG_ROWS) for d in fa._SUPPORTED_D})


@pytest.mark.parametrize("d, rows", SPLIT_CASES)
def test_split_pass_gives_the_operands_the_descriptors_name(d, rows):
    """TMA lands a [rows, D] tile (Q, dO, K or V) in Tile32<D> panels; the
    split pass writes big = tf32(x) in place, small = tf32(x - big) in the
    same layout, and (for the stages) the big and small transposes. Read
    through the descriptors the kernels build, the big and small tiles are
    the B (or A) of S = Q Kᵀ, k step by k step, and the transposes are the
    B of O += drop(P) V, dS K, dV += drop(Pᵀ) dO and dK += dSᵀ Q: n = d,
    k = the stage's rows, k index l of step c standing for stage row
    8c + 2(l % 4) + l / 4, the row whose value a_split puts at l."""
    x = np.random.default_rng(d * 1000 + rows).normal(size=(rows, d)).astype(np.float32)
    transpose = rows != WG_ROWS
    big, small, t_big, t_small, _ = split_pass(_land(x), d, rows, transpose)
    hi, lo = _split(x)
    for kk in range(d // 8):
        np.testing.assert_array_equal(descriptor_read(big, d, rows, 0, kk, rows),
                                      hi[:, 8 * kk:8 * kk + 8])
        np.testing.assert_array_equal(descriptor_read(small, d, rows, 0, kk, rows),
                                      lo[:, 8 * kk:8 * kk + 8])
    if not transpose:
        return
    order = [2 * (l % 4) + l // 4 for l in range(8)]
    n = min(d, 64)  # at most 64 columns of the accumulator a wgmma
    for c in range(rows // 8):
        stage_rows = [8 * c + o for o in order]
        for half in range(d // n):
            for mem, want in ((t_big, hi), (t_small, lo)):
                got = descriptor_read(mem, rows, d, half * n, c, n)
                np.testing.assert_array_equal(got, want[stage_rows, half * n:half * n + n].T)


@pytest.mark.parametrize("d", fa._SUPPORTED_D)
def test_v_pass_writes_only_the_transposes(d):
    """K1's pass over a V stage (split_pass<D, kKeys, false, true>) leaves
    the raw tile as TMA landed it, writes no twin, and writes Vᵀ big and
    small whole: every element of both transposes, read through the
    descriptor of O += drop(P) V, is the split of V in a_split's k order."""
    rows = dq_keys(d)
    x = np.random.default_rng(d).normal(size=(rows, d)).astype(np.float32)
    raw = _land(x)
    big, small, t_big, t_small, _ = split_pass(raw, d, rows, True, keep_rows=False)
    np.testing.assert_array_equal(big, raw)
    assert np.isnan(small).all()
    assert not np.isnan(t_big).any() and not np.isnan(t_small).any()
    hi, lo = _split(x)
    order = [2 * (l % 4) + l // 4 for l in range(8)]
    n = min(d, 64)
    for c in range(rows // 8):
        stage_rows = [8 * c + o for o in order]
        for half in range(d // n):
            for mem, want in ((t_big, hi), (t_small, lo)):
                got = descriptor_read(mem, rows, d, half * n, c, n)
                np.testing.assert_array_equal(got, want[stage_rows, half * n:half * n + n].T)


@pytest.mark.parametrize("d", fa._SUPPORTED_D)
def test_transposed_stores_are_free_of_bank_conflicts(d):
    """At 32-row stages each warp's transposed store (one element of the
    chunk each lane holds) fills one 128-byte row: 32 different banks."""
    rows = 32
    x = np.zeros((rows, d), np.float32)
    *_, stores = split_pass(_land(x), d, rows, True)
    assert stores
    for words in stores.values():
        assert len(words) == 32 and len({w % 32 for w in words}) == 32


def test_k_slot_inverts_the_a_fragment_order():
    """a_split feeds k index l as stage row 2(l % 4) + l / 4 of its step;
    k_slot sends that row back to l, for every row of a stage."""
    for r in range(64):
        l = k_slot(r) % 8
        assert k_slot(r) // 8 == r // 8 and 2 * (l % 4) + l // 4 == r % 8


# --------------------------------------------------------------------------
# 3xTF32 and the schedules
# --------------------------------------------------------------------------


def tf32(x):
    """``cvt.rna.tf32.f32`` with the low 13 bits cleared (ties away from
    zero: half of the dropped range added to the magnitude bits)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = tf32(x)
    return big, tf32(np.asarray(x, np.float32) - big)


def mm3(a, b, acc=None):
    """acc + a @ b in 3xTF32, k step by k step of 8 (wgmma.m64nNk8): small·big,
    then big·small, then big·big into one float32 accumulator."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        a_big, a_small = _split(a[..., k0:k0 + 8])
        b_big, b_small = _split(b[..., k0:k0 + 8, :])
        out = out + a_small @ b_big
        out = out + a_big @ b_small
        out = out + a_big @ b_big
    return out


def mm1(a, b, acc=None):
    """The same with one TF32 product a k step."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        out = out + tf32(a[..., k0:k0 + 8]) @ tf32(b[..., k0:k0 + 8, :])
    return out


def _keep(h, rows, keys, rate):
    """keep(row seed, key) of the hash dropout for every (b, h) slice:
    [B, H, len(rows), len(keys)] (flash_common.cuh's formula)."""
    threshold = min(round((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)
    out = []
    for bb in range(B):
        per_head = []
        for hh in range(h):
            sseed = _hash(SEED + (bb * h + hh) * GOLDEN)
            rseed = _hash(rows.astype(np.uint64) + sseed * GOLDEN)
            per_head.append(_hash(keys[None, :].astype(np.uint64) + rseed[:, None] * GOLDEN)
                            < threshold)
        out.append(per_head)
    return np.array(out)


def _rows(x, idx, s):
    """Rows ``idx`` of [..., S, ...] along axis 2, zero past S (TMA's fill)."""
    inside = idx < s
    got = np.take(x, np.where(inside, idx, 0), axis=2)
    shape = [1] * got.ndim
    shape[2] = len(idx)
    return np.where(inside.reshape(shape), got, 0).astype(np.float32)


def dkv_edge(i0, rows, key_w, s, causal):
    """K3's per-warp test of a query stage: queries past S, or (causal) a
    query before the warp's last key."""
    return i0 + rows > s or (causal and i0 < key_w + 16)


def dq_edge(j0, keys, row_w, s, causal):
    """K2's per-warp test of a key stage: keys past S, or (causal) a key
    past the warp's first row."""
    return j0 + keys > s or (causal and j0 + keys - 1 > row_w)


def fwd_edge(j0, keys, row_w, s, causal):
    """K1's per-warp test of a key stage, K2's: keys past S, or (causal) a
    key past the warp's first row."""
    return j0 + keys > s or (causal and j0 + keys - 1 > row_w)


def emulate_fwd(q, k, v, mask, causal, rate, mm=mm3, edge_of=fwd_edge):
    """o and lse [B, H, S, 1] as K1 computes them: blocks of 64 queries, key
    stages of dq_keys(D) up to the block's last row when causal,
    S = Q Kᵀ, then per stage s = S·scale + mask_j, −inf past S and past the
    diagonal where a warp of 16 rows finds the stage on its edge, the online
    softmax once a stage (m_new = max(m, the stage's row max), O and l
    rescaled by exp(m − m_new), against 0 while m_new is −inf), p =
    exp(s − m_new), l += p undropped, the keep bits, O += drop(P) V (k = the
    stage's keys); at the end o = O·(1/l) and lse = m + log l."""
    b, h, s, d = q.shape
    keys_a_stage = dq_keys(d)
    scale = np.float32(1.0 / np.sqrt(d))
    inv_keep = np.float32(1.0 / (1.0 - rate)) if rate else np.float32(1.0)
    o = np.zeros_like(q)
    lse = np.zeros((b, h, s, 1), np.float32)
    for q0 in range(0, s, WG_ROWS):
        ri = np.arange(q0, q0 + WG_ROWS)
        qt = _rows(q, ri, s)
        acc = np.zeros((b, h, WG_ROWS, d), np.float32)
        m = np.full((b, h, WG_ROWS, 1), -np.inf, np.float32)
        l = np.zeros((b, h, WG_ROWS, 1), np.float32)  # noqa: E741
        k_end = min(s, q0 + WG_ROWS) if causal else s
        for j0 in range(0, k_end, keys_a_stage):
            kj = np.arange(j0, j0 + keys_a_stage)
            kt, vt = _rows(k, kj, s), _rows(v, kj, s)
            mk = np.zeros((b, 1, keys_a_stage), np.float32)
            if mask is not None:
                mk = _rows(mask[:, :, 0, :, None], kj, s)[..., 0]
            sc = (mm(qt, np.swapaxes(kt, -1, -2)) * scale + mk[..., None, :]).astype(np.float32)
            for w in range(4):
                if edge_of(j0, keys_a_stage, q0 + 16 * w, s, causal):
                    wr = ri[16 * w:16 * w + 16]
                    cut = (kj[None, :] >= s) | (causal & (kj[None, :] > wr[:, None]))
                    sc[:, :, 16 * w:16 * w + 16] = np.where(cut, -np.inf,
                                                            sc[:, :, 16 * w:16 * w + 16])
            m_new = np.maximum(m, sc.max(-1, keepdims=True))
            base = np.where(m_new == -np.inf, np.float32(0), m_new)
            corr = np.exp(m - base, dtype=np.float32)
            p = np.exp(sc - base, dtype=np.float32)
            l = (l * corr + p.sum(-1, keepdims=True, dtype=np.float32))  # noqa: E741
            if rate:
                p = np.where(_keep(h, ri, kj, rate), p * inv_keep, 0).astype(np.float32)
            acc = mm(p, vt, acc * corr)
            m = m_new
        inside = ri < s
        o[:, :, ri[inside]] = (acc * (np.float32(1) / l))[:, :, inside]
        lse[:, :, ri[inside]] = (m + np.log(l))[:, :, inside]
    return o, lse


def emulate_dkv(q, k, v, mask, do, lse, delta, causal, rate, mm=mm3, edge_of=dkv_edge):
    """dk, dv and the per-head dmask [B, H, S] as K3 computes them: blocks
    of 64 keys, query stages of dkv_rows(D) from the block's first key when
    causal, Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, then per warp of 16 keys the edge
    rule, P = exp(Sᵀ·scale + mask_j − lse_i), the keep bits, dSᵀ, and
    dV += drop(Pᵀ) dO, dK += dSᵀ Q (k = the stage's queries) and dmask_j +=
    Σ_i dSᵀ, all in float32; dk scaled once at the end."""
    b, h, s, d = q.shape
    rows = dkv_rows(d)
    scale = np.float32(1.0 / np.sqrt(d))
    inv_keep = np.float32(1.0 / (1.0 - rate)) if rate else np.float32(1.0)
    dk, dv = np.zeros_like(q), np.zeros_like(q)
    dmask = np.zeros((b, h, s), np.float32)
    for k0 in range(0, s, WG_ROWS):
        keys = np.arange(k0, k0 + WG_ROWS)
        kt, vt = _rows(k, keys, s), _rows(v, keys, s)
        mk = np.zeros((b, 1, WG_ROWS), np.float32)
        if mask is not None:
            mk = _rows(mask[:, :, 0, :, None], keys, s)[..., 0]
        acc_dk, acc_dv = np.zeros((b, h, WG_ROWS, d), np.float32), np.zeros((b, h, WG_ROWS, d),
                                                                            np.float32)
        dm = np.zeros((b, h, WG_ROWS), np.float32)
        i_begin = k0 if causal else 0
        for i0 in range(i_begin, s, rows):
            qi = np.arange(i0, i0 + rows)
            qt, dot = _rows(q, qi, s), _rows(do, qi, s)
            ls, de = _rows(lse[..., 0, None], qi, s)[..., 0], _rows(delta[..., None], qi, s)[..., 0]
            st = mm(kt, np.swapaxes(qt, -1, -2))  # [B, H, 64 keys, rows]
            dpt = mm(vt, np.swapaxes(dot, -1, -2))
            pt = np.exp(st * scale + mk[..., :, None] - ls[..., None, :], dtype=np.float32)
            for w in range(4):
                if edge_of(i0, rows, k0 + 16 * w, s, causal):
                    wk = keys[16 * w:16 * w + 16]
                    cut = (qi[None, :] >= s) | (causal & (wk[:, None] > qi[None, :]))
                    pt[:, :, 16 * w:16 * w + 16] = np.where(cut, 0, pt[:, :, 16 * w:16 * w + 16])
            pdrop = pt
            if rate:
                kept = np.swapaxes(_keep(h, qi, keys, rate), -1, -2)  # [B, H, keys, queries]
                dpt = np.where(kept, dpt * inv_keep, 0).astype(np.float32)
                pdrop = np.where(kept, pt * inv_keep, 0).astype(np.float32)
            dst = (pt * (dpt - de[..., None, :])).astype(np.float32)
            dm = dm + dst.sum(-1, dtype=np.float32)
            acc_dv = mm(pdrop, dot, acc_dv)
            acc_dk = mm(dst, qt, acc_dk)
        inside = keys < s
        dk[:, :, keys[inside]] = (acc_dk * scale)[:, :, inside]
        dv[:, :, keys[inside]] = acc_dv[:, :, inside]
        dmask[:, :, keys[inside]] = dm[:, :, inside]
    return dk, dv, dmask


def emulate_dq(q, k, v, mask, do, o, lse, causal, rate, mm=mm3, edge_of=dq_edge):
    """dq and Δ as K2 computes them: blocks of 64 queries, key stages of
    dq_keys(D) up to the block's last row when causal, S = Q Kᵀ and
    dP = dO Vᵀ, per warp of 16 rows the edge rule, P, the keep bits and dS
    in float32, dq += dS K (k = the stage's keys), scaled once at the end;
    Δ = rowsum(dO ⊙ O) in float32."""
    b, h, s, d = q.shape
    keys_a_stage = dq_keys(d)
    scale = np.float32(1.0 / np.sqrt(d))
    inv_keep = np.float32(1.0 / (1.0 - rate)) if rate else np.float32(1.0)
    delta = (do * o).sum(-1, dtype=np.float32)
    dq = np.zeros_like(q)
    for q0 in range(0, s, WG_ROWS):
        ri = np.arange(q0, q0 + WG_ROWS)
        qt, dot = _rows(q, ri, s), _rows(do, ri, s)
        ls, de = _rows(lse[..., 0, None], ri, s)[..., 0], _rows(delta[..., None], ri, s)[..., 0]
        acc = np.zeros((b, h, WG_ROWS, d), np.float32)
        k_end = min(s, q0 + WG_ROWS) if causal else s
        for j0 in range(0, k_end, keys_a_stage):
            kj = np.arange(j0, j0 + keys_a_stage)
            kt, vt = _rows(k, kj, s), _rows(v, kj, s)
            mk = np.zeros((b, 1, keys_a_stage), np.float32)
            if mask is not None:
                mk = _rows(mask[:, :, 0, :, None], kj, s)[..., 0]
            sc = mm(qt, np.swapaxes(kt, -1, -2))  # [B, H, 64 queries, keys]
            dp = mm(dot, np.swapaxes(vt, -1, -2))
            pt = np.exp(sc * scale + mk[..., None, :] - ls[..., :, None], dtype=np.float32)
            for w in range(4):
                if edge_of(j0, keys_a_stage, q0 + 16 * w, s, causal):
                    wr = ri[16 * w:16 * w + 16]
                    cut = (kj[None, :] >= s) | (causal & (kj[None, :] > wr[:, None]))
                    pt[:, :, 16 * w:16 * w + 16] = np.where(cut, 0, pt[:, :, 16 * w:16 * w + 16])
            if rate:
                dp = np.where(_keep(h, ri, kj, rate), dp * inv_keep, 0).astype(np.float32)
            ds = (pt * (dp - de[..., :, None])).astype(np.float32)
            acc = mm(ds, kt, acc)
        inside = ri < s
        dq[:, :, ri[inside]] = (acc * scale)[:, :, inside]
    return dq, delta


B, H = 2, 2
# (S, D, padded mask, causal, dropout rate): ragged lengths around 64-row
# blocks and 32-row stages, every supported head dim (D = 128: 8-query
# stages in K3, 16-key stages in K2), masks, causal, dropout
CASES = {
    "s100_d32_mask": (100, 32, True, False, 0.0),
    "s100_d32_causal_drop": (100, 32, False, True, RATE),
    "s200_d32_mask_causal_drop": (200, 32, True, True, RATE),
    "s200_d16_mask_drop": (200, 16, True, False, RATE),
    "s100_d64_mask_causal_drop": (100, 64, True, True, RATE),
    "s100_d128_mask_drop": (100, 128, True, False, RATE),
}


@lru_cache(maxsize=None)
def _case(name):
    """Inputs (numpy float32) and JAX's float32 forward and backward, in
    interpret mode, under the hash seed the emulation draws with."""
    s, d, masked, causal, rate = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q, k, v, do = (rng.normal(size=(B, H, s, d)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.zeros((B, 1, 1, s), np.float32)
        mask[0, ..., s - 7:] = -1e9
        mask[1, ..., s - 41:] = -1e9
    jm = None if mask is None else jnp.asarray(mask)
    seed = jnp.uint32(SEED)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jfa._flash_forward(jq, jk, jv, jm, seed, BLOCK, BLOCK, True, causal, rate)
    dq, dk, dv, dmask = jfa._flash_backward(jq, jk, jv, jm, seed, o, lse, jdo, BLOCK, BLOCK,
                                            True, causal, rate)
    want = {"o": np.asarray(o), "lse": np.asarray(lse), "dq": np.asarray(dq),
            "dk": np.asarray(dk), "dv": np.asarray(dv),
            "dmask": None if dmask is None else np.asarray(dmask)}
    return (q, k, v, mask, do), (causal, rate), want


def _worst(got, want, tol=TOL):
    return float((np.abs(got - want) / (tol["atol"] + tol["rtol"] * np.abs(want))).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_fwd_schedule_matches_jax(name):
    """K1's schedule in 3xTF32 gives JAX's o and lse within the forward's
    float32 tolerance."""
    (q, k, v, mask, _), (causal, rate), want = _case(name)
    o, lse = emulate_fwd(q, k, v, mask, causal, rate)
    assert np.isfinite(o).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(o, want["o"], err_msg="o", **FWD_TOL)
    np.testing.assert_allclose(lse.reshape(want["lse"].shape), want["lse"], err_msg="lse",
                               **FWD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dkv_schedule_matches_jax(name):
    """K3's schedule in 3xTF32 gives JAX's dk, dv and dmask (summed over
    heads, as JAX returns it) within the float32 tolerance."""
    (q, k, v, mask, do), (causal, rate), want = _case(name)
    delta = (do * want["o"]).sum(-1, dtype=np.float32)
    dk, dv, dmask = emulate_dkv(q, k, v, mask, do, want["lse"], delta, causal, rate)
    assert np.isfinite(dk).all() and np.isfinite(dv).all()
    np.testing.assert_allclose(dk, want["dk"], err_msg="dk", **TOL)
    np.testing.assert_allclose(dv, want["dv"], err_msg="dv", **TOL)
    if mask is not None:
        np.testing.assert_allclose(dmask.sum(1)[:, None, None, :], want["dmask"],
                                   err_msg="dmask", **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dq_schedule_matches_jax(name):
    """K2's schedule in 3xTF32 gives JAX's dq within the float32 tolerance,
    and its Δ is JAX's formula."""
    (q, k, v, mask, do), (causal, rate), want = _case(name)
    dq, delta = emulate_dq(q, k, v, mask, do, want["o"], want["lse"], causal, rate)
    assert np.isfinite(dq).all()
    np.testing.assert_allclose(dq, want["dq"], err_msg="dq", **TOL)
    jdelta = np.asarray(jnp.sum(jnp.asarray(do) * jnp.asarray(want["o"]), axis=-1))
    np.testing.assert_allclose(delta, jdelta, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["s100_d32_mask", "s200_d32_mask_causal_drop"])
def test_one_tf32_product_misses_the_tolerance(name):
    """The comparison is sharp enough to see TF32: the same schedules with
    one TF32 product per product leave the float32 tolerances (the
    forward's for o and lse, and the gradients')."""
    (q, k, v, mask, do), (causal, rate), want = _case(name)
    o, lse = emulate_fwd(q, k, v, mask, causal, rate, mm=mm1)
    worst = max(_worst(o, want["o"], FWD_TOL),
                _worst(lse.reshape(want["lse"].shape), want["lse"], FWD_TOL))
    assert worst > 1.0, f"one TF32 product stayed within the forward's TOL ({worst:.3f})"
    delta = (do * want["o"]).sum(-1, dtype=np.float32)
    dk, dv, _ = emulate_dkv(q, k, v, mask, do, want["lse"], delta, causal, rate, mm=mm1)
    dq, _ = emulate_dq(q, k, v, mask, do, want["o"], want["lse"], causal, rate, mm=mm1)
    worst = max(_worst(dk, want["dk"]), _worst(dv, want["dv"]), _worst(dq, want["dq"]))
    assert worst > 1.0, f"one TF32 product stayed within TOL ({worst:.3f})"


@pytest.mark.parametrize("kernel", ["dkv", "dq", "fwd"])
def test_a_wrong_edge_rule_shows(kernel):
    """The comparison rests on the edge rules: with the causal half of a
    rule forgotten (a stage taken as interior where the kernel masks it)
    the emulation no longer agrees with JAX."""
    (q, k, v, mask, do), (causal, rate), want = _case("s200_d32_mask_causal_drop")
    if kernel == "fwd":
        got = emulate_fwd(q, k, v, mask, causal, rate,
                          edge_of=lambda j0, keys, rw, s, c: j0 + keys > s)[0]
        assert not np.allclose(got, want["o"], **FWD_TOL)
        return
    if kernel == "dkv":
        delta = (do * want["o"]).sum(-1, dtype=np.float32)
        got = emulate_dkv(q, k, v, mask, do, want["lse"], delta, causal, rate,
                          edge_of=lambda i0, rows, kw, s, c: i0 + rows > s)[0]
        ref = want["dk"]
    else:
        got = emulate_dq(q, k, v, mask, do, want["o"], want["lse"], causal, rate,
                         edge_of=lambda j0, keys, rw, s, c: j0 + keys > s)[0]
        ref = want["dq"]
    assert not np.allclose(got, ref, **TOL)


def test_keep_bits_match_jax():
    rows, keys = np.arange(0, 40), np.arange(0, 100)
    want = np.asarray(jfa.dropout_keep_mask(jnp.uint32(SEED), B, H, 100, RATE))
    np.testing.assert_array_equal(_keep(H, rows, keys, RATE), want[:, :, :40])


def test_tf32_split_is_exact_to_2_to_the_minus_22():
    x = np.random.default_rng(5).normal(size=4096).astype(np.float32)
    big, small = _split(x)
    assert ((big.view(np.uint32) & 0x1FFF) == 0).all()
    residual = np.abs(x.astype(np.float64) - big - small) / np.abs(x.astype(np.float64))
    assert residual.max() <= 2.0 ** -22


# --------------------------------------------------------------------------
# The source
# --------------------------------------------------------------------------

WITH_HEADER = TEXT + HEADER.read_text()


@pytest.mark.parametrize("kernel", ["flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"])
def test_backward_kernels_issue_tf32_wgmma_on_tma_stages(kernel):
    """K2 and K3, and since its redesign K1 too, reach TMA copies completing
    on mbarriers, the proxy fence that publishes the split pass's writes to
    wgmma, and wgmma with .tf32 operands, three per product; nothing of the
    mma.sync design: no mma.sync, cp.async.cg or ldmatrix. One __syncthreads
    (after the barriers' init)."""
    ptx, reached = _reached(WITH_HEADER, kernel)
    for instruction in ("cp.async.bulk.tensor", "mbarrier.try_wait",
                        "mbarrier.arrive.expect_tx", "fence.proxy.async",
                        "wgmma.fence", "wgmma.commit_group", "wgmma.wait_group"):
        assert instruction in ptx, (kernel, instruction)
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k8\.f32\.tf32\.tf32", ptx)
    for instruction in ("mma.sync", "cp.async.cg", "ldmatrix", "cp.async.commit_group"):
        assert instruction not in ptx, (kernel, instruction, sorted(reached))
    assert {"mma3_ss", "mma3_rs", "split_pass", "tma_load", "a_split", "exp_fast"} <= reached
    funcs = _functions(WITH_HEADER)
    assert funcs["mma3_ss"][1].count("wgmma_tf32_ss<N>(") == 3
    assert funcs["mma3_rs"][1].count("wgmma_tf32_rs<kN>(") == 3
    assert "__syncthreads()" in funcs["init_bars"][1]
    assert "__syncthreads()" not in funcs[kernel][1]


@pytest.mark.parametrize("instruction", ["mma.sync", "ldmatrix", "cp.async.cg",
                                         "cp.async.commit_group", "cp.async.wait_group"])
def test_no_instruction_of_the_mma_sync_design_is_left_in_float32(instruction):
    """The mma.sync design is gone from the whole float32 source and its
    headers, not only from the kernels' reach: no code names its
    instructions (the header's comment still tells of it)."""
    for text in (TEXT, HEADER.read_text(), (cuda_build.CSRC_DIR / "flash_common.cuh").read_text()):
        assert instruction not in _code(text)


def test_forward_consumer_loop_is_a_do_loop_with_s_in_flight_beside_p_v():
    """K1's consumers leave O += drop(P) V in flight while the next stage's
    S is issued, wait once for both, release the stage after that wait, and
    write the scores into registers of their own: the element-wise work
    writes no accumulator but O's rescale, which comes after the wait. The
    consumer and producer loops are do-while loops (every block has a
    stage)."""
    body = _functions(TEXT)["flash_fwd_kernel"][1]
    consumer = body[body.index("mbar_wait(bars.own_ready, 0);"):]
    assert consumer.count("wgmma_wait_all();") == 2  # one a stage, one after the loop
    stage = consumer[consumer.index("do {"):consumer.index("} while (++tile < n_tiles);")]
    s_issue, wait = stage.index("mma3_ss<kKeys>(s,"), stage.index("wgmma_wait_all();")
    release = stage.index("mbar_arrive(&bars.empty[(tile - 1) % L::kStages]);")
    rescale, pv = stage.index("acc[4 * i] *= corr_a;"), stage.index("mma3_rs<D, kKeys>(acc,")
    assert s_issue < wait < release < rescale < pv
    assert "x[4 * n + e] = sc;" in stage and "s[4 * n + e] =" not in stage
    assert body.count("do {") == 2 and body.count("} while (++tile < n_tiles);") == 2
    assert "for (int tile = 0; tile < n_tiles" not in body


def test_every_kernel_of_the_source_is_launched_as_designed():
    """The float32 source holds three kernels, each launched through
    launch_tma with its tensor maps (K1 q, k and v; K2 and K3 also dO); no
    other kernel (no old body) is left, and every helper is reached."""
    code = _code(TEXT)
    kernels = set(re.findall(r"__global__\s[^;{]*?(\w+)\(const Params\b", code))
    assert kernels == {"flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"}
    assert "launch_tma<FwdMaps, flash_fwd_kernel<D>>(FwdLayout<D>::kSmem," in code
    assert "launch_tma<BwdMaps, flash_dq_kernel<D>>(DqLayout<D>::kSmem," in code
    assert "launch_tma<BwdMaps, flash_dkv_kernel<D>>(DkvLayout<D>::kSmem," in code
    assert "flash::launch" not in code and "flash::launch" not in _code(
        (cuda_build.CSRC_DIR / "flash_common.cuh").read_text())
    reached = set()
    for kernel in kernels:
        reached |= _reached(WITH_HEADER, kernel)[1]
    own = set(_functions(TEXT))
    # read by the layouts and the launch
    rules = {"dkv_rows", "dkv_stages", "dq_keys", "dq_stages"}
    assert own - reached <= rules | kernels, sorted(own - reached)


def test_float32_maps_go_through_the_shared_cache():
    """The float32 library encodes its tensor maps through the shared
    header's cache (hopper.cuh), keyed with the element type and binding the
    device's context before a thread's first encode; the cache has internal
    linkage, so each library keeps its own and exports its own counts, which
    the wrapper reads."""
    code = _code(TEXT)
    assert "cuTensorMapEncodeTiled" not in code
    assert "kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in code
    # K1's q, k and v; K2's and K3's q, dO, k and v
    assert len(re.findall(r"tensor_map\(&maps\.\w+, p\.\w+, kF32,", code)) == 7
    header = _code(HEADER.read_text())
    for name in ("static EncodeTiled encoder()", "static std::atomic<long long> map_lookups",
                 "static bool tensor_map("):  # internal linkage: a cache a library
        assert name in header, name
    assert "inline bool tensor_map(" not in header
    key = header[header.index("struct MapKey"):]
    key = key[:key.index("};")]
    assert "CUtensorMapDataType dtype;" in key and "dtype == o.dtype" in key
    body = header[header.index("static bool tensor_map("):]
    body = body[:body.index("\n}\n")]
    assert body.index("cudaSetDevice(dev)") < body.index("encode(&cache.maps[slot], dtype")
    exported = set(re.findall(r'extern "C" long long (\w+)\(\)', TEXT))
    assert exported == set(fa._F32_MAP_COUNTS.values())


def test_no_fallback_routes_float32_elsewhere():
    """float32 reaches the tf32x3 library and nothing else: the source's
    C functions take float32 only, and the wrapper's route is the dtype's."""
    assert fa.route(torch.float32) == "tf32x3"
    assert "if (dtype != 0) return (int)cudaErrorInvalidValue;  // float32 only" in TEXT
