"""The bf16 dq kernel's (K2's) tile bookkeeping against JAX, on the CPU.

``flash_dq_tc_kernel`` in ``csrc/flash_attention_tc.cu`` runs only on the
card, so this file walks its schedule in numpy, step for step, and holds
the result against JAX's ``_flash_backward`` (its Pallas kernels in
interpret mode, bf16 inputs). The emulation does what the kernel does and
no more:

- row blocks of 64 or 128 queries (one or two consumer warpgroups, as
  ``tc_geometry`` chooses), each warp 16 of them;
- key tiles of 64 (``kDqKeys``) whose rows past S are zeros (TMA's fill),
  with the mask row 0 past S; causal blocks stop after their last query
  row;
- each tile's case resolved once per warp: on an edge tile (keys past S,
  or a key past the warp's first row when causal) every element is
  masked to 0 past S and past its row's diagonal; on any other tile
  nothing is;
- P = 2^(S·scale·log2 e + mask·log2 e − lse·log2 e), the keep bit
  keep(row seed, key) of the hash dropout, dS = P (drop(dP) − Δ) in
  float32, rounded to bf16 before dS K, dq summed in float32 and scaled
  once at the end, then rounded to bf16.

JAX computes the same function with its own tiles (50 × 50 here) and
rounds dS to bf16 at the same place (``_dq_kernel`` :385). The two sides
differ in the summation order of dq over keys, in exp against exp2 of a
pre-scaled score, and so in which way a few dS round to bf16 (one step of
2^-8 relative). Tolerance: 1e-2 + 1e-2·|dq|, the bf16 dq tolerance of
``chip_smoke.py`` against the plain version; Δ within 1e-5 of JAX's
formula (products of bf16 pairs are exact in float32).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_flash_hopper import TC_DQ_KEYS, tc_geometry

pytestmark = pytest.mark.torch

jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")

B, H, D = 2, 2, 16
BLOCK = 50  # JAX's tiles: a divisor of every S below
RATE = 0.1
SEED = 0x2F6B1D3
LOG2E = np.float32(1.4426950408889634)
M1, M2, GOLDEN = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
DQ_TOL = dict(atol=1e-2, rtol=1e-2)


def _bf16(x):
    """``x`` rounded to the nearest bf16 (ties to even), as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _hash(x):
    x = np.asarray(x, np.uint64) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * M1) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * M2) & 0xFFFFFFFF
    return x ^ (x >> 16)


def _keep(bh, rows, keys, rate):
    """keep(row seed, key) of the hash dropout for query ``rows`` x
    ``keys`` of slice ``bh``: the formula of ``flash_common.cuh``."""
    threshold = min(round((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)
    sseed = _hash(SEED + bh * GOLDEN)
    rseed = _hash(rows.astype(np.uint64) + sseed * GOLDEN)
    return _hash(keys[None, :].astype(np.uint64) + rseed[:, None] * GOLDEN) < threshold


def kernel_edge(k0, warp_row0, s, causal):
    """K2's per-warp test of a key tile: keys past S, or (causal) a key
    past the warp's first row."""
    return k0 + TC_DQ_KEYS > s or (causal and k0 + TC_DQ_KEYS - 1 > warp_row0)


def emulate_dq(q, k, v, mask, do, o, lse, causal, rate, sm_count=132, edge_of=kernel_edge):
    """dq (bf16 values in float32) and Δ as K2 computes them, walking its
    blocks, warps and key tiles. Inputs are float32 arrays holding bf16
    values; ``mask`` is [B, 1, 1, S] or None; ``lse`` [B, H, S, 1].
    ``edge_of`` decides each tile's case. Returns also the number of key
    tiles of each row block."""
    b, h, s, d = q.shape
    geo = tc_geometry("flash_bwd_dq", q.shape, sm_count=sm_count, causal=causal)
    rows = geo["rows_per_block"]
    scale = np.float32(1.0 / np.sqrt(d))
    scale_log2 = np.float32(scale * LOG2E)
    inv_keep = np.float32(1.0 / (1.0 - rate)) if rate else np.float32(1.0)
    delta = (do * o).sum(-1, dtype=np.float32)  # [B, H, S]
    dq = np.zeros_like(q)
    tiles = []
    for x in range(-(-s // rows)):
        q0 = x * rows
        k_end = min(s, q0 + rows) if causal else s
        n_tiles = -(-k_end // TC_DQ_KEYS)
        tiles.append(n_tiles)
        for warp_row0 in range(q0, q0 + rows, 16):
            r = np.arange(warp_row0, warp_row0 + 16)
            inside = r < s
            rc = np.where(inside, r, 0)
            # Q and dO rows past S are TMA's zeros; lse and Δ 0 there
            qw = np.where(inside[:, None], q[:, :, rc], 0)
            dow = np.where(inside[:, None], do[:, :, rc], 0)
            lse_w = np.where(inside, lse[:, :, rc, 0], 0) * LOG2E
            delta_w = np.where(inside, delta[:, :, rc], 0)
            acc = np.zeros((b, h, 16, d), np.float32)
            for tile in range(n_tiles):
                k0 = tile * TC_DQ_KEYS
                j = np.arange(k0, k0 + TC_DQ_KEYS)
                jin = j < s
                jc = np.where(jin, j, 0)
                kt = np.where(jin[:, None], k[:, :, jc], 0)
                vt = np.where(jin[:, None], v[:, :, jc], 0)
                mrow = np.zeros((b, 1, 1, TC_DQ_KEYS), np.float32)
                if mask is not None:
                    mrow = np.where(jin, mask[..., jc], 0) * LOG2E
                sc = np.einsum("bhid,bhjd->bhij", qw, kt, dtype=np.float32)
                dp = np.einsum("bhid,bhjd->bhij", dow, vt, dtype=np.float32)
                pt = np.exp2(sc * scale_log2 + mrow[:, :, 0, None] - lse_w[..., None],
                             dtype=np.float32)
                if edge_of(k0, warp_row0, s, causal):
                    cut = (j[None, :] >= s) | (causal & (j[None, :] > r[:, None]))
                    pt = np.where(cut, 0, pt)
                if rate:
                    keep = np.stack([np.stack([_keep(bb * h + hh, r, j, rate)
                                               for hh in range(h)]) for bb in range(b)])
                    dp = np.where(keep, dp * inv_keep, 0)
                ds = _bf16(pt * (dp - delta_w[..., None]))
                acc += np.einsum("bhij,bhjd->bhid", ds, kt, dtype=np.float32)
            out = _bf16(acc * scale)
            dq[:, :, r[inside]] = out[:, :, inside]
    return dq, delta, tiles


def _inputs(s, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(rng.normal(size=(B, H, s, D))) for _ in range(4))
    mask = None
    if masked:
        mask = np.zeros((B, 1, 1, s), np.float32)
        mask[0, ..., s - 7:] = -1e9
        mask[1, ..., s - 41:] = -1e9
        mask = _bf16(mask)
    return q, k, v, mask, do


def _jax_backward(q, k, v, mask, do, causal, rate):
    """(o, lse) of JAX's forward and dq of its backward, bf16, in
    interpret mode, from the same hash seed the emulation draws with."""
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jm = None if mask is None else jnp.asarray(mask, jnp.bfloat16)
    seed = jnp.uint32(SEED)
    o, lse = jfa._flash_forward(jq, jk, jv, jm, seed, BLOCK, BLOCK, True, causal, rate)
    dq, _, _, _ = jfa._flash_backward(jq, jk, jv, jm, seed, o, lse, jdo, BLOCK, BLOCK, True,
                                      causal, rate)
    return (np.asarray(o.astype(jnp.float32)), np.asarray(lse, np.float32),
            np.asarray(dq.astype(jnp.float32)))


@pytest.mark.parametrize("sm_count", [132, 4], ids=["one_warpgroup", "two_warpgroups"])
@pytest.mark.parametrize("s, masked, causal, rate", [
    (100, True, False, 0.0),
    (100, False, True, RATE),
    (200, True, False, RATE),
    (200, True, True, RATE),
])
def test_dq_schedule_matches_jax(s, masked, causal, rate, sm_count):
    """At S that are not a multiple of a key tile, K2's schedule gives
    JAX's dq within the bf16 tolerance, with one consumer warpgroup (64-row
    blocks, as 132 SMs choose at this size) and with two (128-row blocks,
    as a grid that fills 4 SMs chooses); its Δ is JAX's formula."""
    q, k, v, mask, do = _inputs(s, masked)
    o, lse, dq_jax = _jax_backward(q, k, v, mask, do, causal, rate)
    dq, delta, _ = emulate_dq(q, k, v, mask, do, o, lse, causal, rate, sm_count)
    assert np.isfinite(dq).all()
    np.testing.assert_allclose(dq, dq_jax, **DQ_TOL)
    want = np.asarray(jnp.sum(jnp.asarray(do) * jnp.asarray(o), axis=-1))
    np.testing.assert_allclose(delta, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s, causal, sm_count, want", [
    (100, False, 132, [2, 2]),  # 64-row blocks, keys 0-63 and 64-99
    (200, False, 132, [4, 4, 4, 4]),
    (200, True, 132, [1, 2, 3, 4]),  # each block stops after its last row
    (200, True, 4, [2, 4]),  # 128-row blocks
    (100, True, 4, [2]),
])
def test_dq_key_tiles_per_block(s, causal, sm_count, want):
    """The key tiles each row block walks: all of ceil(S / 64) unmasked;
    causal, up to the block's last query row."""
    q, k, v, mask, do = _inputs(s, False)
    zeros = np.zeros((B, H, s, 1), np.float32)
    _, _, tiles = emulate_dq(q, k, v, None, do, q, zeros, causal, 0.0, sm_count)
    assert tiles == want


@pytest.mark.parametrize("wrong_edge", [
    lambda k0, row0, s, causal: k0 + TC_DQ_KEYS > s,  # the causal test forgotten
    lambda k0, row0, s, causal: causal and k0 + TC_DQ_KEYS - 1 > row0 + 15,  # last row's
])
def test_a_wrong_edge_rule_shows(wrong_edge):
    """The comparison rests on the edge rule: with a tile taken as interior
    where K2 masks it, the emulation no longer agrees with JAX (causal,
    S = 200, 64-row blocks)."""
    q, k, v, mask, do = _inputs(200, True)
    o, lse, dq_jax = _jax_backward(q, k, v, mask, do, True, 0.0)
    dq, _, _ = emulate_dq(q, k, v, mask, do, o, lse, True, 0.0, edge_of=wrong_edge)
    assert not np.allclose(dq, dq_jax, **DQ_TOL)


def test_bf16_rounding_matches_jax():
    x = np.random.default_rng(3).normal(size=4096).astype(np.float32) * 1e3
    want = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(_bf16(x), want)


def test_keep_bits_match_jax():
    rows, keys = np.arange(0, 48), np.arange(0, 200)
    want = np.asarray(jfa.dropout_keep_mask(jnp.uint32(SEED), B, H, 200, RATE))
    for bb in range(B):
        for hh in range(H):
            got = _keep(bb * H + hh, rows, keys, RATE)
            np.testing.assert_array_equal(got, want[bb, hh, :48])
