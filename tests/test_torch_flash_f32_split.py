"""3xTF32, the arithmetic of the float32 flash kernels, on the CPU.

``csrc/flash_attention.cu`` runs every matrix product of its forward (K1),
dq (K2) and dk/dv (K3) kernels on the tensor cores in TF32, as
``wgmma.m64nNk8`` (their Hopper schedules, stage by stage:
``test_torch_flash_f32_hopper.py``), with one split for all three. Each float32 operand x is split into big = tf32(x) and
small = tf32(x - big), where tf32 is ``cvt.rna.tf32.f32`` (round to
nearest, ties away from zero, 10 mantissa bits), and each 8-wide k step adds
three products into one float32 accumulator: small·big, then big·small,
then big·big. No compiler and no card run here, so this file rebuilds that
arithmetic in torch on float32 bits and builds the kernels from it:
the forward's two products (S = Q·Kᵀ, then O += drop(P)·V) with its online
softmax over 16-key steps, held against :func:`flash_forward_reference` at
the tolerance ``chip_smoke.py`` holds o and lse to on the card (1e-5 +
1e-5·|ref|); and the backward's five (S and dP, then dq = dS·K in K2; Sᵀ
and dPᵀ, then dv = drop(P)ᵀ·dO and dk = dSᵀ·Q in K3), held against
:func:`flash_backward_reference` at the backward's (1e-4 + 1e-4·|ref|).
The same kernels with one TF32 product per product miss those tolerances,
which is why the kernels split.

It also models the fragment layout of ``mma.m16n8k8`` as the PTX ISA
defines it, lane by lane (each warp's share of a ``wgmma`` m64 accumulator
and register A operand has that layout): the C fragment of S (or P, or dS)
read as the A fragment of the next product in the k order the kernels'
``a_split`` uses.
"""

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.ops import flash_attention as fa
from gradaccum_tpu_torch.utils import cuda_build, kernel_variants

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)  # chip_smoke.py's float32 TOL for dq, dk, dv, dmask
FWD_TOL = dict(rtol=1e-5, atol=1e-5)  # and for o and lse


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bits, low 13 bits cleared: add half of
    the dropped range to the magnitude bits (the sign bit is apart, so this
    rounds ties away from zero), then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b):
    """a @ b in 3xTF32, k step by k step of 8, each step small·big, then
    big·small, then big·big into one float32 accumulator."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        a_big, a_small = split(a[..., k0:k0 + 8])
        b_big, b_small = split(b[..., k0:k0 + 8, :])
        acc = acc + a_small @ b_big
        acc = acc + a_big @ b_small
        acc = acc + a_big @ b_big
    return acc


def mm1(a, b):
    """a @ b with one TF32 product per k step."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        acc = acc + tf32(a[..., k0:k0 + 8]) @ tf32(b[..., k0:k0 + 8, :])
    return acc


def kernel_forward(q, k, v, mask, seed, causal, rate, mm):
    """(o, lse) in K1's arithmetic, with the products done by ``mm``. The
    keys stream in 16-key steps (finer than K1's stages of 32, so that the
    rescale runs more often); per step S = Q·Kᵀ,
    s = S·scale + mask_j, −inf past the diagonal, then the online softmax:
    m_new = max(m, the step's row max), O and l rescaled by
    exp(m − m_new) (against 0 while a row's max is still −inf), p =
    exp(s − m_new), l += p undropped, O += drop(P)·V. At the end o = O·(1/l)
    and lse = m + log l."""
    b, h, n, d = q.shape
    scale = 1.0 / d ** 0.5
    keep = None
    if rate > 0.0:
        _, inv_keep = fa._dropout_config(rate)
        keep = fa.dropout_keep_mask(seed, b, h, n, rate)
    rows = torch.arange(n)[:, None]
    m = torch.full((b, h, n, 1), -torch.inf)
    l = torch.zeros(b, h, n, 1)  # noqa: E741
    acc = torch.zeros(b, h, n, d)
    for j0 in range(0, n, 16):
        j1 = min(j0 + 16, n)
        s = mm(q, k[..., j0:j1, :].transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask[..., j0:j1]
        if causal:
            s = s.masked_fill(torch.arange(j0, j1)[None, :] > rows, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        corr = torch.exp(m - base)
        p = torch.exp(s - base)
        l = l * corr + p.sum(dim=-1, keepdim=True)  # noqa: E741
        if keep is not None:
            p = torch.where(keep[..., j0:j1], p * inv_keep, 0.0)
        acc = acc * corr + mm(p, v[..., j0:j1, :])
        m = m_new
    return acc * (1.0 / l), m + torch.log(l)


def kernel_backward(q, k, v, mask, seed, o, lse, g, causal, rate, mm):
    """(dq, dk, dv, dmask) as K2 and K3 compute them, with the products
    done by ``mm``: the element-wise steps in float32, P = exp(S·scale +
    mask_j − lse_i), zero past the diagonal, drop(dP), dS = P (drop(dP) − Δ).
    K3 recomputes P and dS from Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ."""
    b, h, n, d = q.shape
    scale = 1.0 / d ** 0.5
    keep = None
    if rate > 0.0:
        _, inv_keep = fa._dropout_config(rate)
        keep = fa.dropout_keep_mask(seed, b, h, n, rate)
    above = torch.ones(n, n, dtype=torch.bool).triu(1) if causal else None
    delta = fa._delta(g, o)

    def d_scores(s, dp):
        if mask is not None:
            s = s + mask
        p = torch.exp(s - lse)
        if above is not None:
            p = p.masked_fill(above, 0.0)
        p_drop = p
        if keep is not None:
            dp = torch.where(keep, dp * inv_keep, 0.0)
            p_drop = torch.where(keep, p * inv_keep, 0.0)
        return p * (dp - delta), p_drop

    # K2: S = Q Kᵀ, dP = dO Vᵀ, dq = dS K
    ds, _ = d_scores(mm(q, k.transpose(-1, -2)) * scale, mm(g, v.transpose(-1, -2)))
    dq = mm(ds, k) * scale
    # K3: Sᵀ = K Qᵀ, dPᵀ = V dOᵀ, dv = drop(P)ᵀ dO, dk = dSᵀ Q
    ds_t, p_drop_t = (x.transpose(-1, -2) for x in d_scores(
        mm(k, q.transpose(-1, -2)).transpose(-1, -2) * scale,
        mm(v, g.transpose(-1, -2)).transpose(-1, -2)))
    dv = mm(p_drop_t, g)
    dk = mm(ds_t, q) * scale
    dmask = ds_t.sum(dim=-1)[:, :, None, :] if mask is not None else None
    return dq, dk, dv, dmask


def _inputs(shape, masked, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                  for _ in range(4))
    mask = None
    if masked:
        b, _, n, _ = shape
        lengths = rng.integers(n // 4, n + 1, size=b)
        pad = np.arange(n)[None, :] >= lengths[:, None]
        mask = torch.from_numpy((pad * -1e9).astype(np.float32).reshape(b, 1, 1, n))
    return q, k, v, g, mask


# (shape, padded mask, causal, dropout rate): gpt_lm's attention, GPT-Small's
# sequence and head dim at a small batch, and the widest head dim with a mask
CASES = {
    "gpt_lm": ((16, 4, 64, 32), False, True, 0.1),
    "gpt_small_seq": ((2, 2, 512, 64), False, True, 0.1),
    "d128_mask": ((2, 2, 128, 128), True, False, 0.0),
}


def _worst(got, want, tol=TOL):
    """max over elements of |got − want| / (atol + rtol·|want|): above 1 is
    outside ``tol``."""
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_forward_holds_float32_tolerance(case):
    shape, masked, causal, rate = CASES[case]
    q, k, v, _, mask = _inputs(shape, masked, seed=sorted(CASES).index(case))
    seed = 0x5EED1234 if rate else None
    want = fa.flash_forward_reference(q, k, v, mask, seed, causal, rate)
    got = kernel_forward(q, k, v, mask, seed, causal, rate, mm3)
    for name, a, b in zip(("o", "lse"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **FWD_TOL)
    # one TF32 product per product: outside the same tolerance
    single = kernel_forward(q, k, v, mask, seed, causal, rate, mm1)
    worst = max(_worst(a, b, FWD_TOL) for a, b in zip(single, want))
    assert worst > 1.0, f"single TF32 stayed within TOL ({worst:.3f})"


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_products_hold_float32_tolerance(case):
    shape, masked, causal, rate = CASES[case]
    q, k, v, g, mask = _inputs(shape, masked, seed=sorted(CASES).index(case))
    seed = 0x5EED1234 if rate else None
    o, lse = fa.flash_forward_reference(q, k, v, mask, seed, causal, rate)
    want = fa.flash_backward_reference(q, k, v, mask, seed, o, lse, g, causal, rate)
    got = kernel_backward(q, k, v, mask, seed, o, lse, g, causal, rate, mm3)
    names = ("dq", "dk", "dv", "dmask")
    for name, a, b in zip(names, got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)
    # one TF32 product per product: outside the same tolerance
    single = kernel_backward(q, k, v, mask, seed, o, lse, g, causal, rate, mm1)
    worst = max(_worst(a, b) for a, b in zip(single[:3], want[:3]))
    assert worst > 1.0, f"single TF32 stayed within TOL ({worst:.3f})"


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0, -2.0 ** -30], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0, -2.0 ** -30]
    assert tf32(x).tolist() == want
    assert (tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_leaves_a_residual_of_about_2_to_the_minus_22():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    big, small = split(x)
    assert torch.equal(big, tf32(big)) and torch.equal(small, tf32(small))
    residual = ((x.double() - big.double() - small.double()).abs() / x.double().abs()).max()
    assert residual <= 2.0 ** -22
    assert ((x.double() - big.double()).abs() / x.double().abs()).max() > 2.0 ** -13


# --------------------------------------------------------------------------
# Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32; lane = 4 g + t)
# --------------------------------------------------------------------------


def _mma(a_regs, b_regs):
    """C = A·B of one mma.m16n8k8 from the lanes' registers: A rows g, g+8,
    g, g+8 at columns t, t, t+4, t+4; B rows t, t+4 at column g; C rows g,
    g, g+8, g+8 at columns 2t, 2t+1, 2t, 2t+1."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        gi, ti = divmod(lane, 4)
        a[gi, ti], a[gi + 8, ti], a[gi, ti + 4], a[gi + 8, ti + 4] = a_regs[lane]
        b[ti, gi], b[ti + 4, gi] = b_regs[lane]
    c = a @ b
    return [(c[gi, 2 * ti], c[gi, 2 * ti + 1], c[gi + 8, 2 * ti], c[gi + 8, 2 * ti + 1])
            for gi, ti in (divmod(lane, 4) for lane in range(32))]


def _c_matrix(c_regs):
    c = np.zeros((16, 8))
    for lane, (c0, c1, c2, c3) in enumerate(c_regs):
        gi, ti = divmod(lane, 4)
        c[gi, 2 * ti], c[gi, 2 * ti + 1], c[gi + 8, 2 * ti], c[gi + 8, 2 * ti + 1] = c0, c1, c2, c3
    return c


def test_c_fragment_is_the_a_fragment_in_the_kernels_k_order():
    """dq += dS K (or O += drop(P) V) for one k step of 8 keys: the C
    registers of dS taken as (c0, c2, c1, c3), as a_split takes them, are
    the A fragment when the k index l stands for key 2 (l % 4) + l / 4, so
    the B operand holds K's rows 2t and 2t+1 at column g (the transposed
    tile puts key r at k_slot(r)); the product is dS·K."""
    rng = np.random.default_rng(5)
    ds, k = rng.normal(size=(16, 8)), rng.normal(size=(8, 8))
    c_regs = [(ds[g, 2 * t], ds[g, 2 * t + 1], ds[g + 8, 2 * t], ds[g + 8, 2 * t + 1])
              for g, t in (divmod(lane, 4) for lane in range(32))]
    a_regs = [(c0, c2, c1, c3) for c0, c1, c2, c3 in c_regs]
    b_regs = [(k[2 * t, g], k[2 * t + 1, g]) for g, t in (divmod(lane, 4) for lane in range(32))]
    np.testing.assert_allclose(_c_matrix(_mma(a_regs, b_regs)), ds @ k, rtol=1e-12)


@pytest.mark.parametrize("variant", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_apply_to_the_source(variant):
    """Each variant that ``utils/kernel_variants.py`` times on the card is a
    set of substitutions, each matching the float32 source exactly once."""
    source = (cuda_build.CSRC_DIR / f"{kernel_variants.SOURCE}.cu").read_text()
    assert kernel_variants.variant_source(variant) != source
