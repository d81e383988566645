"""The float32 matrix products of ``ops/matmul.py`` (``csrc/gemm_f32.cu``).

On the CPU: the split of a float32 value into three bfloat16 terms is
exact, the sum of the term-pair products the kernel forms comes within
float32's own error of a float64 product, the route sends CPU tensors to
the plain product with ``torch.matmul``'s gradients, GPT's head gives bf16
gradients to bf16 inputs, and the tile plan depends on the shape alone.

On the card (skipped without one): every layout and dtype pair the kernel
instantiates against float64 at odd shapes, and the main path's shapes
(GPT-2 medium's head in its three layouts, BERT-Large's Dense weights over
16,384 rows, the 5-wide classifier) at no more than twice cuBLAS's float32
error (TF32 off) on the same inputs, with and without bias.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.ops import matmul

pytestmark = pytest.mark.torch


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the float32 product kernel needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# --------------------------------------------------------------------------
# The split and its arithmetic (CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_three_terms_sum_to_the_float32_value_bit_for_bit(sign):
    rng = np.random.default_rng(7)
    exps = rng.integers(-100, 101, size=200_000)
    mant = rng.integers(0, 2**23, size=exps.size)
    bits = ((exps + 127).astype(np.uint32) << 23) | mant.astype(np.uint32)
    x = torch.from_numpy(bits.view(np.float32) * np.float32(sign))
    # and the values next to the powers of two the rounding may reach
    edge = torch.tensor([2.0 ** e * f for e in (-100, -1, 0, 1, 100)
                         for f in (1.0, 1 - 2**-24, 1 + 2**-23, 1.5 - 2**-23)]) * sign
    for v in (x, edge):
        hi, mid, lo = matmul.split_terms(v)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        total = (hi.double() + mid.double()) + lo.double()
        assert torch.equal(total.float(), v)
        assert torch.equal(total, v.double())


def test_a_bfloat16_operand_is_its_own_one_term():
    x = torch.randn(8, 8).to(torch.bfloat16)
    (only,) = matmul.split_terms(x)
    assert only is x


@pytest.mark.parametrize("a_dt,b_dt,count", [
    (torch.float32, torch.float32, 6), (torch.float32, torch.bfloat16, 3),
    (torch.bfloat16, torch.float32, 3), (torch.bfloat16, torch.bfloat16, 1)])
def test_term_pairs_are_those_with_i_plus_j_at_most_two(a_dt, b_dt, count):
    pairs = matmul.term_pairs(a_dt, b_dt)
    assert len(pairs) == count and len(set(pairs)) == count
    assert all(i + j <= 2 for i, j in pairs)
    assert pairs[-1] == (0, 0)  # the largest product last


@pytest.mark.parametrize("k", [64, 1024, 4096])
def test_term_pair_sum_is_within_float32_matmuls_error_of_float64(k):
    g = torch.Generator().manual_seed(k)
    a = torch.randn(96, k, generator=g)
    b = torch.randn(k, 80, generator=g)
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs())

    def err(c):
        return float(((c.double() - exact).abs() / scale).max())

    emulated, fp32 = err(matmul.emulate(a, b)), err(a @ b)
    # float32's own product errs by a few ulp of the sum of |a||b|
    assert fp32 < 2 ** -20
    assert emulated <= 2 * fp32 + 2 ** -23
    # one bf16 product (the hi terms alone) is far off: the split is what
    # makes it float32
    hi = err(matmul.split_terms(a)[0].float() @ matmul.split_terms(b)[0].float())
    assert hi > 50 * max(emulated, fp32)


def test_mixed_dtypes_emulate_with_three_products():
    g = torch.Generator().manual_seed(3)
    a = torch.randn(32, 256, generator=g)
    b = torch.randn(256, 48, generator=g).to(torch.bfloat16)
    exact = a.double() @ b.double()
    got = matmul.emulate(a, b)
    assert float((got.double() - exact).abs().max()) < 1e-5 * float(exact.abs().max())


# --------------------------------------------------------------------------
# The route on the CPU
# --------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_product():
    matmul.reset_launch_counts()
    x = torch.randn(3, 5, 16)
    w, b = torch.randn(12, 16), torch.randn(12)
    y = matmul.linear(x, w, b)
    assert torch.equal(y, torch.nn.functional.linear(x, w, b))
    assert matmul.launch_counts() == {"gemm_f32": 0}
    assert matmul.product_counts() == {1: 0, 3: 0, 6: 0}


@pytest.mark.parametrize("shape", [(5, 16), (3, 5, 16)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_cpu_route_is_the_one_plain_function(monkeypatch, shape, with_bias):
    """The CPU ``linear`` and the operator's CPU kernel are both
    ``mm_plain``, and its bits are ``F.linear``'s."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(*shape, generator=g)
    w = torch.randn(12, 16, generator=g)
    b = torch.randn(12, generator=g) if with_bias else None
    calls = []
    plain = matmul.mm_plain
    monkeypatch.setattr(matmul, "mm_plain", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    y = matmul.linear(x, w, b)
    assert calls == [1]
    assert torch.equal(y, torch.nn.functional.linear(x, w, b))
    op = matmul.mm_f32_op(x.reshape(-1, 16), w, b, False, True, torch.float32)
    assert torch.equal(op, y.reshape(-1, 12))


@pytest.mark.parametrize("a_t,b_t", [(False, True), (False, False), (True, False), (True, True)])
def test_operator_on_the_cpu_is_the_plain_product(a_t, b_t):
    g = torch.Generator().manual_seed(11)
    a = torch.randn(7, 9, generator=g)
    b = torch.randn(9, 6, generator=g)
    a_in = a.t().contiguous() if a_t else a
    b_in = b.t().contiguous() if b_t else b
    bias = torch.randn(6, generator=g)
    got = matmul.mm_f32_op(a_in, b_in, bias, a_t, b_t, torch.float32)
    assert torch.allclose(got, a @ b + bias, rtol=1e-6, atol=1e-6)
    assert matmul.mm_f32_op(a_in, b_in, None, a_t, b_t, torch.bfloat16).dtype == torch.bfloat16


def test_cpu_gradients_match_torch_matmul_in_float32():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 6, 32, generator=g, requires_grad=True)
    w = torch.randn(24, 32, generator=g, requires_grad=True)
    b = torch.randn(24, generator=g, requires_grad=True)
    dy = torch.randn(4, 6, 24, generator=g)
    matmul.linear(x, w, b).backward(dy)
    got = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    (torch.matmul(x, w.t()) + b).backward(dy)
    for mine, ref in zip(got, (x.grad, w.grad, b.grad)):
        assert mine.dtype == torch.float32
        assert torch.allclose(mine, ref, rtol=1e-6, atol=1e-5)


def test_gpt_head_gives_bf16_inputs_bf16_gradients():
    from gradaccum_tpu_torch.models.gpt import GPTConfig, GPTLM

    cfg = GPTConfig(vocab_size=96, hidden_size=32, num_layers=1, num_heads=4,
                    intermediate_size=64, max_position_embeddings=16, dtype=torch.bfloat16)
    model = GPTLM(cfg).to(torch.bfloat16)
    ids = torch.randint(0, 96, (2, 8), generator=torch.Generator().manual_seed(1))
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16).requires_grad_()
    table = model.word_embeddings.weight
    logits = matmul.linear(x, table)
    assert logits.dtype == torch.float32 and logits.shape == (2, 8, 96)
    dlogits = torch.randn(2, 8, 96, generator=torch.Generator().manual_seed(3))
    logits.backward(dlogits)
    assert x.grad.dtype == torch.bfloat16 and table.grad.dtype == torch.bfloat16
    # the bf16 roundings of the float32 gradients, as .float()'s backward gives
    ref_dx = (dlogits.reshape(-1, 96) @ table.detach().float()).to(torch.bfloat16)
    ref_dt = (dlogits.reshape(-1, 96).t() @ x.detach().float().reshape(-1, 32)).to(torch.bfloat16)
    assert torch.equal(x.grad.reshape(-1, 32), ref_dx)
    assert torch.equal(table.grad, ref_dt)
    # the model's own forward runs the head through the route too
    out = model(ids)
    assert out.dtype == torch.float32 and out.shape == (2, 8, 96)


@pytest.mark.parametrize("dtype,cols,wide", [
    (torch.float32, 64, True), (torch.float32, 61, False),    # rows 244 bytes apart
    (torch.bfloat16, 64, True), (torch.bfloat16, 61, False),  # 122 bytes apart
])
def test_tma_takes_operands_whose_rows_are_16_byte_aligned(dtype, cols, wide):
    t = torch.randn(8 * cols).to(dtype).reshape(8, cols)
    assert matmul._wide(t) == wide
    if dtype == torch.bfloat16 and not wide:
        # the wrapper's padded copy: aligned rows, the same values
        padded = matmul._padded(t)
        assert matmul._wide(padded) and torch.equal(padded, t)


@pytest.mark.parametrize("shape,want", [
    ((16384, 1024, 1024), (1, 32, False)),     # BERT's Dense forward
    ((1024, 1024, 16384), (2, 256, True)),     # its 1024 x 1024 weight gradients: 64 tiles
    ((4096, 1024, 16384), (1, 512, False)),    # 256 tiles fill the card
    ((16384, 50257, 1024), (1, 32, True)),     # GPT's head forward
    ((16384, 1024, 50257), (1, 1571, False)),  # its input gradient
    ((50257, 1024, 16384), (1, 512, False)),   # its table gradient
    ((64, 5, 1024), (4, 8, True)),             # the 5-wide classifier
])
def test_plan_depends_on_the_shape_alone(shape, want):
    assert matmul.plan(*shape, 132) == want
    splits, per, _ = want
    nk = -(-shape[2] // matmul.TILE_K)
    assert (splits - 1) * per < nk <= splits * per


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


def _operands(m, n, k, a_dt, b_dt, a_t, b_t, dev, seed, pad=0):
    """op(a) [m, k] and op(b) [k, n] as the operator takes them, rows
    ``pad`` elements wider than they need (a pitch no 16 bytes divide when
    odd), values rounded to their dtype."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(rows, cols, dt):
        full = torch.randn(rows, cols + pad, generator=g, device=dev).to(dt)
        return full[:, :cols]

    a = make(k, m, a_dt) if a_t else make(m, k, a_dt)
    b = make(n, k, b_dt) if b_t else make(k, n, b_dt)
    return a, b


def _op64(t, trans):
    return t.double().t() if trans else t.double()


def _rel(c, exact):
    return float(torch.linalg.norm((c.double() - exact).flatten()) /
                 torch.linalg.norm(exact.flatten()))


@pytest.mark.parametrize("a_dt,b_dt", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("a_t,b_t", [(False, True), (False, False), (True, False), (True, True)])
def test_card_every_layout_against_float64(a_dt, b_dt, a_t, b_t):
    dev = _card()
    for (m, n, k, pad), out_dt in zip([(200, 130, 77, 0), (129, 257, 300, 1), (64, 5, 1000, 3),
                                       (300, 40, 4000, 0)],
                                      [torch.float32, torch.bfloat16] * 2):
        a, b = _operands(m, n, k, a_dt, b_dt, a_t, b_t, dev, m + n + k, pad)
        bias = torch.randn(n, device=dev)
        exact = _op64(a, a_t) @ _op64(b, b_t) + bias.double()
        matmul.reset_launch_counts()
        got = matmul.mm_cuda(a, b, bias, a_t, b_t, out_dt)
        torch.cuda.synchronize()
        assert matmul.launch_counts() == {"gemm_f32": 1}
        assert got.shape == (m, n) and got.dtype == out_dt
        ref = torch.matmul(a.float().t() if a_t else a.float(),
                           b.float().t() if b_t else b.float()) + bias
        bound = 2 * _rel(ref, exact) + 1e-7 if out_dt == torch.float32 else 4e-3
        assert _rel(got, exact) <= bound, (m, n, k, out_dt, _rel(got, exact), _rel(ref, exact))


def test_card_split_k_gives_the_same_bits_every_run():
    dev = _card()
    a, b = _operands(1024, 1024, 16384, torch.float32, torch.float32, True, False, dev, 9)
    assert matmul.plan(1024, 1024, 16384, matmul._sms(dev))[0] > 1
    first = matmul.mm_cuda(a, b, None, True, False)
    for _ in range(3):
        assert torch.equal(matmul.mm_cuda(a, b, None, True, False), first)


# the main path's products: (name, m, n, k, a dtype, b dtype, a_t, b_t, out dtype)
MAIN_SHAPES = [
    ("gpt head forward", 16384, 50257, 1024, "bf16", "bf16", False, True, "f32"),
    ("gpt head dx", 16384, 1024, 50257, "f32", "bf16", False, False, "bf16"),
    ("gpt head dtable", 50257, 1024, 16384, "f32", "bf16", True, False, "bf16"),
    ("bert 1024x1024 forward", 16384, 1024, 1024, "f32", "f32", False, True, "f32"),
    ("bert 1024x1024 dx", 16384, 1024, 1024, "f32", "f32", False, False, "f32"),
    ("bert 1024x1024 dw", 1024, 1024, 16384, "f32", "f32", True, False, "f32"),
    ("bert 1024->4096 forward", 16384, 4096, 1024, "f32", "f32", False, True, "f32"),
    ("bert 1024->4096 dx", 16384, 1024, 4096, "f32", "f32", False, False, "f32"),
    ("bert 1024->4096 dw", 4096, 1024, 16384, "f32", "f32", True, False, "f32"),
    ("bert 4096->1024 forward", 16384, 1024, 4096, "f32", "f32", False, True, "f32"),
    ("bert 4096->1024 dx", 16384, 4096, 1024, "f32", "f32", False, False, "f32"),
    ("bert 4096->1024 dw", 1024, 4096, 16384, "f32", "f32", True, False, "f32"),
    ("classifier forward", 64, 5, 1024, "f32", "f32", False, True, "f32"),
    ("classifier dx", 64, 1024, 5, "f32", "f32", False, False, "f32"),
    ("classifier dw", 5, 1024, 64, "f32", "f32", True, False, "f32"),
]
_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def main_operands(m, n, k, a_dt, b_dt, a_t, b_t, dev, seed):
    """A main-path product's operands as the model hands them over: GPT's
    head gradient [16384, 50257] float32 with its unaligned rows; x and the
    table bf16; BERT's activations and weights float32."""
    return _operands(m, n, k, _DT[a_dt], _DT[b_dt], a_t, b_t, dev, seed)


@pytest.mark.parametrize("case", MAIN_SHAPES, ids=[c[0] for c in MAIN_SHAPES])
@pytest.mark.parametrize("with_bias", [False, True])
def test_card_main_shapes_within_twice_cublas_float32_error(case, with_bias):
    dev = _card()
    name, m, n, k, a_dt, b_dt, a_t, b_t, out_dt = case
    a, b = main_operands(m, n, k, a_dt, b_dt, a_t, b_t, dev, 1)
    bias = torch.randn(n, device=dev) if with_bias else None
    out_dt = torch.float32 if with_bias else _DT[out_dt]
    got = matmul.mm_cuda(a, b, bias, a_t, b_t, out_dt)
    ref = torch.matmul(a.float().t() if a_t else a.float(), b.float().t() if b_t else b.float())
    if bias is not None:
        ref = ref + bias
    ref = ref.to(out_dt)
    del a, b
    a, b = main_operands(m, n, k, a_dt, b_dt, a_t, b_t, dev, 1)
    exact = _op64(a, a_t) @ _op64(b, b_t)
    if bias is not None:
        exact += bias.double()
    del a, b
    mine, lib = _rel(got, exact), _rel(ref, exact)
    worst_mine = float((got.double() - exact).abs().max())
    worst_lib = float((ref.double() - exact).abs().max())
    print(f"{name} bias={with_bias}: relative error {mine:.3e} (cuBLAS {lib:.3e}), "
          f"largest {worst_mine:.3e} (cuBLAS {worst_lib:.3e})")
    assert mine <= 2 * lib, (name, mine, lib)
    assert worst_mine <= 2 * worst_lib, (name, worst_mine, worst_lib)


def test_card_linear_gradients_in_the_inputs_dtypes():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(3, 100, 64, generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    t = torch.randn(333, 64, generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    matmul.reset_launch_counts()
    y = matmul.linear(x, t)
    dy = torch.randn(y.shape, generator=g, device=dev)
    y.backward(dy)
    torch.cuda.synchronize()
    assert matmul.launch_counts() == {"gemm_f32": 3}
    assert matmul.product_counts() == {1: 1, 3: 2, 6: 0}
    assert x.grad.dtype == t.grad.dtype == torch.bfloat16
    ref_dx = (dy.reshape(-1, 333).double() @ t.detach().double()).reshape(x.shape)
    ref_dt = dy.reshape(-1, 333).double().t() @ x.detach().double().reshape(-1, 64)
    # exact products, then one rounding to bf16: within a bf16 half ulp
    assert torch.allclose(x.grad.double(), ref_dx, rtol=2**-8, atol=1e-6)
    assert torch.allclose(t.grad.double(), ref_dt, rtol=2**-8, atol=1e-6)
    assert torch.allclose(y.double(), x.detach().double() @ t.detach().double().t(),
                          rtol=1e-6, atol=1e-5)


def time_main_shapes(repeats: int = 10) -> list:
    """Card ms of the kernel and of cuBLAS's float32 product (TF32 off) at
    each main-path shape (CUDA events over ``repeats`` launches after a
    warm-up, operands warm in L2 where they fit), beside the least time: the
    float32 work 2 m n k at 989 TFLOP/s over the term-pair products (165,
    330 or 989), or the bytes read once and written once at 3.35 TB/s."""
    dev = _card()
    rows = []
    for name, m, n, k, a_dt, b_dt, a_t, b_t, out_dt in MAIN_SHAPES:
        a, b = main_operands(m, n, k, a_dt, b_dt, a_t, b_t, dev, 1)
        out = _DT[out_dt]
        products = len(matmul.term_pairs(_DT[a_dt], _DT[b_dt]))
        fa, fb = a.float(), b.float()

        def kernel():
            return matmul.mm_cuda(a, b, None, a_t, b_t, out)

        def library():
            return torch.matmul(fa.t() if a_t else fa, fb.t() if b_t else fb).to(out)

        times = {}
        for label, fn in (("kernel", kernel), ("cublas", library), ("kernel2", kernel)):
            fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[label] = start.elapsed_time(end) / repeats
        flop = 2.0 * m * n * k
        nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
                  + m * n * out.itemsize)
        bound = max(flop * products / 989e12, nbytes / 3.35e12) * 1e3
        rows.append({"name": name, "m": m, "n": n, "k": k, "products": products,
                     "ms": min(times["kernel"], times["kernel2"]),
                     "ms_runs": [times["kernel"], times["kernel2"]],
                     "cublas_f32_ms": times["cublas"], "bound_ms": bound,
                     "tensor_tflops": flop * products / min(times["kernel"], times["kernel2"]) / 1e9,
                     "f32_tflops": flop / min(times["kernel"], times["kernel2"]) / 1e9})
        print(rows[-1], flush=True)
        del a, b, fa, fb
    return rows


if __name__ == "__main__":
    import json
    import sys

    print(torch.cuda.get_device_name(0))
    result = time_main_shapes()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(result, f, indent=1)
