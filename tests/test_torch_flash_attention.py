"""The port's flash attention held against the JAX package's.

Both sides get the same numpy inputs. The JAX side runs its Pallas kernels
as its own tests do on the CPU (interpret mode, blocks 16x16); the port's
side runs the kernels' plain PyTorch versions, which is what a CPU tensor
reaches. Tolerances are the JAX suite's own for its kernels against dense
attention: 1e-5 on the forward, 1e-4 on gradients (float32, summation
order differs). The dropout keep mask must be equal bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

B, H, S, D = 2, 2, 64, 16
BLOCKS = dict(block_q=16, block_k=16)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# name -> (mask kind, causal)
CASES = {
    "mask": ("padded", False),
    "bias": ("bias", False),  # a dense additive mask: its gradient is the signal
    "no_mask": (None, False),
    "causal": (None, True),
    "causal_mask": ("padded", True),
}


def _inputs(seed, mask_kind):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(4))
    mask = None
    if mask_kind == "padded":
        mask = np.zeros((B, 1, 1, S), np.float32)
        mask[0, ..., S - 7:] = -1e9
        mask[1, ..., S - 19:] = -1e9
    elif mask_kind == "bias":
        mask = (0.5 * rng.normal(size=(B, 1, 1, S))).astype(np.float32)
    return q, k, v, g, mask


def _jax(q, k, v, g, mask, causal, rate=0.0, key=None):
    """(o, grads) of JAX flash_attention; grads of sum(o * g) w.r.t. q, k, v
    (and the mask when there is one)."""

    def loss(*args):
        q_, k_, v_ = args[:3]
        m_ = args[3] if len(args) > 3 else None
        o = jfa.flash_attention(q_, k_, v_, m_, causal=causal, dropout_rate=rate,
                                dropout_rng=key, **BLOCKS)
        return jnp.sum(o * g), o

    args = [jnp.asarray(x) for x in (q, k, v)] + ([jnp.asarray(mask)] if mask is not None else [])
    grads, o = jax.grad(loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return np.asarray(o), [np.asarray(x) for x in grads]


def _torch(q, k, v, g, mask, causal, rate=0.0, seed=None):
    tensors = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tm = torch.tensor(mask, requires_grad=True) if mask is not None else None
    o = tfa.flash_attention(*tensors, tm, dropout_rate=rate, dropout_seed=seed, causal=causal)
    (o * torch.tensor(g)).sum().backward()
    grads = [t.grad.numpy() for t in tensors] + ([tm.grad.numpy()] if tm is not None else [])
    return o.detach().numpy(), grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    mask_kind, causal = CASES[case]
    q, k, v, g, mask = _inputs(1, mask_kind)
    o_j, _ = _jax(q, k, v, g, mask, causal)
    o_t, _ = _torch(q, k, v, g, mask, causal)
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax(case):
    mask_kind, causal = CASES[case]
    q, k, v, g, mask = _inputs(2, mask_kind)
    _, grads_j = _jax(q, k, v, g, mask, causal)
    _, grads_t = _torch(q, k, v, g, mask, causal)
    assert len(grads_t) == len(grads_j) == (4 if mask is not None else 3)
    if mask_kind == "bias":
        assert np.abs(grads_j[3]).max() > 1e-2  # the mask gradient carries signal
    for name, a, b in zip(("dq", "dk", "dv", "dmask"), grads_t, grads_j):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", ["mask", "causal_mask"])
def test_dropout_matches_jax_under_the_same_seed(case):
    """Rate 0.1: the JAX side derives its seed from a PRNG key
    (jax.random.bits), and the port is handed that same uint32."""
    mask_kind, causal = CASES[case]
    q, k, v, g, mask = _inputs(3, mask_kind)
    key = jax.random.PRNGKey(11)
    seed = int(jax.random.bits(key, dtype=jnp.uint32))
    o_j, grads_j = _jax(q, k, v, g, mask, causal, rate=0.1, key=key)
    o_t, grads_t = _torch(q, k, v, g, mask, causal, rate=0.1, seed=seed)
    np.testing.assert_allclose(o_t, o_j, **FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dmask"), grads_t, grads_j):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
    # and dropout really acted: the undropped output differs
    o_plain, _ = _torch(q, k, v, g, mask, causal)
    assert np.abs(o_plain - o_t).max() > 1e-2


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 2**32 - 1])
def test_keep_mask_equals_jax_bit_for_bit(seed, rate):
    want = np.asarray(jfa.dropout_keep_mask(seed, B, H, S, rate))
    got = tfa.dropout_keep_mask(seed, B, H, S, rate).numpy()
    assert got.dtype == np.bool_ and got.shape == (B, H, S, S)
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) < 0.02


def test_keep_mask_takes_a_tensor_seed():
    seed = 0x9E3779B9
    a = tfa.dropout_keep_mask(seed, B, H, S, 0.1)
    b = tfa.dropout_keep_mask(torch.tensor([seed], dtype=torch.int64), B, H, S, 0.1)
    assert torch.equal(a, b)


def test_mul32_keeps_the_low_32_bits():
    """The int64 hash splits each multiply into 16-bit halves: the full
    product of two 32-bit values would overflow int64."""
    rng = np.random.default_rng(5)
    xs = [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x80000000] + [
        int(x) for x in rng.integers(0, 2**32, size=200)]
    t = torch.tensor(xs, dtype=torch.int64)
    for c in (tfa._M1, tfa._M2, tfa._GOLDEN):
        got = tfa._mul32(t, c).tolist()
        assert got == [(x * c) & 0xFFFFFFFF for x in xs]


def test_rejects_what_jax_rejects():
    q, k, v, _, mask = _inputs(4, "padded")
    tq, tk, tv, tm = (torch.tensor(x) for x in (q, k, v, mask))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(tq, tk, tv, tm, dropout_fn=lambda p: p)
    with pytest.raises(ValueError):
        tfa.flash_attention(tq, tk, tv, tm, dropout_rate=0.1)  # no seed, no generator
    with pytest.raises(ValueError):
        tfa.flash_attention(tq, tk, tv, tm, dropout_rate=1.0, dropout_seed=1)


def test_seed_from_generator_is_a_uint32_and_reproducible():
    q, k, v, _, mask = _inputs(5, "padded")
    tq, tk, tv, tm = (torch.tensor(x) for x in (q, k, v, mask))
    seeds = [int(tfa.draw_seed(torch.Generator().manual_seed(3))) for _ in range(2)]
    assert seeds[0] == seeds[1] and 0 <= seeds[0] < 2**32
    a = tfa.flash_attention(tq, tk, tv, tm, dropout_rate=0.1,
                            generator=torch.Generator().manual_seed(3))
    b = tfa.flash_attention(tq, tk, tv, tm, dropout_rate=0.1, dropout_seed=seeds[0])
    assert torch.equal(a, b)


def test_attention_fn_flags():
    assert tfa.flash_attention.inkernel_dropout is True
    assert tfa.causal_flash_attention.inkernel_dropout is True
    assert tfa.causal_flash_attention.handles_causality is True
    q, k, v, g, _ = _inputs(6, None)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    assert torch.equal(tfa.causal_flash_attention(tq, tk, tv),
                       tfa.flash_attention(tq, tk, tv, causal=True))


def test_mask_without_grad_gets_no_gradient_and_same_qkv_grads(monkeypatch):
    """BERT's mask is built from input_mask and needs no gradient: the
    backward then asks the dk/dv kernel for no dmask rows, and dq/dk/dv are
    those of the run whose mask does take a gradient (and JAX's)."""
    q, k, v, g, mask = _inputs(7, "padded")
    _, grads_with = _torch(q, k, v, g, mask, False)
    _, grads_j = _jax(q, k, v, g, mask, False)

    asked = []
    backward = tfa._backward
    monkeypatch.setattr(tfa, "_backward",
                        lambda *a: asked.append(a[-1]) or backward(*a))
    tensors = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tm = torch.tensor(mask)
    o = tfa.flash_attention(*tensors, tm)
    (o * torch.tensor(g)).sum().backward()
    assert asked == [False]
    assert tm.grad is None
    for name, t, a, b in zip(("dq", "dk", "dv"), tensors, grads_with, grads_j):
        np.testing.assert_array_equal(t.grad.numpy(), a, err_msg=name)
        np.testing.assert_allclose(t.grad.numpy(), b, err_msg=name, **GRAD_TOL)


def test_routes_are_fixed_by_dtype():
    """Every bfloat16 kernel (forward, dq, dk/dv) goes to the bf16
    tensor-core kernels; every float32 one to the 3xTF32 ones. No other
    input picks the route."""
    assert tfa.route(torch.bfloat16) == "tc"
    assert tfa.route(torch.float32) == "tf32x3"
    tfa.reset_launch_counts()
    assert tfa.route_counts() == {"flash_fwd": {"tf32x3": 0, "tc": 0},
                                  "flash_bwd_dq": {"tf32x3": 0, "tc": 0},
                                  "flash_bwd_dkv": {"tf32x3": 0, "tc": 0}}


@pytest.mark.parametrize("route", sorted(tfa._SOURCES))
def test_wrapper_symbols_match_the_sources(route):
    """No compiler runs here, so hold the ctypes table against the C
    sources: every function the wrapper binds is exported by its source
    with as many parameters as the wrapper declares."""
    import re
    from pathlib import Path

    source, functions = tfa._SOURCES[route]
    text = (Path(tfa.__file__).parents[1] / "csrc" / f"{source}.cu").read_text()
    exported = {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert set(exported) == set(functions.values())
    for name, symbol in functions.items():
        assert exported[symbol].count(",") + 1 == len(tfa._ARGTYPES[name]), symbol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_matches_jax_formula(dtype):
    """Δ = rowsum(dO ⊙ O), which the dq kernels now compute, held against
    _flash_backward's own formula run through jnp, on the same numpy g and
    o cast to the same dtype. Each product of two bfloat16 values is exact
    in float32, so only the summation order can differ."""
    rng = np.random.default_rng(8)
    g, o = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(2))
    jg, jo = (jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (g, o))
    want = np.asarray(jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32),
                              axis=-1, keepdims=True))
    tg, to = (torch.tensor(x).to(getattr(torch, dtype)) for x in (g, o))
    got = tfa._delta(tg, to)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, S, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cpu_backward_never_calls_a_cuda_wrapper(monkeypatch):
    """A CPU tensor takes the plain versions, forward and backward: every
    CUDA wrapper is made to raise, and the backward still runs and matches
    JAX."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA wrapper was called on CPU tensors")

    for name in ("flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda"):
        monkeypatch.setattr(tfa, name, refuse)
    q, k, v, g, mask = _inputs(9, "padded")
    _, grads_t = _torch(q, k, v, g, mask, False)
    _, grads_j = _jax(q, k, v, g, mask, False)
    for name, a, b in zip(("dq", "dk", "dv", "dmask"), grads_t, grads_j):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_library_key_covers_the_shared_headers(tmp_path, monkeypatch):
    from gradaccum_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    before = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert cuda_build.library_path("k") != before
