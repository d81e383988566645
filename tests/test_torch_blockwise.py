"""The port's blockwise attention and ``bwd_impl="xla"`` held against JAX's.

Both sides get the same numpy inputs. ``blockwise_attention`` is XLA code in
JAX (a ``lax.scan`` over key blocks) and plain torch ops in the port; its
forward and its gradients (autograd against ``jax.vjp``) agree to 1e-5 in
float32, where only the summation order differs, and to 2e-2 in bfloat16,
where both sides round the block products to bf16 (2^-8 relative) and may
accumulate them in another order. ``flash_attention(bwd_impl="xla")`` keeps
the forward (the Pallas kernel in interpret mode on the JAX side, the
kernel's plain version here) and differentiates the blockwise core: its
gradients agree with JAX's ``bwd_impl="xla"`` and with the port's own
kernel-path backward to 1e-4, the flash suite's gradient tolerance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.parallel.ring_attention import blockwise_attention

jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")
jring = importlib.import_module("gradaccum_tpu.parallel.ring_attention")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

B, H, S, D = 2, 2, 16, 8
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = (0.5 * rng.normal(size=(B, 1, 1, S))).astype(np.float32)
        mask[0, ..., S - 5:] = -1e9  # padded keys beside a dense bias
    return q, k, v, g, mask


def _jax_grads(fn, q, k, v, g, mask, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    if mask is not None:
        args.append(jnp.asarray(mask, dtype))
    out, vjp = jax.vjp(lambda *a: fn(*a[:3], a[3] if len(a) > 3 else None), *args)
    grads = vjp(jnp.asarray(g, dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(x.astype(jnp.float32)) for x in grads])


def _torch_grads(fn, q, k, v, g, mask, dtype=torch.float32):
    args = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    if mask is not None:
        args.append(torch.tensor(mask, dtype=dtype, requires_grad=True))
    out = fn(*args[:3], args[3] if len(args) > 3 else None)
    grads = torch.autograd.grad(out, args, torch.tensor(g, dtype=dtype))
    return out.detach().float().numpy(), [x.float().numpy() for x in grads]


def _close(got, want, tol):
    out_t, grads_t = got
    out_j, grads_j = want
    np.testing.assert_allclose(out_t, out_j, **tol)
    assert len(grads_t) == len(grads_j)
    for name, a, b in zip(("dq", "dk", "dv", "dmask"), grads_t, grads_j):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize("block", [8, S])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_blockwise_forward_and_grads_match_jax(block, causal, masked):
    q, k, v, g, mask = _inputs(block + 2 * causal + masked, masked)
    want = _jax_grads(lambda *a: jring.blockwise_attention(*a, block_size=block,
                                                           causal=causal), q, k, v, g, mask)
    got = _torch_grads(lambda *a: blockwise_attention(*a, block_size=block, causal=causal),
                       q, k, v, g, mask)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_bf16_matches_jax(causal):
    q, k, v, g, mask = _inputs(11, True)
    want = _jax_grads(lambda *a: jring.blockwise_attention(*a, block_size=8, causal=causal),
                      q, k, v, g, mask, dtype=jnp.bfloat16)
    got = _torch_grads(lambda *a: blockwise_attention(*a, block_size=8, causal=causal),
                       q, k, v, g, mask, dtype=torch.bfloat16)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_xla_backward_matches_jax_and_the_kernel_path(causal, masked):
    q, k, v, g, mask = _inputs(20 + 2 * causal + masked, masked)
    want = _jax_grads(lambda *a: jfa.flash_attention(*a, causal=causal, bwd_impl="xla",
                                                     block_q=8, block_k=8), q, k, v, g, mask)
    got = _torch_grads(lambda *a: tfa.flash_attention(*a, causal=causal, bwd_impl="xla",
                                                      block_k=8), q, k, v, g, mask)
    _close(got, want, GRAD_TOL)
    pallas = _torch_grads(lambda *a: tfa.flash_attention(*a, causal=causal), q, k, v, g, mask)
    _close(got, pallas, GRAD_TOL)


def test_causal_flash_attention_passes_bwd_impl_through():
    q, k, v, g, mask = _inputs(30, True)
    got = _torch_grads(lambda *a: tfa.causal_flash_attention(*a, bwd_impl="xla", block_k=8),
                       q, k, v, g, mask)
    want = _torch_grads(lambda *a: blockwise_attention(*a, block_size=8, causal=True),
                        q, k, v, g, mask)
    _close(got, want, GRAD_TOL)


def test_xla_backward_refuses_dropout_and_unknown_impls():
    q = torch.zeros(1, 1, 16, 8)
    with pytest.raises(NotImplementedError, match="no in-kernel dropout"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=3, bwd_impl="xla")
    with pytest.raises(ValueError, match="bwd_impl"):
        tfa.flash_attention(q, q, q, bwd_impl="triton")
    # JAX checks the seed before the backward: the same order of refusals
    with pytest.raises(ValueError, match="requires"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1, bwd_impl="xla")


def test_blockwise_refuses_dropout_and_ragged_blocks():
    q = torch.zeros(1, 1, 12, 8)
    with pytest.raises(NotImplementedError):
        blockwise_attention(q, q, q, dropout_fn=lambda p: p)
    with pytest.raises(ValueError, match="not divisible"):
        blockwise_attention(q, q, q, block_size=8)
