"""The port's blockwise int8 codec held against JAX's ``memory/quant.py``.

The same seeded numpy values go through both packages: the int8 codes and
the float32 scales must be equal bit for bit, at lengths that end inside,
on and past a 256-value block, for an all-zero block (scale 0, exact zeros
back) and for a block that holds +-absmax (codes +-127, and ties that round
half to even). The round trip is off by at most absmax/254 per value, and
the codes take under a 3.9th of float32's bytes.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.memory import quant as tq

jq = importlib.import_module("gradaccum_tpu.memory.quant")

pytestmark = pytest.mark.torch


def _both(x: np.ndarray):
    t = tq.quantize_blockwise(torch.from_numpy(x))
    j = jq.quantize_blockwise(jnp.asarray(x))
    return t, j


def _assert_same_codes(t, j):
    assert t.shape == j.shape
    assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy().view(np.uint32),
                                  np.asarray(j.scale).view(np.uint32))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1024])
def test_codes_and_scales_bitwise_equal_to_jax(n):
    x = np.random.default_rng(n).normal(0, 0.02, size=(n,)).astype(np.float32)
    t, j = _both(x)
    _assert_same_codes(t, j)
    assert t.q.shape == (-(-n // 256), 256)
    back = tq.dequantize_blockwise(t, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jq.dequantize_blockwise(j, jnp.float32)))


def test_zero_block_and_absmax_block():
    x = np.zeros((3, 256), np.float32)
    x[1] = np.linspace(-1.0, 1.0, 256, dtype=np.float32)  # +-absmax at the ends
    x[2, :4] = [2.5, -2.5, 2.5 * 127 / 254, 0.5 * 2.5 / 127]  # half-way ties
    t, j = _both(x)
    _assert_same_codes(t, j)
    assert float(t.scale[0]) == 0.0 and not bool(t.q[0].any())
    assert int(t.q[1, 0]) == -127 and int(t.q[1, -1]) == 127
    back = tq.dequantize_blockwise(t, torch.float32)
    assert back.shape == (3, 256) and not bool(back[0].any())


def test_round_trip_bound_and_bytes():
    x = np.random.default_rng(1).normal(0, 0.02, size=(1024,)).astype(np.float32)
    t = tq.quantize_blockwise(torch.from_numpy(x))
    back = tq.dequantize_blockwise(t, torch.float32).numpy()
    bound = np.repeat(np.abs(x.reshape(-1, 256)).max(axis=1) / 254.0, 256) + 1e-9
    assert np.all(np.abs(back - x) <= bound)
    assert t.nbytes < x.nbytes / 3.9
    with pytest.raises(ValueError, match="shape"):
        t.copy_(tq.quantize_blockwise(torch.zeros(5)))
