"""The port's threefry random numbers (``utils/prng.py``) against ``jax.random``.

JAX's default implementation in this environment: ``threefry2x32`` with
``jax_threefry_partitionable=True``. Key data, ``fold_in``, the random bits
and the uniforms are bitwise equal to JAX's for several seeds, fold-in
indices and shapes, the GPT vocabulary of 50257 included, and so are the
per-row (vmapped) keys the serving engine uses. The Gumbel draws go through
``log`` twice, and torch's ``log`` and XLA's differ in the last bits: they
are held within 4 float32 ulps of magnitude 16 (GUMBEL_ATOL), and the
categorical draws built on them are equal on the cases below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.utils import prng

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1, -1, 2 ** 32 - 1, 2 ** 40 + 3, -(2 ** 31) - 1]
SHAPES = [(1,), (5,), (3, 7), (2, 96), (50257,)]
# two float32 logs of different implementations: |a - b| within a few ulps
# of the largest value a low-mode Gumbel draw reaches (~16)
GUMBEL_ATOL = 4 * float(np.spacing(np.float32(16.0)))


def _same(a, b):
    a = np.asarray(a).astype(np.int64) if np.asarray(a).dtype.kind == "u" else np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.astype(a.dtype).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_are_jax_bits(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same(jk, tk)
    for data in (0, 1, 5, 1000, 2 ** 31 + 5):
        _same(jax.random.fold_in(jk, data), prng.fold_in(tk, data))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_bits_and_uniforms_are_jax_bits(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    tk = prng.fold_in(prng.PRNGKey(seed), 11)
    _same(jax.random.bits(jk, shape), prng.random_bits(tk, shape))
    _same(jax.random.uniform(jk, shape), prng.uniform(tk, shape))
    tiny = float(np.finfo(np.float32).tiny)
    _same(jax.random.uniform(jk, shape, minval=tiny, maxval=1.0),
          prng.uniform(tk, shape, minval=tiny, maxval=1.0))
    _same(jax.random.uniform(jk, shape, minval=-2.5, maxval=3.0),
          prng.uniform(tk, shape, minval=-2.5, maxval=3.0))


@pytest.mark.parametrize("mode", ["low", "high"])
def test_gumbel_within_ulps(mode):
    for seed in (0, 5):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for shape in ((96,), (50257,)):
            want = np.asarray(jax.random.gumbel(jk, shape, mode=mode))
            got = prng.gumbel(tk, shape, mode).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


def test_vmapped_keys_match_per_row():
    """One key per slot, each folded with its own index: the engine's draw."""
    seeds, idx = [3, 0, 9, 2 ** 31 - 1], [0, 3, 5, 9]
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    folded = jax.vmap(jax.random.fold_in)(jkeys, jnp.asarray(idx))
    tfolded = prng.fold_in(prng.key_data(seeds), torch.tensor(idx))
    _same(folded, tfolded)
    _same(jax.vmap(lambda k: jax.random.bits(k, (96,)))(folded),
          prng.random_bits(tfolded, (96,)))
    _same(jax.vmap(lambda k: jax.random.uniform(k, (50257,)))(folded),
          prng.uniform(tfolded, (50257,)))
    logits = np.random.default_rng(0).normal(size=(4, 96)).astype(np.float32) * 3
    want = jax.vmap(lambda k, lg: jax.random.categorical(k, lg))(folded, logits)
    _same(want, prng.categorical(tfolded, torch.tensor(logits)))


def test_categorical_single_key_over_a_batch():
    """A ``[2]`` key draws the noise over the whole ``[B, V]`` (flat counts)."""
    rng = np.random.default_rng(1)
    for seed in range(6):
        logits = rng.normal(size=(3, 50)).astype(np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), seed + 2)
        want = jax.random.categorical(key, logits)
        got = prng.categorical(prng.fold_in(prng.PRNGKey(seed), seed + 2),
                               torch.tensor(logits))
        _same(want, got)


def test_seed_range_is_jax_s():
    for seed in (2 ** 64, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            prng.PRNGKey(seed)
    with pytest.raises(ValueError, match="mode"):
        prng.gumbel(prng.PRNGKey(0), (3,), mode="mid")
