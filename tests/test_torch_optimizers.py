"""The port's ``adam`` and ``sgd`` held against JAX's.

Mirrors ``tests/test_adamw.py``: three bias-corrected Adam updates against
the TF formulation and against JAX (parameters within 2e-6; ``t`` exact),
Adam's ``t`` independent of the caller's step, and SGD with and without
momentum over three updates against JAX. ``alpha_t`` is computed in
float32 on the device from ``t``, as JAX does.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.ops import adamw as topt
from gradaccum_tpu_torch.ops import schedule as tsched

jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jsched = importlib.import_module("gradaccum_tpu.ops.schedule")

pytestmark = pytest.mark.torch

PARAM_ATOL = 2e-6


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=shape).astype(np.float32) for name, shape in shapes.items()}


SHAPES = {"dense/bias": (4,), "dense/kernel": (3, 4), "p": (5,)}


def _run(t_opt, j_opt, steps=(0, 0, 0), seed=0):
    params = _tree(seed, SHAPES)
    grads = [_tree(seed + 1 + i, SHAPES) for i in range(len(steps))]
    tp = {n: torch.tensor(v) for n, v in params.items()}
    ts = t_opt.init(tp)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = j_opt.init(jp)
    j_update = jax.jit(j_opt.update)
    for g, step in zip(grads, steps):
        tp, ts = t_opt.update({n: torch.tensor(v) for n, v in g.items()}, ts, tp, step)
        jp, js = j_update({n: jnp.asarray(v) for n, v in g.items()}, js, jp, step)
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=0,
                                       atol=PARAM_ATOL, err_msg=n)
    return params, grads, tp, ts, js


def test_adam_bias_correction_matches_tf_formulation_and_jax():
    params, grads, tp, ts, js = _run(topt.adam(1e-3), jopt.adam(1e-3))
    p, m, v = params["p"], 0.0, 0.0
    for t, g in enumerate((gr["p"] for gr in grads), 1):
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        alpha = 1e-3 * np.sqrt(1 - 0.999**t) / (1 - 0.9**t)
        p = p - alpha * m / (np.sqrt(v) + 1e-8)
    np.testing.assert_allclose(tp["p"].numpy(), p, rtol=1e-5)
    assert int(ts.t) == int(js.t) == 3 and ts.t.dtype == torch.int32


def test_adam_with_a_schedule_matches_jax():
    _run(topt.adam(tsched.warmup_polynomial_decay(1e-2, 10, 2), beta_1=0.8, epsilon=1e-6),
         jopt.adam(jsched.warmup_polynomial_decay(1e-2, 10, 2), beta_1=0.8, epsilon=1e-6),
         steps=(1, 4, 9))


def test_adam_t_independent_of_schedule_step():
    """The update count lives in the optimizer state, not in the caller's
    step counter."""
    opt = topt.adam(1e-2)
    grads = {"p": torch.full((2,), 0.5)}
    a, _ = opt.update(grads, opt.init({"p": torch.ones(2)}), {"p": torch.ones(2)}, 999)
    b, _ = opt.update(grads, opt.init({"p": torch.ones(2)}), {"p": torch.ones(2)}, 0)
    assert torch.equal(a["p"], b["p"])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    _, _, tp, ts, js = _run(topt.sgd(0.1, momentum=momentum), jopt.sgd(0.1, momentum=momentum))
    if momentum:
        for n in SHAPES:
            np.testing.assert_allclose(ts[n].numpy(), np.asarray(js[n]), rtol=0, atol=1e-6)
    else:
        assert ts == () and js == ()


def test_sgd_step():
    opt = topt.sgd(0.1)
    p, _ = opt.update({"p": torch.full((2,), 0.5)}, opt.init({"p": torch.ones(2)}),
                      {"p": torch.ones(2)}, 0)
    np.testing.assert_allclose(p["p"].numpy(), 0.95)


@pytest.mark.parametrize("knob", [dict(master_dtype=torch.float32), dict(moment_dtype="q8")])
def test_unported_adam_knobs_raise(knob):
    # these knobs were refused before the mixed-precision slice; they build
    # now, and tests/test_torch_mixed.py holds them against JAX
    opt = topt.adam(1e-3, **knob)
    state = opt.init({"w": torch.zeros(3)})
    if "master_dtype" in knob:
        assert isinstance(state, topt.MasterAdamBCState) and opt.fused is not None
    else:
        assert type(state.m["w"]).__name__ == "QuantTensor" and opt.fused is None
