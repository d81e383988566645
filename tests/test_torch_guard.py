"""The non-finite guard and dynamic loss scaling of the port, against JAX.

On a linear regression toy, in scan and in streaming mode, the same numpy
windows (NaN inputs in chosen micro-batches) go through both packages with
``skip_nonfinite=True``:

- one NaN micro-batch in a window: it contributes zeros, the denominator
  stays K (or becomes the good count with ``normalize_by_good_count``);
- a window with only NaN micro-batches applies nothing: parameters and
  optimizer state after it equal those before it bit for bit;
- dynamic loss scaling halves on each dirty window and regrows after
  ``growth_interval`` clean ones: the scale sequence equals JAX's exactly;
- ``aux["skipped"]`` and ``aux["good_count"]`` equal JAX's exactly, and
  the parameters agree within 2e-6;
- ``validate_config`` refuses what JAX refuses, with the same error.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as topt
from gradaccum_tpu_torch.ops import loss_scale as tls

jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jls = importlib.import_module("gradaccum_tpu.ops.loss_scale")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K, B = 4, 8
PARAM_ATOL = 2e-6


def make_windows(seed, n_windows, bad):
    """Parameters and ``n_windows`` windows of K*B rows; the micro-batches
    ``(window, index)`` in ``bad`` get NaN inputs."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3, 1)).astype(np.float32),
              "bias": np.zeros((1,), np.float32)}
    windows = []
    for w in range(n_windows):
        x = rng.normal(size=(K * B, 3)).astype(np.float32)
        y = x @ np.asarray([[1.0], [-2.0], [0.5]], np.float32)
        for bw, i in bad:
            if bw == w:
                x[i * B:(i + 1) * B] = np.nan
        windows.append({"x": x, "y": y})
    return params, windows


def j_loss(params, batch):
    return jnp.mean((batch["x"] @ params["w"] + params["bias"] - batch["y"]) ** 2)


def t_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] + params["bias"] - batch["y"]) ** 2)


def _calls(mode, windows):
    if mode == "scan":
        return windows
    return [{k: v[i * B:(i + 1) * B] for k, v in w.items()} for w in windows for i in range(K)]


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def run_port(mode, params, windows, opt, cfg):
    """Final state, per-call aux (numpy) and a snapshot of (params, opt
    state) tensors after each window."""
    tparams = {k: torch.tensor(params[k], requires_grad=True) for k in sorted(params)}
    if mode == "scan":
        fn = tacc.accumulate_scan(t_loss, opt, cfg)
        state = tacc.scan_init(tparams, opt, loss_scale=cfg.loss_scale)
    else:
        fn = tacc.streaming_step(t_loss, opt, cfg)
        state = tacc.streaming_init(tparams, opt, loss_scale=cfg.loss_scale)
    auxes, snaps = [], []
    per_window = 1 if mode == "scan" else K
    for n, call in enumerate(_calls(mode, windows), 1):
        batch = {k: torch.tensor(v) for k, v in call.items()}
        if mode == "scan":
            batch = tacc.stack_micro_batches(batch, K)
        state, aux = fn(state, batch)
        auxes.append({k: _np(v) for k, v in aux.items()})
        if n % per_window == 0:
            snaps.append([t.detach().clone() for t in _tensors(state)])
    return state, auxes, snaps


def _tensors(state):
    opt = state.opt_state
    if isinstance(opt, tuple) and hasattr(opt, "_fields"):
        leaves = [v for f in opt for v in (f.values() if isinstance(f, dict) else [f])]
    else:
        leaves = list(opt.values()) if isinstance(opt, dict) else []
    return list(state.params.values()) + leaves


def run_jax(mode, params, windows, opt, cfg):
    if mode == "scan":
        fn = jax.jit(jacc.accumulate_scan(j_loss, opt, cfg))
        state = jacc.scan_init(params, opt, loss_scale=cfg.loss_scale)
    else:
        fn = jax.jit(jacc.streaming_step(j_loss, opt, cfg))
        state = jacc.streaming_init(params, opt, loss_scale=cfg.loss_scale)
    auxes = []
    for call in _calls(mode, windows):
        batch = jacc.stack_micro_batches(call, K) if mode == "scan" else call
        state, aux = fn(state, batch)
        auxes.append({k: np.asarray(v) for k, v in aux.items()})
    return state, auxes


def _configs(**kw):
    return (tacc.GradAccumConfig(K, first_step_quirk=False, **kw),
            jacc.GradAccumConfig(K, first_step_quirk=False,
                                 **{k: (jls.LossScaleConfig(*v) if k == "loss_scale" else v)
                                    for k, v in kw.items()}))


def _compare(port, jax_run, keys=("skipped", "good_count", "loss_scale")):
    (state, auxes, _), (jstate, jauxes) = port, jax_run
    assert len(auxes) == len(jauxes)
    for got, want in zip(auxes, jauxes):
        for key in keys:
            if key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    for name, p in state.params.items():
        assert bool(torch.isfinite(p).all()), name
        np.testing.assert_allclose(_np(p), np.asarray(jstate.params[name]), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", ["scan", "streaming"])
def test_one_nan_micro_batch_is_skipped_like_jax(mode, normalize):
    params, windows = make_windows(0, 2, bad={(0, 2)})
    tcfg, jcfg = _configs(clip_norm=1.0, skip_nonfinite=True,
                          normalize_by_good_count=normalize)
    port = run_port(mode, params, windows, topt.adamw(1e-2), tcfg)
    jax_run = run_jax(mode, params, windows, jopt.adamw(1e-2), jcfg)
    _compare(port, jax_run)
    skipped = [int(a["skipped"]) for a in port[1]]
    assert sum(skipped) == 1
    if mode == "streaming":
        assert skipped == [0, 0, 1, 0, 0, 0, 0, 0]
        assert [int(a["good_count"]) for a in port[1]] == [1, 1, 0, 1, 1, 1, 1, 1]
    else:
        assert skipped == [1, 0] and [int(a["good_count"]) for a in port[1]] == [3, 4]


@pytest.mark.parametrize("opt_name", ["adamw", "adam", "sgd-momentum"])
@pytest.mark.parametrize("mode", ["scan", "streaming"])
def test_all_bad_window_is_a_bitwise_no_op(mode, opt_name):
    params, windows = make_windows(1, 3, bad={(1, i) for i in range(K)})
    make = {"adamw": (topt.adamw(1e-2), jopt.adamw(1e-2)),
            "adam": (topt.adam(1e-2), jopt.adam(1e-2)),
            "sgd-momentum": (topt.sgd(1e-2, momentum=0.9), jopt.sgd(1e-2, momentum=0.9))}
    t_opt, j_opt = make[opt_name]
    tcfg, jcfg = _configs(skip_nonfinite=True)
    port = run_port(mode, params, windows, t_opt, tcfg)
    jax_run = run_jax(mode, params, windows, j_opt, jcfg)
    _compare(port, jax_run)
    snaps = port[2]
    assert all(torch.equal(a, b) for a, b in zip(snaps[0], snaps[1]))  # window 1: no-op
    assert not all(torch.equal(a, b) for a, b in zip(snaps[1], snaps[2]))  # window 2 applies
    if opt_name == "adam":
        assert int(port[0].opt_state.t) == int(jax_run[0].opt_state.t) == 2
    if mode == "scan":
        assert np.isnan(port[1][1]["loss"]) and np.isnan(jax_run[1][1]["loss"])


@pytest.mark.parametrize("mode", ["scan", "streaming"])
def test_loss_scale_halves_and_regrows_like_jax(mode):
    """Dirty, clean, clean, clean, clean, dirty, clean windows at growth
    interval 2: 16 -> 8, 8, 16, 16, 32 (capped at 32), 16, 16."""
    dirty = {0, 5}
    params, windows = make_windows(2, 7, bad={(w, 1) for w in dirty})
    scale_cfg = (16.0, 2, 2.0, 0.5, 1.0, 32.0)  # LossScaleConfig fields, in order
    tcfg, jcfg = _configs(clip_norm=1.0, skip_nonfinite=True,
                          loss_scale=tls.LossScaleConfig(*scale_cfg))
    port = run_port(mode, params, windows, topt.adam(1e-2), tcfg)
    jax_run = run_jax(mode, params, windows, jopt.adam(1e-2), jcfg)
    _compare(port, jax_run)
    ends = [float(a["loss_scale"]) for a in port[1]][(K - 1 if mode == "streaming" else 0)::
                                                     (K if mode == "streaming" else 1)]
    assert ends == [8.0, 8.0, 16.0, 16.0, 32.0, 16.0, 16.0]
    assert port[0].loss_scale.scale.dtype == torch.float32
    assert port[0].loss_scale.good_windows.dtype == torch.int32
    assert int(port[0].loss_scale.good_windows) == int(jax_run[0].loss_scale.good_windows)


def test_update_loss_scale_matches_jax_exactly():
    cfg = (4.0, 3, 2.0, 0.5, 1.0, 16.0)
    t_state = tls.init_loss_scale(tls.LossScaleConfig(*cfg))
    j_state = jls.init_loss_scale(jls.LossScaleConfig(*cfg))
    for clean in (False, False, False, True, True, True, True, True, True, True, True, False):
        t_state = tls.update_loss_scale(t_state, tls.LossScaleConfig(*cfg), torch.tensor(clean))
        j_state = jls.update_loss_scale(j_state, jls.LossScaleConfig(*cfg), jnp.asarray(clean))
        assert float(t_state.scale) == float(j_state.scale)
        assert int(t_state.good_windows) == int(j_state.good_windows)


REFUSALS = [
    dict(normalize_by_good_count=True),
    dict(loss_scale=()),
    dict(skip_nonfinite=True, normalize_by_good_count=True, loss_scale=()),
    dict(fused_adam=True, clip_norm=1.0),
    dict(fused_adam=True, skip_nonfinite=True, normalize_by_good_count=True),
    dict(fused_adam=True, axis_name="data"),
    dict(skip_nonfinite=True),
]


@pytest.mark.parametrize("which", range(len(REFUSALS)))
def test_validate_config_refuses_what_jax_refuses(which):
    kw = REFUSALS[which]
    t_kw = {k: (tls.LossScaleConfig(*v) if k == "loss_scale" else v) for k, v in kw.items()}
    j_kw = {k: (jls.LossScaleConfig(*v) if k == "loss_scale" else v) for k, v in kw.items()}
    try:
        jacc.validate_config(jacc.GradAccumConfig(K, **j_kw))
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        tacc.validate_config(tacc.GradAccumConfig(K, **t_kw))  # accepted by both
    else:
        with pytest.raises(ValueError) as got:
            tacc.validate_config(tacc.GradAccumConfig(K, **t_kw))
        assert str(got.value) == want


def test_all_finite_and_zero_if_bad_choose_on_the_device():
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(tacc._all_finite(torch.tensor(0.5), grads))
    assert not bool(tacc._all_finite(torch.tensor(float("nan")), grads[:1]))
    assert bool(tacc._all_finite(torch.tensor(0.5), grads[:1]))
    zeroed = tacc._zero_if_bad(grads, torch.tensor(False))
    assert all(bool((z == 0).all()) for z in zeroed)
    kept = tacc._zero_if_bad(grads[:1], torch.tensor(True))
    assert torch.equal(kept[0], grads[0])
