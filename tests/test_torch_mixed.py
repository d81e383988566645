"""Mixed precision, memory-lean optimizer state and fused accumulation in
the port, held against JAX's ``tests/test_mixed.py`` contracts.

- Optimizers: ``adamw``/``adam`` with float32 masters over bfloat16
  parameters, fed the same bfloat16 gradients as JAX: masters and moments
  within 1e-6 of JAX's after 5 updates, the bfloat16 parameters equal.
  Updates below a bfloat16 ulp accumulate in the masters. The downcast
  contract raises as JAX's does, and an explicit ``moment_dtype`` allows
  it. ``q8`` moments decode within one quantum of JAX's; ``adam_mini``'s
  scalar v (with and without q8) within 1e-6. q8 optimizers and
  ``adam_mini`` expose no fused hooks.
- Fused accumulation (scan, and streaming with the quirk on and off):
  parameters and moments within 1e-6 of JAX's fused trajectory at K=4;
  bitwise equal to the port's two-pass path at K=1; the all-bad window a
  bitwise no-op in bfloat16 with masters, with the loss-scale cycle and
  the skip counts equal to JAX's; the streaming state has no accumulator;
  the accumulation layer's and the Estimator's refusals raise JAX's errors.
- Checkpoints: housing bfloat16 with ``adam(master_dtype=float32)``
  resumes bit for bit (scan, and streaming in the middle of a window with
  fused accumulation or with q8 moments); a q8 moment restores only into
  its own shape.
- ``compute_dtype`` in the BERT, MLP and CNN bundles: bfloat16 storage,
  the forward within bfloat16 tolerance of JAX's from the same weights.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator import checkpoint as tckpt
from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator
from gradaccum_tpu_torch.interop import params_from_jax
from gradaccum_tpu_torch.memory.quant import QuantTensor, dequantize_blockwise
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.models import housing_mlp as thousing
from gradaccum_tpu_torch.models import mnist_cnn as tmnist
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as topt
from gradaccum_tpu_torch.ops import loss_scale as tls

jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jls = importlib.import_module("gradaccum_tpu.ops.loss_scale")
jquant = importlib.import_module("gradaccum_tpu.memory.quant")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")
jest = importlib.import_module("gradaccum_tpu.estimator.estimator")
jbert = importlib.import_module("gradaccum_tpu.models.bert")
jhousing = importlib.import_module("gradaccum_tpu.models.housing_mlp")
jmnist = importlib.import_module("gradaccum_tpu.models.mnist_cnn")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K, B = 4, 8
BF16 = torch.bfloat16
STATE_ATOL = 1e-6  # masters, moments and f32 parameters against JAX


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def toy(seed, n_windows=3, bad=()):
    """Linear-regression parameters and windows of K*B rows; the
    micro-batches ``(window, index)`` in ``bad`` get NaN inputs."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3, 1)).astype(np.float32),
              "bias": rng.normal(size=(1,)).astype(np.float32)}
    windows = []
    for w in range(n_windows):
        x = rng.normal(size=(K * B, 3)).astype(np.float32)
        y = (x @ np.asarray([[1.0], [-2.0], [0.5]], np.float32)
             + rng.normal(0, 0.1, size=(K * B, 1))).astype(np.float32)
        for bw, i in bad:
            if bw == w:
                x[i * B:(i + 1) * B] = np.nan
        windows.append({"x": x, "y": y})
    return params, windows


def j_loss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["bias"] - b["y"]) ** 2)


def t_loss(p, b):
    return torch.mean((b["x"] @ p["w"].float() + p["bias"].float() - b["y"]) ** 2)


def _calls(mode, windows, k=K):
    if mode == "scan":
        return windows
    return [{key: v[i * B:(i + 1) * B] for key, v in w.items()} for w in windows
            for i in range(k)]


def _opt_leaves(state):
    """``{field/name: tensor}`` of an optimizer state (q8 moments decoded)."""
    out = {}
    for field in state._fields:
        value = getattr(state, field)
        if isinstance(value, dict):
            for name, t in value.items():
                if isinstance(t, QuantTensor):
                    t = dequantize_blockwise(t)
                elif isinstance(t, jquant.QuantTensor):
                    t = jquant.dequantize_blockwise(t, jnp.float32)
                out[f"{field}/{name}"] = _np(t)
        else:
            out[field] = _np(value)
    return out


def run_port(mode, params, windows, opt, cfg, k=K, dtype=None):
    tparams = {n: torch.tensor(params[n]).to(dtype or torch.float32).requires_grad_()
               for n in sorted(params)}
    if mode == "scan":
        fn = tacc.accumulate_scan(t_loss, opt, cfg)
        state = tacc.scan_init(tparams, opt, loss_scale=cfg.loss_scale)
    else:
        fn = tacc.streaming_step(t_loss, opt, cfg)
        state = tacc.streaming_init(tparams, opt, loss_scale=cfg.loss_scale,
                                    fused=cfg.fused_adam)
    auxes, snaps = [], []
    for n, call in enumerate(_calls(mode, windows, k), 1):
        batch = {key: torch.tensor(v) for key, v in call.items()}
        if mode == "scan":
            batch = tacc.stack_micro_batches(batch, k)
        state, aux = fn(state, batch)
        auxes.append({key: _np(torch.as_tensor(v)) for key, v in aux.items()})
        if mode == "scan" or n % k == 0:
            snaps.append([t.detach().clone() for t in _state_tensors(state)])
    return state, auxes, snaps


def _state_tensors(state):
    out = list(state.params.values())
    for value in state.opt_state:
        values = value.values() if isinstance(value, dict) else [value]
        for t in values:
            out.extend([t.q, t.scale] if isinstance(t, QuantTensor) else [t])
    return out


def run_jax(mode, params, windows, opt, cfg, k=K, dtype=None):
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    if dtype is not None:
        jparams = jtree.tree_cast_floating(jparams, jnp.bfloat16)
    if mode == "scan":
        fn = jax.jit(jacc.accumulate_scan(j_loss, opt, cfg))
        state = jacc.scan_init(jparams, opt, loss_scale=cfg.loss_scale)
    else:
        fn = jax.jit(jacc.streaming_step(j_loss, opt, cfg))
        state = jacc.streaming_init(jparams, opt, loss_scale=cfg.loss_scale,
                                    fused=cfg.fused_adam)
    auxes = []
    for call in _calls(mode, windows, k):
        batch = jacc.stack_micro_batches(call, k) if mode == "scan" else call
        state, aux = fn(state, batch)
        auxes.append({key: np.asarray(v) for key, v in aux.items()})
    return state, auxes


def _configs(**kw):
    ls = kw.pop("loss_scale", None)
    return (tacc.GradAccumConfig(**kw, loss_scale=None if ls is None
                                 else tls.LossScaleConfig(*ls)),
            jacc.GradAccumConfig(**kw, loss_scale=None if ls is None
                                 else jls.LossScaleConfig(*ls)))


def _assert_states_close(state, jstate, atol=STATE_ATOL, params_equal=False):
    for name, p in state.params.items():
        got, want = _np(p), _np(jstate.params[name])
        if params_equal:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    got, want = _opt_leaves(state.opt_state), _opt_leaves(jstate.opt_state)
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _bf16_grads(seed, shapes):
    """bfloat16 gradients as numpy float32 values both packages cast exactly."""
    rng = np.random.default_rng(seed)
    return {n: torch.tensor(rng.normal(size=s).astype(np.float32)).to(BF16).float().numpy()
            for n, s in shapes.items()}


SHAPES = {"dense/bias": (4,), "dense/kernel": (3, 4), "LayerNorm/scale": (5,)}


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_master_weights_match_jax_over_bf16_params(name):
    rng = np.random.default_rng(0)
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
    t_opt = getattr(topt, name)(1e-2, master_dtype=torch.float32)
    j_opt = getattr(jopt, name)(1e-2, master_dtype=jnp.float32)
    tp = {n: torch.tensor(v).to(BF16) for n, v in params.items()}
    jp = jtree.tree_cast_floating({n: jnp.asarray(v) for n, v in params.items()}, jnp.bfloat16)
    ts, js = t_opt.init(tp), j_opt.init(jp)
    assert type(ts).__name__ == type(js).__name__
    j_update = jax.jit(j_opt.update)
    for step in range(5):
        g = _bf16_grads(10 + step, SHAPES)
        tp, ts = t_opt.update({n: torch.tensor(v).to(BF16) for n, v in g.items()}, ts, tp, step)
        jp, js = j_update({n: jnp.asarray(v, jnp.bfloat16) for n, v in g.items()}, js, jp, step)
    for n in params:
        assert tp[n].dtype == BF16 and ts.master[n].dtype == torch.float32
        np.testing.assert_array_equal(_np(tp[n]), _np(jp[n]), err_msg=n)
    got, want = _opt_leaves(ts), _opt_leaves(js)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)


def test_master_weights_accumulate_sub_ulp_updates():
    """An update far below the bfloat16 ulp at 1.0: the masters integrate
    every step and track the float32 run; bfloat16 without masters never
    moves (as JAX's test_master_weights_accumulate_sub_ulp_updates)."""
    p32 = {"w": torch.ones(4)}
    pbf = {"w": torch.ones(4, dtype=BF16)}
    pnv = {"w": torch.ones(4, dtype=BF16)}
    g32 = {"w": torch.full((4,), 0.5)}
    gbf = {"w": torch.full((4,), 0.5, dtype=BF16)}
    ref = topt.adamw(1e-5, weight_decay_rate=0.0)
    mix = topt.adamw(1e-5, weight_decay_rate=0.0, master_dtype=torch.float32)
    naive = topt.adamw(1e-5, weight_decay_rate=0.0)
    s_ref, s_mix, s_naive = ref.init(p32), mix.init(pbf), naive.init(pnv)
    for step in range(20):
        p32, s_ref = ref.update(g32, s_ref, p32, step)
        pbf, s_mix = mix.update(gbf, s_mix, pbf, step)
        pnv, s_naive = naive.update(gbf, s_naive, pnv, step)
    np.testing.assert_allclose(s_mix.master["w"].numpy(), p32["w"].numpy(), rtol=1e-5, atol=1e-7)
    assert float(p32["w"][0]) < 1.0
    assert float(pnv["w"][0]) == 1.0


def test_silent_moment_downcast_raises_explicit_cast_allowed():
    bp = {"w": torch.ones(8, 4, dtype=BF16)}
    g32 = {"w": torch.full((8, 4), 0.25)}
    jbp = {"w": jnp.ones((8, 4), jnp.bfloat16)}
    jg32 = {"w": jnp.full((8, 4), 0.25)}
    for t_opt, j_opt in ((topt.adamw(1e-2), jopt.adamw(1e-2)), (topt.adam(1e-2), jopt.adam(1e-2))):
        with pytest.raises(ValueError) as want:
            j_opt.update(jg32, j_opt.init(jbp), jbp, 0)
        with pytest.raises(ValueError) as got:
            t_opt.update(g32, t_opt.init(bp), bp, 0)
        assert str(got.value).replace("torch.", "") == str(want.value)
    opt = topt.adamw(1e-2, moment_dtype=BF16)
    params, state = opt.update(g32, opt.init(bp), bp, 0)
    assert state.m["w"].dtype == BF16 and params["w"].dtype == BF16
    opt = topt.adamw(1e-2, master_dtype=torch.float32)
    state = opt.init(bp)
    assert isinstance(state, topt.MasterAdamState)
    assert state.m["w"].dtype == state.master["w"].dtype == torch.float32
    assert opt.update(g32, state, bp, 0)[0]["w"].dtype == BF16


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_q8_moments_within_one_quantum_of_jax(name):
    rng = np.random.default_rng(2)
    shapes = {"w": (300,), "b": (7,)}
    params = {n: rng.normal(0, 0.1, size=s).astype(np.float32) for n, s in shapes.items()}
    t_opt = getattr(topt, name)(1e-2, moment_dtype="q8")
    j_opt = getattr(jopt, name)(1e-2, moment_dtype="q8")
    assert t_opt.fused is None and j_opt.fused is None
    tp = {n: torch.tensor(v) for n, v in params.items()}
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    ts, js = t_opt.init(tp), j_opt.init(jp)
    j_update = jax.jit(j_opt.update)
    for step in range(5):
        g = {n: rng.normal(0, 1, size=s).astype(np.float32) for n, s in shapes.items()}
        tp, ts = t_opt.update({n: torch.tensor(v) for n, v in g.items()}, ts, tp, step)
        jp, js = j_update({n: jnp.asarray(v) for n, v in g.items()}, js, jp, step)
    for field in ("m", "v"):
        for n in shapes:
            t, j = getattr(ts, field)[n], getattr(js, field)[n]
            assert isinstance(t, QuantTensor) and t.q.dtype == torch.int8
            quantum = np.repeat(np.asarray(j.scale), 256)[:t.q.numel()].reshape(t.q.shape)
            diff = np.abs(t.q.numpy().astype(np.float32) * t.scale.numpy()[:, None]
                          - np.asarray(j.q).astype(np.float32) * np.asarray(j.scale)[:, None])
            assert np.all(diff <= quantum * (1 + 1e-6) + 1e-12), (field, n)
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("q8", [False, True], ids=["f32-m", "q8-m"])
def test_adam_mini_scalar_v_matches_jax(q8):
    rng = np.random.default_rng(3)
    shapes = {"w": (16, 4), "bias": (4,)}
    params = {n: rng.normal(0, 0.1, size=s).astype(np.float32) for n, s in shapes.items()}
    kw = dict(moment_dtype="q8") if q8 else {}
    t_opt, j_opt = topt.adam_mini(1e-2, **kw), jopt.adam_mini(1e-2, **kw)
    assert t_opt.fused is None and j_opt.fused is None
    tp = {n: torch.tensor(v) for n, v in params.items()}
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    ts, js = t_opt.init(tp), j_opt.init(jp)
    assert isinstance(ts, topt.AdamBCState)
    for step in range(5):
        g = {n: rng.normal(0, 1, size=s).astype(np.float32) for n, s in shapes.items()}
        tp, ts = t_opt.update({n: torch.tensor(v) for n, v in g.items()}, ts, tp, step)
        jp, js = j_opt.update({n: jnp.asarray(v) for n, v in g.items()}, js, jp, step)
    for n in shapes:
        assert ts.v[n].shape == () and ts.v[n].dtype == torch.float32
        np.testing.assert_allclose(float(ts.v[n]), float(js.v[n]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=0, atol=1e-5)
    assert int(ts.t) == int(js.t) == 5
    masters = topt.adam_mini(1e-2, master_dtype=torch.float32, moment_dtype="q8")
    state = masters.init({n: t.to(BF16) for n, t in tp.items()})
    assert isinstance(state, topt.MasterAdamBCState) and state.master["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# fused accumulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,quirk", [("scan", False), ("streaming", True),
                                        ("streaming", False)],
                         ids=["scan", "streaming-quirk", "streaming-no-quirk"])
def test_fused_trajectory_matches_jax(mode, quirk):
    params, windows = toy(0, n_windows=3)
    tcfg, jcfg = _configs(num_micro_batches=K, fused_adam=True, first_step_quirk=quirk)
    port = run_port(mode, params, windows, topt.adamw(1e-2, weight_decay_rate=0.01), tcfg)
    jrun = run_jax(mode, params, windows, jopt.adamw(1e-2, weight_decay_rate=0.01), jcfg)
    _assert_states_close(port[0], jrun[0])
    for got, want in zip(port[1], jrun[1]):
        assert "grad_norm" not in got and got.keys() == want.keys()
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    if mode == "streaming":
        assert port[0].accum_grads == () and jrun[0].accum_grads == ()
        assert int(port[0].good_count) == int(jrun[0].good_count)


@pytest.mark.parametrize("opt_name", ["adamw", "adam"])
@pytest.mark.parametrize("mode", ["scan", "streaming"])
def test_fused_equals_two_pass_at_k1_bitwise(mode, opt_name):
    params, windows = toy(1, n_windows=1)
    windows = [{k: v[:B] for k, v in w.items()} for w in windows * 3]
    states = []
    for fused in (False, True):
        opt = getattr(topt, opt_name)(1e-2, master_dtype=torch.float32)
        cfg = tacc.GradAccumConfig(1, fused_adam=fused)
        state, auxes, _ = run_port(mode, params, windows, opt, cfg, k=1, dtype=BF16)
        states.append((state, auxes))
    (a, aux_a), (b, aux_b) = states
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    losses = [r["loss"] for r in aux_a]
    assert np.all(np.isfinite(losses)) and losses == [r["loss"] for r in aux_b]


@pytest.mark.parametrize("mode", ["scan", "streaming"])
def test_fused_all_bad_window_is_a_bitwise_no_op_with_the_scale_cycle(mode):
    """bfloat16 parameters, float32 masters, fused, the guard and a dynamic
    scale: a window with one NaN micro-batch, an all-NaN window, then two
    clean ones. The skip counts, the good counts and the scales equal JAX's;
    the all-bad window leaves every parameter, master and moment bit for bit."""
    params, windows = toy(2, n_windows=4, bad={(0, 1)} | {(1, i) for i in range(K)})
    tcfg, jcfg = _configs(num_micro_batches=K, fused_adam=True, skip_nonfinite=True,
                          first_step_quirk=False, loss_scale=(16.0, 2))
    port = run_port(mode, params, windows, topt.adamw(1e-2, master_dtype=torch.float32),
                    tcfg, dtype=BF16)
    jrun = run_jax(mode, params, windows, jopt.adamw(1e-2, master_dtype=jnp.float32),
                   jcfg, dtype=BF16)
    for got, want in zip(port[1], jrun[1]):
        for key in ("skipped", "good_count", "loss_scale"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    snaps = port[2]
    assert all(torch.equal(x, y) for x, y in zip(snaps[0], snaps[1]))
    assert not all(torch.equal(x, y) for x, y in zip(snaps[1], snaps[2]))
    ends = [float(a["loss_scale"]) for a in port[1]][(K - 1 if mode == "streaming" else 0)::
                                                     (K if mode == "streaming" else 1)]
    assert ends == [8.0, 4.0, 4.0, 8.0]
    assert sum(int(a["skipped"]) for a in port[1]) == 1 + K
    _assert_states_close(port[0], jrun[0], atol=1e-5)


def test_fused_refusals_raise_jax_errors():
    base_t, base_j = _configs(num_micro_batches=K, fused_adam=True)
    with pytest.raises(ValueError, match="FusedAccum") as got:
        tacc.accumulate_scan(t_loss, topt.sgd(1e-2), base_t)
    with pytest.raises(ValueError, match="FusedAccum"):
        jacc.accumulate_scan(j_loss, jopt.sgd(1e-2), base_j)
    with pytest.raises(ValueError, match="FusedAccum"):
        tacc.streaming_step(t_loss, topt.adamw(1e-2, moment_dtype="q8"), base_t)
    assert "ops.adamw.adamw / ops.adamw.adam" in str(got.value)
    # the Estimator: an optimizer without hooks, and sparse_embed
    cases = [
        (dict(), lambda m: (m.sgd(1e-2),)),
        (dict(sparse_embed=True), lambda m: (m.adamw(1e-2),)),
    ]
    jb = jbert.bert_classifier_bundle(jbert.BertConfig.tiny_for_tests())
    tb = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests())
    for kw, make_opt in cases:
        with pytest.raises(ValueError) as want:
            jest.Estimator(jb, *make_opt(jopt), base_j, mode="scan", **kw)
        with pytest.raises(ValueError) as got:
            Estimator(tb, *make_opt(topt), base_t, mode="scan", device="cpu", **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

HK = 3  # K of the housing runs: windows of 3 in streaming mode


def _housing_estimator(model_dir, mode, opt, fused=False):
    bundle = thousing.housing_mlp_bundle(hidden=(16, 8), compute_dtype=BF16)
    return Estimator(bundle, opt, tacc.GradAccumConfig(HK, fused_adam=fused),
                     RunConfig(model_dir=str(model_dir), seed=11, save_checkpoints_steps=None,
                               log_step_count_steps=1000),
                     mode=mode, device="cpu")


def _housing_batches(n, rows):
    rng = np.random.default_rng(7)
    return [{"x": rng.normal(size=(rows, 14)).astype(np.float32),
             "y": rng.normal(size=(rows, 1)).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("case", ["scan-master", "streaming-fused", "streaming-q8"])
def test_bf16_master_checkpoint_bitwise_resume(tmp_path, case):
    """Train straight against train, crash, restore from disk, train on:
    the bfloat16 parameters, the float32 masters and the moments (q8 codes
    and scales) equal bit for bit. The streaming runs stop in the middle of
    a window (5 micro-batches at K=3, the quirk on: applies at 0 and 3)."""
    mode = "scan" if case == "scan-master" else "streaming"

    def opt():
        if case == "streaming-q8":
            return topt.adamw(1e-2, master_dtype=torch.float32, moment_dtype="q8")
        return topt.adam(1e-2, master_dtype=torch.float32)

    fused = case == "streaming-fused"
    if mode == "scan":
        batches, stop, total = _housing_batches(4, HK * B), 2 * HK, 4 * HK
        first, rest = batches[:2], batches[2:]
    else:
        batches, stop, total = _housing_batches(9, B), 5, 9
        first, rest = batches[:5], batches[5:]
    full = _housing_estimator(tmp_path / "full", mode, opt(), fused).train(batches, total)
    _housing_estimator(tmp_path / "res", mode, opt(), fused).train(first, stop)
    assert tckpt.latest_checkpoint(str(tmp_path / "res"))[0] == stop
    resumed = _housing_estimator(tmp_path / "res", mode, opt(), fused).train(rest, total)
    assert full.step == resumed.step == total
    assert next(iter(resumed.params.values())).dtype == BF16
    assert type(resumed.opt_state) is type(full.opt_state)
    assert "master" in resumed.opt_state._fields
    if fused:
        assert resumed.accum_grads == ()
    a, b = _state_tensors(full), _state_tensors(resumed)
    assert len(a) == len(b) and any(t.dtype == torch.int8 for t in a) == (case == "streaming-q8")
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_q8_moment_restores_only_into_its_shape(tmp_path):
    opt = topt.adamw(1e-2, moment_dtype="q8")
    tckpt.save(str(tmp_path), opt.init({"w": torch.ones(5)}), step=1)
    restored = tckpt.restore(str(tmp_path), opt.init({"w": torch.zeros(5)}))
    assert restored.m["w"].shape == (5,)
    with pytest.raises(ValueError, match="QuantTensor of shape"):
        tckpt.restore(str(tmp_path), opt.init({"w": torch.zeros(6)}))


# ---------------------------------------------------------------------------
# compute_dtype storage in the BERT, MLP and CNN bundles
# ---------------------------------------------------------------------------

# bf16 forward against JAX's from the same bf16 weights: both run each
# product in bfloat16 (2^-8 relative per rounding) in another summation
# order; the heads are float32
BF16_FWD_TOL = dict(rtol=5e-2, atol=5e-2)


def _bert_inputs():
    rng = np.random.default_rng(4)
    mask = np.ones((4, 16), np.int32)
    mask[1, 10:] = 0
    return {"input_ids": (rng.integers(5, 128, size=(4, 16)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((4, 16), np.int32),
            "label": rng.integers(0, 2, size=4).astype(np.int32)}


def _bf16_pair(j_f32_bundle, j_bf16_bundle, t_bundle, sample):
    params = j_f32_bundle.init(jax.random.PRNGKey(0), sample)
    model = t_bundle.init(1, "cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))  # rounds to bf16
    return jtree.tree_cast_floating(params, jnp.bfloat16), model


@pytest.mark.parametrize("which", ["bert", "housing", "mnist"])
def test_compute_dtype_storage_and_forward_match_jax(which):
    if which == "bert":
        cfg_kw = dict(hidden_dropout=0.0, attention_dropout=0.0)
        batch = _bert_inputs()
        jf = jbert.bert_classifier_bundle(jbert.BertConfig.tiny_for_tests(**cfg_kw))
        jb = jbert.bert_classifier_bundle(jbert.BertConfig.tiny_for_tests(**cfg_kw),
                                          compute_dtype=jnp.bfloat16)
        tb = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests(**cfg_kw),
                                          compute_dtype=BF16)
        key, sample = "logits", {k: v[:1] for k, v in batch.items()}
    elif which == "housing":
        rng = np.random.default_rng(5)
        batch = {"x": rng.uniform(0, 2, size=(8, 14)).astype(np.float32),
                 "y": rng.normal(size=(8, 1)).astype(np.float32)}
        jf, jb = jhousing.housing_mlp_bundle(), jhousing.housing_mlp_bundle(
            compute_dtype=jnp.bfloat16)
        tb = thousing.housing_mlp_bundle(compute_dtype=BF16)
        key, sample = "predictions", batch
    else:
        rng = np.random.default_rng(6)
        batch = {"image": rng.uniform(0, 1, size=(4, 28, 28, 1)).astype(np.float32),
                 "label": rng.integers(0, 10, size=4).astype(np.int32)}
        jf, jb = jmnist.mnist_cnn_bundle(), jmnist.mnist_cnn_bundle(compute_dtype=jnp.bfloat16)
        tb = tmnist.mnist_cnn_bundle(compute_dtype=BF16)
        key, sample = "logits", batch
    jparams, model = _bf16_pair(jf, jb, tb, sample)
    assert {p.dtype for p in model.parameters()} == {BF16}
    assert {leaf.dtype for leaf in jax.tree.leaves(jparams)} == {jnp.dtype(jnp.bfloat16)}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = tb.predict(model, tbatch)[key]
    want = np.asarray(jb.predict(jparams, batch)[key])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16_FWD_TOL)
    loss = tb.loss(model, dict(tbatch, rng=torch.Generator().manual_seed(0)))
    jloss = jb.loss(jparams, dict(batch, rng=jax.random.PRNGKey(0)))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), **BF16_FWD_TOL)
