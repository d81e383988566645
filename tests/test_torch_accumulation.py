"""The port's train step held against the JAX package's, end to end.

Three scan-mode updates of the tiny BERT classifier (flash core, dropout
off) at micro-batch 2 x K=2, clip 1.0 and AdamW over a warmup + polynomial
decay schedule, in the port and in JAX ``accumulate_scan`` from the same
weights on the same batches. Per update, ``loss`` and ``grad_norm`` agree
to 1e-5 and ``lr_step`` exactly; schedule values agree exactly.

Final parameters agree to atol 2e-6. The AdamW step is ``lr·m/(√v + eps)``
with no bias correction, so for a gradient element far below eps/√(1−β2)
the update is about ``lr·0.1·g/eps`` = 100·g at lr 1e-3: a float32
summation-order difference of 1e-9 in such a gradient becomes 1e-7 in the
weight, and three updates stack it. 2e-6 leaves an order of magnitude over
that while any real divergence (a wrong sign, decay on the wrong leaf, an
off-by-one schedule step) moves weights by ~lr = 1e-3.
"""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.data.pipeline import Dataset
from gradaccum_tpu_torch.estimator import checkpoint as tckpt
from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator
from gradaccum_tpu_torch.interop import params_from_jax, params_to_jax
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as tadamw
from gradaccum_tpu_torch.ops import clipping as tclip
from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig
from gradaccum_tpu_torch.ops import schedule as tsched
from gradaccum_tpu_torch.utils.tree import named_parameters

jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jadamw = importlib.import_module("gradaccum_tpu.ops.adamw")
jbert = importlib.import_module("gradaccum_tpu.models.bert")
jclip = importlib.import_module("gradaccum_tpu.ops.clipping")
jfa = importlib.import_module("gradaccum_tpu.ops.flash_attention")
jsched = importlib.import_module("gradaccum_tpu.ops.schedule")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K, MICRO, S, UPDATES = 2, 2, 16, 3
LR, TOTAL, WARMUP = 1e-3, 12, 4
PARAM_ATOL = 2e-6


def make_batch(seed, n, s=S, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, s)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, s), np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


def _schedules():
    return [
        (jsched.warmup_polynomial_decay(LR, TOTAL, WARMUP),
         tsched.warmup_polynomial_decay(LR, TOTAL, WARMUP)),
        (jsched.warmup_polynomial_decay(2e-5, 400, 40),
         tsched.warmup_polynomial_decay(2e-5, 400, 40)),
        (jsched.polynomial_decay(1e-3, 50, end_value=1e-5, power=1.0),
         tsched.polynomial_decay(1e-3, 50, end_value=1e-5, power=1.0)),
        (jsched.warmup_polynomial_decay(3e-4, 100, 0), tsched.warmup_polynomial_decay(3e-4, 100, 0)),
        (jsched.constant(0.1), tsched.constant(0.1)),
    ]


@pytest.mark.parametrize("which", range(5))
def test_schedule_values_equal_jax_exactly(which):
    js, ts = _schedules()[which]
    for step in (0, 1, 2, 3, 4, 5, 6, 11, 12, 39, 40, 41, 99, 100, 399, 400, 1000):
        want = np.float32(js(jax.numpy.asarray(step, jax.numpy.int32)))
        got = ts(step)
        assert got.dtype == torch.float32
        assert got.item() == want, (step, got.item(), want)


@functools.lru_cache(maxsize=None)
def jax_trajectory():
    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    core = functools.partial(jfa.flash_attention, block_q=16, block_k=16)
    bundle = jbert.bert_classifier_bundle(cfg, attention_fn=core)
    params = bundle.init(jax.random.PRNGKey(0), make_batch(0, 1))
    opt = jadamw.adamw(jsched.warmup_polynomial_decay(LR, TOTAL, WARMUP))
    step = jax.jit(jacc.accumulate_scan(
        bundle.loss, opt, jacc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False),
        needs_rng=True))
    state = jacc.scan_init(params, opt)
    init_params = jax.device_get(params)
    auxes = []
    for i in range(UPDATES):
        sb = jacc.stack_micro_batches(make_batch(10 + i, K * MICRO), K)
        state, aux = step(state, sb, jax.random.PRNGKey(i))
        auxes.append({k: np.asarray(v) for k, v in aux.items()})
    return init_params, auxes, jax.device_get(state.params), int(state.step)


def port_bundle(**cfg_kw):
    cfg = tbert.BertConfig.tiny_for_tests(**cfg_kw)
    return tbert.bert_classifier_bundle(cfg, attention_fn=tfa.flash_attention)


def test_three_scan_updates_match_jax():
    init_params, auxes_j, final_j, step_j = jax_trajectory()
    bundle = port_bundle(hidden_dropout=0.0, attention_dropout=0.0)
    model = bundle.init(0, "cpu")
    model.load_state_dict(params_from_jax(init_params))
    opt = tadamw.adamw(tsched.warmup_polynomial_decay(LR, TOTAL, WARMUP))
    step = tacc.accumulate_scan(lambda p, b: bundle.loss(model, b), opt,
                                tacc.GradAccumConfig(K, clip_norm=1.0), needs_rng=True)
    state = tacc.scan_init(named_parameters(model), opt)
    for i in range(UPDATES):
        sb = tacc.stack_micro_batches(
            {k: torch.as_tensor(v) for k, v in make_batch(10 + i, K * MICRO).items()}, K)
        state, aux = step(state, sb, torch.Generator().manual_seed(i))
        want = auxes_j[i]
        assert aux["lr_step"] == int(want["lr_step"]) == K * (i + 1)
        np.testing.assert_allclose(aux["loss"].item(), want["loss"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux["grad_norm"].item(), want["grad_norm"], rtol=1e-5)
    assert state.step == step_j == K * UPDATES
    got = dict(jtree.named_leaves(params_to_jax(state.params)))
    want = dict(jtree.named_leaves(final_j))
    init = dict(jtree.named_leaves(init_params))
    moved = 0.0
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
        moved = max(moved, float(np.abs(want[name] - init[name]).max()))
    assert moved > 100 * PARAM_ATOL  # the weights really moved


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(2)
    names = {"params/dense/kernel": (4, 3), "params/dense/bias": (3,),
             "params/LayerNorm/scale": (3,)}
    p = {n: rng.normal(size=s).astype(np.float32) for n, s in names.items()}
    g = {n: rng.normal(size=s).astype(np.float32) for n, s in names.items()}
    to_tree = lambda d: {"params": {"dense": {"kernel": d["params/dense/kernel"],  # noqa: E731
                                              "bias": d["params/dense/bias"]},
                                    "LayerNorm": {"scale": d["params/LayerNorm/scale"]}}}
    jopt = jadamw.adamw(1e-2, weight_decay_rate=0.1)
    jp = to_tree(p)
    jstate = jopt.init(jp)
    topt = tadamw.adamw(1e-2, weight_decay_rate=0.1)
    tp = {n: torch.tensor(v) for n, v in p.items()}
    tstate = topt.init(tp)
    for step in (1, 2):
        jp, jstate = jopt.update(to_tree(g), jstate, jp, step)
        tp, tstate = topt.update({n: torch.tensor(v) for n, v in g.items()}, tstate, tp, step)
    want = dict(jtree.named_leaves(jp))
    for n in names:
        np.testing.assert_allclose(tp[n].numpy(), want[n], rtol=1e-6, atol=1e-7, err_msg=n)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(5, 4)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    for clip in (0.5, 100.0):
        jg, jn = jclip.clip_by_global_norm(g, clip)
        tg, tn = tclip.clip_by_global_norm({k: torch.tensor(v) for k, v in g.items()}, clip)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-7)


def test_stack_micro_batches_matches_jax():
    batch = make_batch(1, 6)
    want = jacc.stack_micro_batches(batch, 3)
    got = tacc.stack_micro_batches({k: torch.as_tensor(v) for k, v in batch.items()}, 3)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("knob", [
    dict(skip_nonfinite=True, fused_adam=True, example_axes=("seq",)),
    dict(skip_nonfinite=True, loss_scale=LossScaleConfig(), axis_name="data"),
    dict(skip_nonfinite=True, example_axes=("seq",)), dict(axis_name="data"),
    dict(example_axes=("seq",)),
])
def test_unported_knobs_raise(knob):
    # the guard, loss scaling and fused_adam are ported (tests/test_torch_guard.py,
    # tests/test_torch_mixed.py), and so are axis_name (data parallelism,
    # tests/test_torch_parallel.py) and example_axes (sequence parallelism,
    # tests/test_torch_sp.py). Each builds; unbound, its axis raises JAX's
    # NameError at the first call; on a one-rank gloo group bound to it the
    # step equals the step without it bit for bit (a one-rank SUM is the
    # identity, the denominator K·1)
    from gradaccum_tpu_torch.examples.common import free_port
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2 * 3, 3)).astype(np.float32)
    batch = tacc.stack_micro_batches({"x": torch.as_tensor(x),
                                      "y": torch.as_tensor(x @ np.ones((3, 1), np.float32))}, 2)
    w0 = rng.normal(size=(3, 1)).astype(np.float32)

    def run(config):
        opt = tadamw.adamw(1e-2)
        state = tacc.scan_init({"w": torch.tensor(w0, requires_grad=True)}, opt,
                               loss_scale=config.loss_scale)
        step = tacc.accumulate_scan(
            lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), opt, config)
        for _ in range(2):
            state, aux = step(state, batch)
        return state, aux

    config = tacc.GradAccumConfig(2, **knob)
    want, want_aux = run(config._replace(axis_name=None, example_axes=()))
    axis = "data" if "axis_name" in knob else "seq"
    with pytest.raises(NameError, match=f"unbound axis name: {axis}"):
        run(config)
    mesh_lib.initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cpu",
                                  timeout_s=60)
    try:
        if axis == "data":
            mesh = mesh_lib.data_parallel_mesh()
            got, got_aux = run(config)
            assert mesh.calls["all_reduce:grads"] == 2  # one per update
        else:
            mesh = mesh_lib.make_mesh(data=1, seq=1)  # one-rank axes issue nothing
            got, got_aux = run(config)
            assert not mesh.calls
    finally:
        mesh_lib.shutdown()
    assert torch.equal(got.params["w"], want.params["w"])
    assert torch.equal(got.opt_state.m["w"], want.opt_state.m["w"])
    assert torch.equal(got_aux["loss"], want_aux["loss"])


@pytest.mark.parametrize("knob", [dict(master_dtype=torch.float32), dict(moment_dtype="q8")])
def test_unported_adamw_knobs_raise(knob):
    # these knobs were refused before the mixed-precision slice; they build
    # now, and tests/test_torch_mixed.py holds them against JAX
    opt = tadamw.adamw(1e-3, **knob)
    state = opt.init({"w": torch.zeros(3)})
    if "master_dtype" in knob:
        assert isinstance(state, tadamw.MasterAdamState) and opt.fused is not None
    else:
        assert type(state.m["w"]).__name__ == "QuantTensor" and opt.fused is None


def _estimator(model_dir):
    bundle = port_bundle()  # hidden and attention dropout 0.1: the generator path runs
    sched = tsched.warmup_polynomial_decay(LR, 8, 2)
    return Estimator(bundle, tadamw.adamw(sched), tacc.GradAccumConfig(K, clip_norm=1.0),
                     RunConfig(model_dir=str(model_dir), save_checkpoints_steps=None,
                               log_step_count_steps=1000),
                     mode="scan", device="cpu")


def test_estimator_checkpoint_resume_is_bitwise(tmp_path):
    batches = list(Dataset.from_arrays(make_batch(20, 32)).batch(K * MICRO, drop_remainder=True))
    full = _estimator(tmp_path / "full").train(batches, max_steps=8)
    _estimator(tmp_path / "resumed").train(batches[:2], max_steps=8)
    assert tckpt.latest_checkpoint(str(tmp_path / "resumed"))[0] == 4
    resumed_est = _estimator(tmp_path / "resumed")
    resumed = resumed_est.train(batches[2:], max_steps=8)
    assert full.step == resumed.step == 8
    for kind, a, b in (("params", full.params, resumed.params),
                       ("m", full.opt_state.m, resumed.opt_state.m),
                       ("v", full.opt_state.v, resumed.opt_state.v)):
        for name in a:
            assert torch.equal(a[name], b[name]), f"{kind} {name}"
    # the resumed model (restored in place) evaluates with the same weights
    evald = Dataset.from_arrays(make_batch(21, 8)).batch(4)
    assert resumed_est.evaluate(evald)["accuracy"] == \
        _estimator(tmp_path / "full").evaluate(evald)["accuracy"]
