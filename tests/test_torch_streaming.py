"""The port's streaming mode held against its scan mode and against JAX.

Mirrors the golden cases of ``tests/test_accumulation.py`` on a linear
regression toy, with the same numpy inputs through ``streaming_step`` of
both packages: quirk-free streaming equals scan (bit for bit in the port,
the same floats in the same order) and JAX's streaming (parameters within
2e-6); the first-step quirk's K×-under-scaled first update; the apply
cadence with the quirk; Adam's ``t`` advancing only on applies; the clip
after averaging. The schedule steps are pinned exactly: quirk-free
streaming reads scan's ``step + K`` values, the quirk reads ``step``.

Then the Estimator: a resume after 3 of K=4 micro-batches continues bit for
bit (parameters, optimizer state, accumulators, good count, loss scale),
and three streaming windows of the tiny BERT (dropout 0) agree with the
JAX Estimator's, per-step losses to 1e-5 and parameters to 2e-6.
"""

import importlib

import jax
import jax.numpy as jnp
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
from gradaccum_tpu_torch.ops import adamw as topt
from gradaccum_tpu_torch.ops import schedule as tsched
from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig

jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jsched = importlib.import_module("gradaccum_tpu.ops.schedule")
jbert = importlib.import_module("gradaccum_tpu.models.bert")
jest = importlib.import_module("gradaccum_tpu.estimator.estimator")
jconfig = importlib.import_module("gradaccum_tpu.estimator.config")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K, B = 4, 8
PARAM_ATOL = 2e-6


def make_data(rng, n):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    w_true = np.asarray([[1.0], [-2.0], [0.5]], np.float32)
    y = x @ w_true + 0.1 * rng.normal(size=(n, 1)).astype(np.float32)
    return {"x": x, "y": y}


def make_params(rng):
    return {"w": rng.normal(size=(3, 1)).astype(np.float32),
            "bias": np.zeros((1,), np.float32)}


def j_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["bias"]
    return jnp.mean((pred - batch["y"]) ** 2)


def t_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["bias"]
    return torch.mean((pred - batch["y"]) ** 2)


def t_params(p):
    # the JAX leaf order (sorted keys): global norms sum in the same order
    return {k: torch.tensor(p[k], requires_grad=True) for k in sorted(p)}


def t_batch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def micro_batches(bigs):
    return [{k: v[i * B:(i + 1) * B] for k, v in big.items()} for big in bigs
            for i in range(K)]


def assert_params_close(got, want, atol=PARAM_ATOL):
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(want[name]),
                                   rtol=0, atol=atol, err_msg=name)


def run_jax_streaming(params, micros, opt, cfg):
    fn = jax.jit(jacc.streaming_step(j_loss, opt, cfg))
    s = jacc.streaming_init(params, opt)
    applied = []
    for m in micros:
        s, aux = fn(s, m)
        applied.append(float(aux["applied"]))
    return s, applied


def run_port_streaming(params, micros, opt, cfg):
    fn = tacc.streaming_step(t_loss, opt, cfg)
    s = tacc.streaming_init(t_params(params), opt)
    applied = []
    for m in micros:
        s, aux = fn(s, t_batch(m))
        applied.append(aux["applied"])
    return s, applied


def test_streaming_quirk_free_equals_scan_and_jax():
    """Two cycles, non-constant schedule: port streaming == port scan bit
    for bit, and == JAX streaming within 2e-6."""
    rng = np.random.default_rng(0)
    params = make_params(rng)
    bigs = [make_data(rng, K * B) for _ in range(2)]
    cfg_kw = dict(num_micro_batches=K, first_step_quirk=False)

    t_opt = topt.adamw(tsched.warmup_polynomial_decay(1e-2, 10 * K, K), weight_decay_rate=0.01)
    scan_fn = tacc.accumulate_scan(t_loss, t_opt, tacc.GradAccumConfig(**cfg_kw))
    sc = tacc.scan_init(t_params(params), t_opt)
    for big in bigs:
        sc, _ = scan_fn(sc, tacc.stack_micro_batches(t_batch(big), K))

    s, applied = run_port_streaming(params, micro_batches(bigs), t_opt,
                                    tacc.GradAccumConfig(**cfg_kw))
    assert applied == ([0.0] * (K - 1) + [1.0]) * 2
    assert s.step == sc.step == 2 * K
    for name in sc.params:
        assert torch.equal(s.params[name], sc.params[name]), name
    assert all(bool((a == 0).all()) for a in s.accum_grads.values())  # zeroed after apply

    j_opt = jopt.adamw(jsched.warmup_polynomial_decay(1e-2, 10 * K, K), weight_decay_rate=0.01)
    js, j_applied = run_jax_streaming(params, micro_batches(bigs), j_opt,
                                      jacc.GradAccumConfig(**cfg_kw))
    assert j_applied == applied
    assert int(js.step) == s.step
    assert_params_close(s.params, js.params)


def test_streaming_schedule_steps_match_scan_exactly():
    """Quirk-free streaming hands the schedule exactly scan's step + K
    values; with the quirk it reads the pre-increment step (0, K, ...)."""
    rng = np.random.default_rng(1)
    params = make_params(rng)
    bigs = [make_data(rng, K * B) for _ in range(2)]
    seen = {}

    def recording(key):
        def schedule(step):
            seen.setdefault(key, []).append(step)
            return torch.tensor(1e-3, dtype=torch.float32)
        return topt.sgd(schedule)

    scan_fn = tacc.accumulate_scan(t_loss, recording("scan"), tacc.GradAccumConfig(K))
    sc = tacc.scan_init(t_params(params), recording("scan"))
    for big in bigs:
        sc, aux = scan_fn(sc, tacc.stack_micro_batches(t_batch(big), K))
    for quirk in (False, True):
        run_port_streaming(params, micro_batches(bigs), recording(quirk),
                           tacc.GradAccumConfig(K, first_step_quirk=quirk))
    assert seen["scan"] == seen[False] == [K, 2 * K]
    assert seen[True] == [0, K]
    assert all(type(step) is int for steps in seen.values() for step in steps)


def test_streaming_first_step_quirk():
    """Step 0 applies ONE micro-batch normalized by 1/K (SGD, lr 1)."""
    rng = np.random.default_rng(2)
    params = make_params(rng)
    data = make_data(rng, B)
    s, applied = run_port_streaming(params, [data], topt.sgd(1.0),
                                    tacc.GradAccumConfig(K, first_step_quirk=True))
    assert applied == [1.0]
    g = jax.grad(j_loss)(params, data)
    expected = jax.tree.map(lambda p, gg: p - gg / K, params, g)
    assert_params_close(s.params, expected, atol=1e-6)
    js, _ = run_jax_streaming(params, [data], jopt.sgd(1.0),
                              jacc.GradAccumConfig(K, first_step_quirk=True))
    assert_params_close(s.params, js.params, atol=1e-7)


def test_streaming_apply_cadence_with_quirk():
    """Applies fire at steps 0, K, 2K, ... (optimization.py:91 + 102)."""
    rng = np.random.default_rng(3)
    params = make_params(rng)
    data = make_data(rng, B)
    cfg_kw = dict(num_micro_batches=3, first_step_quirk=True)
    _, applied = run_port_streaming(params, [data] * 7, topt.sgd(0.01),
                                    tacc.GradAccumConfig(**cfg_kw))
    _, j_applied = run_jax_streaming(params, [data] * 7, jopt.sgd(0.01),
                                     jacc.GradAccumConfig(**cfg_kw))
    assert applied == j_applied == [1, 0, 0, 1, 0, 0, 1]


def test_streaming_adam_update_count_only_on_apply():
    """Adam's bias-correction t advances per update, not per micro-batch,
    and the trajectory agrees with JAX's."""
    rng = np.random.default_rng(4)
    params = make_params(rng)
    micros = micro_batches([make_data(rng, K * B) for _ in range(2)])
    s, _ = run_port_streaming(params, micros, topt.adam(1e-2),
                              tacc.GradAccumConfig(K, first_step_quirk=False))
    assert int(s.opt_state.t) == 2 and s.opt_state.t.dtype == torch.int32
    assert s.step == 2 * K
    js, _ = run_jax_streaming(params, micros, jopt.adam(1e-2),
                              jacc.GradAccumConfig(K, first_step_quirk=False))
    assert int(js.opt_state.t) == 2
    assert_params_close(s.params, js.params)


@pytest.mark.parametrize("mode", ["scan", "streaming"])
def test_clip_after_average_not_per_micro_batch(mode):
    """Micro-batch gradients of ±10 and ±9 average to 0: clip after the
    average is a no-op (per-micro clipping would move w); gradients of 8
    average to 8 and clip to 1."""
    def loss(p, batch):
        return torch.mean(batch["g"] * p["w"])  # grad == mean(batch["g"])

    cfg = tacc.GradAccumConfig(4, clip_norm=1.0, first_step_quirk=False)
    opt = topt.sgd(1.0)
    for g, want in (([[10.0], [-10.0], [9.0], [-9.0]], 0.0), ([[8.0]] * 4, -1.0)):
        big = {"g": torch.tensor(g)}
        params = {"w": torch.zeros(1, requires_grad=True)}
        if mode == "scan":
            state, _ = tacc.accumulate_scan(loss, opt, cfg)(
                tacc.scan_init(params, opt), tacc.stack_micro_batches(big, 4))
        else:
            step = tacc.streaming_step(loss, opt, cfg)
            state = tacc.streaming_init(params, opt)
            for i in range(4):
                state, _ = step(state, {"g": big["g"][i:i + 1]})
        np.testing.assert_allclose(state.params["w"].detach().numpy(), want, atol=1e-6)


# -- the Estimator -----------------------------------------------------------


def make_bert_batch(seed, n, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, s)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, s), np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


RESUME_CASES = {
    "adamw": dict(optimizer=lambda: topt.adamw(tsched.warmup_polynomial_decay(1e-3, 8, 2)),
                  accum=dict()),
    "adam-guard-scale": dict(optimizer=lambda: topt.adam(1e-3),
                             accum=dict(skip_nonfinite=True,
                                        loss_scale=LossScaleConfig(init_scale=2.0**4,
                                                                   growth_interval=1))),
    "sgd-momentum-guard": dict(optimizer=lambda: topt.sgd(1e-2, momentum=0.9),
                               accum=dict(skip_nonfinite=True, normalize_by_good_count=True)),
}


def _streaming_estimator(model_dir, case):
    bundle = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests())  # dropout 0.1
    c = RESUME_CASES[case]
    return Estimator(bundle, c["optimizer"](),
                     tacc.GradAccumConfig(K, clip_norm=1.0, **c["accum"]),
                     RunConfig(model_dir=str(model_dir), save_checkpoints_steps=None,
                               log_step_count_steps=1000), device="cpu")


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_in_the_middle_of_a_window_is_bitwise(tmp_path, case):
    """Stop after 3 of K=4 micro-batches, restore from the checkpoint, and
    continue: the same state, bit for bit, as the uninterrupted run."""
    batches = list(Dataset.from_arrays(make_bert_batch(20, 2 * K * 2)).batch(
        2, drop_remainder=True))
    full_est = _streaming_estimator(tmp_path / "full", case)
    assert full_est.mode == "streaming"  # the default, as in JAX
    full = full_est.train(batches, max_steps=2 * K)
    _streaming_estimator(tmp_path / "resumed", case).train(batches[:3], max_steps=2 * K)
    step, path = tckpt.latest_checkpoint(str(tmp_path / "resumed"))
    assert step == 3
    # the window holds a partial sum at the save
    mid = torch.load(path, weights_only=True)
    assert any(float(v.abs().sum()) > 0 for k, v in mid.items() if k.startswith("accum_grads/"))
    resumed_est = _streaming_estimator(tmp_path / "resumed", case)
    resumed = resumed_est.train(batches[3:], max_steps=2 * K)
    assert full.step == resumed.step == 2 * K
    assert full_est.apply_steps == [0, K]  # the quirk: applies at 0 and K
    want, got = tckpt.flatten(full), tckpt.flatten(resumed)
    assert want.keys() == got.keys()
    assert any(key.startswith("accum_grads/") for key in want)
    for key in want:
        if isinstance(want[key], torch.Tensor):
            assert torch.equal(want[key], got[key]), key
        else:
            assert want[key] == got[key], key


def _jax_streaming_estimator_run(model_dir):
    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    bundle = jbert.bert_classifier_bundle(cfg)
    params = jax.device_get(bundle.init(jax.random.PRNGKey(0), make_bert_batch(0, 1)))
    est = jest.Estimator(bundle, jopt.adamw(jsched.warmup_polynomial_decay(1e-3, 3 * K, 2)),
                         jacc.GradAccumConfig(K, clip_norm=1.0),
                         jconfig.RunConfig(model_dir=model_dir, save_checkpoints_steps=None,
                                           log_step_count_steps=1000),
                         mode="streaming", warm_start=params)
    state = est.train(_bert_micro_batches(), max_steps=3 * K)
    return params, jax.device_get(state.params), _read_csv(model_dir)


def _bert_micro_batches():
    return list(Dataset.from_arrays(make_bert_batch(30, 3 * K * 2)).batch(2))


def _read_csv(model_dir):
    with open(f"{model_dir}/loss_vs_step.csv") as f:
        rows = f.read().strip().splitlines()
    assert rows[0] == "step,loss"
    return [(int(s), float(v)) for s, v in (r.split(",") for r in rows[1:])]


def test_streaming_estimator_matches_jax(tmp_path):
    """Three windows of tiny BERT (dropout 0) through both Estimators in
    streaming mode with the quirk: per-step losses within 1e-5, final
    parameters within 2e-6."""
    init, want_params, want_rows = _jax_streaming_estimator_run(str(tmp_path / "jax"))
    cfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    base = tbert.bert_classifier_bundle(cfg)

    def init_from_jax(seed, device):
        model = base.init(seed, device)
        model.load_state_dict(params_from_jax(init))
        return model

    est = Estimator(base._replace(init=init_from_jax),
                    topt.adamw(tsched.warmup_polynomial_decay(1e-3, 3 * K, 2)),
                    tacc.GradAccumConfig(K, clip_norm=1.0),
                    RunConfig(model_dir=str(tmp_path / "port"), save_checkpoints_steps=None,
                              log_step_count_steps=1000), device="cpu")
    state = est.train(_bert_micro_batches(), max_steps=3 * K)
    assert state.step == 3 * K and est.apply_steps == [0, K, 2 * K]
    rows = _read_csv(str(tmp_path / "port"))
    assert [s for s, _ in rows] == [s for s, _ in want_rows] == list(range(1, 3 * K + 1))
    np.testing.assert_allclose([v for _, v in rows], [v for _, v in want_rows],
                               rtol=1e-5, atol=1e-5)
    got = dict(jtree.named_leaves(params_to_jax(state.params)))
    want = dict(jtree.named_leaves(want_params))
    start = dict(jtree.named_leaves(init))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
    assert max(float(np.abs(want[n] - start[n]).max()) for n in want) > 100 * PARAM_ATOL
