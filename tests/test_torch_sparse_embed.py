"""Sparse (token-level) embedding-gradient accumulation in the port.

- Sparse against dense in the port: three scan updates of the tiny BERT
  from the same weights on the same batches (dropout 0.1, the same
  generator draws) agree to rtol 1e-6 / atol 1e-7, the JAX suite's own
  sparse-vs-dense tolerance: the table's gradient sums the same float32
  row cotangents in another order.
- Against JAX's ``accumulate_scan_sparse_embed``: per update loss and grad
  norm to 1e-5, ``lr_step`` exactly, parameters within 2e-6 after three
  updates (the AdamW amplification the accumulation tests explain).
- No dense [vocab, hidden] cotangent is formed in the loop: autograd is
  never asked for the table, the loss never reads the table, and one
  ``index_add_`` runs per update.
- The guard and loss scaling on a toy embedding regression, against JAX:
  skip counts, good counts and scales exactly, the all-bad window a bitwise
  no-op, parameters within 2e-6.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator
from gradaccum_tpu_torch.interop import params_from_jax, params_to_jax
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as tadamw
from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.ops import loss_scale as tls
from gradaccum_tpu_torch.ops import schedule as tsched
from gradaccum_tpu_torch.ops.sparse_embed import SparseEmbedHooks, accumulate_scan_sparse_embed
from gradaccum_tpu_torch.utils.tree import named_parameters

jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jadamw = importlib.import_module("gradaccum_tpu.ops.adamw")
jbert = importlib.import_module("gradaccum_tpu.models.bert")
jls = importlib.import_module("gradaccum_tpu.ops.loss_scale")
jsched = importlib.import_module("gradaccum_tpu.ops.schedule")
jsparse = importlib.import_module("gradaccum_tpu.ops.sparse_embed")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K, MICRO, S, UPDATES = 2, 2, 16, 3
PARAM_ATOL = 2e-6
TABLE = "params/bert/word_embeddings/embedding"


def make_batch(seed, n, s=S, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, s)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, s), np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


def stacked(i):
    return tacc.stack_micro_batches(
        {k: torch.as_tensor(v) for k, v in make_batch(10 + i, K * MICRO).items()}, K)


def port_step(model, bundle, opt, config, sparse):
    if sparse:
        hooks = bundle.sparse_embed._replace(
            loss_with_rows=lambda p, rows, b: bundle.sparse_embed.loss_with_rows(model, rows, b))
        return accumulate_scan_sparse_embed(hooks, opt, config)
    return tacc.accumulate_scan(lambda p, b: bundle.loss(model, b), opt, config, needs_rng=True)


def run_port(sparse, init=None, **cfg_kw):
    cfg = tbert.BertConfig.tiny_for_tests(**cfg_kw)
    bundle = tbert.bert_classifier_bundle(cfg, attention_fn=tfa.flash_attention)
    model = bundle.init(0, "cpu")
    if init is not None:
        model.load_state_dict(params_from_jax(init))
    opt = tadamw.adamw(tsched.warmup_polynomial_decay(1e-3, 12, 4))
    step = port_step(model, bundle, opt, tacc.GradAccumConfig(K, clip_norm=1.0), sparse)
    state = tacc.scan_init(named_parameters(model), opt)
    gen = torch.Generator().manual_seed(5)
    auxes = []
    for i in range(UPDATES):
        state, aux = step(state, stacked(i), gen)
        auxes.append(aux)
    return state, auxes


def test_sparse_matches_dense_trajectory_with_dropout():
    dense, dense_aux = run_port(False)
    sparse, sparse_aux = run_port(True)
    for a, b in zip(dense_aux, sparse_aux):
        np.testing.assert_allclose(b["loss"].item(), a["loss"].item(), rtol=1e-6)
        np.testing.assert_allclose(b["grad_norm"].item(), a["grad_norm"].item(), rtol=1e-5)
    assert sparse.step == dense.step == K * UPDATES
    for name in dense.params:
        np.testing.assert_allclose(sparse.params[name].detach().numpy(),
                                   dense.params[name].detach().numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@functools.lru_cache(maxsize=None)
def jax_trajectory():
    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    bundle = jbert.bert_classifier_bundle(cfg)  # dense core: dropout off, same math
    params = bundle.init(jax.random.PRNGKey(0), make_batch(0, 1))
    opt = jadamw.adamw(jsched.warmup_polynomial_decay(1e-3, 12, 4))
    step = jax.jit(jsparse.accumulate_scan_sparse_embed(
        bundle.sparse_embed, opt, jacc.GradAccumConfig(K, clip_norm=1.0)))
    state = jacc.scan_init(params, opt)
    auxes = []
    for i in range(UPDATES):
        sb = jacc.stack_micro_batches(make_batch(10 + i, K * MICRO), K)
        state, aux = step(state, sb, jax.random.PRNGKey(i))
        auxes.append({k: np.asarray(v) for k, v in aux.items()})
    return jax.device_get(params), auxes, jax.device_get(state.params)


def test_sparse_matches_jax_accumulate_scan_sparse_embed():
    init, auxes_j, final_j = jax_trajectory()
    state, auxes = run_port(True, init=init, hidden_dropout=0.0, attention_dropout=0.0)
    for i, (aux, want) in enumerate(zip(auxes, auxes_j)):
        assert aux["lr_step"] == int(want["lr_step"]) == K * (i + 1)
        np.testing.assert_allclose(aux["loss"].item(), want["loss"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux["grad_norm"].item(), want["grad_norm"], rtol=1e-5)
    got = dict(jtree.named_leaves(params_to_jax(state.params)))
    want = dict(jtree.named_leaves(final_j))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=PARAM_ATOL, err_msg=name)
    moved = np.abs(want[TABLE] - dict(jtree.named_leaves(init))[TABLE]).max()
    assert moved > 100 * PARAM_ATOL


def test_the_table_takes_no_dense_gradient_in_the_loop(monkeypatch):
    cfg = tbert.BertConfig.tiny_for_tests()
    bundle = tbert.bert_classifier_bundle(cfg, attention_fn=tfa.flash_attention)
    model = bundle.init(0, "cpu")
    table = named_parameters(model)[TABLE]
    asked, scatters = [], []
    grad, index_add = torch.autograd.grad, torch.Tensor.index_add_

    def recording_grad(outputs, inputs, *a, **kw):
        asked.extend(tuple(t.shape) for t in inputs)
        return grad(outputs, inputs, *a, **kw)

    def recording_index_add(self, *a, **kw):
        scatters.append(tuple(self.shape))
        return index_add(self, *a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", recording_grad)
    monkeypatch.setattr(torch.Tensor, "index_add_", recording_index_add)
    opt = tadamw.adamw(1e-3)
    step = port_step(model, bundle, opt, tacc.GradAccumConfig(K, clip_norm=1.0), True)
    state = tacc.scan_init(named_parameters(model), opt)
    state, _ = step(state, stacked(0), torch.Generator())
    assert tuple(table.shape) not in asked  # no [V, H] cotangent asked for
    assert asked.count((MICRO, S, cfg.hidden_size)) == K  # the rows, once per micro-batch
    assert scatters == [tuple(table.shape)]  # one scatter-add per update

    # the loss with rows never reads the table
    batch = {k: v[0] for k, v in stacked(1).items()}
    batch["rng"] = torch.Generator().manual_seed(1)
    rows = torch.nn.functional.embedding(batch["input_ids"].long(), table.detach())
    want = bundle.sparse_embed.loss_with_rows(model, rows, batch)
    with torch.no_grad():
        table.fill_(float("nan"))
    batch["rng"] = torch.Generator().manual_seed(1)
    assert torch.equal(bundle.sparse_embed.loss_with_rows(model, rows, batch), want)


# -- guard and loss scaling on a toy embedding regression ---------------------

V, HID, B = 12, 4, 3


def toy_windows(seed, n_windows, bad):
    rng = np.random.default_rng(seed)
    params = {"bias": np.zeros((1,), np.float32),
              "emb": rng.normal(size=(V, HID)).astype(np.float32),
              "w": rng.normal(size=(HID, 1)).astype(np.float32)}
    windows = []
    for w in range(n_windows):
        ids = rng.integers(0, V, size=(K * B, 5)).astype(np.int32)
        y = rng.normal(size=(K * B, 1)).astype(np.float32)
        for bw, i in bad:
            if bw == w:
                y[i * B:(i + 1) * B] = np.nan
        windows.append({"ids": ids, "y": y})
    return params, windows


def j_loss_with_rows(params, rows, batch):
    return jnp.mean((rows.sum(axis=1) @ params["w"] + params["bias"] - batch["y"]) ** 2)


def t_loss_with_rows(params, rows, batch):
    return torch.mean((rows.sum(dim=1) @ params["w"] + params["bias"] - batch["y"]) ** 2)


def _guard_runs(windows, params, t_opt, j_opt, **kw):
    tcfg = tacc.GradAccumConfig(K, skip_nonfinite=True, **kw)
    jkw = {k: (jls.LossScaleConfig(*v) if k == "loss_scale" else v) for k, v in kw.items()}
    jcfg = jacc.GradAccumConfig(K, skip_nonfinite=True, **jkw)
    if "loss_scale" in kw:
        tcfg = tcfg._replace(loss_scale=tls.LossScaleConfig(*kw["loss_scale"]))
    tstep = accumulate_scan_sparse_embed(SparseEmbedHooks("emb", "ids", t_loss_with_rows),
                                         t_opt, tcfg)
    jstep = jax.jit(jsparse.accumulate_scan_sparse_embed(
        jsparse.SparseEmbedHooks(("emb",), "ids", j_loss_with_rows), j_opt, jcfg))
    tstate = tacc.scan_init({k: torch.tensor(v, requires_grad=True) for k, v in params.items()},
                            t_opt, loss_scale=tcfg.loss_scale)
    jstate = jacc.scan_init(params, j_opt, loss_scale=jcfg.loss_scale)
    out, snaps = [], []
    for i, w in enumerate(windows):
        tstate, taux = tstep(tstate, tacc.stack_micro_batches(
            {k: torch.tensor(v) for k, v in w.items()}, K), torch.Generator())
        jstate, jaux = jstep(jstate, jacc.stack_micro_batches(w, K), jax.random.PRNGKey(i))
        out.append((taux, jaux))
        snaps.append([t.detach().clone() for t in (*tstate.params.values(),
                                                   *tstate.opt_state.m.values(),
                                                   *tstate.opt_state.v.values())])
    return tstate, jstate, out, snaps


@pytest.mark.parametrize("normalize", [False, True])
def test_guard_skips_like_jax(normalize):
    params, windows = toy_windows(0, 3, bad={(0, 1), (1, 0), (1, 1)})
    tstate, jstate, out, snaps = _guard_runs(windows, params, tadamw.adamw(1e-2),
                                             jadamw.adamw(1e-2), clip_norm=1.0,
                                             normalize_by_good_count=normalize)
    assert [int(t["skipped"]) for t, _ in out] == [int(j["skipped"]) for _, j in out] == [1, 2, 0]
    assert [int(t["good_count"]) for t, _ in out] == [1, 0, 2]
    assert all(torch.equal(a, b) for a, b in zip(snaps[0], snaps[1]))  # all-bad: no-op
    assert np.isnan(out[1][0]["loss"].item()) and np.isnan(float(out[1][1]["loss"]))
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[name]),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_loss_scale_halves_and_regrows_like_jax():
    params, windows = toy_windows(1, 5, bad={(0, 1), (3, 0)})
    scale_cfg = (16.0, 1, 2.0, 0.5, 1.0, 32.0)  # LossScaleConfig fields, in order
    tstate, jstate, out, _ = _guard_runs(windows, params, tadamw.adamw(1e-2),
                                         jadamw.adamw(1e-2), clip_norm=1.0,
                                         loss_scale=scale_cfg)
    scales = [float(t["loss_scale"]) for t, _ in out]
    assert scales == [float(j["loss_scale"]) for _, j in out] == [8.0, 16.0, 32.0, 16.0, 32.0]
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[name]),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


# -- the Estimator ------------------------------------------------------------


def _estimator(**kw):
    bundle = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests(),
                                          attention_fn=tfa.flash_attention)
    return Estimator(bundle, tadamw.adamw(1e-3), tacc.GradAccumConfig(K, clip_norm=1.0),
                     RunConfig(log_step_count_steps=1000, save_checkpoints_steps=None),
                     device="cpu", **kw)


def test_estimator_sparse_embed_matches_dense():
    batches = [{k: v for k, v in make_batch(30 + i, K * MICRO).items()} for i in range(3)]
    dense = _estimator(mode="scan").train(batches)
    sparse = _estimator(mode="scan", sparse_embed=True).train(batches)
    assert dense.step == sparse.step == 3 * K
    for name in dense.params:
        np.testing.assert_allclose(sparse.params[name].detach().numpy(),
                                   dense.params[name].detach().numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_estimator_and_step_refusals():
    with pytest.raises(ValueError, match="mode='scan'"):
        _estimator(mode="streaming", sparse_embed=True)
    bundle = _estimator(mode="scan").model._replace(sparse_embed=None)
    with pytest.raises(ValueError, match="hooks"):
        Estimator(bundle, tadamw.adamw(1e-3), tacc.GradAccumConfig(K), mode="scan",
                  device="cpu", sparse_embed=True)
    # axis_name is ported (data parallelism; sparse DP against dense DP and
    # JAX in tests/test_torch_parallel.py): the step builds, and outside a
    # bound mesh its call raises JAX's unbound-axis error
    step = accumulate_scan_sparse_embed(SparseEmbedHooks("emb", "ids", t_loss_with_rows),
                                        tadamw.adamw(1e-3),
                                        tacc.GradAccumConfig(K, axis_name="data"))
    params = {"emb": torch.zeros(8, 2, requires_grad=True)}
    batch = {"ids": torch.zeros(K, 1, 3, dtype=torch.int64), "y": torch.zeros(K, 1)}
    with pytest.raises(NameError, match="unbound axis name: data"):
        step(tacc.scan_init(params, tadamw.adamw(1e-3)), batch, torch.Generator())
