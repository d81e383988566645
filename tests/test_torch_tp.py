"""The port's tensor parallelism held against JAX's GSPMD step, on gloo ranks.

One spawn of four gloo ranks on the CPU (``examples/common.py ::
spawn_ranks``, with a deadline) runs every multi-rank case; each rank
saves what it saw and the tests hold it against JAX on the same numpy
inputs. Tiny BERT (JAX's ``tests/test_tp.py`` shapes: K=2, 4 rows per
micro-batch, S=16, three updates) through ``Estimator(mesh=make_mesh(...),
sharding_rules=bert_tp_rules())``:

- tp=2 (two replicas side by side on an axis the step does not use) and
  dp=2 x tp=2, dropout 0, from JAX's weights: losses within 1e-5 and the
  gathered parameters within rtol 2e-4, atol 2e-5 of JAX's GSPMD step
  (``shard_params(..., bert_tp_rules())`` on ``make_mesh(data=d, model=2)``
  of the virtual CPU devices, jitted ``accumulate_scan``);
- dropout 0.1 through the flash core (its plain version on the CPU): tp=2
  against the port's own tp=1 run, and dp=2 x tp=2 against dp=2 x tp=1,
  losses within 1e-5 (JAX's ``jax.random`` masks cannot be matched; the
  kernels' keep mask is keyed on each rank's place in the heads, and hidden
  dropout is drawn alike on the ranks of a model group); the dense core's
  dropout likewise;
- the collectives of one update equal the design's count, per layer and
  micro-batch (PERF.md);
- a checkpoint written at tp=2 restores at tp=1 bitwise, and one written
  at tp=1 restores at tp=2 bitwise;
- sparse embedding gradients on the GSPMD counterpart: under the
  vocab-sharded table at dp=2 x tp=2, with ``sharding_rules=()`` and with
  ``zero1=True``, against the dense gradient;
- ZeRO-1 with rules and Adam-mini at dp=2 x tp=2 against one process;
- each update's norm before clipping equals the run without tensor
  parallelism (the norm is the whole model's, not a rank's blocks');
- GPT's gradients at tp=2 (the tied head over the vocab-sharded table,
  the logits gathered with a backward that does not sum) against one
  process, dropout 0.1 through the causal flash core.

Without a spawn: the port's ``spec_for`` against JAX's for every leaf of
BERT, MoE-BERT and GPT under each rule set; the ZeRO-1 specs of every state
leaf against JAX's ``zero1_state_specs``; the keep mask with
``head_offset`` against the slice of the whole heads' mask.

    python -m pytest -m torch tests/test_torch_tp.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

K, B, S, UPDATES, WORLD, TP = 2, 4, 16, 3, 4, 2
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)  # JAX's tests/test_tp.py
LR = 1e-3


def host_batches(seed=5, n=UPDATES, rows=K * B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.ones((rows, S), np.int32)
        mask[0, S - 5:] = 0  # a padded tail in one example
        out.append({"input_ids": rng.integers(0, 128, size=(rows, S)).astype(np.int32),
                    "input_mask": mask, "segment_ids": np.zeros((rows, S), np.int32),
                    "label": rng.integers(0, 2, size=(rows,)).astype(np.int32)})
    return out


# --------------------------------------------------------------------------
# the ranks: python -m tests.test_torch_tp <outdir>
# --------------------------------------------------------------------------


def _rank_cases(outdir):
    from gradaccum_tpu_torch.estimator import checkpoint as tckpt
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.ops import schedule as tsched
    from gradaccum_tpu_torch.ops.flash_attention import flash_attention
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.parallel.sharding import gather_params
    from gradaccum_tpu_torch.parallel.tp import bert_tp_rules

    out = {}
    warm = {k: torch.as_tensor(v) for k, v in np.load(os.path.join(outdir, "warm.npz")).items()}
    batches = host_batches()

    def estimator(mesh, rules, dropout=0.0, flash=False, opt=None, model_dir=None, **kw):
        cfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=dropout, attention_dropout=dropout)
        core = flash_attention if flash else tbert.dense_attention
        opt = opt or topt.adamw(tsched.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                                weight_decay_rate=0.01)
        return Estimator(tbert.bert_classifier_bundle(cfg, num_classes=2, attention_fn=core),
                         opt, tacc.GradAccumConfig(num_micro_batches=K, clip_norm=1.0,
                                                   first_step_quirk=False),
                         RunConfig(seed=7, model_dir=model_dir, save_checkpoints_steps=None,
                                   log_step_count_steps=1000),
                         mode="scan", device="cpu", mesh=mesh, sharding_rules=rules,
                         warm_start=warm, **kw)

    def run(tag, est, mesh=None, batches=batches):
        """Train one update per batch; record the losses, each update's
        norm before clipping, the gathered parameters and the collectives
        of each update."""
        est.train([])  # builds the state and the step
        inner = est._train_step

        def step(state, batch, *rng):
            state, aux = inner(state, batch, *rng)
            out.setdefault(f"{tag}/norm", []).append(float(aux["grad_norm"]))
            return state, aux

        est._train_step = step
        for batch in batches:
            if mesh is not None:
                mesh.reset_calls()
            est.train([batch])
            out.setdefault(f"{tag}/loss", []).append(float(est.last_loss))
            if mesh is not None:
                for key, n in mesh.calls.items():
                    out.setdefault(f"{tag}/calls/{key}", []).append(n)
        state = est._state
        params = gather_params(state.params, est.mesh, est._rules) if est._rules else \
            state.params
        for name, p in params.items():
            out[f"{tag}/params/{name}"] = p.detach().float().numpy().copy()
        return est

    # the layout: rank r at np.unravel_index(r, sizes); the hybrid mesh at one slice
    hybrid = mesh_lib.make_hybrid_mesh([("replica", 2), ("model", TP)], [("data", 1)])
    out["layout/hybrid_names"] = list(hybrid.axis_names)
    out["layout/hybrid_coords"] = [hybrid.coords[a] for a in hybrid.axis_names]
    for axis in hybrid.axis_names:
        out[f"layout/ranks/{axis}"] = hybrid.axis(axis).ranks

    rules = bert_tp_rules()
    # tp=2: two replicas of a model group side by side (an axis no rule or
    # step reads), so four ranks run it
    tp_mesh = mesh_lib.make_mesh([("replica", 2), ("model", TP)])
    est = run("tp0", estimator(tp_mesh, rules), tp_mesh)
    # evaluation and predict run the sharded forward; export gathers the
    # parameters on every rank and rank 0 traces the unsharded model
    evald = host_batches(seed=9, n=2)
    out["tp0/eval"] = [est.evaluate(evald, state=est._state)["accuracy"]]
    out["tp0/predict"] = np.stack([p["logits"] for p in est.predict(evald, state=est._state)])
    sample = {k: v[:2] for k, v in evald[0].items() if k != "label"}
    path = est.export_model(os.path.join(outdir, "export_tp0"), sample, state=est._state)
    out["tp0/exported"] = [path is not None]
    run("tp1", estimator(tp_mesh, rules, dropout=0.1, flash=True), tp_mesh)
    run("tp1_dense", estimator(tp_mesh, rules, dropout=0.1), tp_mesh, batches[:2])
    run("ref1", estimator(None, None, dropout=0.1, flash=True))
    run("ref1_dense", estimator(None, None, dropout=0.1), batches=batches[:2])
    est = run("ref0", estimator(None, None))
    out["ref0/eval"] = [est.evaluate(evald, state=est._state)["accuracy"]]
    out["ref0/predict"] = np.stack([p["logits"] for p in est.predict(evald, state=est._state)])

    # checkpoints: tp=2 -> tp=1 and tp=1 -> tp=2, bitwise
    d2, d1 = os.path.join(outdir, "ckpt_tp2"), os.path.join(outdir, "ckpt_tp1")
    est = estimator(tp_mesh, rules, dropout=0.1, flash=True, model_dir=d2)
    est.train([], final_save=False)
    tp_mesh.barrier()  # every rank has read the empty directory before rank 0 writes
    est.train(batches[:1])
    whole = tckpt.flatten(est._global_state(est._state))
    tp_mesh.barrier()  # rank 0 wrote it
    one = estimator(None, None, dropout=0.1, flash=True, model_dir=d2)
    restored = tckpt.flatten(one._init_state())
    out["ckpt/2to1"] = np.asarray(all(
        torch.equal(whole[k], restored[k]) if isinstance(whole[k], torch.Tensor)
        else whole[k] == restored[k] for k in whole) and whole.keys() == restored.keys())
    if tp_mesh.rank == 0:
        estimator(None, None, model_dir=d1).train(batches[:1])
    tp_mesh.barrier()
    saved = tckpt.flatten(estimator(None, None, model_dir=d1)._init_state())
    est = estimator(tp_mesh, rules, model_dir=d1)
    back = tckpt.flatten(est._global_state(est._init_state()))
    out["ckpt/1to2"] = np.asarray(all(
        torch.equal(saved[k], back[k]) if isinstance(saved[k], torch.Tensor)
        else saved[k] == back[k] for k in saved))

    # dp=2 x tp=2, and dp=2 x tp=1 for the dropout run
    dptp = mesh_lib.make_mesh(data=2, model=TP)
    run("dptp0", estimator(dptp, rules), dptp)
    run("dptp1", estimator(dptp, rules, dropout=0.1, flash=True), dptp)
    short = batches[:2]  # the sparse and Adam-mini cases: two updates
    run("dptp_sparse", estimator(dptp, rules, sparse_embed=True), dptp, short)
    run("dptp_short", estimator(dptp, rules), dptp, short)

    def mini():
        return topt.adam_mini(tsched.warmup_polynomial_decay(LR, 100, num_warmup_steps=10))

    run("dptp_zero1_mini", estimator(dptp, rules, opt=mini(), zero1=True), dptp, short)
    run("ref_mini", estimator(None, None, opt=mini()), batches=short)
    dp = mesh_lib.make_mesh(data=2, replica=2)
    run("dp1", estimator(dp, (), dropout=0.1, flash=True), dp)
    _gpt_case(out, tp_mesh)
    run("dp_dense", estimator(dp, ()), dp, short)
    run("dp_sparse", estimator(dp, (), sparse_embed=True), dp, short)
    run("dp_zero1_sparse", estimator(dp, None, zero1=True, sparse_embed=True), dp, short)
    return {k: np.asarray(v) for k, v in out.items()}


def _gpt_case(out, mesh):
    """GPT's gradients at tp=2 (the tied head over the vocab-sharded
    table, the logits gathered) against one process: the flash core,
    dropout 0.1, one forward and backward."""
    from gradaccum_tpu_torch.models import gpt as tgpt
    from gradaccum_tpu_torch.ops.flash_attention import causal_flash_attention
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.parallel.sharding import gather_params, shard_params
    from gradaccum_tpu_torch.parallel.tp import gpt_tp_rules
    from gradaccum_tpu_torch.utils.tree import named_parameters

    mesh = mesh_lib.make_mesh([("replica", 2), ("model", TP)])
    bundle = tgpt.gpt_lm_bundle(tgpt.GPTConfig.tiny_for_tests(dropout=0.1),
                                attention_fn=causal_flash_attention)
    ids = torch.as_tensor(np.random.default_rng(8).integers(0, 96, size=(4, S)))
    for tag, rules in (("gpt_one", None), ("gpt_tp", gpt_tp_rules())):
        model = bundle.init(3, "cpu")
        params = named_parameters(model)
        if rules:
            shard_params(params, mesh, rules)
        loss = bundle.loss(model, {"input_ids": ids, "rng": torch.Generator().manual_seed(4)})
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if rules:
            grads = gather_params(grads, mesh, rules)
        out[f"{tag}/loss"] = [float(loss)]
        for name, g in grads.items():
            out[f"{tag}/grad/{name}"] = g.numpy().copy()


def _rank_main(outdir):
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    os.environ["GRADACCUM_EVENTS"] = "0"  # no TensorBoard import for the checkpoint cases
    info = mesh_lib.initialize_multihost(device="cpu", timeout_s=60)
    try:
        results = _rank_cases(outdir)
        rank = info["process_index"]
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))


if __name__ == "__main__":
    _rank_main(sys.argv[1])


# --------------------------------------------------------------------------
# the tests (JAX on the virtual CPU devices of tests/conftest.py)
# --------------------------------------------------------------------------


def _jax_bert(dropout=0.0):
    import jax

    from gradaccum_tpu.models import bert as jbert

    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=dropout, attention_dropout=dropout)
    bundle = jbert.bert_classifier_bundle(cfg, num_classes=2)
    params = bundle.init(jax.random.PRNGKey(0), host_batches()[0])
    return bundle, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from gradaccum_tpu_torch.interop import params_from_jax
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.utils.tree import named_parameters

    outdir = tmp_path_factory.mktemp("tp_ranks")
    _, jparams = _jax_bert()
    module = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests()).init(0, "cpu")
    module.load_state_dict(params_from_jax(jparams))
    np.savez(outdir / "warm.npz", **{name: p.detach().numpy()
                                     for name, p in named_parameters(module).items()})
    from test_torch_parallel import spawn_cases

    return spawn_cases("tests.test_torch_tp", outdir, world=WORLD, deadline_s=240), jparams


def _gspmd(jparams, data):
    """JAX's GSPMD tensor-parallel step (``tests/test_tp.py``'s): losses
    and final parameters of three updates on ``make_mesh(data=data,
    model=2)``."""
    import jax

    import gradaccum_tpu as gt
    from gradaccum_tpu.ops.accumulation import scan_init
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.sharding import device_put_batch, shard_params
    from gradaccum_tpu.parallel.tp import bert_tp_rules

    bundle, _ = _jax_bert()
    opt = gt.ops.adamw(gt.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                       weight_decay_rate=0.01)
    accum = gt.GradAccumConfig(num_micro_batches=K, clip_norm=1.0)
    mesh = make_mesh(data=data, model=TP, devices=jax.devices()[:data * TP])
    step = jax.jit(gt.accumulate_scan(bundle.loss, opt, accum, needs_rng=True))
    state = shard_params(scan_init(jparams, opt), mesh, bert_tp_rules())
    losses = []
    for i, b in enumerate(host_batches()):
        batch = device_put_batch(gt.stack_micro_batches(b, K), mesh, leading_unsharded=1)
        state, aux = step(state, batch, jax.random.PRNGKey(100 + i))
        losses.append(float(jax.device_get(aux["loss"])))
    return losses, jax.device_get(state.params)


def _flat(tree):
    from gradaccum_tpu.utils.tree import named_leaves

    return dict(named_leaves(tree))


def _same_on_ranks(out, key):
    for r in range(1, WORLD):
        np.testing.assert_array_equal(out[r][key], out[0][key], err_msg=f"rank {r} {key}")
    return out[0][key]


def _check_params(out, tag, want, skip=()):
    from gradaccum_tpu_torch.interop import params_to_jax

    got = {k[len(tag) + 8:]: out[0][k] for k in out[0] if k.startswith(f"{tag}/params/")}
    assert got
    got = _flat(params_to_jax({k: torch.as_tensor(v) for k, v in got.items()}))
    want = _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        if any(s in name for s in skip):
            continue
        np.testing.assert_allclose(got[name], np.asarray(want[name]), err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("tag,data", [("tp0", 1), ("dptp0", 2)])
def test_tp_matches_jax_gspmd_step(ranks, tag, data):
    out, jparams = ranks
    losses, params = _gspmd(jparams, data)
    got = _same_on_ranks(out, f"{tag}/loss")
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
    for r in range(WORLD):
        _check_params([out[r]], tag, {"params": params["params"]})


@pytest.mark.parametrize("tag,ref", [("tp1", "ref1"), ("tp1_dense", "ref1_dense"),
                                     ("dptp1", "dp1")])
def test_tp_with_dropout_matches_the_port_without_tp(ranks, tag, ref):
    out, _ = ranks
    got = _same_on_ranks(out, f"{tag}/loss")
    np.testing.assert_allclose(got, out[0][f"{ref}/loss"], rtol=LOSS_RTOL)
    # dropout drew the same masks: the losses are not those of dropout 0
    assert not np.allclose(out[0]["ref0/loss"][1:], out[0]["ref1/loss"][1:], rtol=1e-3)
    names = [k for k in out[0] if k.startswith(f"{ref}/params/")]
    for k in names:
        np.testing.assert_allclose(out[0][k.replace(ref, tag, 1)], out[0][k],
                                   err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("tag,ref", [("tp0", "ref0"), ("tp1", "ref1"), ("tp1_dense", "ref1_dense"),
                                     ("dptp1", "dp1")])
def test_norm_before_clipping_is_the_whole_models(ranks, tag, ref):
    """The global norm sums every block of the sharded gradients once: the
    norm each update reports equals the run without tensor parallelism."""
    out, _ = ranks
    for r in range(WORLD):
        np.testing.assert_allclose(out[r][f"{tag}/norm"], out[r][f"{ref}/norm"], rtol=1e-5)


def test_gpt_tied_head_gradients_at_tp2_equal_one_process(ranks):
    out, _ = ranks
    for r in range(WORLD):
        np.testing.assert_allclose(out[r]["gpt_tp/loss"], out[r]["gpt_one/loss"], rtol=1e-6)
        names = [k[len("gpt_one/grad/"):] for k in out[r] if k.startswith("gpt_one/grad/")]
        assert any("word_embeddings" in n for n in names)
        for n in names:
            np.testing.assert_allclose(out[r][f"gpt_tp/grad/{n}"], out[r][f"gpt_one/grad/{n}"],
                                       rtol=1e-5, atol=1e-7, err_msg=n)


def test_collectives_per_update_equal_the_design(ranks):
    """Per micro-batch, on the model axis: the embedding lookup's sum, then
    per layer the attention output's and the FFN output's sums forward and
    the two ``copy_to`` sums backward (4 per layer); per update one scalar
    all-reduce for the global norm. On the data axis one gradient average
    per micro-batch (the GSPMD counterpart)."""
    out, _ = ranks
    layers = 2
    per_micro = 1 + 4 * layers
    for r in range(WORLD):
        calls = {k[len("tp0/calls/"):]: list(v) for k, v in out[r].items()
                 if k.startswith("tp0/calls/")}
        assert calls["model/all_reduce"] == [K * per_micro + 1] * UPDATES
        assert calls["model/all_reduce:norm"] == [1] * UPDATES
        assert calls["model/all_reduce:reduce_from"] == [K * (1 + 2 * layers)] * UPDATES
        assert calls["model/all_reduce:copy_to"] == [K * 2 * layers] * UPDATES
        assert set(calls) == {"model/all_reduce", "model/all_reduce:norm",
                              "model/all_reduce:reduce_from", "model/all_reduce:copy_to"}
        dp = {k[len("dptp0/calls/"):]: list(v) for k, v in out[r].items()
              if k.startswith("dptp0/calls/")}
        assert dp["data/all_reduce:grads"] == [K] * UPDATES
        assert dp["model/all_reduce"] == [K * per_micro + 1] * UPDATES


def test_eval_predict_and_export_under_rules(ranks, tmp_path_factory):
    """Evaluation and predict at tp=2 equal the one-process run's (the
    same weights up to the tolerance the parity test holds), and the
    artifact rank 0 alone wrote from the gathered parameters predicts what
    the sharded model predicted (JAX's
    ``test_export_from_rules_sharded_training``)."""
    from gradaccum_tpu_torch.estimator.export import load_exported

    out, _ = ranks
    assert [bool(out[r]["tp0/exported"][0]) for r in range(WORLD)] == [True, False, False,
                                                                           False]
    for r in range(WORLD):
        np.testing.assert_array_equal(out[r]["tp0/predict"], out[0]["tp0/predict"])
        np.testing.assert_allclose(out[r]["tp0/eval"], out[r]["ref0/eval"])
        np.testing.assert_allclose(out[r]["tp0/predict"], out[r]["ref0/predict"],
                                   **PARAM_TOL)
    outdir = [p for p in tmp_path_factory.getbasetemp().iterdir()
              if p.name.startswith("tp_ranks")][0]
    model = load_exported(str(outdir / "export_tp0"))
    evald = host_batches(seed=9, n=2)
    got = np.concatenate([np.asarray(model({k: v for k, v in b.items() if k != "label"})
                                     ["logits"]) for b in evald])
    np.testing.assert_allclose(got, out[0]["tp0/predict"], rtol=1e-5, atol=1e-6)


def test_checkpoints_restore_across_tp_widths_bitwise(ranks):
    out, _ = ranks
    for r in range(WORLD):
        assert bool(out[r]["ckpt/2to1"]), f"rank {r}: tp=2 -> tp=1"
        assert bool(out[r]["ckpt/1to2"]), f"rank {r}: tp=1 -> tp=2"


@pytest.mark.parametrize("tag,ref", [("dptp_sparse", "dptp_short"), ("dp_sparse", "dp_dense"),
                                     ("dp_zero1_sparse", "dp_dense")])
def test_sparse_embed_on_the_gspmd_counterpart_equals_dense(ranks, tag, ref):
    out, _ = ranks
    for r in range(WORLD):
        np.testing.assert_allclose(out[r][f"{tag}/loss"], out[r][f"{ref}/loss"], rtol=1e-6)
        for k in out[r]:
            if k.startswith(f"{ref}/params/"):
                np.testing.assert_allclose(out[r][k.replace(ref, tag, 1)], out[r][k],
                                           rtol=0, atol=1e-6, err_msg=k)


def test_zero1_with_rules_and_adam_mini_matches_one_process(ranks):
    """dp=2 x tp=2, ZeRO-1 over the rule-replicated moments, Adam-mini's
    per-tensor statistic summed over the model and data blocks. The key
    biases are left out of the parameter check: their gradient is zero but
    for rounding (the softmax ignores a shift shared by every key), and
    Adam-mini divides it by its own RMS, so their update is rounding noise
    (``tests/test_torch_zero.py`` holds Adam-mini under ZeRO-1 at 1e-6 on a
    model without such a leaf)."""
    out, _ = ranks
    got = _same_on_ranks(out, "dptp_zero1_mini/loss")
    np.testing.assert_allclose(got, out[0]["ref_mini/loss"], rtol=LOSS_RTOL)
    for k in out[0]:
        if k.startswith("ref_mini/params/") and "key/bias" not in k:
            np.testing.assert_allclose(out[0][k.replace("ref_mini", "dptp_zero1_mini", 1)],
                                       out[0][k], err_msg=k, **PARAM_TOL)


def test_hybrid_mesh_lays_ranks_out_as_jax(ranks):
    """Rank r sits where JAX's ``make_hybrid_mesh`` puts device r (one
    slice: the DCN axis of size 1 first), and each axis's group is the
    ranks that differ only in that axis."""
    import jax

    from gradaccum_tpu.parallel.mesh import make_hybrid_mesh

    out, _ = ranks
    jmesh = make_hybrid_mesh([("replica", 2), ("model", TP)], [("data", 1)],
                             devices=jax.devices()[:WORLD])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(WORLD):
        assert list(out[r]["layout/hybrid_names"]) == list(jmesh.axis_names)
        where = tuple(int(c) for c in out[r]["layout/hybrid_coords"])
        assert ids[where] == jax.devices()[r].id
        for i, axis in enumerate(jmesh.axis_names):
            line = np.moveaxis(ids, i, -1)[tuple(c for j, c in enumerate(where) if j != i)]
            want = [int(np.where(np.asarray([d.id for d in jax.devices()[:WORLD]]) == d)[0][0])
                    for d in line] if jmesh.shape[axis] > 1 else [r]
            assert list(out[r][f"layout/ranks/{axis}"]) == want, (r, axis)


# --------------------------------------------------------------------------
# without a spawn
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(axis_sizes=[("data", -1), ("model", -1)]),
    dict(axis_sizes=[("data", 3)]),
    dict(axis_sizes=[("data", -1), ("model", 3)]),
    dict(axis_sizes=[("data", 2), ("model", 2)], model=2),
    dict(axis_sizes=None, data=2, model=2, expert=4),
], ids=["two-absorbing", "too-few", "indivisible", "both-forms", "too-many"])
def test_make_mesh_errors_are_jax_word_for_word(kw):
    from gradaccum_tpu.parallel.mesh import make_mesh as jmake

    import jax

    from gradaccum_tpu_torch.parallel.mesh import _axis_sizes

    kw = dict(kw)
    sizes = kw.pop("axis_sizes")
    with pytest.raises(ValueError) as want:
        jmake(sizes, devices=jax.devices()[:8], **kw)
    with pytest.raises(ValueError) as got:
        _axis_sizes(sizes, kw, 8)
    assert str(got.value) == str(want.value)


def test_make_mesh_absorbs_the_rest_as_jax():
    import jax

    from gradaccum_tpu.parallel.mesh import make_mesh as jmake

    from gradaccum_tpu_torch.parallel.mesh import _axis_sizes

    for sizes in ([("data", -1), ("model", 2)], [("model", 2), ("data", -1)], None):
        want = jmake(sizes, devices=jax.devices()[:8])
        names, got = _axis_sizes(sizes, {}, 8)
        assert dict(zip(names, got)) == dict(want.shape)


def _models():
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.models import gpt as tgpt

    return {
        "bert": lambda: tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests()),
        "moe_bert": lambda: tbert.bert_classifier_bundle(
            tbert.BertConfig.tiny_for_tests(num_experts=4)),
        "gpt": lambda: tgpt.gpt_lm_bundle(tgpt.GPTConfig.tiny_for_tests()),
    }


def _rule_sets():
    from gradaccum_tpu.parallel import tp as jtp

    from gradaccum_tpu_torch.parallel import tp as ttp

    names = ("bert_tp_rules", "gpt_tp_rules", "bert_tp_ep_rules")
    return {n: (getattr(jtp, n)(), getattr(ttp, n)()) for n in names}


@pytest.mark.parametrize("model", ["bert", "moe_bert", "gpt"])
@pytest.mark.parametrize("rules", ["bert_tp_rules", "gpt_tp_rules", "bert_tp_ep_rules"])
def test_spec_for_equals_jax_for_every_leaf(model, rules):
    from gradaccum_tpu.parallel.sharding import spec_for as jspec

    from gradaccum_tpu_torch.parallel.sharding import spec_for as tspec
    from gradaccum_tpu_torch.utils.tree import named_parameters

    jrules, trules = _rule_sets()[rules]
    names = list(named_parameters(_models()[model]().init(0, "cpu")))
    split = 0
    for name in names:
        want, got = tuple(jspec(name, jrules)), tuple(tspec(name, trules))
        assert got == want, name
        split += bool(any(got))
    assert split > 0


@pytest.mark.parametrize("rules", [None, "bert_tp_rules", "bert_tp_ep_rules"])
@pytest.mark.parametrize("model", ["bert", "moe_bert"])
def test_zero1_specs_equal_jax_for_every_state_leaf(model, rules):
    import jax

    import importlib

    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu.parallel.zero import zero1_state_specs
    from gradaccum_tpu.utils.tree import named_leaves

    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as tadamw
    from gradaccum_tpu_torch.parallel.zero import zero1_partition_specs
    from gradaccum_tpu_torch.utils.tree import named_parameters

    jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
    jadamw = importlib.import_module("gradaccum_tpu.ops.adamw")
    jrules, trules = _rule_sets()[rules] if rules else (None, None)
    experts = 4 if model == "moe_bert" else 0
    jparams = jbert.bert_classifier_bundle(
        jbert.BertConfig.tiny_for_tests(num_experts=experts)).init(
        jax.random.PRNGKey(0), host_batches()[0])
    jstate = jacc.scan_init(jparams, jadamw.adamw(1e-3))
    want = {name: tuple(spec) for name, spec in
            named_leaves(zero1_state_specs(jstate, 2, jrules))}
    module = _models()[model]().init(0, "cpu")
    tstate = tacc.scan_init(named_parameters(module), tadamw.adamw(1e-3))
    got = {k: tuple(v) for k, v in zero1_partition_specs(tstate, 2, trules).items()}
    assert set(want) - set(got) == {"step"}  # the port's step is a Python int
    data_split = 0
    for name, spec in got.items():
        assert spec == want[name], name
        data_split += "data" in spec
    assert data_split > 0


def test_sharding_rules_refuse_q8_moments():
    """A q8 moment's blockwise codes cannot be cut into a rank's block, as
    ZeRO-1 refuses them: the placement raises before anything is split."""
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.parallel.sharding import P, shard_params

    state = tacc.scan_init({"params/w/kernel": torch.ones(4, 256)},
                           topt.adamw(1e-3, moment_dtype="q8"))
    with pytest.raises(ValueError, match="moment_dtype='q8' OR sharding rules"):
        shard_params(state, mesh=None, rules=[(r"kernel", P(None, "model"))])


@pytest.mark.parametrize("offset,total", [(4, 8), (2, 6), (0, 8)])
def test_keep_mask_with_head_offset_is_the_slice_of_the_whole(offset, total):
    """Heads [offset, offset + 4) of a ``total``-head attention draw exactly
    that slice of its keep mask, and the plain forward and backward on the
    four heads equal the slice of the whole heads' (one rank's heads under
    tensor parallelism)."""
    from gradaccum_tpu_torch.ops import flash_attention as tfa

    seed, b, s, d, h = 123456789, 2, 24, 16, 4
    whole = tfa.dropout_keep_mask(seed, b, total, s, 0.1)
    part = tfa.dropout_keep_mask(seed, b, h, s, 0.1, head_offset=offset, heads_total=total)
    assert torch.equal(part, whole[:, offset:offset + h])
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.tensor(rng.normal(size=(b, total, s, d)).astype(np.float32))
                  for _ in range(4))
    o, lse = tfa.flash_forward_reference(q, k, v, None, seed, False, 0.1)
    sl = slice(offset, offset + h)
    po, plse = tfa.flash_forward_reference(q[:, sl], k[:, sl], v[:, sl], None, seed, False,
                                           0.1, head_offset=offset, heads_total=total)
    torch.testing.assert_close(po, o[:, sl], rtol=0, atol=0)
    torch.testing.assert_close(plse, lse[:, sl], rtol=0, atol=0)
    grads = tfa.flash_backward_reference(q, k, v, None, seed, o, lse, g, False, 0.1)
    pgrads = tfa.flash_backward_reference(q[:, sl], k[:, sl], v[:, sl], None, seed, po, plse,
                                          g[:, sl], False, 0.1, head_offset=offset,
                                          heads_total=total)
    for whole_g, part_g in zip(grads[:3], pgrads[:3]):
        torch.testing.assert_close(part_g, whole_g[:, sl], rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not lie"):
        tfa.dropout_keep_mask(seed, b, h, s, 0.1, head_offset=total - 1, heads_total=total)
