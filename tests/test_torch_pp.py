"""The port's pipeline parallelism held against JAX's GPipe step.

Two spawns of gloo ranks on the CPU (``examples/common.py ::
spawn_ranks``, with a deadline): two ranks (pipe=2) and four (pipe=4, and
pipe=2 × data=2). Each rank saves what it saw, and the tests hold it
against JAX's ``make_pp_train_step`` on the virtual CPU devices of
``tests/conftest.py``, from the same stage-stacked parameters and batches
(``tests/test_pp.py``'s linear stages; BERT through
``bert_pipeline_spec``):

- three updates at pipe=2 (K=4, K=2), pipe=4 and pipe=2 × data=2 with
  AdamW: losses and parameters within 2e-6 at every update (BERT: rtol
  2e-4, atol 2e-5, JAX's own limits against dense training);
- the three guard levels, each against JAX's verdicts and update: a NaN in
  a raw batch leaf (1), an overflow inside stage 0 (2), a loss that
  overflows on the last rank (3), and a micro-batch poisoned in one data
  shard skipped on both;
- loss scaling: scaled against unscaled bitwise on clean windows, an
  all-bad window a bitwise no-op that halves the scale, regrowth after two
  clean windows, as JAX's ``test_pp_loss_scale_matches_unscaled_then_halve_regrow``;
- remat in BERT's stages against none;
- the collectives per update equal the design's count (PERF.md);
- ``Estimator(pipeline=...)``: its global checkpoint restores in one
  process bitwise, its evaluation runs the merged dense model;
- JAX's refusals, word for word (the step's, the Estimator's, BERT's,
  ``bert_finetune --pp``'s).

    python -m pytest -m torch tests/test_torch_pp.py
"""

import dataclasses
import importlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

BL, D = 8, 16  # the linear stages: rows per micro-batch, width
UPDATES = 3
LR = 1e-3
TRAJ = 2e-6  # float32 trajectories against JAX
BK, BMICRO, BS = 4, 8, 16  # the BERT cases: K, rows per micro-batch, tokens
# name: (world, mesh axes, K, kind); kinds "linear", "bert"
CASES = {
    "p2k4": (2, dict(pipe=2), 4, "linear"),
    "p2k2": (2, dict(pipe=2), 2, "linear"),
    "p4k4": (4, dict(pipe=4), 4, "linear"),
    "p2d2": (4, dict(pipe=2, data=2), 4, "linear"),
    "bert_p2": (2, dict(pipe=2), BK, "bert"),
    "bert_p2d2": (4, dict(pipe=2, data=2), BK, "bert"),
}


def stages_np(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"b": rng.normal(scale=0.1, size=(D,)).astype(np.float32),
             "w": rng.normal(scale=0.5, size=(D, D)).astype(np.float32)} for _ in range(n)]


def linear_batch(k, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(k, BL, D)).astype(np.float32),
            "y": rng.normal(size=(k, BL, D)).astype(np.float32)}


def bert_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((BK * BMICRO, BS), np.int32)
    mask[0, BS - 4:] = 0  # a padded tail: the ctx path must carry it
    return {"input_ids": rng.integers(0, 128, size=(BK * BMICRO, BS)).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((BK * BMICRO, BS), np.int32),
            "label": rng.integers(0, 2, size=(BK * BMICRO,)).astype(np.int32)}


def stacked_bert(seed):
    return {k: v.reshape((BK, BMICRO) + v.shape[1:]) for k, v in bert_batch(seed).items()}


# the guard cases at pipe=2, K=4: (stage kind, poisoned batch)
def guard_batches():
    level1 = linear_batch(4, 12)
    level1["x"][1] = np.nan  # a raw leaf: caught before the stages
    level2 = linear_batch(4, 13)
    level2["x"][2] = 3e38  # finite, but stage 0's product overflows
    level3 = linear_batch(4, 14)
    level3["y"][3] = 1e20  # finite leaves and stages; the loss overflows
    dp = linear_batch(4, 15)
    dp["x"][2, : BL // 2] = np.nan  # one data shard's rows only
    return {"level1": level1, "level2": level2, "level3": level3, "dp": dp}


# --------------------------------------------------------------------------
# the ranks: python -m tests.test_torch_pp <outdir> <world>
# --------------------------------------------------------------------------


def _t_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _t_linear(params, x):
    return x @ params["w"] + params["b"]


def _t_loss(out, labels):
    return torch.mean((out - labels["y"]) ** 2)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _rank_cases(outdir, world):
    from gradaccum_tpu_torch.estimator import checkpoint as tckpt
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.models import bert_pp as tbpp
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.parallel import pp

    out = {}
    warm = {k: torch.as_tensor(v) for k, v in np.load(os.path.join(outdir, "warm.npz")).items()}
    cfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    meshes = {}

    def mesh_for(axes):
        key = tuple(sorted(axes.items()))
        if key not in meshes:
            meshes[key] = mesh_lib.make_mesh(**axes)
        return mesh_lib.bind_mesh(meshes[key])

    def record(tag, state, aux, mesh):
        whole = pp.pp_global_state(state, mesh.axis("pipe"))
        params = pp.flat_params(whole.params)
        for name, p in params.items():
            out.setdefault(f"{tag}/param/{name}", []).append(p.detach().numpy().copy())
        for key in ("loss", "skipped", "good_count", "loss_scale"):
            if key in aux:
                out.setdefault(f"{tag}/{key}", []).append(float(aux[key]))

    def bert_parts(n_stages, remat=False):
        spec = tbpp.bert_pipeline_spec(dataclasses.replace(cfg, remat=remat), n_stages)
        pre, stages, post = spec.partition(warm, n_stages)
        return spec, pre, stages, post

    for tag, (w, axes, k, kind) in CASES.items():
        if w != world:
            continue
        mesh = mesh_for(axes)
        data = "data" if "data" in axes else None
        opt = topt.adamw(LR, weight_decay_rate=0.01)
        if kind == "linear":
            step = pp.make_pp_train_step(_t_stage, _t_loss, opt, k, mesh, data_axis=data)
            state = pp.pp_init(stages_np(axes["pipe"]), opt)
            data_for = [_t(linear_batch(k, 20 + u)) for u in range(UPDATES)]
        else:
            spec, pre, stages, post = bert_parts(axes["pipe"])
            step = pp.make_pp_train_step(
                spec.stage_fn, spec.loss_fn, opt, k, mesh, data_axis=data,
                input_key=spec.input_key, pre_fn=spec.pre_fn, ctx_keys=spec.ctx_keys)
            state = pp.pp_init(stages, opt, pre_params=pre, post_params=post)
            data_for = [_t(stacked_bert(60 + u)) for u in range(UPDATES)]
        state = pp.pp_local_state(state, mesh.axis("pipe"))
        for u, batch in enumerate(data_for):
            mesh.reset_calls()
            state, aux = step(state, batch)
            if u == 0:
                for key, n in mesh.calls.items():
                    out[f"{tag}/calls/{key}"] = n
            record(tag, state, aux, mesh)

    if world == 2:
        mesh = mesh_for(dict(pipe=2))
        # the guard, each level alone, SGD so the update is the gradient
        for level, batch in guard_batches().items():
            if level == "dp":
                continue
            opt = topt.sgd(0.5)
            fn = _t_linear if level == "level2" else _t_stage
            step = pp.make_pp_train_step(fn, _t_loss, opt, 4, mesh, skip_nonfinite=True)
            state = pp.pp_local_state(pp.pp_init(stages_np(2, seed=1), opt), mesh.axis("pipe"))
            state, aux = step(state, _t(batch))
            record(f"guard_{level}", state, aux, mesh)
        # loss scaling: scaled against unscaled, then an all-bad window and regrowth
        ls = LossScaleConfig(init_scale=16.0, growth_interval=2)
        opt = topt.adamw(LR, weight_decay_rate=0.01)
        step_u = pp.make_pp_train_step(_t_stage, _t_loss, opt, 2, mesh, skip_nonfinite=True)
        step_s = pp.make_pp_train_step(_t_stage, _t_loss, opt, 2, mesh, skip_nonfinite=True,
                                       loss_scale=ls)
        su = pp.pp_local_state(pp.pp_init(stages_np(2, seed=2), opt), mesh.axis("pipe"))
        ss = pp.pp_local_state(pp.pp_init(stages_np(2, seed=2), opt, loss_scale=ls),
                               mesh.axis("pipe"))
        for u in range(3):
            batch = _t(linear_batch(2, 70 + u))
            su, au = step_u(su, batch)
            ss, a_s = step_s(ss, batch)
        record("ls_unscaled", su, au, mesh)
        record("ls", ss, a_s, mesh)
        before = {k: v.detach().clone() for k, v in tckpt.flatten(ss).items()
                  if isinstance(v, torch.Tensor)}
        bad = linear_batch(2, 73)
        bad["x"][:] = np.nan
        ss, aux = step_s(ss, _t(bad))
        after = tckpt.flatten(ss)
        out["ls/bad_noop"] = all(torch.equal(before[k], after[k]) for k in before
                                 if not k.startswith("loss_scale"))
        record("ls", ss, aux, mesh)
        for u in range(2):
            ss, aux = step_s(ss, _t(linear_batch(2, 74 + u)))
        record("ls", ss, aux, mesh)
        # remat in the BERT stages against none: one update each
        for remat in (False, True):
            spec, pre, stages, post = bert_parts(2, remat)
            opt = topt.adamw(LR, weight_decay_rate=0.01)
            step = pp.make_pp_train_step(spec.stage_fn, spec.loss_fn, opt, BK, mesh,
                                         input_key=spec.input_key, pre_fn=spec.pre_fn,
                                         ctx_keys=spec.ctx_keys)
            state = pp.pp_local_state(pp.pp_init(stages, opt, pre_params=pre, post_params=post),
                                      mesh.axis("pipe"))
            state, aux = step(state, _t(stacked_bert(60)))
            record(f"remat_{remat}", state, aux, mesh)
        # the Estimator on the pipeline: two updates, a global checkpoint
        model_dir = os.path.join(outdir, "est_ckpt")
        est = Estimator(tbert.bert_classifier_bundle(cfg, num_classes=2),
                        topt.adamw(LR, weight_decay_rate=0.01),
                        tacc.GradAccumConfig(BK, clip_norm=1.0, first_step_quirk=False,
                                             skip_nonfinite=True),
                        RunConfig(seed=7, model_dir=model_dir, save_checkpoints_steps=None,
                                  log_step_count_steps=1000),
                        mode="scan", device="cpu", mesh=mesh, warm_start=warm,
                        pipeline=tbpp.bert_pipeline_spec(cfg, 2))
        for u in range(2):
            est.train([bert_batch(60 + u)], final_save=u == 1)
            out.setdefault("est/loss", []).append(float(est.last_loss))
        out["est/accuracy"] = est.evaluate([bert_batch(80)])["accuracy"]
        whole = est._global_state(est._state)
        for key, v in tckpt.flatten(whole).items():
            if isinstance(v, torch.Tensor):
                out[f"est/state/{key}"] = v.detach().numpy().copy()
    else:
        mesh = mesh_for(dict(pipe=2, data=2))
        opt = topt.sgd(0.5)
        step = pp.make_pp_train_step(_t_stage, _t_loss, opt, 4, mesh, data_axis="data",
                                     skip_nonfinite=True)
        state = pp.pp_local_state(pp.pp_init(stages_np(2, seed=1), opt), mesh.axis("pipe"))
        state, aux = step(state, _t(guard_batches()["dp"]))
        record("guard_dp", state, aux, mesh)
    return out


def _rank_main(outdir, world):
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    os.environ["GRADACCUM_EVENTS"] = "0"
    info = mesh_lib.initialize_multihost(device="cpu", timeout_s=60)
    try:
        results = _rank_cases(outdir, int(world))
        rank = info["process_index"]
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])


# --------------------------------------------------------------------------
# the tests (JAX on the virtual CPU devices of tests/conftest.py)
# --------------------------------------------------------------------------


def _jax_bert_params():
    import jax

    from gradaccum_tpu.models import bert as jbert

    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    return jax.device_get(jbert.bert_classifier_bundle(cfg, num_classes=2).init(
        jax.random.PRNGKey(0), bert_batch(60)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from gradaccum_tpu_torch.examples.common import spawn_ranks
    from gradaccum_tpu_torch.interop import params_from_jax
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.utils.tree import named_parameters

    jparams = _jax_bert_params()
    module = tbert.bert_classifier_bundle(
        tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)).init(0, "cpu")
    module.load_state_dict(params_from_jax(jparams))
    out, dirs = {}, {}
    for world in (2, 4):
        outdir = dirs[world] = tmp_path_factory.mktemp(f"pp_ranks{world}")
        np.savez(outdir / "warm.npz", **{name: p.detach().numpy() for name, p in
                                         named_parameters(module).items()})
        assert spawn_ranks("tests.test_torch_pp", [str(outdir), str(world)], world, "cpu",
                           deadline_s=240) == {"ok": True}
        out[world] = [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(world)]
    return out, jparams, dirs


def _jax_linear(k, seed=0):
    import jax.numpy as jnp

    def stage(params, x):
        return jnp.tanh(x @ params["w"] + params["b"])

    def linear(params, x):
        return x @ params["w"] + params["b"]

    def loss(out, labels):
        return jnp.mean((out - labels["y"]) ** 2)

    return stage, linear, loss


def _jax_run(axes, k, kind, jparams, data=None, opt=None, **kw):
    """JAX's ``make_pp_train_step`` on ``axes``: ``(aux per update, the
    state after each update)`` as host trees."""
    import jax

    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu.models import bert_pp as jbpp
    from gradaccum_tpu.ops.adamw import adamw
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.pp import make_pp_train_step, pp_init

    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(**axes, devices=jax.devices()[:n])
    opt = opt or adamw(LR, weight_decay_rate=0.01)
    data_axis = "data" if "data" in axes else None
    if kind == "bert":
        cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
        pre_fn, stage_fn, loss_fn = jbpp.bert_pp_fns(cfg, cfg.num_layers // axes["pipe"])
        pre, stages, post = jbpp.bert_pp_partition(jparams, axes["pipe"])
        step = make_pp_train_step(stage_fn, loss_fn, opt, k, mesh, data_axis=data_axis,
                                  input_key="input_ids", pre_fn=pre_fn,
                                  ctx_keys=("input_mask",), **kw)
        state = pp_init(stages, opt, pre_params=pre, post_params=post)
        data = data or [stacked_bert(60 + u) for u in range(UPDATES)]
    else:
        stage, linear, loss = _jax_linear(k)
        seed = kw.pop("seed", 0)
        step = make_pp_train_step(linear if kw.pop("linear", False) else stage, loss, opt, k,
                                  mesh, data_axis=data_axis, **kw)
        state = pp_init(stages_np(axes["pipe"], seed=seed), opt,
                        loss_scale=kw.get("loss_scale"))
        data = data or [linear_batch(k, 20 + u) for u in range(UPDATES)]
    auxes, params = [], []
    for batch in data:
        state, aux = step(state, batch)
        auxes.append(jax.device_get(aux))
        params.append(jax.device_get(state.params))
    return auxes, params


def _flat_jax(params):
    """A JAX pipeline state's parameters in the port's flat names and layouts."""
    from gradaccum_tpu_torch.interop import pipeline_params_from_jax
    from gradaccum_tpu_torch.parallel.pp import flat_params

    return {k: v.numpy() for k, v in flat_params(pipeline_params_from_jax(params)).items()}


def _check(ranks_out, tag, auxes, params, rtol=0.0, atol=TRAJ):
    for r, out in enumerate(ranks_out):
        np.testing.assert_allclose(out[f"{tag}/loss"], [float(a["loss"]) for a in auxes],
                                   rtol=max(rtol, 1e-6), atol=atol, err_msg=f"{tag} loss")
        for u, want in enumerate(params):
            for name, w in _flat_jax(want).items():
                np.testing.assert_allclose(out[f"{tag}/param/{name}"][u], w, rtol=rtol,
                                           atol=atol, err_msg=f"{tag} rank {r} update {u} "
                                                              f"{name}")


@pytest.mark.parametrize("tag", [t for t, c in CASES.items() if c[3] == "linear"])
def test_pp_step_matches_jax(ranks, tag):
    out, jparams, _ = ranks
    world, axes, k, kind = CASES[tag]
    auxes, params = _jax_run(axes, k, kind, jparams)
    _check(out[world], tag, auxes, params)


@pytest.mark.parametrize("tag", [t for t, c in CASES.items() if c[3] == "bert"])
def test_bert_pipeline_matches_jax(ranks, tag):
    out, jparams, _ = ranks
    world, axes, k, kind = CASES[tag]
    auxes, params = _jax_run(axes, k, kind, jparams)
    _check(out[world], tag, auxes, params, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("level", ["level1", "level2", "level3", "dp"])
def test_guard_levels_match_jax_verdicts(ranks, level):
    from gradaccum_tpu.ops.adamw import sgd

    out, jparams, _ = ranks
    axes = dict(pipe=2, data=2) if level == "dp" else dict(pipe=2)
    auxes, params = _jax_run(axes, 4, "linear", jparams, data=[guard_batches()[level]],
                             opt=sgd(0.5), skip_nonfinite=True, seed=1,
                             linear=level == "level2")
    assert int(auxes[0]["skipped"]) == 1 and int(auxes[0]["good_count"]) == 3
    ranks_out = out[4 if level == "dp" else 2]
    for r in ranks_out:
        assert r[f"guard_{level}/skipped"] == [1.0] and r[f"guard_{level}/good_count"] == [3.0]
    _check(ranks_out, f"guard_{level}", auxes, params, rtol=1e-6, atol=1e-6)


def test_loss_scale_halves_and_regrows_as_jax(ranks):
    out, _, _ = ranks
    for r in out[2]:
        for name in (k for k in r if k.startswith("ls_unscaled/param/")):
            np.testing.assert_array_equal(r[name][0], r["ls/param/" + name.split("/", 2)[2]][0])
        np.testing.assert_allclose(r["ls/loss"][0], r["ls_unscaled/loss"][0], rtol=1e-6)
        # 16 -> 32 after two clean windows; halved by the bad one; regrown
        assert list(r["ls/loss_scale"]) == [32.0, 16.0, 32.0]
        assert bool(r["ls/bad_noop"]) and np.isnan(r["ls/loss"][1])
        assert r["ls/good_count"][1] == 0.0


def test_loss_scale_trajectory_matches_jax(ranks):
    """The same scaled run in JAX: the scales and parameters agree."""
    from gradaccum_tpu.ops.adamw import adamw
    from gradaccum_tpu.ops.loss_scale import LossScaleConfig

    out, jparams, _ = ranks
    bad = linear_batch(2, 73)
    bad["x"][:] = np.nan
    data = [linear_batch(2, 70 + u) for u in range(3)] + [bad] + \
        [linear_batch(2, 74 + u) for u in range(2)]
    auxes, params = _jax_run(dict(pipe=2), 2, "linear", jparams, data=data,
                             opt=adamw(LR, weight_decay_rate=0.01), skip_nonfinite=True,
                             loss_scale=LossScaleConfig(init_scale=16.0, growth_interval=2),
                             seed=2)
    for r in out[2]:
        assert list(r["ls/loss_scale"]) == [float(auxes[i]["loss_scale"]) for i in (2, 3, 5)]
        for u, i in enumerate((2, 3, 5)):
            for name, w in _flat_jax(params[i]).items():
                np.testing.assert_allclose(r[f"ls/param/{name}"][u], w, rtol=0, atol=TRAJ)


def test_bert_stage_remat_matches_no_remat(ranks):
    out, _, _ = ranks
    for r in out[2]:
        np.testing.assert_allclose(r["remat_True/loss"], r["remat_False/loss"], rtol=1e-6)
        for key in (k for k in r if k.startswith("remat_False/param/")):
            np.testing.assert_allclose(r["remat_True" + key[len("remat_False"):]], r[key],
                                       rtol=1e-6, atol=1e-7, err_msg=key)


def test_collectives_per_update_equal_the_design(ranks):
    """Per update with P stages and K micro-batches: 2 (K + P - 2)
    ppermutes on pipe, one SUM all-reduce on pipe, one on data with a data
    axis (PERF.md)."""
    out, _, _ = ranks
    for tag, (world, axes, k, _) in CASES.items():
        p = axes["pipe"]
        want = {"pipe/ppermute": 2 * (k + p - 2), "pipe/all_reduce": 1}
        if "data" in axes:
            want["data/all_reduce"] = 1
        for r in out[world]:
            got = {key[len(f"{tag}/calls/"):]: int(v) for key, v in r.items()
                   if key.startswith(f"{tag}/calls/") and ":" not in key[len(f"{tag}/calls/"):]}
            assert got == want, (tag, got)


def test_estimator_pipeline_checkpoint_restores_in_one_process(ranks):
    """The Estimator's global checkpoint (``[P, ...]`` stages) restores into
    the whole pipeline state built in one process, bitwise equal to what
    the ranks gathered; its evaluation equals the merged dense model's."""
    from gradaccum_tpu_torch.estimator import checkpoint as tckpt
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.models import bert_pp as tbpp
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.parallel import pp

    import types

    out, _, dirs = ranks
    r0 = out[2][0]
    model_dir = dirs[2] / "est_ckpt"
    cfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    spec = tbpp.bert_pipeline_spec(cfg, 2)
    module = tbert.bert_classifier_bundle(cfg).init(0, "cpu")
    opt = topt.adamw(LR, weight_decay_rate=0.01)
    from gradaccum_tpu_torch.utils.tree import named_parameters

    pre, stages, post = spec.partition(named_parameters(module), 2)
    template = pp.pp_init(stages, opt, pre_params=pre, post_params=post)
    restored = tckpt.flatten(tckpt.restore(str(model_dir), template))
    saved = {k[len("est/state/"):]: v for k, v in r0.items() if k.startswith("est/state/")}
    assert set(saved) == {k for k, v in restored.items() if isinstance(v, torch.Tensor)}
    for key, v in saved.items():
        np.testing.assert_array_equal(restored[key].detach().numpy(), v, err_msg=key)
    # merged into the dense model in one process, it evaluates as the ranks did
    est = Estimator(tbert.bert_classifier_bundle(cfg, num_classes=2), opt,
                    tacc.GradAccumConfig(BK, first_step_quirk=False),
                    RunConfig(), mode="scan", device="cpu")
    merged = spec.merge(tckpt.restore(str(model_dir), template).params)
    assert merged.keys() == named_parameters(module).keys()
    got = est.evaluate([bert_batch(80)], state=types.SimpleNamespace(params=merged, step=8))
    assert got["accuracy"] == float(r0["est/accuracy"])


def _jax_refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_step_refusals_match_jax():
    import jax

    from gradaccum_tpu.ops.adamw import adamw as jadamw
    from gradaccum_tpu.ops.loss_scale import LossScaleConfig as JLS
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.pp import make_pp_train_step as jstep
    from gradaccum_tpu_torch.ops.adamw import adamw as tadamw
    from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig as TLS
    from gradaccum_tpu_torch.parallel.pp import make_pp_train_step as tstep

    jmesh = make_mesh(pipe=2, devices=jax.devices()[:2])

    class Fake:  # make_pp_train_step reads the mesh only after its refusals
        def axis(self, name):
            return None

        def over(self, names):
            return None

    stage, _, loss = _jax_linear(2)
    for kw in (dict(normalize_by_good_count=True), dict(loss_scale="LS")):
        jkw = {k: (JLS() if v == "LS" else v) for k, v in kw.items()}
        tkw = {k: (TLS() if v == "LS" else v) for k, v in kw.items()}
        want = _jax_refusal(lambda: jstep(stage, loss, jadamw(1e-3), 2, jmesh, **jkw))
        got = _jax_refusal(lambda: tstep(_t_stage, _t_loss, tadamw(1e-3), 2, Fake(), **tkw))
        assert want is not None and got == want


def test_bert_pp_refuses_dropout_and_moe_as_jax():
    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu.models import bert_pp as jbpp
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.models import bert_pp as tbpp

    for kw in ({}, dict(hidden_dropout=0.0, attention_dropout=0.0, num_experts=2)):
        want = _jax_refusal(lambda: jbpp.bert_pp_fns(jbert.BertConfig.tiny_for_tests(**kw), 1))
        got = _jax_refusal(lambda: tbpp.bert_pp_fns(tbert.BertConfig.tiny_for_tests(**kw), 1))
        assert want is not None and got == want


@pytest.mark.parametrize("case", ["no-pipe", "streaming", "quirk", "zero1", "sparse", "fused"])
def test_estimator_pipeline_refusals_match_jax(case):
    import gradaccum_tpu as gt
    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu.models import bert_pp as jbpp
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.models import bert_pp as tbpp
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt

    class Fake:
        def __init__(self, **axes):
            self.shape = axes

        def axis(self, name):
            return None

    axes = dict(pipe=1, data=2) if case == "no-pipe" else dict(pipe=2, data=2)
    kw = {"streaming": dict(mode="streaming"), "zero1": dict(zero1=True),
          "sparse": dict(sparse_embed=True)}.get(case, {})
    quirk = case == "quirk"
    fused = case == "fused"
    jcfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    tcfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    want = _jax_refusal(lambda: gt.Estimator(
        jbert.bert_classifier_bundle(jcfg), gt.ops.adamw(1e-3),
        gt.GradAccumConfig(2, first_step_quirk=quirk, fused_adam=fused),
        mesh=Fake(**axes), pipeline=jbpp.bert_pipeline_spec(jcfg, 2),
        **dict(dict(mode="scan"), **kw)))
    got = _jax_refusal(lambda: Estimator(
        tbert.bert_classifier_bundle(tcfg), topt.adamw(1e-3),
        tacc.GradAccumConfig(2, first_step_quirk=quirk, fused_adam=fused),
        mesh=Fake(**axes), pipeline=tbpp.bert_pipeline_spec(tcfg, 2), device="cpu",
        **dict(dict(mode="scan"), **kw)))
    assert want is not None and got == want, (case, got, want)


REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("argv", [
    ["--pp", "0"],
    ["--pp", "2", "--sp", "2"],
    ["--pp", "2", "--tp", "2"],
    ["--pp", "2", "--mode", "streaming"],
    ["--zero1", "--dp", "2", "--pp", "2"],
    ["--sparse-embed-grad", "--pp", "2"],
    ["--pp", "3"],
], ids=["pp-0", "pp-with-sp", "pp-with-tp", "pp-streaming", "pp-zero1", "pp-sparse-embed",
        "pp-layers-not-split"])
def test_pp_parser_errors_match_jax(argv, tmp_path, capsys):
    from gradaccum_tpu_torch.examples import bert_finetune as tbf

    sys.path.insert(0, str(REPO))
    jbf = importlib.import_module("examples.bert_finetune")
    with pytest.raises(SystemExit):
        jbf.main([*argv, "--model-dir", str(tmp_path / "jax")])
    want = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    with pytest.raises(SystemExit):
        tbf.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1] == want



def test_pipeline_params_carry_to_the_port_and_back():
    """A JAX ``PipelineParams`` (BERT through ``bert_pp_partition``,
    stage-stacked) carried into the port's layout and back is JAX's bit
    for bit; the port's stacked kernels are the transposes."""
    import jax

    from gradaccum_tpu.models import bert_pp as jbpp
    from gradaccum_tpu.ops.adamw import adamw as jadamw
    from gradaccum_tpu.parallel.pp import pp_init
    from gradaccum_tpu_torch.interop import pipeline_params_from_jax, pipeline_params_to_jax

    pre, stages, post = jbpp.bert_pp_partition(_jax_bert_params(), 2)
    jparams = jax.device_get(pp_init(stages, jadamw(LR), pre_params=pre,
                                     post_params=post).params)
    port = pipeline_params_from_jax(jparams)
    q = port.stages["params/sub_0/attention/query/kernel"]
    want = np.asarray(jparams.stages["params"]["sub_0"]["attention"]["query"]["kernel"])
    np.testing.assert_array_equal(q.numpy(), np.swapaxes(want, -1, -2))
    back = pipeline_params_to_jax(port)
    for got, ref in zip(back, jparams):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), got, ref)
