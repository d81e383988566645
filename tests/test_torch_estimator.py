"""The port's Estimator held against the JAX Estimator on the same specs.

The housing MLP (cheap in both packages), weights carried from JAX, in
streaming and in scan mode:

- ``Estimator()`` defaults to ``mode="streaming"`` in both packages;
- ``train_and_evaluate`` runs the same evaluations at the same steps: the
  first after the first chunk, then at most every ``throttle_secs``, and
  one at the end (each evaluation's metrics within 1e-5);
- after ``train(final_save=False)``, ``evaluate`` and ``predict`` read the
  newest checkpoint in ``model_dir``, not the newer weights in memory,
  unless given ``state=`` (or ``checkpoint_path=``), as JAX's do.
"""

import importlib
import inspect

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.data.pipeline import Dataset
from gradaccum_tpu_torch.estimator import checkpoint as tckpt
from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
from gradaccum_tpu_torch.estimator.estimator import Estimator
from gradaccum_tpu_torch.interop import params_from_jax
from gradaccum_tpu_torch.models import housing_mlp as thousing
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as topt

jhousing = importlib.import_module("gradaccum_tpu.models.housing_mlp")
jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jest_mod = importlib.import_module("gradaccum_tpu.estimator.estimator")
jconfig = importlib.import_module("gradaccum_tpu.estimator.config")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K, MICRO = 3, 8


def housing_data(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, 14)).astype(np.float32)
    return {"x": x, "y": (x[:, :1] * 0.7 + rng.normal(0, 1, size=(n, 1))).astype(np.float32)}


TRAIN, EVAL = housing_data(1, 12 * MICRO), housing_data(2, 20)
INIT = jax.device_get(jhousing.housing_mlp_bundle().init(jax.random.PRNGKey(0),
                                                         {"x": EVAL["x"][:1]}))


def train_fn(mode):
    host = MICRO * (K if mode == "scan" else 1)
    return lambda: Dataset.from_arrays(TRAIN).batch(host, drop_remainder=True)


def eval_fn():
    return Dataset.from_arrays(EVAL).batch(8)


def make_pair(mode, tmp_path, **run_kw):
    """The JAX and the port Estimator on the same specs, from INIT."""
    j = jest_mod.Estimator(jhousing.housing_mlp_bundle(), jopt.adam(1e-2),
                           jacc.GradAccumConfig(K), jconfig.RunConfig(
                               model_dir=str(tmp_path / "jax"), **run_kw),
                           mode=mode, warm_start=INIT)
    base = thousing.housing_mlp_bundle()

    def init_from_jax(seed, device):
        model = base.init(seed, device)
        model.load_state_dict(params_from_jax(INIT))
        return model

    t = Estimator(base._replace(init=init_from_jax), topt.adam(1e-2), tacc.GradAccumConfig(K),
                  RunConfig(model_dir=str(tmp_path / "port"), **run_kw), mode=mode,
                  device="cpu")
    return j, t


def record_evaluations(est):
    """Wrap ``est.evaluate``: the step of each evaluation and its metrics."""
    seen = []
    inner = est.evaluate

    def evaluate(*args, **kw):
        results = inner(*args, **kw)
        seen.append((int(jax.device_get(kw["state"].step)), results["mae"], results["rmse"]))
        return results

    est.evaluate = evaluate
    return seen


def test_default_mode_is_streaming():
    assert inspect.signature(jest_mod.Estimator).parameters["mode"].default == "streaming"
    assert inspect.signature(Estimator).parameters["mode"].default == "streaming"
    est = Estimator(thousing.housing_mlp_bundle(), topt.adam(1e-3), tacc.GradAccumConfig(2),
                    device="cpu")
    assert est.mode == "streaming"
    with pytest.raises(ValueError, match="mode"):
        Estimator(thousing.housing_mlp_bundle(), topt.adam(1e-3), tacc.GradAccumConfig(2),
                  mode="pipelined", device="cpu")


@pytest.mark.parametrize("throttle", [3600, 0])
@pytest.mark.parametrize("mode", ["streaming", "scan"])
def test_train_and_evaluate_runs_the_same_evaluations_as_jax(tmp_path, mode, throttle):
    """The first evaluation after the first chunk (3 micro-batches), then
    every chunk (throttle 0) or none until the end (throttle 3600)."""
    kw = dict(log_step_count_steps=K, save_checkpoints_steps=None)
    j, t = make_pair(mode, tmp_path, **kw)
    j_seen, t_seen = record_evaluations(j), record_evaluations(t)
    spec = dict(max_steps=4 * K)
    j.train_and_evaluate(jconfig.TrainSpec(train_fn(mode), **spec),
                         jconfig.EvalSpec(eval_fn, throttle_secs=throttle))
    t.train_and_evaluate(TrainSpec(train_fn(mode), **spec),
                         EvalSpec(eval_fn, throttle_secs=throttle))
    want_steps = [3, 12] if throttle else [3, 6, 9, 12]
    assert [s for s, _, _ in t_seen] == [s for s, _, _ in j_seen] == want_steps
    for (_, mae, rmse), (_, j_mae, j_rmse) in zip(t_seen, j_seen):
        np.testing.assert_allclose([mae, rmse], [j_mae, j_rmse], rtol=1e-5)


@pytest.mark.parametrize("mode", ["streaming", "scan"])
def test_evaluate_prefers_the_newest_checkpoint_like_jax(tmp_path, mode):
    """Train 9 micro-batches with a checkpoint at step 6 and no final save:
    evaluate() and predict() read step 6's weights, evaluate(state=) the
    in-memory step 9's, evaluate(checkpoint_path=) the named file's."""
    kw = dict(log_step_count_steps=1000, save_checkpoints_steps=6)
    j, t = make_pair(mode, tmp_path, **kw)
    batches = list(train_fn(mode)())
    j_state = j.train(batches, max_steps=9, final_save=False)
    t_state = t.train(batches, max_steps=9, final_save=False)
    assert t_state.step == int(j_state.step) == 9
    assert [s for s, _ in tckpt.all_checkpoints(str(tmp_path / "port"))] == [6]

    j_ckpt, t_ckpt = j.evaluate(eval_fn), t.evaluate(eval_fn)
    np.testing.assert_allclose(t_ckpt["mae"], j_ckpt["mae"], rtol=1e-5)
    t_live = t.evaluate(eval_fn, state=t_state)
    np.testing.assert_allclose(t_live["mae"], j.evaluate(eval_fn, state=j_state)["mae"],
                               rtol=1e-5)
    assert abs(t_live["mae"] - t_ckpt["mae"]) > 1e-4  # the two weights differ
    path = tckpt.latest_checkpoint(str(tmp_path / "port"))[1]
    assert t.evaluate(eval_fn, checkpoint_path=path)["mae"] == t_ckpt["mae"]

    t_pred = list(t.predict(eval_fn))
    j_pred = list(j.predict(eval_fn))
    assert len(t_pred) == len(j_pred) == len(EVAL["y"])
    np.testing.assert_allclose(np.stack([p["predictions"] for p in t_pred]),
                               np.stack([np.asarray(p["predictions"]) for p in j_pred]),
                               rtol=1e-5, atol=1e-5)
    # the in-memory training state is untouched by the checkpoint reads
    assert all(a is b for a, b in zip(t._state.params.values(), t_state.params.values()))
    assert t.evaluate(eval_fn, state=t_state)["mae"] == t_live["mae"]


def test_inference_weights_without_checkpoints(tmp_path):
    """No checkpoint: the in-memory state, else a fresh init."""
    bundle = thousing.housing_mlp_bundle()
    est = Estimator(bundle, topt.adam(1e-2), tacc.GradAccumConfig(K),
                    RunConfig(model_dir=str(tmp_path), save_checkpoints_steps=None,
                              log_step_count_steps=1000), device="cpu")
    fresh = est.evaluate(eval_fn)
    again = Estimator(bundle, topt.adam(1e-2), tacc.GradAccumConfig(K), device="cpu")
    assert again.evaluate(eval_fn)["mae"] == fresh["mae"]  # same seed, same init
    est.train(list(train_fn("streaming")()), max_steps=6, final_save=False)
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    trained = est.evaluate(eval_fn)
    assert trained["mae"] == est.evaluate(eval_fn, state=est._state)["mae"]
    assert trained["mae"] != fresh["mae"]
    # another Estimator's state: its weights are copied into an inference module
    assert again.evaluate(eval_fn, state=est._state)["mae"] == trained["mae"]
    assert again.evaluate(eval_fn)["mae"] == fresh["mae"]
