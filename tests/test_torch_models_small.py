"""The port's MNIST CNN and housing MLP held against the JAX models.

From the same weights (carried with ``interop.params_from_jax``) and the
same numpy batches: logits and loss within 1e-5, every gradient within
1e-4. The CNN case is the check on the conv kernel layout (HWIO <-> OIHW)
and on the flatten order (flax flattens NHWC, so the first Dense's 5408
rows are in (h, w, c) order): a wrong one moves the logits by O(1). Then
variant 02 of the MNIST example (K=2, Adam 1e-4, the quirk on) for a few
streaming steps through both Estimators: per-step losses within 1e-5 and
parameters within 2e-6. And the housing MLP's MAE and RMSE against JAX's
metrics.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.data.pipeline import Dataset
from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator
from gradaccum_tpu_torch.interop import params_from_jax, params_to_jax
from gradaccum_tpu_torch.models import housing_mlp as thousing
from gradaccum_tpu_torch.models import mnist_cnn as tmnist
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as topt
from gradaccum_tpu_torch.utils.tree import named_parameters

jmnist = importlib.import_module("gradaccum_tpu.models.mnist_cnn")
jhousing = importlib.import_module("gradaccum_tpu.models.housing_mlp")
jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jest = importlib.import_module("gradaccum_tpu.estimator.estimator")
jconfig = importlib.import_module("gradaccum_tpu.estimator.config")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def mnist_batch(seed, n=8):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, size=(n, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(0, 10, size=n).astype(np.int32)}


def housing_batch(seed, n=8):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0, 10, size=(n, 14)).astype(np.float32),
            "y": rng.normal(20, 5, size=(n, 1)).astype(np.float32)}


def _carried(j_bundle, t_bundle, sample, seed=0):
    params = jax.device_get(j_bundle.init(jax.random.PRNGKey(seed), sample))
    model = t_bundle.init(1, "cpu")
    model.load_state_dict(params_from_jax(params))
    return params, model


CASES = {
    "mnist_cnn": (jmnist.mnist_cnn_bundle, tmnist.mnist_cnn_bundle, mnist_batch, "logits"),
    "housing_mlp": (jhousing.housing_mlp_bundle, thousing.housing_mlp_bundle, housing_batch,
                    "predictions"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_and_gradients_match_jax(case):
    j_make, t_make, make_batch, out_key = CASES[case]
    j_bundle, t_bundle = j_make(), t_make()
    batch = make_batch(1)
    params, model = _carried(j_bundle, t_bundle, batch)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    want = np.asarray(j_bundle.predict(params, batch)[out_key])
    got = t_bundle.predict(model, tb)[out_key].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    j_loss, j_grads = jax.value_and_grad(j_bundle.loss)(params, batch)
    named = named_parameters(model)
    t_loss = t_bundle.loss(model, tb)
    t_grads = torch.autograd.grad(t_loss, list(named.values()))
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5, atol=1e-5)
    got_g = dict(jtree.named_leaves(params_to_jax(dict(zip(named, t_grads)))))
    want_g = dict(jtree.named_leaves(jax.device_get(j_grads)))
    assert got_g.keys() == want_g.keys()
    for name in want_g:
        assert got_g[name].shape == want_g[name].shape, name
        np.testing.assert_allclose(got_g[name], want_g[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_mnist_predict_outputs():
    bundle = tmnist.mnist_cnn_bundle()
    model = bundle.init(0, "cpu")
    out = bundle.predict(model, {k: torch.tensor(v) for k, v in mnist_batch(2, 4).items()})
    assert out["logits"].shape == (4, 10) and out["classes"].shape == (4,)
    torch.testing.assert_close(out["probabilities"].sum(-1), torch.ones(4))
    assert torch.equal(out["classes"], out["logits"].argmax(-1))


def test_conv_kernel_and_flatten_layout():
    """The conv kernel maps HWIO <-> OIHW and back unchanged; the dense
    kernel's rows are in (h, w, c) order, so permuting them to (c, h, w)
    changes the logits."""
    j_bundle, t_bundle = jmnist.mnist_cnn_bundle(), tmnist.mnist_cnn_bundle()
    batch = mnist_batch(3, 2)
    params, model = _carried(j_bundle, t_bundle, batch)
    assert tuple(model.conv.weight.shape) == (32, 1, 3, 3)
    back = params_to_jax(model)
    np.testing.assert_array_equal(back["params"]["conv"]["kernel"],
                                  params["params"]["conv"]["kernel"])
    np.testing.assert_array_equal(back["params"]["dense"]["kernel"],
                                  params["params"]["dense"]["kernel"])
    kernel = params["params"]["dense"]["kernel"]  # [13*13*32, 64], rows (h, w, c)
    chw = kernel.reshape(13, 13, 32, 64).transpose(2, 0, 1, 3).reshape(-1, 64)
    wrong = jax.tree.map(np.array, params)
    wrong["params"]["dense"]["kernel"] = chw
    model.load_state_dict(params_from_jax(wrong))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    right = np.asarray(j_bundle.predict(params, batch)["logits"])
    assert np.abs(t_bundle.predict(model, tb)["logits"].numpy() - right).max() > 1e-3


def _batches(n_steps, micro=4):
    data = mnist_batch(10, n_steps * micro)
    return list(Dataset.from_arrays(data).batch(micro))


def test_mnist_variant_02_streaming_trajectory_matches_jax(tmp_path):
    """Variant 02's config (K=2, Adam 1e-4, the quirk on) at micro-batch 4
    for 6 streaming steps: per-step losses within 1e-5, parameters 2e-6."""
    steps = 6
    j_bundle = jmnist.mnist_cnn_bundle()
    params = jax.device_get(j_bundle.init(jax.random.PRNGKey(0), mnist_batch(0, 1)))
    j_est = jest.Estimator(j_bundle, jopt.adam(1e-4),
                           jacc.GradAccumConfig(2, first_step_quirk=True),
                           jconfig.RunConfig(model_dir=str(tmp_path / "jax"),
                                             save_checkpoints_steps=None,
                                             log_step_count_steps=1000),
                           mode="streaming", warm_start=params)
    j_state = j_est.train(_batches(steps), max_steps=steps)

    base = tmnist.mnist_cnn_bundle()

    def init_from_jax(seed, device):
        model = base.init(seed, device)
        model.load_state_dict(params_from_jax(params))
        return model

    t_est = Estimator(base._replace(init=init_from_jax), topt.adam(1e-4),
                      tacc.GradAccumConfig(2, first_step_quirk=True),
                      RunConfig(model_dir=str(tmp_path / "port"), save_checkpoints_steps=None,
                                log_step_count_steps=1000), device="cpu")
    t_state = t_est.train(_batches(steps), max_steps=steps)
    assert t_state.step == int(j_state.step) == steps
    assert t_est.apply_steps == [0, 2, 4] and int(t_state.opt_state.t) == 3

    def rows(d):
        with open(d / "loss_vs_step.csv") as f:
            return [tuple(map(float, r.split(","))) for r in f.read().split()[1:]]

    got, want = rows(tmp_path / "port"), rows(tmp_path / "jax")
    np.testing.assert_array_equal([s for s, _ in got], [s for s, _ in want])
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5, atol=1e-5)
    got_p = dict(jtree.named_leaves(params_to_jax(t_state.params)))
    want_p = dict(jtree.named_leaves(jax.device_get(j_state.params)))
    for name in want_p:
        np.testing.assert_allclose(got_p[name], want_p[name], rtol=0, atol=2e-6, err_msg=name)


def test_housing_metrics_match_jax():
    j_bundle, t_bundle = jhousing.housing_mlp_bundle(), thousing.housing_mlp_bundle()
    batches = [housing_batch(s, n) for s, n in ((5, 8), (6, 3))]
    params, model = _carried(j_bundle, t_bundle, batches[0])
    for key in ("mae", "rmse"):
        j_metric, t_metric = j_bundle.eval_metrics[key], t_bundle.eval_metrics[key]
        jt = jc = tt = tc = 0.0
        for b in batches:
            total, count = j_metric.update(j_bundle.predict(params, b), b)
            jt, jc = jt + float(total), jc + float(count)
            tb = {k: torch.tensor(v) for k, v in b.items()}
            total, count = t_metric.update(t_bundle.predict(model, tb), tb)
            tt, tc = tt + total, tc + count
        assert tc == jc == 11
        np.testing.assert_allclose(t_metric.finalize(tt, tc),
                                   float(j_metric.finalize(np.float32(jt), np.float32(jc))),
                                   rtol=1e-5)
