"""The port's expert parallelism held against JAX, on gloo ranks.

One spawn of four gloo ranks on the CPU runs every multi-rank case (as
``tests/test_torch_parallel.py`` does); the tests hold what each rank saved
against JAX on the same numpy inputs:

- ``moe_apply`` with its expert leaves split by ``moe_ep_rules`` over
  ``expert=4``, and by ``bert_tp_ep_rules`` over ``model=2 x expert=2``,
  against JAX's ``moe_apply`` jitted on the same sharding of the virtual
  CPU devices (``tests/test_moe.py ::
  test_moe_expert_parallel_matches_single_device``): the output within
  rtol 1e-5, atol 1e-6, and the gradients of x, the router and the gathered
  expert leaves against JAX's single-device gradients;
- MoE-BERT (4 experts, top-2) through ``Estimator`` at tp=2 x ep=2
  (``bert_tp_ep_rules``) and at ep=2 (``moe_ep_rules``), dropout 0, from
  JAX's weights: losses within 1e-5 and the gathered parameters within
  rtol 2e-4, atol 2e-5 of JAX's GSPMD step on ``make_mesh(data=1, model=2,
  expert=2)``, and the dropped fraction of every layer exactly the
  single-process port's.

    python -m pytest -m torch tests/test_torch_ep.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

WORLD, E, T, D, H, TOP_K = 4, 4, 32, 16, 32, 2
K, B, S, UPDATES = 2, 4, 16, 3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
LR = 1e-3


def moe_inputs():
    rng = np.random.default_rng(17)
    params = {"router": rng.normal(size=(D, E)).astype(np.float32) / 4,
              "w_in": rng.normal(size=(E, D, H)).astype(np.float32) / 4,
              "b_in": rng.normal(size=(E, H)).astype(np.float32) / 10,
              "w_out": rng.normal(size=(E, H, D)).astype(np.float32) / 6,
              "b_out": rng.normal(size=(E, D)).astype(np.float32) / 10}
    x = rng.normal(size=(2, T // 2, D)).astype(np.float32)
    g = rng.normal(size=(2, T // 2, D)).astype(np.float32)
    return params, x, g


def host_batches(seed=5, n=UPDATES, rows=K * B):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 128, size=(rows, S)).astype(np.int32),
             "input_mask": np.ones((rows, S), np.int32),
             "segment_ids": np.zeros((rows, S), np.int32),
             "label": rng.integers(0, 2, size=(rows,)).astype(np.int32)} for _ in range(n)]


# --------------------------------------------------------------------------
# the ranks: python -m tests.test_torch_ep <outdir>
# --------------------------------------------------------------------------


def _moe_case(out, tag, mesh, rules):
    from gradaccum_tpu_torch.models.moe import ExpertShards, moe_apply
    from gradaccum_tpu_torch.parallel.sharding import gather_params, shard_params

    params, x, g = moe_inputs()
    named = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    local = {k: v.detach().clone().requires_grad_() for k, v in
             shard_params({k: v.detach() for k, v in named.items()}, mesh, rules).items()}
    axes = tuple(a for a in ("expert", "model") if a in mesh.shape)
    ep = ExpertShards(mesh.coords["expert"] * local["w_in"].shape[0], mesh.over(axes),
                      mesh.axis("model") if "model" in mesh.shape else None)
    tx = torch.tensor(x, requires_grad=True)
    mesh.reset_calls()
    y, aux = moe_apply(local, tx, top_k=TOP_K, ep=ep)
    (y * torch.tensor(g)).sum().backward()
    out[f"{tag}/calls"] = np.asarray(sorted(f"{k}={v}" for k, v in mesh.calls.items()))
    out[f"{tag}/y"] = y.detach().numpy()
    out[f"{tag}/dropped"] = aux["dropped_fraction"].numpy()
    out[f"{tag}/grad/x"] = tx.grad.numpy()
    grads = gather_params({k: v.grad for k, v in local.items()}, mesh, rules)
    for k, v in grads.items():
        out[f"{tag}/grad/{k}"] = v.numpy()


def _rank_cases(outdir):
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.models.moe import moe_ep_rules
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.ops import schedule as tsched
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.parallel.sharding import gather_params
    from gradaccum_tpu_torch.parallel.tp import bert_tp_ep_rules

    out = {}
    ep4 = mesh_lib.make_mesh(expert=4)
    _moe_case(out, "ep4", ep4, moe_ep_rules())
    tpep = mesh_lib.make_mesh(model=2, expert=2)
    _moe_case(out, "tp2ep2", tpep, bert_tp_ep_rules())

    warm = {k: torch.as_tensor(v) for k, v in np.load(os.path.join(outdir, "warm.npz")).items()}
    cfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0,
                                          num_experts=E, moe_top_k=TOP_K)

    def run(tag, mesh, rules):
        opt = topt.adamw(tsched.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                         weight_decay_rate=0.01)
        est = Estimator(tbert.bert_classifier_bundle(cfg, num_classes=2), opt,
                        tacc.GradAccumConfig(num_micro_batches=K, clip_norm=1.0,
                                             first_step_quirk=False),
                        RunConfig(seed=7, save_checkpoints_steps=None, log_step_count_steps=1000),
                        mode="scan", device="cpu", mesh=mesh, sharding_rules=rules,
                        warm_start=warm)
        for batch in host_batches():
            est.train([batch])
            out.setdefault(f"{tag}/loss", []).append(float(est.last_loss))
            out.setdefault(f"{tag}/dropped", []).append(
                [float(getattr(est.module.bert, f"layer_{i}").moe.last_aux["dropped_fraction"])
                 for i in range(cfg.num_layers)])
        params = est._state.params
        if rules:
            params = gather_params(params, mesh, rules)
        for name, p in params.items():
            out[f"{tag}/params/{name}"] = p.detach().numpy().copy()

    run("bert_tpep", mesh_lib.make_mesh(data=1, model=2, expert=2), bert_tp_ep_rules())
    # ep=2: two replicas side by side on an axis no rule or step reads
    run("bert_ep", mesh_lib.make_mesh(replica=2, expert=2), moe_ep_rules())
    run("bert_one", None, None)
    return {k: np.asarray(v) for k, v in out.items()}


def _rank_main(outdir):
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
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


def _jax_bert():
    import jax

    from gradaccum_tpu.models import bert as jbert

    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0,
                                          num_experts=E, moe_top_k=TOP_K)
    bundle = jbert.bert_classifier_bundle(cfg, num_classes=2)
    return bundle, bundle.init(jax.random.PRNGKey(0), host_batches()[0])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from gradaccum_tpu_torch.interop import params_from_jax
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.utils.tree import named_parameters

    outdir = tmp_path_factory.mktemp("ep_ranks")
    _, jparams = _jax_bert()
    module = tbert.bert_classifier_bundle(
        tbert.BertConfig.tiny_for_tests(num_experts=E, moe_top_k=TOP_K)).init(0, "cpu")
    module.load_state_dict(params_from_jax(jparams))
    np.savez(outdir / "warm.npz", **{name: p.detach().numpy()
                                     for name, p in named_parameters(module).items()})
    from test_torch_parallel import spawn_cases

    return spawn_cases("tests.test_torch_ep", outdir, world=WORLD, deadline_s=240), jparams


@pytest.mark.parametrize("tag", ["ep4", "tp2ep2"])
def test_expert_parallel_moe_apply_matches_jax_sharded(ranks, tag):
    import jax
    import jax.numpy as jnp

    from gradaccum_tpu.models.moe import moe_apply, moe_ep_rules
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.sharding import shard_params
    from gradaccum_tpu.parallel.tp import bert_tp_ep_rules

    out, _ = ranks
    params, x, g = moe_inputs()
    if tag == "ep4":
        mesh, rules = make_mesh(expert=4, devices=jax.devices()[:4]), moe_ep_rules()
    else:
        mesh = make_mesh(model=2, expert=2, devices=jax.devices()[:4])
        rules = bert_tp_ep_rules()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = jax.jit(lambda p, x: moe_apply(p, x, top_k=TOP_K))(shard_params(jp, mesh, rules), x)
    want_y, want_aux = want
    for r in range(WORLD):
        np.testing.assert_allclose(out[r][f"{tag}/y"], np.asarray(want_y), rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")
        assert float(out[r][f"{tag}/dropped"]) == float(want_aux["dropped_fraction"])

    def loss(p, x):
        return jnp.sum(moe_apply(p, x, top_k=TOP_K)[0] * g)

    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    for r in range(WORLD):
        np.testing.assert_allclose(out[r][f"{tag}/grad/x"], np.asarray(gx), rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r} x")
        for k in params:
            np.testing.assert_allclose(out[r][f"{tag}/grad/{k}"], np.asarray(gp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"rank {r} {k}")


def test_expert_region_sums_once_over_the_expert_and_model_group(ranks):
    """One forward and backward of the MoE layer: the combine's sum forward,
    and backward x's and the gates' ``copy_to`` sums, over the expert (x
    model) group; under ``bert_tp_ep_rules`` also b_out's ``copy_to`` over
    the model axis."""
    out, _ = ranks
    for r in range(WORLD):
        assert list(out[r]["ep4/calls"]) == sorted([
            "expert/all_reduce=3", "expert/all_reduce:copy_to=2",
            "expert/all_reduce:reduce_from=1"])
        assert list(out[r]["tp2ep2/calls"]) == sorted([
            "model+expert/all_reduce=3", "model+expert/all_reduce:copy_to=2",
            "model+expert/all_reduce:reduce_from=1", "model/all_reduce=1",
            "model/all_reduce:copy_to=1"])


@pytest.fixture(scope="module")
def jax_gspmd(ranks):
    """JAX's GSPMD step on ``make_mesh(data=1, model=2, expert=2)``: the
    losses and final parameters of three updates."""
    return _jax_gspmd(ranks[1])


def _jax_gspmd(jparams):
    import jax

    import gradaccum_tpu as gt
    from gradaccum_tpu.ops.accumulation import scan_init
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.sharding import device_put_batch, shard_params
    from gradaccum_tpu.parallel.tp import bert_tp_ep_rules

    bundle, _ = _jax_bert()
    opt = gt.ops.adamw(gt.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                       weight_decay_rate=0.01)
    accum = gt.GradAccumConfig(num_micro_batches=K, clip_norm=1.0)
    mesh = make_mesh(data=1, model=2, expert=2, devices=jax.devices()[:4])
    step = jax.jit(gt.accumulate_scan(bundle.loss, opt, accum, needs_rng=True))
    state = shard_params(scan_init(jparams, opt), mesh, bert_tp_ep_rules())
    losses = []
    for i, b in enumerate(host_batches()):
        batch = device_put_batch(gt.stack_micro_batches(b, K), mesh, leading_unsharded=1)
        state, aux = step(state, batch, jax.random.PRNGKey(100 + i))
        losses.append(float(jax.device_get(aux["loss"])))
    return losses, jax.device_get(state.params)


@pytest.mark.parametrize("tag", ["bert_tpep", "bert_ep"])
def test_moe_bert_under_rules_matches_jax_and_one_process(ranks, jax_gspmd, tag):
    from gradaccum_tpu.utils.tree import named_leaves

    from gradaccum_tpu_torch.interop import params_to_jax

    out, _ = ranks
    losses, params = jax_gspmd
    want = dict(named_leaves({"params": params["params"]}))
    for r in range(WORLD):
        np.testing.assert_allclose(out[r][f"{tag}/loss"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[r][f"{tag}/loss"], out[r]["bert_one/loss"],
                                   rtol=LOSS_RTOL)
        # the routing is the whole bank's on every rank: drops are exact
        np.testing.assert_array_equal(out[r][f"{tag}/dropped"], out[r]["bert_one/dropped"])
        got = {k[len(tag) + 8:]: torch.as_tensor(out[r][k]) for k in out[r]
               if k.startswith(f"{tag}/params/")}
        got = dict(named_leaves(params_to_jax(got)))
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], np.asarray(want[name]), err_msg=name,
                                       **PARAM_TOL)
