"""The port's sequence parallelism held against JAX and the one-process step.

One spawn of four gloo ranks on the CPU (``examples/common.py ::
spawn_ranks``, with a deadline) runs every multi-rank case; each rank
saves what it saw, and the tests hold it against JAX (on the virtual CPU
devices of ``tests/conftest.py``) and against the port's own one-process
step on the same numpy inputs. Two meshes: data=2 × seq=2 and data=1 ×
seq=4.

- ``ring_attention`` and ``ulysses_attention`` at 2 and 4 seq ranks
  against JAX's ring under ``shard_map`` (forward and q/k/v gradients) and
  against the port's dense attention: forward within 1e-5, gradients within
  1e-4;
- BERT with ``seq_axis`` (ring) forward against JAX's seq-sharded forward
  at 2 and 4 seq ranks, within 1e-5;
- the dp × sp step (``make_dp_sp_train_step``, scan mode) at dp=2 × sp=2
  (ring and Ulysses) and sp=4, and with ``zero1``, against the port's
  one-process scan step from the same carried JAX parameters, three
  updates: losses and parameters within rtol 2e-4, atol 2e-5. JAX's own
  SP step fails on this JAX (``gradaccum_tpu/ops/accumulation.py:431``);
- the head's gradient at sp=2 (SGD at lr 1, no clip: the update is the
  gradient) equals one process's: a step that summed it over ``seq`` would
  double it;
- a NaN seen by one seq rank only skips that micro-batch on every rank,
  and the update equals the one-process guarded step's;
- the collectives per update equal the design's count (PERF.md);
- ``Estimator`` on a data × seq mesh (dense twin as ``eval_model``)
  against the one-process Estimator;
- the ``bert_finetune --sp`` parser errors against JAX's, word for word.

    python -m pytest -m torch tests/test_torch_sp.py
"""

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

WORLD = 4
K, B, S = 2, 4, 16  # micro-batches, global rows per micro-batch, global tokens
AB, AH, AD = 2, 4, 8  # attention inputs [AB, AH, S, AD]
LR = 1e-3
UPDATES = 3
NAN_ROW, NAN_COL = 1 * B + 2, S - 1  # micro-batch 1, a token of the last seq rank
MESHES = {"sp2": dict(data=2, seq=2), "sp4": dict(data=1, seq=4)}
STEPS = {  # tag: (mesh, core, zero1)
    "dp2sp2_ring": ("sp2", "ring", False),
    "dp2sp2_ulysses": ("sp2", "ulysses", False),
    "sp4_ring": ("sp4", "ring", False),
    "dp2sp2_zero1": ("sp2", "ring", True),
}


def attention_inputs():
    rng = np.random.default_rng(11)
    q, k, v, w = (rng.normal(size=(AB, AH, S, AD)).astype(np.float32) for _ in range(4))
    keep = np.ones((AB, S), np.float32)
    keep[1, S - 3:] = 0
    mask = ((1.0 - keep[:, None, None, :]) * -1e9).astype(np.float32)
    return q, k, v, mask, w


def bert_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((K * B, S), np.int32)
    mask[1, S - 3:] = 0  # a padded tail in one example
    return {"input_ids": rng.integers(0, 128, size=(K * B, S)).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((K * B, S), np.int32),
            "label": rng.integers(0, 2, size=(K * B,)).astype(np.int32)}


def batches():
    return [bert_batch(30 + u) for u in range(UPDATES)]


def poisoned():
    """A float column the loss adds times 0: NaN at one token of one row of
    micro-batch 1, which only the last seq rank holds."""
    batch = bert_batch(40)
    poison = np.zeros((K * B, S), np.float32)
    poison[NAN_ROW, NAN_COL] = np.nan
    return dict(batch, poison=poison)


# --------------------------------------------------------------------------
# the ranks: python -m tests.test_torch_sp <outdir>
# --------------------------------------------------------------------------


def _cfg(tbert):
    return tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _rank_cases(outdir):
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.ops import schedule as tsched
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.parallel import zero
    from gradaccum_tpu_torch.parallel.ring_attention import (
        SEQ_BATCH_KEYS,
        make_ring_attention_fn,
        ring_attention,
        shard_seq_batch,
    )
    from gradaccum_tpu_torch.parallel.sp import make_dp_sp_train_step
    from gradaccum_tpu_torch.parallel.ulysses import make_ulysses_attention_fn, ulysses_attention
    from gradaccum_tpu_torch.utils.tree import named_parameters

    out = {}
    warm = {k: torch.as_tensor(v) for k, v in np.load(os.path.join(outdir, "warm.npz")).items()}
    cfg = _cfg(tbert)
    cores = {"ring": make_ring_attention_fn("seq"), "ulysses": make_ulysses_attention_fn("seq")}

    def model(core):
        bundle = tbert.bert_classifier_bundle(cfg, num_classes=2, attention_fn=cores[core],
                                              seq_axis="seq")
        module = bundle.init(0, "cpu")
        with torch.no_grad():
            for name, p in named_parameters(module).items():
                p.copy_(warm[name])
        return bundle, module

    def adamw():
        return topt.adamw(tsched.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                          weight_decay_rate=0.01)

    def record_params(tag, params):
        for name, p in params.items():
            out[f"{tag}/param/{name}"] = p.detach().numpy().copy()

    meshes = {tag: mesh_lib.make_mesh(**axes) for tag, axes in MESHES.items()}
    for tag, mesh in meshes.items():
        mesh_lib.bind_mesh(mesh)
        seq = mesh.axis("seq")
        size = S // seq.world
        local = slice(seq.rank * size, (seq.rank + 1) * size)
        q, k, v, mask, w = (torch.as_tensor(a) for a in attention_inputs())
        for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            qs, ks, vs = (t[:, :, local].clone().requires_grad_() for t in (q, k, v))
            o = fn(qs, ks, vs, mask[..., local], axis="seq")
            (o * w[:, :, local]).sum().backward()
            for key, t in (("o", o), ("dq", qs.grad), ("dk", ks.grad), ("dv", vs.grad)):
                out[f"{tag}/{name}/{key}"] = t.detach().numpy().copy()
        # the seq-aware BERT forward on this rank's token block
        bundle, module = model("ring")
        local_batch = shard_seq_batch(_t(bert_batch(30)), mesh)
        out[f"{tag}/logits"] = bundle.predict(module, local_batch)["logits"].numpy().copy()

    for tag, (mesh_tag, core, zero1) in STEPS.items():
        mesh = mesh_lib.bind_mesh(meshes[mesh_tag])
        bundle, module = model(core)
        opt = adamw()
        step = make_dp_sp_train_step(
            lambda p, b, m=module, bn=bundle: bn.loss(m, b), opt,
            tacc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False), mesh,
            needs_rng=True, zero1=zero1)
        state = tacc.scan_init(named_parameters(module), opt)
        if zero1:
            state = zero.zero1_shard_state(state, mesh.axis("data"))
        for u, batch in enumerate(batches()):
            mesh.reset_calls()
            state, aux = step(state, tacc.stack_micro_batches(_t(batch), K), torch.Generator())
            out.setdefault(f"{tag}/loss", []).append(float(aux["loss"]))
            if u == 0:
                for key, n in mesh.calls.items():
                    out[f"{tag}/calls/{key}"] = n
        record_params(tag, state.params)

    # the head's gradient: SGD at lr 1 and no clip, one update
    mesh_lib.bind_mesh(meshes["sp2"])
    bundle, module = model("ring")
    opt = topt.sgd(1.0)
    step = make_dp_sp_train_step(lambda p, b: bundle.loss(module, b), opt,
                                 tacc.GradAccumConfig(K, first_step_quirk=False),
                                 meshes["sp2"], needs_rng=True)
    state, _ = step(tacc.scan_init(named_parameters(module), opt),
                    tacc.stack_micro_batches(_t(bert_batch(30)), K), torch.Generator())
    record_params("sgd", state.params)

    # a NaN on one seq rank: skipped on all of them
    for tag in ("sp4", "sp2"):
        mesh_lib.bind_mesh(meshes[tag])
        bundle, module = model("ring")
        opt = adamw()
        cfg_guard = tacc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False,
                                         skip_nonfinite=True)
        step = make_dp_sp_train_step(
            lambda p, b, m=module, bn=bundle: bn.loss(m, b) + b["poison"].sum() * 0,
            opt, cfg_guard, meshes[tag], needs_rng=True,
            seq_keys=SEQ_BATCH_KEYS + ("poison",))
        state, aux = step(tacc.scan_init(named_parameters(module), opt),
                          tacc.stack_micro_batches(_t(poisoned()), K), torch.Generator())
        out[f"nan_{tag}/skipped"] = int(aux["skipped"])
        out[f"nan_{tag}/good_count"] = int(aux["good_count"])
        out[f"nan_{tag}/loss"] = float(aux["loss"])
        record_params(f"nan_{tag}", state.params)

    # the Estimator on the data x seq mesh, the dense twin evaluating
    mesh = mesh_lib.bind_mesh(meshes["sp2"])
    est = Estimator(
        tbert.bert_classifier_bundle(cfg, num_classes=2, attention_fn=cores["ring"],
                                     seq_axis="seq"),
        adamw(), tacc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False),
        RunConfig(seed=7, save_checkpoints_steps=None, log_step_count_steps=1000),
        mode="scan", device="cpu", mesh=mesh, warm_start=warm,
        eval_model=tbert.bert_classifier_bundle(cfg, num_classes=2))
    for batch in batches():
        est.train([batch])
        out.setdefault("estimator/loss", []).append(float(est.last_loss))
    out["estimator/accuracy"] = est.evaluate([bert_batch(50)])["accuracy"]
    record_params("estimator", est._state.params)
    return out


def _rank_main(outdir):
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    os.environ["GRADACCUM_EVENTS"] = "0"
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


def _jax_params():
    import jax

    from gradaccum_tpu.models import bert as jbert

    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    return jbert.bert_classifier_bundle(cfg, num_classes=2).init(jax.random.PRNGKey(0),
                                                                 bert_batch(30))


def _port_module(jparams):
    from gradaccum_tpu_torch.interop import params_from_jax
    from gradaccum_tpu_torch.models import bert as tbert

    module = tbert.bert_classifier_bundle(_cfg(tbert)).init(0, "cpu")
    module.load_state_dict(params_from_jax(jparams))
    return module


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from gradaccum_tpu_torch.utils.tree import named_parameters

    outdir = tmp_path_factory.mktemp("sp_ranks")
    jparams = _jax_params()
    np.savez(outdir / "warm.npz", **{name: p.detach().numpy() for name, p in
                                     named_parameters(_port_module(jparams)).items()})
    from test_torch_parallel import spawn_cases

    return spawn_cases("tests.test_torch_sp", outdir, world=WORLD, deadline_s=240), jparams


def _coords(tag, r):
    axes = MESHES[tag]
    data, seq = np.unravel_index(r, (axes["data"], axes["seq"]))
    return int(data), int(seq), axes["seq"]


def _jax_ring(n):
    """JAX's ring attention under shard_map on ``n`` devices: the output
    and the q/k/v gradients of sum(o * w)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.ring_attention import ring_attention
    from gradaccum_tpu.utils import compat

    q, k, v, mask, w = (jnp.asarray(a) for a in attention_inputs())
    mesh = make_mesh(seq=n, devices=jax.devices()[:n])
    seq = P(None, None, "seq")
    ring = compat.shard_map(lambda *a: ring_attention(*a, axis="seq"), mesh=mesh,
                            in_specs=(seq, seq, seq, P(None, None, None, "seq")),
                            out_specs=seq)
    o = jax.jit(ring)(q, k, v, mask)
    grads = jax.jit(jax.grad(lambda q_, k_, v_: jnp.sum(ring(q_, k_, v_, mask) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return {"o": np.asarray(o), **{n_: np.asarray(g) for n_, g in zip(("dq", "dk", "dv"), grads)}}


def _port_dense():
    from gradaccum_tpu_torch.models.bert import dense_attention

    q, k, v, mask, w = (torch.as_tensor(a) for a in attention_inputs())
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = dense_attention(q, k, v, mask)
    (o * w).sum().backward()
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("core", ["ring", "ulysses"])
def test_attention_cores_match_jax_ring_and_dense(ranks, tag, core):
    out, _ = ranks
    _, _, n = _coords(tag, 0)
    want_jax, want_dense = _jax_ring(n), _port_dense()
    for r in range(WORLD):
        _, s, n = _coords(tag, r)
        size = S // n
        for key in ("o", "dq", "dk", "dv"):
            got = out[r][f"{tag}/{core}/{key}"]
            tol = 1e-5 if key == "o" else 1e-4
            for want in (want_jax[key], want_dense[key]):
                np.testing.assert_allclose(got, want[:, :, s * size:(s + 1) * size],
                                           rtol=tol, atol=tol, err_msg=f"{tag} {core} {key}")


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_bert_seq_forward_matches_jax(ranks, tag):
    """The seq-sharded BERT forward against JAX's (``test_sp_forward_matches_dense``)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.ring_attention import make_ring_attention_fn
    from gradaccum_tpu.utils import compat

    out, jparams = ranks
    n = MESHES[tag]["seq"]
    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    bundle = jbert.bert_classifier_bundle(cfg, num_classes=2,
                                          attention_fn=make_ring_attention_fn("seq"),
                                          seq_axis="seq")
    spec = {"input_ids": P(None, "seq"), "input_mask": P(None, "seq"),
            "segment_ids": P(None, "seq"), "label": P()}
    predict = jax.jit(compat.shard_map(lambda p, b: bundle.predict(p, b)["logits"],
                                       mesh=make_mesh(seq=n, devices=jax.devices()[:n]),
                                       in_specs=(P(), spec), out_specs=P()))
    want = np.asarray(predict(jparams, bert_batch(30)))
    for r in range(WORLD):
        np.testing.assert_allclose(out[r][f"{tag}/logits"], want, rtol=1e-5, atol=1e-5)


def _one_process(jparams, data, opt=None, clip=1.0, loss_extra=False, skip=False):
    """The port's one-process scan step from the carried parameters: the
    losses of each update and the final parameters."""
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.ops import schedule as tsched
    from gradaccum_tpu_torch.utils.tree import named_parameters

    bundle = tbert.bert_classifier_bundle(_cfg(tbert), num_classes=2)
    module = _port_module(jparams)
    opt = opt or topt.adamw(tsched.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                            weight_decay_rate=0.01)

    def loss(p, b):
        value = bundle.loss(module, b)
        return value + b["poison"].sum() * 0 if loss_extra else value

    step = tacc.accumulate_scan(loss, opt, tacc.GradAccumConfig(
        K, clip_norm=clip, first_step_quirk=False, skip_nonfinite=skip), needs_rng=True)
    state = tacc.scan_init(named_parameters(module), opt)
    losses, auxes = [], []
    for batch in data:
        state, aux = step(state, tacc.stack_micro_batches(_t(batch), K), torch.Generator())
        losses.append(float(aux["loss"]))
        auxes.append(aux)
    return losses, {k: v.detach().numpy() for k, v in state.params.items()}, auxes


def _check_params(out, tag, want, rtol=2e-4, atol=2e-5):
    for r in range(WORLD):
        for name, w in want.items():
            np.testing.assert_allclose(out[r][f"{tag}/param/{name}"], w, rtol=rtol, atol=atol,
                                       err_msg=f"{tag} rank {r} {name}")


@pytest.mark.parametrize("tag", sorted(STEPS))
def test_dp_sp_step_matches_the_one_process_step(ranks, tag):
    out, jparams = ranks
    want_losses, want, _ = _one_process(jparams, batches())
    for r in range(WORLD):
        np.testing.assert_allclose(out[r][f"{tag}/loss"], want_losses, rtol=2e-4, atol=2e-5)
    _check_params(out, tag, want)


def test_head_gradient_at_sp2_equals_one_process(ranks):
    """SGD at lr 1 without clipping: each parameter moves by its averaged
    gradient. The pooler and classifier (after the summed readout) must
    move as in one process, not twice as far."""
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.utils.tree import named_parameters

    out, jparams = ranks
    init = {k: v.detach().numpy() for k, v in named_parameters(_port_module(jparams)).items()}
    _, want, _ = _one_process(jparams, [bert_batch(30)], opt=topt.sgd(1.0), clip=None)
    head = [name for name in want if name.startswith(("params/pooler", "params/classifier"))]
    assert head
    for r in range(WORLD):
        for name in head:
            got = init[name] - out[r][f"sgd/param/{name}"]
            np.testing.assert_allclose(got, init[name] - want[name], rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} {name}")
    _check_params(out, "sgd", want, rtol=1e-5, atol=1e-6)


def test_nan_on_one_seq_rank_skips_the_micro_batch_everywhere(ranks):
    out, jparams = ranks
    losses, want, auxes = _one_process(jparams, [poisoned()], loss_extra=True, skip=True)
    assert int(auxes[0]["skipped"]) == 1
    for r in range(WORLD):
        # sp4: data=1, so the micro-batch is skipped whole; sp2: the data
        # shard holding the row skips it, the other keeps its rows (JAX's
        # data shards keep their own verdicts): 1 of K x 2
        assert out[r]["nan_sp4/skipped"] == 1 and out[r]["nan_sp4/good_count"] == K - 1
        assert out[r]["nan_sp2/skipped"] == 1 and out[r]["nan_sp2/good_count"] == 2 * K - 1
        np.testing.assert_allclose(out[r]["nan_sp4/loss"], losses[0], rtol=2e-4)
        for name in want:
            np.testing.assert_array_equal(out[r][f"nan_sp2/param/{name}"],
                                          out[0][f"nan_sp2/param/{name}"])
    _check_params(out, "nan_sp4", want)


def test_collectives_per_update_equal_the_design(ranks):
    """Per update (K=2 micro-batches, L=2 layers): ring, one ppermute per
    hop per layer forward and one back, (n-1)·2·L per micro-batch; Ulysses
    two all-to-alls forward and two back and one mask all-gather per layer;
    the readout's sum once per micro-batch; ONE gradient all-reduce over
    data and seq together (with ZeRO-1 one parameter all-gather over data)."""
    out, _ = ranks
    L = 2
    want = {
        "dp2sp2_ring": {"seq/ppermute": K * 2 * L * 1, "seq/all_reduce": K,
                        "data+seq/all_reduce": 1},
        "dp2sp2_ulysses": {"seq/all_to_all": K * 4 * L, "seq/all_gather": K * L,
                           "seq/all_reduce": K, "data+seq/all_reduce": 1},
        # data=1: the gradient's one all-reduce runs over seq alone
        "sp4_ring": {"seq/ppermute": K * 2 * L * 3, "seq/all_reduce": K + 1},
        "dp2sp2_zero1": {"seq/ppermute": K * 2 * L, "seq/all_reduce": K,
                         "data+seq/all_reduce": 1, "data/all_gather": 1},
    }
    for tag, calls in want.items():
        for r in range(WORLD):
            got = {k[len(f"{tag}/calls/"):]: int(v) for k, v in out[r].items()
                   if k.startswith(f"{tag}/calls/") and ":" not in k[len(f"{tag}/calls/"):]}
            assert got == calls, (tag, r, got)


def test_estimator_on_a_seq_mesh_matches_one_process(ranks):
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.ops import schedule as tsched

    from gradaccum_tpu_torch.utils.tree import named_parameters

    out, jparams = ranks
    warm = {k: v.detach() for k, v in named_parameters(_port_module(jparams)).items()}
    est = Estimator(tbert.bert_classifier_bundle(_cfg(tbert), num_classes=2),
                    topt.adamw(tsched.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                               weight_decay_rate=0.01),
                    tacc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False),
                    RunConfig(seed=7, save_checkpoints_steps=None, log_step_count_steps=1000),
                    mode="scan", device="cpu", warm_start=warm)
    losses = []
    for batch in batches():
        est.train([batch])
        losses.append(float(est.last_loss))
    accuracy = est.evaluate([bert_batch(50)])["accuracy"]
    want = {k: v.detach().numpy() for k, v in est._state.params.items()}
    for r in range(WORLD):
        np.testing.assert_allclose(out[r]["estimator/loss"], losses, rtol=2e-4, atol=2e-5)
        assert float(out[r]["estimator/accuracy"]) == accuracy
    _check_params(out, "estimator", want)


def test_estimator_refuses_seq_with_streaming_rules_sparse_and_fused():
    """JAX's refusals, word for word (checked before any mesh is used)."""
    import gradaccum_tpu as gt
    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt

    class Fake:  # a mesh's shape is all the checks read
        def __init__(self, **axes):
            self.shape = axes

    def errors(pkg_est, bundle, opt, acc_cfg, mesh, **kw):
        try:
            pkg_est(bundle, opt, acc_cfg, mesh=mesh, **kw)
        except ValueError as e:
            return str(e)
        return None

    jb = jbert.bert_classifier_bundle(jbert.BertConfig.tiny_for_tests())
    tb = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests())
    cases = [dict(mode="streaming"), dict(mode="scan", sharding_rules=()),
             dict(mode="scan", sparse_embed=True),
             dict(mode="scan", fused=True)]
    for case in cases:
        case = dict(case)
        fused = case.pop("fused", False)
        jcfg = gt.GradAccumConfig(2, fused_adam=fused)
        tcfg = tacc.GradAccumConfig(2, fused_adam=fused)
        want = errors(gt.Estimator, jb, gt.ops.adamw(1e-3), jcfg, Fake(data=1, seq=2), **case)
        got = errors(lambda *a, mesh, **kw: Estimator(*a, mesh=mesh, device="cpu", **kw),
                     tb, topt.adamw(1e-3), tcfg, Fake(data=1, seq=2), **case)
        assert want is not None and got == want, (case, got, want)


REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("argv", [
    ["--sp", "0"],
    ["--sp", "2", "--tp", "2"],
    ["--sp", "2", "--mode", "streaming"],
    ["--sp", "3", "--seq-len", "32"],
    ["--zero1", "--dp", "2", "--sp", "2"],
    ["--sparse-embed-grad", "--sp", "2"],
], ids=["sp-0", "sp-with-tp", "sp-streaming", "seq-not-divisible", "sp-zero1",
        "sp-sparse-embed"])
def test_sp_parser_errors_match_jax(argv, tmp_path, capsys):
    from gradaccum_tpu_torch.examples import bert_finetune as tbf

    sys.path.insert(0, str(REPO))
    jbf = importlib.import_module("examples.bert_finetune")
    with pytest.raises(SystemExit):
        jbf.main([*argv, "--model-dir", str(tmp_path / "jax")])
    want = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    with pytest.raises(SystemExit):
        tbf.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1] == want


def test_bundle_refuses_dropout_with_seq_axis_as_jax():
    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu_torch.models import bert as tbert

    with pytest.raises(ValueError) as want:
        jbert.bert_classifier_bundle(jbert.BertConfig.tiny_for_tests(), seq_axis="seq")
    with pytest.raises(ValueError) as got:
        tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests(), seq_axis="seq")
    assert str(got.value) == str(want.value)


def test_ulysses_refuses_heads_the_axis_does_not_divide_as_jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
    from gradaccum_tpu.utils import compat
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib
    from gradaccum_tpu_torch.parallel.ulysses import ulysses_attention

    x = np.zeros((1, 3, 8, 4), np.float32)
    seq = P(None, None, "seq")
    with pytest.raises(ValueError) as want:
        compat.shard_map(lambda a: jax_ulysses(a, a, a, axis="seq"),
                         mesh=make_mesh(seq=2, devices=jax.devices()[:2]),
                         in_specs=(seq,), out_specs=seq)(jnp.asarray(x))
    # a two-rank seq axis in one process: the check comes before any collective
    fake = mesh_lib.DataMesh(0, 2, torch.device("cpu"), "gloo", axis="seq")
    mesh_lib._BOUND["seq"] = fake
    try:
        with pytest.raises(ValueError) as got:
            t = torch.as_tensor(x[:, :, :4])
            ulysses_attention(t, t, t, axis="seq")
    finally:
        mesh_lib._BOUND.pop("seq", None)
    assert str(got.value) == str(want.value)



def test_estimator_on_a_seq_mesh_needs_the_dense_twin_to_evaluate():
    """Evaluation runs whole sequences: a sequence-parallel model without
    its dense twin as ``eval_model`` is refused, not run on the wrong
    layout."""
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.parallel.ring_attention import make_ring_attention_fn

    class Fake:  # what the Estimator reads of a mesh before evaluating
        shape = {"data": 1, "seq": 2}
        device = torch.device("cpu")
        rank = 0

        def axis(self, name):
            return None

    bundle = tbert.bert_classifier_bundle(_cfg(tbert), attention_fn=make_ring_attention_fn(),
                                          seq_axis="seq")
    est = Estimator(bundle, topt.adamw(1e-3), tacc.GradAccumConfig(K, first_step_quirk=False),
                    mode="scan", device="cpu", mesh=Fake())
    with pytest.raises(ValueError, match="dense twin as eval_model"):
        est.evaluate([bert_batch(50)])
