"""The port's data parallelism held against the JAX package, on gloo ranks.

One spawn of two gloo ranks on the CPU (``examples/common.py ::
spawn_ranks``, with a deadline) runs every multi-rank case of this file;
each rank saves what it saw, and the tests hold it against JAX on the same
numpy inputs. The linear model of ``tests/test_parallel.py`` (K=2, 4 rows
per rank):

- scan DP (``make_dp_train_step``) against JAX's ``make_pjit_dp_train_step``
  at N = 2 on the virtual CPU devices and against single-device JAX on the
  global batch: three updates, parameters within 2e-6 at each; exactly ONE
  gradient all-reduce per update, and none other;
- the port's GSPMD counterpart (``make_pjit_dp_train_step``) against JAX's;
- streaming DP against JAX's ``make_dp_train_step(mode="streaming")``: one
  gradient all-reduce per micro-batch, parameters within 2e-6 per call;
- the guard with a NaN in one rank's rows: scan mode skips that rank's
  micro-batch alone (skipped 1, good 3 of K·N = 4, as JAX's summed
  ``n_good``; parameters against JAX's single-device step over the same
  four local micro-batches), streaming mode skips it on both ranks (the
  pmin'd verdict; skip counts and parameters against JAX's streaming DP);
- ``cross_shard_optimizer``, mean and sum, and its error against JAX's;
- sparse embedding gradients under DP on JAX's ``test_sparse_with_dp_axis``
  setup (tiny BERT, K=4, 1 row per rank, dropout 0): sparse DP against dense
  DP and against JAX's single-device dense step on the global batch.

Without a spawn: ``host_shard`` and ``shard_dim`` against JAX's functions,
``batch_shard`` against JAX's batch sharding, and the unbound axis name.

    python -m pytest -m torch tests/test_torch_parallel.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

K, B, N, UPDATES = 2, 4, 2, 3
PARAM_ATOL = 2e-6
LR = 1e-2
NAN_ROW = N * B - 1  # a row of rank 1's block
SP_K, SP_MICRO, SP_SEQ = 4, 2, 16  # JAX's test_sparse_with_dp_axis


def make_params(rng):
    return {"w": rng.normal(size=(3, 1)).astype(np.float32),
            "bias": np.zeros((1,), np.float32)}


def make_data(rng, n):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (x @ np.asarray([[1.0], [-2.0], [0.5]], np.float32)).astype(np.float32)
    return {"x": x, "y": y}


def inputs():
    """The params and the global host batches every case trains on."""
    rng = np.random.default_rng(19830610)
    params = make_params(rng)
    bigs = [make_data(rng, K * N * B) for _ in range(UPDATES)]
    return params, bigs


def poisoned(bigs):
    """The batches with a NaN in one row of rank 1's block of micro-batch 0
    of the first update (the first micro call in streaming mode)."""
    out = [{k: v.copy() for k, v in big.items()} for big in bigs]
    out[0]["x"][NAN_ROW] = np.nan
    return out


def sparse_batch():
    rng = np.random.default_rng(115)
    vocab = 128
    return {"input_ids": rng.integers(0, vocab, size=(SP_K * SP_MICRO, SP_SEQ)).astype(np.int32),
            "input_mask": np.ones((SP_K * SP_MICRO, SP_SEQ), np.int32),
            "segment_ids": np.zeros((SP_K * SP_MICRO, SP_SEQ), np.int32),
            "label": rng.integers(0, 2, size=(SP_K * SP_MICRO,)).astype(np.int32)}


# --------------------------------------------------------------------------
# the ranks: python -m tests.test_torch_parallel <outdir>
# --------------------------------------------------------------------------


def _t_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["bias"]
    return torch.mean((pred - batch["y"]) ** 2)


def _t_params(p):
    return {k: torch.tensor(p[k], requires_grad=True) for k in sorted(p)}


def _t_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _rank_cases(mesh, outdir):
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.ops import schedule as tsched
    from gradaccum_tpu_torch.parallel import cross_shard_optimizer, dp
    from gradaccum_tpu_torch.utils.tree import named_parameters

    params, bigs = inputs()
    out = {}

    def opt():
        return topt.adamw(tsched.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                          weight_decay_rate=0.01)

    def record(prefix, state, aux, calls):
        for name, p in state.params.items():
            out.setdefault(f"{prefix}/{name}", []).append(p.detach().numpy().copy())
        for key in ("loss", "skipped", "good_count"):
            if key in aux:
                out.setdefault(f"{prefix}/{key}", []).append(float(aux[key]))
        for key in ("all_reduce", "all_reduce:grads", "pmin"):
            out.setdefault(f"{prefix}/calls/{key}", []).append(calls.get(key, 0))

    def scan_run(prefix, builder, cfg, batches, optimizer):
        step = builder(_t_loss, optimizer, cfg, mesh, mode="scan")
        state = tacc.scan_init(_t_params(params), optimizer)
        for big in batches:
            mesh.reset_calls()
            state, aux = step(state, tacc.stack_micro_batches(_t_batch(big), K))
            record(prefix, state, aux, dict(mesh.calls))

    def stream_run(prefix, cfg, batches, o=None):
        o = o or opt()
        step = dp.make_dp_train_step(_t_loss, o, cfg, mesh, mode="streaming")
        state = tacc.streaming_init(_t_params(params), o)
        for big in batches:
            for i in range(K):
                mesh.reset_calls()
                micro = {k: v[i * N * B:(i + 1) * N * B] for k, v in big.items()}
                state, aux = step(state, _t_batch(micro))
                record(prefix, state, aux, dict(mesh.calls))

    cfg = tacc.GradAccumConfig(num_micro_batches=K, clip_norm=1.0)
    scan_run("scan_dp", dp.make_dp_train_step, cfg, bigs, opt())
    scan_run("scan_pjit", dp.make_pjit_dp_train_step, cfg, bigs, opt())
    stream_run("stream_dp", cfg, bigs)
    guard = tacc.GradAccumConfig(num_micro_batches=K, clip_norm=1.0, skip_nonfinite=True)
    scan_run("scan_guard", dp.make_dp_train_step, guard, poisoned(bigs),
             topt.adamw(LR, weight_decay_rate=0.01))
    stream_run("stream_guard", guard, poisoned(bigs))
    # SGD without clipping: the update reads the gradient's scale (the
    # denominator K·N, the streaming 1/N, the good count)
    plain = tacc.GradAccumConfig(num_micro_batches=K)
    scan_run("sgd_scan", dp.make_dp_train_step, plain, bigs, topt.sgd(LR))
    scan_run("sgd_pjit", dp.make_pjit_dp_train_step, plain, bigs, topt.sgd(LR))
    stream_run("sgd_streaming", plain, bigs, topt.sgd(LR))
    by_good = tacc.GradAccumConfig(num_micro_batches=K, skip_nonfinite=True,
                                   normalize_by_good_count=True)
    scan_run("sgd_good_scan", dp.make_dp_train_step, by_good, poisoned(bigs), topt.sgd(LR))
    stream_run("sgd_good_streaming", by_good, poisoned(bigs), topt.sgd(LR))

    # cross_shard_optimizer: rank-dependent gradients through SGD at rate 1
    for reduction in ("mean", "sum"):
        p = {"w": torch.zeros(3)}
        g = {"w": torch.arange(3, dtype=torch.float32) * (mesh.rank + 1)}
        o = cross_shard_optimizer(topt.sgd(1.0), "data", reduction=reduction)
        o.update(g, o.init(p), p, 0)
        out[f"cross_shard/{reduction}"] = [p["w"].numpy().copy()]

    # sparse embedding gradients: JAX's test_sparse_with_dp_axis setup, dropout 0
    cfg_b = tbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    bundle = tbert.bert_classifier_bundle(cfg_b, num_classes=2)
    init = torch.load(os.path.join(outdir, "bert_init.pt"))
    accfg = tacc.GradAccumConfig(num_micro_batches=SP_K, clip_norm=1.0)
    stacked = tacc.stack_micro_batches(_t_batch(sparse_batch()), SP_K)
    for sparse in (False, True):
        model = bundle.init(0, "cpu")
        model.load_state_dict(init)
        named = named_parameters(model)
        o = topt.adamw(tsched.warmup_polynomial_decay(2e-5, 100, 10), weight_decay_rate=0.01)
        if sparse:
            hooks = bundle.sparse_embed._replace(
                loss_with_rows=lambda p, rows, b, m=model:
                bundle.sparse_embed.loss_with_rows(m, rows, b))
            from gradaccum_tpu_torch.ops.sparse_embed import accumulate_scan_sparse_embed

            step = dp.make_dp_train_step(None, o, accfg, mesh, needs_rng=True,
                                         inner_builder=lambda c, h=hooks, oo=o:
                                         accumulate_scan_sparse_embed(h, oo, c))
        else:
            step = dp.make_dp_train_step(lambda p, b, m=model: bundle.loss(m, b), o, accfg,
                                         mesh, needs_rng=True)
        g = torch.Generator().manual_seed(11)
        state, aux = step(tacc.scan_init(named, o), stacked, g)
        tag = "sparse" if sparse else "dense"
        out[f"bert_{tag}/loss"] = [float(aux["loss"])]
        for name, p in state.params.items():
            out[f"bert_{tag}/{name}"] = [p.detach().numpy().copy()]
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


def _rank_main(outdir):
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    mesh_lib.initialize_multihost(device="cpu", timeout_s=60)
    try:
        mesh = mesh_lib.data_parallel_mesh()
        results = _rank_cases(mesh, outdir)
        np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), **results)
        rank = mesh.rank
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))


if __name__ == "__main__":
    _rank_main(sys.argv[1])


# --------------------------------------------------------------------------
# the tests (JAX on the virtual CPU devices of tests/conftest.py)
# --------------------------------------------------------------------------


def spawn_cases(module, outdir, world=N, deadline_s=240):
    """Run ``python -m module outdir`` on ``world`` gloo ranks; each rank's
    saved arrays, by rank."""
    from gradaccum_tpu_torch.examples.common import spawn_ranks

    assert spawn_ranks(module, [str(outdir)], world, "cpu", deadline_s=deadline_s) == {"ok": True}
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax

    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu_torch.interop import params_from_jax

    outdir = tmp_path_factory.mktemp("dp_ranks")
    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    batch = sparse_batch()
    jparams = jbert.bert_classifier_bundle(cfg, num_classes=2).init(
        jax.random.PRNGKey(0), {k: v[:SP_MICRO] for k, v in batch.items()})
    torch.save(params_from_jax(jparams), outdir / "bert_init.pt")
    return spawn_cases("tests.test_torch_parallel", outdir), jparams


def _jax():
    import importlib

    import jax
    import jax.numpy as jnp

    from gradaccum_tpu.parallel.mesh import data_parallel_mesh
    from gradaccum_tpu.parallel.sharding import device_put_batch

    jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
    jadamw = importlib.import_module("gradaccum_tpu.ops.adamw")
    jsched = importlib.import_module("gradaccum_tpu.ops.schedule")
    jdp = importlib.import_module("gradaccum_tpu.parallel.dp")

    def loss(params, batch):
        pred = batch["x"] @ params["w"] + params["bias"]
        return jnp.mean((pred - batch["y"]) ** 2)

    def opt():
        return jadamw.adamw(jsched.warmup_polynomial_decay(LR, 100, num_warmup_steps=10),
                            weight_decay_rate=0.01)

    return dict(jax=jax, jnp=jnp, acc=jacc, adamw=jadamw, dp=jdp, loss=loss, opt=opt,
                mesh=data_parallel_mesh(N), put=device_put_batch)


def _assert_close(got, want, atol=PARAM_ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol, err_msg=what)


def _both_ranks_equal(ranks_out, key):
    assert np.array_equal(ranks_out[0][key], ranks_out[1][key], equal_nan=True), key
    return ranks_out[0][key]


def test_scan_dp_matches_jax_pjit_and_single_device(ranks):
    out, _ = ranks
    j = _jax()
    params, bigs = inputs()
    cfg = j["acc"].GradAccumConfig(num_micro_batches=K, clip_norm=1.0)
    opt = j["opt"]()
    pjit = j["dp"].make_pjit_dp_train_step(j["loss"], opt, cfg, j["mesh"], mode="scan")
    single = j["jax"].jit(j["acc"].accumulate_scan(j["loss"], opt, cfg))
    sp = j["acc"].scan_init(params, opt)
    ss = j["acc"].scan_init(params, opt)
    for u, big in enumerate(bigs):
        stacked = j["acc"].stack_micro_batches(big, K)
        sp, aux_p = pjit(sp, j["put"](stacked, j["mesh"], leading_unsharded=1))
        ss, aux_s = single(ss, stacked)
        for name in ("w", "bias"):
            got = _both_ranks_equal(out, f"scan_dp/{name}")[u]
            _assert_close(got, sp.params[name], what=f"pjit {name} update {u}")
            _assert_close(got, ss.params[name], what=f"single {name} update {u}")
            _assert_close(_both_ranks_equal(out, f"scan_pjit/{name}")[u], sp.params[name],
                          what=f"port pjit {name} update {u}")
        np.testing.assert_allclose(out[0]["scan_dp/loss"][u], float(aux_p["loss"]), rtol=1e-6)


def test_scan_dp_issues_one_all_reduce_per_update(ranks):
    out, _ = ranks
    for r in range(N):
        # the accumulator, the loss and (under the guard) the good count
        # ride one buffer: nothing else is reduced in an update
        assert list(out[r]["scan_dp/calls/all_reduce"]) == [1] * UPDATES
        assert list(out[r]["scan_dp/calls/all_reduce:grads"]) == [1] * UPDATES
        assert list(out[r]["scan_guard/calls/all_reduce"]) == [1] * UPDATES
        # the GSPMD counterpart pays one per micro-batch
        assert list(out[r]["scan_pjit/calls/all_reduce:grads"]) == [K] * UPDATES


def test_streaming_dp_matches_jax_and_reduces_once_per_micro_batch(ranks):
    out, _ = ranks
    j = _jax()
    params, bigs = inputs()
    cfg = j["acc"].GradAccumConfig(num_micro_batches=K, clip_norm=1.0)
    opt = j["opt"]()
    step = j["dp"].make_dp_train_step(j["loss"], opt, cfg, j["mesh"], mode="streaming")
    state = j["acc"].streaming_init(params, opt)
    call = 0
    for big in bigs:
        for i in range(K):
            micro = {k: v[i * N * B:(i + 1) * N * B] for k, v in big.items()}
            state, aux = step(state, j["put"](micro, j["mesh"]))
            for name in ("w", "bias"):
                _assert_close(_both_ranks_equal(out, f"stream_dp/{name}")[call],
                              state.params[name], what=f"{name} call {call}")
            np.testing.assert_allclose(out[0]["stream_dp/loss"][call], float(aux["loss"]),
                                       rtol=1e-6)
            call += 1
    for r in range(N):
        assert list(out[r]["stream_dp/calls/all_reduce:grads"]) == [1] * (K * UPDATES)


def test_scan_guard_skips_one_ranks_micro_batch_as_jax(ranks):
    """JAX's explicit scan step skips per rank and psums n_good: the same
    as one device running the K·N local micro-batches with denominator K·N
    (AdamW without bias correction at a constant rate reads no step)."""
    out, _ = ranks
    j = _jax()
    params, bigs = inputs()
    cfg = j["acc"].GradAccumConfig(num_micro_batches=K * N, clip_norm=1.0,
                                   skip_nonfinite=True)
    opt = j["adamw"].adamw(LR, weight_decay_rate=0.01)
    single = j["jax"].jit(j["acc"].accumulate_scan(j["loss"], opt, cfg))
    state = j["acc"].scan_init(params, opt)
    for u, big in enumerate(poisoned(bigs)):
        stacked = j["acc"].stack_micro_batches(big, K)  # [K, N*B]: rank r's rows per micro
        local = {k: v.reshape(K, N, B, -1).reshape(K * N, B, -1) for k, v in stacked.items()}
        state, aux = single(state, local)
        assert _both_ranks_equal(out, "scan_guard/skipped")[u] == int(aux["skipped"])
        assert _both_ranks_equal(out, "scan_guard/good_count")[u] == int(aux["good_count"])
        np.testing.assert_allclose(out[0]["scan_guard/loss"][u], float(aux["loss"]), rtol=1e-6)
        for name in ("w", "bias"):
            _assert_close(_both_ranks_equal(out, f"scan_guard/{name}")[u], state.params[name],
                          what=f"{name} update {u}")
    assert list(out[0]["scan_guard/skipped"]) == [1, 0, 0]
    assert list(out[0]["scan_guard/good_count"]) == [3, 4, 4]


def test_streaming_guard_skips_on_every_rank_as_jax(ranks):
    out, _ = ranks
    j = _jax()
    params, bigs = inputs()
    cfg = j["acc"].GradAccumConfig(num_micro_batches=K, clip_norm=1.0, skip_nonfinite=True)
    opt = j["opt"]()
    step = j["dp"].make_dp_train_step(j["loss"], opt, cfg, j["mesh"], mode="streaming")
    state = j["acc"].streaming_init(params, opt)
    call = 0
    skipped = []
    for big in poisoned(bigs):
        for i in range(K):
            micro = {k: v[i * N * B:(i + 1) * N * B] for k, v in big.items()}
            state, aux = step(state, j["put"](micro, j["mesh"]))
            skipped.append(int(aux["skipped"]))
            for name in ("w", "bias"):
                _assert_close(_both_ranks_equal(out, f"stream_guard/{name}")[call],
                              state.params[name], what=f"{name} call {call}")
            call += 1
    assert list(_both_ranks_equal(out, "stream_guard/skipped")) == skipped
    assert skipped == [1, 0, 0, 0, 0, 0]  # the NaN row is rank 1's, micro call 0
    assert list(out[0]["stream_guard/calls/pmin"]) == [1] * (K * UPDATES)


def _jax_streaming(j, cfg, opt, batches, out, prefix, keys=("loss",)):
    """JAX's streaming shard_map DP step over ``batches``, held call by call
    against the ranks' ``prefix`` record."""
    step = j["dp"].make_dp_train_step(j["loss"], opt, cfg, j["mesh"], mode="streaming")
    state = j["acc"].streaming_init(inputs()[0], opt)
    call = 0
    for big in batches:
        for i in range(K):
            micro = {k: v[i * N * B:(i + 1) * N * B] for k, v in big.items()}
            state, aux = step(state, j["put"](micro, j["mesh"]))
            for name in ("w", "bias"):
                _assert_close(_both_ranks_equal(out, f"{prefix}/{name}")[call],
                              state.params[name], what=f"{prefix} {name} call {call}")
            for key in keys:
                np.testing.assert_allclose(out[0][f"{prefix}/{key}"][call], float(aux[key]),
                                           rtol=1e-6, err_msg=f"{prefix} {key} call {call}")
            call += 1


@pytest.mark.parametrize("case", ["scan", "pjit", "streaming"])
def test_unclipped_sgd_dp_matches_jax(ranks, case):
    """SGD without clipping moves by the gradient itself, so a wrong
    denominator (K instead of K·N, a missing 1/N in streaming) shows in
    the parameters, which AdamW's scale-free update would hide."""
    out, _ = ranks
    j = _jax()
    params, bigs = inputs()
    cfg = j["acc"].GradAccumConfig(num_micro_batches=K)
    opt = j["adamw"].sgd(LR)
    prefix = f"sgd_{case}"
    if case == "streaming":
        _jax_streaming(j, cfg, opt, bigs, out, prefix)
        return
    pjit = j["dp"].make_pjit_dp_train_step(j["loss"], opt, cfg, j["mesh"], mode="scan")
    single = j["jax"].jit(j["acc"].accumulate_scan(j["loss"], opt, cfg))
    sp, ss = j["acc"].scan_init(params, opt), j["acc"].scan_init(params, opt)
    for u, big in enumerate(bigs):
        stacked = j["acc"].stack_micro_batches(big, K)
        sp, aux = pjit(sp, j["put"](stacked, j["mesh"], leading_unsharded=1))
        ss, _ = single(ss, stacked)
        for name in ("w", "bias"):
            got = _both_ranks_equal(out, f"{prefix}/{name}")[u]
            _assert_close(got, sp.params[name], what=f"pjit {name} update {u}")
            _assert_close(got, ss.params[name], what=f"single {name} update {u}")
        np.testing.assert_allclose(out[0][f"{prefix}/loss"][u], float(aux["loss"]), rtol=1e-6)


@pytest.mark.parametrize("mode", ["scan", "streaming"])
def test_guard_normalize_by_good_count_matches_jax(ranks, mode):
    """The guard with ``normalize_by_good_count``: the update divides by
    the good count of every rank (scan: the psum'd ``n_good``; streaming:
    the window's good count times N), held against JAX with SGD."""
    out, _ = ranks
    j = _jax()
    params, bigs = inputs()
    opt = j["adamw"].sgd(LR)
    prefix = f"sgd_good_{mode}"
    if mode == "streaming":
        cfg = j["acc"].GradAccumConfig(num_micro_batches=K, skip_nonfinite=True,
                                       normalize_by_good_count=True)
        _jax_streaming(j, cfg, opt, poisoned(bigs), out, prefix, keys=("skipped",))
        return
    cfg = j["acc"].GradAccumConfig(num_micro_batches=K * N, skip_nonfinite=True,
                                   normalize_by_good_count=True)
    single = j["jax"].jit(j["acc"].accumulate_scan(j["loss"], opt, cfg))
    state = j["acc"].scan_init(params, opt)
    for u, big in enumerate(poisoned(bigs)):
        stacked = j["acc"].stack_micro_batches(big, K)
        local = {k: v.reshape(K, N, B, -1).reshape(K * N, B, -1) for k, v in stacked.items()}
        state, aux = single(state, local)
        assert _both_ranks_equal(out, f"{prefix}/good_count")[u] == int(aux["good_count"])
        np.testing.assert_allclose(out[0][f"{prefix}/loss"][u], float(aux["loss"]), rtol=1e-6)
        for name in ("w", "bias"):
            _assert_close(_both_ranks_equal(out, f"{prefix}/{name}")[u], state.params[name],
                          what=f"{name} update {u}")
    assert list(out[0][f"{prefix}/good_count"]) == [3, 4, 4]


def test_cross_shard_optimizer_mean_sum_and_error(ranks):
    out, _ = ranks
    import importlib

    j_cross = importlib.import_module("gradaccum_tpu.parallel.cross_shard").cross_shard_optimizer
    from gradaccum_tpu_torch.ops.adamw import sgd
    from gradaccum_tpu_torch.parallel import cross_shard_optimizer

    base = np.arange(3, dtype=np.float32)
    # rank r holds (r + 1) * base: the sum is 3 * base, the mean 1.5 * base
    for r in range(N):
        np.testing.assert_array_equal(out[r]["cross_shard/sum"][0], -3.0 * base)
        np.testing.assert_array_equal(out[r]["cross_shard/mean"][0], -1.5 * base)
    j_sgd = importlib.import_module("gradaccum_tpu.ops.adamw").sgd

    with pytest.raises(ValueError) as want:
        j_cross(j_sgd(1.0), reduction="max")
    with pytest.raises(ValueError) as got:
        cross_shard_optimizer(sgd(1.0), reduction="max")
    assert str(got.value) == str(want.value)


def test_sparse_embed_dp_matches_dense_dp_and_jax(ranks):
    out, jparams = ranks
    import jax

    import gradaccum_tpu as gt
    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu_torch.interop import params_from_jax, state_dict_key

    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    bundle = jbert.bert_classifier_bundle(cfg, num_classes=2)
    opt = gt.ops.adamw(gt.warmup_polynomial_decay(2e-5, 100, 10), weight_decay_rate=0.01)
    accfg = gt.GradAccumConfig(num_micro_batches=SP_K, clip_norm=1.0)
    step = jax.jit(gt.accumulate_scan(bundle.loss, opt, accfg, needs_rng=True))
    state, aux = step(gt.ops.accumulation.scan_init(jparams, opt),
                      gt.stack_micro_batches(sparse_batch(), SP_K), jax.random.PRNGKey(11))
    want = {k: v.numpy() for k, v in params_from_jax(state.params).items()}
    names = [k.split("/", 1)[1] for k in out[0] if k.startswith("bert_dense/params/")]
    assert len(names) == len(want)
    for name in names:
        dense = _both_ranks_equal(out, f"bert_dense/{name}")[0]
        sparse = _both_ranks_equal(out, f"bert_sparse/{name}")[0]
        np.testing.assert_allclose(sparse, dense, rtol=1e-5, atol=1e-6, err_msg=name)
        _assert_close(dense, want[state_dict_key(name)], what=name)
    np.testing.assert_allclose(out[0]["bert_sparse/loss"][0], out[0]["bert_dense/loss"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(out[0]["bert_dense/loss"][0], float(aux["loss"]), rtol=1e-5)


@pytest.mark.parametrize("n,hosts", [(8, 2), (12, 4), (6, 1), (6, 4)])
def test_host_shard_matches_jax(n, hosts):
    from gradaccum_tpu.parallel.sharding import host_shard as j_host_shard
    from gradaccum_tpu_torch.parallel.sharding import host_shard

    batch = {"x": np.arange(n * 3).reshape(n, 3), "y": np.arange(n)}
    for host in range(hosts):
        try:
            want = j_host_shard(batch, hosts, host)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                host_shard(batch, hosts, host)
            assert str(got.value) == str(e)
            continue
        got = host_shard(batch, hosts, host)
        for key in batch:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def test_shard_dim_and_batch_shard_match_jax():
    import jax

    from gradaccum_tpu.parallel.mesh import data_parallel_mesh
    from gradaccum_tpu.parallel.sharding import device_put_batch
    from gradaccum_tpu.parallel.zero import shard_dim as j_shard_dim
    from gradaccum_tpu_torch.parallel.mesh import DataMesh
    from gradaccum_tpu_torch.parallel.sharding import batch_shard
    from gradaccum_tpu_torch.parallel.zero import shard_dim

    for shape in [(), (1,), (2,), (3,), (3, 4), (5, 6, 8), (128, 64), (7, 9), (4, 3)]:
        for n in (1, 2, 4, 8):
            assert shard_dim(shape, n) == j_shard_dim(shape, n), (shape, n)
    # rank r's rows are the ones JAX lays on device r of the data axis
    x = np.arange(2 * 8 * 3).reshape(2, 8, 3)
    for n in (2, 4):
        placed = device_put_batch({"x": x}, data_parallel_mesh(n), leading_unsharded=1)["x"]
        shards = sorted(placed.addressable_shards, key=lambda s: s.device.id)
        for r in range(n):
            mesh = DataMesh(r, n, "cpu", "gloo")
            got = batch_shard({"x": torch.as_tensor(x)}, mesh, leading_unsharded=1)["x"]
            np.testing.assert_array_equal(got.numpy(), np.asarray(shards[r].data))
    with pytest.raises(ValueError, match="not divisible"):
        batch_shard({"x": torch.zeros(3, 2)}, DataMesh(0, 2, "cpu", "gloo"))
    del jax


def test_unbound_axis_name_raises_as_jax():
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt

    step = tacc.accumulate_scan(_t_loss, topt.sgd(0.1), tacc.GradAccumConfig(K, axis_name="nope"))
    params, bigs = inputs()
    state = tacc.scan_init(_t_params(params), topt.sgd(0.1))
    with pytest.raises(NameError, match="unbound axis name: nope"):
        step(state, tacc.stack_micro_batches(_t_batch(bigs[0]), K))
