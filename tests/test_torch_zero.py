"""ZeRO-1 in the port, held against its own DP step and against JAX.

One spawn of two gloo ranks on the CPU runs every multi-rank case; the
tests read what each rank saved:

- ZeRO-1 ``"collective"`` (the explicit step) against plain DP through the
  Estimator: tiny BERT, dropout 0.1, three scan updates, parameters within
  1e-7; ``zero1=True`` (the placement path) against the port's GSPMD
  counterpart; each rank holds 1/N of every shardable ``opt_state/`` leaf
  and the whole of every other;
- under bfloat16 parameters with float32 masters the parameters are
  all-gathered in bfloat16, once per update, and equal DP's;
- a ZeRO-1 checkpoint written at world 2 in streaming mode after 6
  micro-batches of K=4 (the middle of a window) holds the full tree, and a
  resume continues bit for bit the uninterrupted run's parameters and
  gathered optimizer state;
- ``bf16+fused+zero1`` on a GPT of ``tools/bench_mixed.py``'s shape: the
  optimizer + accumulator bytes per parameter per rank equal JAX's
  accounting of its ZeRO-1 placement at 2 replicas (6 B/param);
- ``Estimator(mesh=, zero1=True)`` against JAX's ``Estimator(zero1=True)``
  on a 2-device mesh, from the same weights, dropout 0: parameters within
  2e-6 and the evaluation's accuracy (the same correct count), with an eval
  stream whose last batch does not divide the ranks.

- Adam-mini (and with float32 masters) under both ZeRO-1 paths against one
  process on the whole batch, within 1e-6: its per-tensor statistic sums
  the blocks' Σg² over the ranks.

Without a spawn: the q8 and fused rejections with JAX's messages, and the
Estimator's zero1 validation against JAX's.

    python -m pytest -m torch tests/test_torch_zero.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

N, K, MICRO, SEQ, UPDATES = 2, 2, 2, 16, 3  # MICRO rows per rank
STREAM_K, SAVE_AT, STREAM_STEPS = 4, 6, 12
EVAL_ROWS, EVAL_BATCH = 11, 4  # batches of 4, 4, 3: the last runs whole on each rank
PARAM_ATOL = 2e-6
GPT = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
           max_position_embeddings=64, dropout=0.0)  # tools/bench_mixed.py's _gpt_cfg


def bert_data(seed, n):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 128, size=(n, SEQ)).astype(np.int32),
            "input_mask": np.ones((n, SEQ), np.int32),
            "segment_ids": np.zeros((n, SEQ), np.int32),
            "label": rng.integers(0, 2, size=(n,)).astype(np.int32)}


def host_batches(n_batches, rows, seed=3):
    data = bert_data(seed, n_batches * rows)
    return [{k: v[i * rows:(i + 1) * rows] for k, v in data.items()} for i in range(n_batches)]


# --------------------------------------------------------------------------
# the ranks: python -m tests.test_torch_zero <outdir>
# --------------------------------------------------------------------------


def _rank_cases(mesh, outdir):
    from gradaccum_tpu_torch.estimator import checkpoint as tckpt
    from gradaccum_tpu_torch.estimator.config import RunConfig
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.models import gpt as tgpt
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.ops import schedule as tsched
    from gradaccum_tpu_torch.parallel import zero

    out = {}
    rows = K * MICRO * N

    def estimator(zero1=False, mode="scan", k=K, model_dir=None, dtype=None, dropout=0.1,
                  warm=None, lr=1e-3, rules=None):
        cfg = tbert.BertConfig.tiny_for_tests(hidden_dropout=dropout, attention_dropout=dropout)
        opt = topt.adamw(tsched.warmup_polynomial_decay(lr, 100, num_warmup_steps=10),
                         weight_decay_rate=0.01,
                         master_dtype=None if dtype is None else torch.float32)
        return Estimator(tbert.bert_classifier_bundle(cfg, num_classes=2, compute_dtype=dtype),
                         opt, tacc.GradAccumConfig(num_micro_batches=k, clip_norm=1.0,
                                                   first_step_quirk=mode == "streaming"),
                         RunConfig(seed=7, model_dir=model_dir, save_checkpoints_steps=None,
                                   log_step_count_steps=1000),
                         mode=mode, device="cpu", mesh=mesh, zero1=zero1, warm_start=warm,
                         sharding_rules=rules)

    def params_of(state):
        return {name: p.detach().float().numpy().copy() for name, p in state.params.items()}

    # (a) DP, ZeRO-1 collective, the GSPMD counterpart and ZeRO-1 placement
    batches = host_batches(UPDATES, rows)
    for tag, kw in (("dp", {}), ("collective", dict(zero1="collective")),
                    ("pjit", dict(rules=())), ("placement", dict(zero1=True))):
        est = estimator(**kw)
        state = est.train(batches)
        for name, value in params_of(state).items():
            out[f"{tag}/{name}"] = value
        if tag == "collective":
            for name, p in state.params.items():
                out[f"shape/m/{name}"] = np.asarray(state.opt_state.m[name].shape)
                out[f"shape/full/{name}"] = np.asarray(p.shape)

    # (b) bf16 parameters, f32 masters: the gather moves bf16
    seen = []
    gather = mesh.all_gather

    def spy(tensor, dim=0, tag=None):
        seen.append(f"{tag}:{str(tensor.dtype).replace('torch.', '')}")
        return gather(tensor, dim, tag)

    for tag, kw in (("bf16_dp", {}), ("bf16_collective", dict(zero1="collective"))):
        mesh.all_gather = spy
        state = estimator(dtype=torch.bfloat16, **kw).train(batches)
        mesh.all_gather = gather
        for name, p in state.params.items():
            out[f"{tag}/{name}"] = p.detach().float().numpy().copy()
            out[f"{tag}/dtype/{name}"] = np.asarray(str(p.dtype))
    out["bf16_gathers"] = np.asarray(seen)

    # (c) a ZeRO-1 checkpoint in the middle of a streaming window, resumed
    stream = host_batches(STREAM_STEPS, MICRO * N, seed=5)
    gathered = {}
    for tag in ("whole", "resumed"):
        d = os.path.join(outdir, f"ckpt_{tag}")
        if tag == "whole":
            est = estimator(zero1="collective", mode="streaming", k=STREAM_K, model_dir=d)
            state = est.train(stream, max_steps=STREAM_STEPS)
        else:
            estimator(zero1="collective", mode="streaming", k=STREAM_K, model_dir=d).train(
                stream[:SAVE_AT], max_steps=SAVE_AT)
            mesh.barrier()  # rank 0 wrote the checkpoint
            saved = torch.load(os.path.join(d, f"ckpt-{SAVE_AT}.pt"))
            for key, value in saved.items():
                if key.startswith("opt_state/") and isinstance(value, torch.Tensor):
                    out[f"saved_shape/{key}"] = np.asarray(value.shape)
            est = estimator(zero1="collective", mode="streaming", k=STREAM_K, model_dir=d)
            state = est.train(stream[SAVE_AT:], max_steps=STREAM_STEPS)
        full = zero.zero1_gather_state(state, mesh, est._zero1_specs)
        gathered[tag] = {k: v.clone() for k, v in tckpt.flatten(full).items()
                         if isinstance(v, torch.Tensor)}
    out["resume_bitwise"] = np.asarray(all(
        torch.equal(gathered["whole"][k], gathered["resumed"][k]) for k in gathered["whole"]))
    out["resume_leaves"] = np.asarray(len(gathered["whole"]))

    # (d) bf16 + fused + ZeRO-1 on bench_mixed's GPT: bytes per parameter
    cfg = tgpt.GPTConfig(**GPT)
    est = Estimator(tgpt.gpt_lm_bundle(cfg, compute_dtype=torch.bfloat16),
                    topt.adamw(1e-3, weight_decay_rate=0.01, master_dtype=torch.float32),
                    tacc.GradAccumConfig(num_micro_batches=4, fused_adam=True),
                    RunConfig(seed=0, save_checkpoints_steps=None, log_step_count_steps=1000),
                    mode="scan", device="cpu", mesh=mesh, zero1=True)
    ids = np.random.default_rng(9).integers(0, GPT["vocab_size"], size=(4 * 2 * N, SEQ))
    state = est.train([{"input_ids": ids.astype(np.int32)}])
    n = sum(p.numel() for p in state.params.values())
    opt_bytes = sum(t.numel() * t.element_size() for field in state.opt_state
                    for t in (field.values() if isinstance(field, dict) else [field]))
    out["gpt/params"] = np.asarray(n)
    out["gpt/opt_bytes"] = np.asarray(opt_bytes)
    out["gpt/loss"] = np.asarray(float(est.last_loss))

    # (e) zero1=True against JAX's, from JAX's weights, dropout 0
    warm = {k: torch.as_tensor(v) for k, v in np.load(os.path.join(outdir, "warm.npz")).items()}
    est = estimator(zero1=True, dropout=0.0, warm=warm, lr=2e-5)
    state = est.train(batches)
    for name, value in params_of(state).items():
        out[f"vs_jax/{name}"] = value
    evald = bert_data(7, EVAL_ROWS)
    res = est.evaluate([{k: v[i:i + EVAL_BATCH] for k, v in evald.items()}
                        for i in range(0, EVAL_ROWS, EVAL_BATCH)], state=state)
    out["vs_jax/accuracy"] = np.asarray(res["accuracy"])

    # (f) Adam-mini's whole-tensor statistic under ZeRO-1, both paths,
    # against one process on the whole batch. The housing MLP, not BERT:
    # BERT's key biases have a gradient that is zero but for rounding (the
    # softmax ignores a shift shared by every key), and Adam-mini divides
    # that rounding noise by its own RMS, so any other summation order
    # moves those leaves by up to the learning rate.
    from gradaccum_tpu_torch.models.housing_mlp import housing_mlp_bundle

    rng = np.random.default_rng(13)
    regress = [{"x": rng.normal(size=(rows, 14)).astype(np.float32),
                "y": rng.normal(size=(rows, 1)).astype(np.float32)} for _ in range(UPDATES)]
    for tag, kw in (("adam_mini", {}), ("adam_mini-master", dict(master_dtype=torch.float32))):
        for path, zero1 in (("collective", "collective"), ("placement", True), ("single", False)):
            est = Estimator(housing_mlp_bundle(hidden=(16, 8, 4)),
                            topt.adam_mini(1e-3, **kw),
                            tacc.GradAccumConfig(num_micro_batches=K, clip_norm=1.0),
                            RunConfig(seed=7, save_checkpoints_steps=None,
                                      log_step_count_steps=1000),
                            mode="scan", device="cpu", mesh=None if path == "single" else mesh,
                            zero1=zero1)
            for name, value in params_of(est.train(regress)).items():
                out[f"{tag}/{path}/{name}"] = value
    return out


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
# the tests
# --------------------------------------------------------------------------


def _jax_bert():
    import jax

    from gradaccum_tpu.models import bert as jbert

    cfg = jbert.BertConfig.tiny_for_tests(hidden_dropout=0.0, attention_dropout=0.0)
    bundle = jbert.bert_classifier_bundle(cfg, num_classes=2)
    params = bundle.init(jax.random.PRNGKey(0), bert_data(0, MICRO))
    return bundle, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from gradaccum_tpu_torch.interop import params_from_jax
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.utils.tree import named_parameters

    outdir = tmp_path_factory.mktemp("zero1_ranks")
    _, jparams = _jax_bert()
    module = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests()).init(0, "cpu")
    module.load_state_dict(params_from_jax(jparams))
    np.savez(outdir / "warm.npz", **{name: p.detach().numpy()
                                     for name, p in named_parameters(module).items()})
    from test_torch_parallel import spawn_cases

    return spawn_cases("tests.test_torch_zero", outdir), jparams


def _names(out, prefix):
    return [k[len(prefix) + 1:] for k in out if k.startswith(prefix + "/params/")]


def test_zero1_collective_equals_dp(ranks):
    out, _ = ranks
    for r in range(N):
        for name in _names(out[r], "dp"):
            np.testing.assert_allclose(out[r][f"collective/{name}"], out[r][f"dp/{name}"],
                                       rtol=0, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(out[r][f"placement/{name}"], out[r][f"pjit/{name}"],
                                       rtol=0, atol=1e-7, err_msg=name)
            np.testing.assert_array_equal(out[r][f"dp/{name}"], out[0][f"dp/{name}"])


def test_each_rank_holds_its_block_of_the_optimizer_state(ranks):
    """Each leaf splits along the dimension JAX's ZeRO-1 splits: JAX's
    ``shard_dim`` of the shape in JAX's layout (a Dense kernel [in, out]
    is the port's [out, in] transposed)."""
    out, _ = ranks
    from gradaccum_tpu.parallel.zero import shard_dim

    sharded = 0
    for name in _names(out[0], "dp"):
        full = tuple(out[0][f"shape/full/{name}"])
        kernel = name.endswith("kernel") and len(full) == 2
        d = shard_dim(full[::-1] if kernel else full, N)
        if kernel and d is not None:
            d = 1 - d
        want = list(full)
        if d is not None:
            want[d] //= N
            sharded += 1
        for r in range(N):
            assert tuple(out[r][f"shape/m/{name}"]) == tuple(want), name
    assert sharded > 0


def test_bf16_params_gather_in_their_dtype_and_equal_dp(ranks):
    out, _ = ranks
    for r in range(N):
        gathers = list(out[r]["bf16_gathers"])
        # the DP run gathers nothing; the ZeRO-1 run one bf16 gather per update
        assert gathers == ["params:bfloat16"] * UPDATES, gathers
        for name in _names(out[r], "bf16_dp"):
            if "/dtype/" in name:
                continue
            np.testing.assert_array_equal(out[r][f"bf16_collective/{name}"],
                                          out[r][f"bf16_dp/{name}"], err_msg=name)
        assert {str(out[r][k]) for k in out[r] if k.startswith("bf16_collective/dtype/")} \
            == {"torch.bfloat16"}


def test_zero1_checkpoint_is_full_tree_and_resumes_bitwise(ranks):
    out, _ = ranks
    for r in range(N):
        assert bool(out[r]["resume_bitwise"]) and int(out[r]["resume_leaves"]) > 0
    shapes = {k.split("/", 1)[1]: tuple(v) for k, v in out[0].items()
              if k.startswith("saved_shape/")}
    for key, shape in shapes.items():
        if key.startswith("opt_state/m/"):
            name = key[len("opt_state/m/"):]
            assert shape == tuple(out[0][f"shape/full/{name}"]), key


def test_bf16_fused_zero1_bytes_per_param_equal_jax_accounting(ranks):
    out, _ = ranks
    import jax
    import jax.numpy as jnp

    from gradaccum_tpu.models.gpt import GPTConfig, gpt_lm_bundle
    from gradaccum_tpu.ops import accumulation as jacc
    from gradaccum_tpu.ops.adamw import adamw
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.parallel.zero import zero1_shard_state

    bundle = gpt_lm_bundle(GPTConfig(**GPT), compute_dtype=jnp.bfloat16)
    params = bundle.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((2, SEQ), np.int32)})
    opt = adamw(1e-3, weight_decay_rate=0.01, master_dtype=jnp.float32)
    state = zero1_shard_state(jacc.scan_init(params, opt), make_mesh(data=N,
                                                                      devices=jax.devices()[:N]))
    jax_bytes = 0
    for leaf in jax.tree.leaves(state.opt_state):
        shards = 1 if leaf.sharding.is_fully_replicated else leaf.sharding.num_devices
        jax_bytes += leaf.nbytes // shards
    n = sum(leaf.size for leaf in jax.tree.leaves(state.params))
    for r in range(N):
        assert int(out[r]["gpt/params"]) == n
        assert int(out[r]["gpt/opt_bytes"]) == jax_bytes  # accumulator: none under fused
        assert np.isfinite(out[r]["gpt/loss"])
    assert abs(jax_bytes / n - 6.0) < 0.01


def test_estimator_zero1_matches_jax_estimator(ranks):
    out, jparams = ranks
    import jax

    import gradaccum_tpu as gt
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu_torch.interop import params_from_jax, state_dict_key

    bundle, _ = _jax_bert()
    est = gt.Estimator(
        bundle, gt.ops.adamw(gt.warmup_polynomial_decay(2e-5, 100, num_warmup_steps=10),
                             weight_decay_rate=0.01),
        gt.GradAccumConfig(num_micro_batches=K, clip_norm=1.0, first_step_quirk=False),
        gt.RunConfig(seed=7), mesh=make_mesh(data=N, devices=jax.devices()[:N]),
        mode="scan", zero1=True, warm_start=jparams)
    state = est.train(host_batches(UPDATES, K * MICRO * N))
    want = {k: v.numpy() for k, v in params_from_jax(jax.device_get(state.params)).items()}
    names = _names(out[0], "vs_jax")
    assert len(names) == len(want)
    for r in range(N):
        for name in names:
            np.testing.assert_allclose(out[r][f"vs_jax/{name}"], want[state_dict_key(name)],
                                       rtol=0, atol=PARAM_ATOL, err_msg=name)
    evald = bert_data(7, EVAL_ROWS)
    res = est.evaluate(lambda: gt.Dataset.from_arrays(evald).batch(EVAL_BATCH), state=state)
    # the same correct count: JAX divides in float32, the port in float64
    np.testing.assert_allclose(float(out[0]["vs_jax/accuracy"]), float(res["accuracy"]),
                               rtol=1e-7)


def _jax_error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("JAX did not raise")


def test_q8_and_fused_rejections_match_jax():
    import importlib

    import jax.numpy as jnp

    jzero = importlib.import_module("gradaccum_tpu.parallel.zero")
    jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
    jadamw = importlib.import_module("gradaccum_tpu.ops.adamw")
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.parallel import zero
    from gradaccum_tpu_torch.parallel.mesh import DataMesh

    p = {"w": np.ones((4, 2), np.float32)}
    j_opt = jadamw.adamw(1e-3, moment_dtype="q8")
    want = _jax_error(lambda: jzero.zero1_state_specs(
        jacc.scan_init({"w": jnp.asarray(p["w"])}, j_opt), 2))
    t_opt = topt.adamw(1e-3, moment_dtype="q8")
    with pytest.raises(ValueError) as got:
        zero.zero1_state_specs(tacc.scan_init({"w": torch.ones(4, 2)}, t_opt), 2)
    assert str(got.value) == want

    fused = dict(num_micro_batches=2, fused_adam=True)
    want = _jax_error(lambda: jzero.make_zero1_train_step(
        lambda p, b: 0.0, jadamw.adamw(1e-3), jacc.GradAccumConfig(**fused), mesh=None))
    with pytest.raises(ValueError) as got:
        zero.make_zero1_train_step(lambda p, b: 0.0, topt.adamw(1e-3),
                                   tacc.GradAccumConfig(**fused),
                                   DataMesh(0, 2, "cpu", "gloo"))
    assert str(got.value) == want


@pytest.mark.parametrize("name", ["adam_mini", "adam_mini-master", "adamw", "adam",
                                  "sgd-momentum"])
def test_zero1_refuses_a_whole_tensor_statistic(name, ranks):
    """Adam-mini's second moment is one scalar per parameter tensor: under
    ZeRO-1 a rank holding a block of the parameter sums its block's Σg²
    over the data ranks before the update, so both ZeRO-1 paths equal one
    process on the whole batch (within 1e-6); the optimizers whose state
    has the parameter's shape shard as before."""
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.parallel import zero

    if name.startswith("adam_mini"):
        out, _ = ranks
        names = [k[len(f"{name}/single/"):] for k in out[0]
                 if k.startswith(f"{name}/single/")]
        assert names
        for r in range(N):
            for path in ("collective", "placement"):
                for p in names:
                    np.testing.assert_allclose(out[r][f"{name}/{path}/{p}"],
                                               out[r][f"{name}/single/{p}"], rtol=0, atol=1e-6,
                                               err_msg=f"rank {r} {path} {p}")
        return
    opt = {"adamw": lambda: topt.adamw(1e-3), "adam": lambda: topt.adam(1e-3),
           "sgd-momentum": lambda: topt.sgd(1e-3, momentum=0.9)}[name]()
    # "w" shards over 2 ranks along dim 0, "b" stays whole
    params = {"w": torch.ones(4, 2), "b": torch.ones(3)}
    state = tacc.scan_init(params, opt)
    specs = zero.zero1_state_specs(state, N)
    sharded = {path for path, d in specs.items() if d is not None}
    assert sharded and all(path.startswith("opt_state/") and path.endswith("/w")
                           or path == "opt_state/w" for path in sharded)


@pytest.mark.parametrize("kw", [dict(zero1="yes"), dict(zero1=True), dict(zero1="collective",
                                                                           fused=True)],
                         ids=["bad-value", "no-data-axis", "collective-fused"])
def test_estimator_zero1_validation_matches_jax(kw):
    import jax

    import gradaccum_tpu as gt
    from gradaccum_tpu.models import bert as jbert
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models import bert as tbert
    from gradaccum_tpu_torch.ops import accumulation as tacc
    from gradaccum_tpu_torch.ops import adamw as topt
    from gradaccum_tpu_torch.parallel.mesh import DataMesh

    fused = kw.get("fused", False)
    world = 1 if kw["zero1"] is True else 2
    jmesh = make_mesh(data=world, devices=jax.devices()[:world])
    want = _jax_error(lambda: gt.Estimator(
        jbert.bert_classifier_bundle(jbert.BertConfig.tiny_for_tests()), gt.ops.adamw(1e-3),
        gt.GradAccumConfig(2, fused_adam=fused), mesh=jmesh, zero1=kw["zero1"]))
    with pytest.raises(ValueError) as got:
        Estimator(tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests()),
                  topt.adamw(1e-3), tacc.GradAccumConfig(2, fused_adam=fused),
                  mesh=DataMesh(0, world, "cpu", "gloo"), zero1=kw["zero1"])
    assert str(got.value) == want
