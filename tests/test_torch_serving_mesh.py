"""The serving mesh in the port: tensor-parallel decode on gloo ranks.

One spawn of two gloo ranks on the CPU (``test_torch_parallel.spawn_cases``,
with a deadline) runs every multi-rank case: ``Engine(mesh=serving_mesh(2))``
and ``ReplicatedEngine(replicas=2, tp=2)`` on JAX's tiny LM (JAX's weights
carried over through ``interop.py``). Each rank saves what it saw, and the
tests hold both ranks to each other and the streams to JAX:

- the counterparts of JAX's four TP tests (``tests/test_serving_multichip.py``
  :49, :78, :99 and ``test_serving_spec.py :: test_spec_parity_tp_mesh``):
  every stream token for token JAX's ``generate_cached`` and JAX's mesh
  engine (``serving_mesh(2)`` on the virtual CPU devices) on the same
  trace, one tick signature, every block reclaimed, each rank's pool
  holding ``num_heads / 2`` heads; the refusals in JAX's words;
- port-side cases against the port's own tp=1 engine on the same prompts:
  a seeded ``MID_DECODE_TICK`` crash, ``recover`` and a requeue; a
  preemption through the host swap store (each rank's record holds its own
  heads: half the tp=1 bytes) and through the tiered store's disk rung
  (each rank's record in its own store directory); the int8 KV pool; a pool grow and a
  checkpoint swap (``params_digest`` of the whole tree equal to tp=1's);
  ``ReplicatedEngine(replicas=2, tp=2)`` stepped and drained;
- the collectives of a micro-step (``2 * num_layers + 2``) and of a
  speculative cycle, counted on the mesh.

Without a spawn: ``serving_mesh``'s refusal in JAX's words and a one-rank
mesh engine (manifest, tags and the server's ``stats()["mesh"]`` as JAX's).
The server over a multi-rank mesh is ``tests/test_torch_serving_mesh_server.py``.

    python -m pytest -m torch tests/test_torch_serving_mesh.py
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

TP = 2
DEADLINE_S = 240
# JAX's four TP tests: engine knobs, SimulationDriver seed and trace
PAGED = dict(engine=dict(num_slots=4, max_len=32, page_size=4), seed=2,
             trace=dict(n_requests=7, arrival_rate=0.6, prompt_len=(1, 12), max_new=(1, 10)))
SAMPLED = dict(engine=dict(num_slots=3, max_len=32, temperature=0.8, top_k=5), seed=5,
               trace=dict(n_requests=5, arrival_rate=0.7, prompt_len=(2, 10), max_new=(2, 8)))
SPEC = dict(engine=dict(num_slots=3, max_len=32, page_size=4, num_blocks=24, speculate_k=3),
            seed=5,
            trace=dict(n_requests=6, arrival_rate=0.6, prompt_len=(1, 12), max_new=(1, 12)))
FLEET = dict(engine=dict(replicas=2, num_slots=3, max_len=32, page_size=4), seed=1,
             trace=dict(n_requests=10, arrival_rate=0.8, prompt_len=(1, 10), max_new=(1, 8)))
# the port-side cases: 4 prompts, 8 new tokens each, a paged pool
PORT = dict(num_slots=4, max_len=32, page_size=4)
PORT_NEW = 8
FAULT_TICK = 2


def _cfg():
    from gradaccum_tpu_torch.models.gpt import GPTConfig

    return GPTConfig.tiny_for_tests(dropout=0.0)


def port_prompts(seed=31, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 96, int(rng.integers(3, 11))).astype(np.int32) for _ in range(n)]


def drain_prompts():
    """JAX's ``test_replicated_drain_free_runs_to_parity`` requests."""
    rng = np.random.default_rng(9)
    return [(rng.integers(0, 96, 3 + i).astype(np.int32), 4 + i % 3) for i in range(6)]


# --------------------------------------------------------------------------
# the ranks: python -m tests.test_torch_serving_mesh <outdir>
# --------------------------------------------------------------------------


def _tree(outdir, name):
    """JAX's weights saved by the test, as the port's decode tree."""
    from gradaccum_tpu_torch.interop import params_tree
    from gradaccum_tpu_torch.models import gpt as tgpt

    model = tgpt.GPTLM(_cfg())
    model.load_state_dict(torch.load(os.path.join(outdir, f"{name}.pt")))
    return params_tree(model)


def _drive(engine, leg):
    """``[[request id, tokens, status]]`` of the leg's seeded trace."""
    from gradaccum_tpu_torch.serving import SimulationDriver

    driver = SimulationDriver(engine, seed=leg["seed"])
    records = driver.run(driver.make_trace(**leg["trace"]))
    return [[int(r["request_id"]), [int(t) for t in r["tokens"]], r["status"]]
            for r in records]


def trace_of(leg, vocab=96):
    """The leg's trace (SimulationDriver's draws need no engine)."""
    from gradaccum_tpu_torch.serving import SimulationDriver

    driver = SimulationDriver.__new__(SimulationDriver)
    driver.seed = leg["seed"]
    return driver.make_trace(vocab_size=vocab, **leg["trace"])


def _streams(engine, rids):
    """``[[tokens, status]]`` of ``rids`` (popped)."""
    out = []
    for rid in rids:
        tokens, status = engine.pop_result(rid)
        out.append([[int(t) for t in tokens], status])
    return out


def _error(kind, call):
    try:
        call()
    except kind as e:
        return str(e)
    return None


def _jax_cases(tree, cfg, mesh_of, out):
    """JAX's four TP tests, and the collectives of a tick and a cycle."""
    from gradaccum_tpu_torch.models.gpt_decode import truncate_draft_params
    from gradaccum_tpu_torch.serving import Engine

    e = Engine(tree, cfg, mesh=mesh_of(), device="cpu", **PAGED["engine"])
    out["paged"] = dict(records=_drive(e, PAGED), decode_programs=e.decode_compile_count(),
                        prefill_programs=e.prefill_compile_count(),
                        allocated=e.pool.allocated_blocks, unreserved=e.pool.unreserved_blocks,
                        num_blocks=e.pool.num_blocks, pool_shape=list(e.pool.k.shape),
                        mesh=e.manifest()["mesh"], tags=e.obs_tags())
    e = Engine(tree, cfg, mesh=mesh_of(), device="cpu", **SAMPLED["engine"])
    out["sampled"] = dict(records=_drive(e, SAMPLED), decode_programs=e.decode_compile_count(),
                          pool_shape=list(e.pool.k.shape))
    draft, dcfg = truncate_draft_params(tree, cfg, 1)
    e = Engine(tree, cfg, mesh=mesh_of(), device="cpu", draft_params=draft, draft_cfg=dcfg,
               **SPEC["engine"])
    out["spec"] = dict(records=_drive(e, SPEC), decode_programs=e.decode_compile_count(),
                       draft_shape=list(e._draft_k.shape),
                       shared=[e.draft_params["params"]["word_embeddings"]["embedding"]
                               is e.params["params"]["word_embeddings"]["embedding"]])
    # one tick of two micro-steps, no admission in it; then one cycle
    prompts = port_prompts()
    e = Engine(tree, cfg, mesh=mesh_of(), device="cpu", decode_block=2, **PORT)
    for i, p in enumerate(prompts[:2]):
        e.submit(p, 12, rng_seed=i)
    e.step()
    e.mesh.reset_calls()
    e.step()
    out["calls_tick"] = dict(e.mesh.calls)
    e = Engine(tree, cfg, mesh=mesh_of(), device="cpu", draft_params=draft, draft_cfg=dcfg,
               **SPEC["engine"])
    for i, p in enumerate(prompts[:2]):
        e.submit(p, 12, rng_seed=i)
    e.step()
    e.mesh.reset_calls()
    e.step()
    out["calls_cycle"] = dict(e.mesh.calls)


def _refusals(tree, cfg, mesh, out):
    """JAX's construction refusals on a tp=2 mesh, word for word."""
    from gradaccum_tpu_torch.models.gpt_decode import truncate_draft_params
    from gradaccum_tpu_torch.parallel.mesh import make_mesh
    from gradaccum_tpu_torch.serving import Engine

    draft, dcfg = truncate_draft_params(tree, cfg, 1)

    def engine(c=cfg, **kw):
        return lambda: Engine(tree, c, num_slots=2, max_len=32, device="cpu",
                              **dict(dict(mesh=mesh), **kw))

    out["refusals"] = {
        "num_blocks": _error(ValueError, engine(page_size=4, num_blocks=7)),
        "num_heads": _error(ValueError, engine(dataclasses.replace(cfg, num_heads=1))),
        "intermediate_size": _error(ValueError, engine(
            dataclasses.replace(cfg, intermediate_size=63))),
        "vocab_size": _error(ValueError, engine(dataclasses.replace(cfg, vocab_size=97))),
        "draft": _error(ValueError, engine(speculate_k=2, draft_params=draft,
                                           draft_cfg=dataclasses.replace(dcfg, num_heads=1))),
        "axis": _error(ValueError, engine(mesh=make_mesh([("data", TP)]))),
    }
    # the port's own: a tree whose embedding is neither the whole vocab nor
    # one rank's block of it
    out["tree_refusal"] = _error(ValueError, engine(
        dataclasses.replace(cfg, vocab_size=cfg.vocab_size + TP)))


def _port_cases(tree, cfg, outdir, mesh_of, out):
    """Recover, host swap, int8 KV, grow and checkpoint swap at tp=2."""
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import Engine, ReconfigError, reconfig

    prompts = port_prompts()

    def engine(**kw):
        return Engine(tree, cfg, mesh=mesh_of(), device="cpu", **dict(PORT, **kw))

    def submit(e, ps=prompts):
        return [e.submit(p, PORT_NEW, rng_seed=i) for i, p in enumerate(ps)]

    # a seeded crash mid tick on both ranks, recover, requeue
    e = engine()
    by_seed = dict(enumerate(submit(e)))
    injector = faults.FaultInjector(faults.FaultSchedule(
        [faults.FaultSpec(faults.MID_DECODE_TICK, at=FAULT_TICK, kind=faults.KIND_CRASH)]))
    failed = []
    with faults.installed(injector):
        while not e.idle:
            try:
                e.step()
            except faults.InjectedCrash:
                for req in e.recover():
                    failed.append(req.rng_seed)
                    by_seed[req.rng_seed] = e.submit(req.prompt, req.max_new_tokens,
                                                     rng_seed=req.rng_seed)
    out["recover"] = dict(streams=_streams(e, [by_seed[i] for i in range(len(prompts))]),
                          failed=failed, fired=len(injector.fired),
                          allocated=e.pool.allocated_blocks)
    # a preemption through the host swap store, then resumed
    e = engine(swap="host")
    rids = submit(e)
    e.step()
    e.step()
    preempted = e.preempt(rids[0])
    e.run_until_idle()
    m = e.metrics.summary()
    out["swap"] = dict(streams=_streams(e, rids), preempted=preempted,
                       swap_bytes_out=m["swap_bytes_out"], swap_bytes_in=m["swap_bytes_in"])
    # the tiered store with a one-byte host rung: the record goes to disk,
    # in this rank's own store directory
    e = engine(swap="tiered", swap_max_bytes=1)
    rids = submit(e)
    e.step()
    e.step()
    e.preempt(rids[0])
    store = e._swap_store
    on_disk = dict(files=sorted(os.listdir(store._dir)), disk_bytes=store.disk_held_bytes)
    e.run_until_idle()
    out["tiered"] = dict(streams=_streams(e, rids), dir=store._dir, **on_disk)
    # the int8 pool
    e = engine(cache_dtype="int8")
    rids = submit(e)
    e.run_until_idle()
    out["int8"] = dict(streams=_streams(e, rids), shape=list(e.pool.k.q.shape))
    # a grow mid-stream (and an indivisible one refused), then a checkpoint
    # swap at idle
    e = engine()
    digest = reconfig.params_digest(e.whole_params())
    rids = submit(e)
    e.step()
    e.step()
    refused = _error(ReconfigError, lambda: e.reconfigure(reconfig.pool_resize(e.num_blocks + 3)))
    grow = e.reconfigure(reconfig.pool_resize(e.num_blocks + 8)).to_dict()
    e.run_until_idle()
    streams = _streams(e, rids)
    swap = e.reconfigure(reconfig.checkpoint_swap(
        checkpoint=os.path.join(outdir, "ckpt_other"))).to_dict()
    after = submit(e)
    e.run_until_idle()
    out["reconfig"] = dict(streams=streams, refused=refused, grow=grow, swap=swap,
                           digest=digest,
                           digest_after=reconfig.params_digest(e.whole_params()),
                           streams_after=_streams(e, after),
                           pool_shape=list(e.pool.k.shape))


def _fleet_cases(tree, cfg, out):
    """``ReplicatedEngine(replicas=2, tp=2)``: JAX's fleet trace stepped,
    then drained."""
    from gradaccum_tpu_torch.obs import trace as ttrace
    from gradaccum_tpu_torch.serving import ReplicatedEngine

    kw = dict(FLEET["engine"])
    fleet = ReplicatedEngine(tree, cfg, tp=TP, device="cpu", **kw)
    tracer = ttrace.Tracer()
    with ttrace.installed(tracer):
        records = _drive(fleet, FLEET)
    ticks = [ev for ev in tracer.snapshot() if ev.get("name") == "serve/tick"]
    out["fleet"] = dict(
        records=records, manifest_mesh=fleet.manifest()["mesh"], tp=fleet.manifest()["tp"],
        engine_meshes=[e["mesh"] for e in fleet.manifest()["engines"]],
        tick_meshes=sorted({ev["args"].get("mesh") for ev in ticks}),
        tick_replicas=sorted({ev["args"].get("replica") for ev in ticks}),
        per_replica=[[e.decode_compile_count(), e.pool.allocated_blocks,
                      e.metrics.tokens_emitted > 0] for e in fleet.replicas],
        groups_distinct=fleet.replicas[0].mesh.axis("model").group
        is not fleet.replicas[1].mesh.axis("model").group,
        weights_shared=all(
            e.params["params"]["word_embeddings"]["embedding"]
            is fleet.replicas[0].params["params"]["word_embeddings"]["embedding"]
            for e in fleet.replicas),
        table_rows=fleet.replicas[0].params["params"]["word_embeddings"]["embedding"].shape[0],
        tags=fleet.obs_tags())
    fleet.close()
    fleet = ReplicatedEngine(tree, cfg, replicas=2, tp=TP, num_slots=2, max_len=32,
                             page_size=4, device="cpu")
    rids = [fleet.submit(p, n, rng_seed=i) for i, (p, n) in enumerate(drain_prompts())]
    fleet.drain()
    out["drain"] = dict(streams=[[[int(t) for t in fleet.pop_result(r)[0]]] for r in rids],
                        idle=fleet.idle)
    fleet.close()


def _rank_cases(outdir):
    from gradaccum_tpu_torch.parallel.mesh import serving_mesh

    cfg = _cfg()
    tree = _tree(outdir, "params")
    out = {}
    with torch.no_grad():
        _jax_cases(tree, cfg, lambda: serving_mesh(TP), out)
        _refusals(tree, cfg, serving_mesh(TP), out)
        _port_cases(tree, cfg, outdir, lambda: serving_mesh(TP), out)
        _fleet_cases(tree, cfg, out)
    return out


def _rank_main(outdir):
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    info = mesh_lib.initialize_multihost(device="cpu", timeout_s=60)
    try:
        out = _rank_cases(outdir)
        rank = info["process_index"]
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), result=np.asarray(json.dumps(out)))
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        print(json.dumps({"ok": True}))


if __name__ == "__main__":
    _rank_main(sys.argv[1])


# --------------------------------------------------------------------------
# the tests (JAX on the virtual CPU devices of tests/conftest.py)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    """JAX's tiny LM at seed 0 (and 99, the checkpoint swap's), carried into
    the port."""
    import jax

    from gradaccum_tpu.models import gpt as jgpt
    from gradaccum_tpu_torch.interop import params_from_jax, params_tree
    from gradaccum_tpu_torch.models import gpt as tgpt

    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    bundle = jgpt.gpt_lm_bundle(jcfg)
    ids = {"input_ids": np.zeros((1, 8), np.int32)}
    params = bundle.init(jax.random.PRNGKey(0), ids)
    other = bundle.init(jax.random.PRNGKey(99), ids)

    def carry(p):
        state = params_from_jax(jax.device_get(p["params"]))
        model = tgpt.GPTLM(_cfg())
        model.load_state_dict(state)
        return state, params_tree(model)

    (state, tree), (other_state, other_tree) = carry(params), carry(other)
    return types.SimpleNamespace(jcfg=jcfg, params=params, other=other, state=state,
                                 tree=tree, other_state=other_state, other_tree=other_tree,
                                 cfg=_cfg())


@pytest.fixture(scope="module")
def ranks(lm, tmp_path_factory):
    from test_torch_parallel import spawn_cases

    from gradaccum_tpu_torch.estimator import checkpoint as tckpt

    outdir = tmp_path_factory.mktemp("serving_mesh")
    torch.save(lm.state, outdir / "params.pt")
    tckpt.save(str(outdir / "ckpt_other"), {"params": lm.other_tree, "step": 1}, step=1)
    got = spawn_cases("tests.test_torch_serving_mesh", outdir, world=TP, deadline_s=DEADLINE_S)
    return [json.loads(str(r["result"])) for r in got]


def _same(ranks, *keys):
    """The value at ``keys`` on rank 0, after asserting rank 1 saw the same."""
    vals = []
    for r in ranks:
        v = r
        for k in keys:
            v = v[k]
        vals.append(v)
    assert vals[0] == vals[1], keys
    return vals[0]


def _jax_solo(lm, prompt, n, **kw):
    from gradaccum_tpu.models.gpt_decode import generate_cached

    return np.asarray(generate_cached(lm.params, lm.jcfg, prompt, n, **kw))[0, len(prompt):] \
        .tolist()


def _jax_mesh_run(lm, leg, mesh, **extra):
    """JAX's mesh engine on the leg's trace: ``(trace, records)``."""
    from gradaccum_tpu.serving import Engine, SimulationDriver

    engine = Engine(lm.params, lm.jcfg, mesh=mesh, **dict(leg["engine"], **extra))
    driver = SimulationDriver(engine, seed=leg["seed"])
    trace = driver.make_trace(**leg["trace"])
    records = driver.run(trace)
    return trace, [[int(r["request_id"]), [int(t) for t in r["tokens"]], r["status"]]
                   for r in records], engine


def _port_solo(lm, prompt, n, tree=None, **kw):
    from gradaccum_tpu_torch.models.gpt_decode import generate_cached

    return generate_cached(tree or lm.tree, lm.cfg, prompt, n, **kw)[0, len(prompt):].tolist()


def _port_engine_streams(lm, prompts, **kw):
    """The port's tp=1 engine on the port-side prompts."""
    from gradaccum_tpu_torch.serving import Engine

    e = Engine(lm.tree, lm.cfg, device="cpu", **dict(PORT, **kw))
    rids = [e.submit(p, PORT_NEW, rng_seed=i) for i, p in enumerate(prompts)]
    e.run_until_idle()
    return [[[int(t) for t in e.pop_result(r)[0]], "done"] for r in rids], e


def test_tp_paged_greedy_parity_compile_once_and_reclaim(lm, ranks, serving_mesh_2):
    """JAX :49. The paged tp=2 engine streams what JAX's generate_cached
    and JAX's mesh engine stream on the same trace; one tick signature;
    every block back at idle; each rank's pool holds one of the two heads."""
    got = _same(ranks, "paged")
    trace, jrecords, jengine = _jax_mesh_run(lm, PAGED, serving_mesh_2)
    assert got["records"] == jrecords
    for item, (_, tokens, status) in zip(trace, got["records"]):
        assert status == "done" and tokens == _jax_solo(lm, item.prompt, item.max_new_tokens)
    assert got["decode_programs"] == jengine.decode_compile_count() == 1
    assert got["prefill_programs"] <= 4
    assert got["allocated"] == 0 and got["unreserved"] == got["num_blocks"]
    assert got["pool_shape"][2] == lm.cfg.num_heads // TP
    assert got["mesh"] == jengine.manifest()["mesh"] == {"model": TP}
    assert got["tags"] == jengine.obs_tags() == {"mesh": "model=2"}


def test_tp_fixed_pool_sampled_parity(lm, ranks, serving_mesh_2):
    """JAX :78. Temperature 0.8, top-k 5 through the head-split fixed pool:
    the per-request streams survive the split bit for bit."""
    import jax

    got = _same(ranks, "sampled")
    trace, jrecords, _ = _jax_mesh_run(lm, SAMPLED, serving_mesh_2)
    assert got["records"] == jrecords
    for item, (_, tokens, _) in zip(trace, got["records"]):
        assert tokens == _jax_solo(lm, item.prompt, item.max_new_tokens, temperature=0.8,
                                   top_k=5, rng=jax.random.PRNGKey(item.rng_seed))
    assert got["decode_programs"] == 1
    assert got["pool_shape"][2] == lm.cfg.num_heads // TP


def test_mesh_rejects_indivisible_shapes(lm, ranks, serving_mesh_2):
    """JAX :99 and the other construction refusals, in JAX's words."""
    import jax

    from gradaccum_tpu.models.gpt_decode import truncate_draft_params
    from gradaccum_tpu.parallel.mesh import make_mesh
    from gradaccum_tpu.serving import Engine

    got = _same(ranks, "refusals")
    draft, dcfg = truncate_draft_params(lm.params, lm.jcfg, 1)

    def jax_error(c=lm.jcfg, **kw):
        with pytest.raises(ValueError) as e:
            Engine(lm.params, c, num_slots=2, max_len=32, **dict(dict(mesh=serving_mesh_2), **kw))
        return str(e.value)

    want = {
        "num_blocks": jax_error(page_size=4, num_blocks=7),
        "num_heads": jax_error(dataclasses.replace(lm.jcfg, num_heads=1)),
        "intermediate_size": jax_error(dataclasses.replace(lm.jcfg, intermediate_size=63)),
        "vocab_size": jax_error(dataclasses.replace(lm.jcfg, vocab_size=97)),
        "draft": jax_error(speculate_k=2, draft_params=draft,
                           draft_cfg=dataclasses.replace(dcfg, num_heads=1)),
        "axis": jax_error(mesh=make_mesh([("data", TP)], devices=jax.devices()[:TP])),
    }
    assert got == want
    assert "num_blocks" in got["num_blocks"]


def test_a_tree_that_is_neither_whole_nor_a_block_is_refused(lm, ranks):
    """The embedding's rows decide how a tree is placed: a config whose
    vocab matches neither them nor tp times them is refused, naming both."""
    got = _same(ranks, "tree_refusal")
    v = lm.cfg.vocab_size
    assert got is not None
    assert f"{v} rows" in got and f"({v + TP})" in got and f"({(v + TP) // TP})" in got


def test_spec_parity_tp_mesh(lm, ranks, serving_mesh_2):
    """``test_serving_spec.py:240``: the draft on its head-split cache and
    the verify step at tp=2, greedy, token for token; the draft shares the
    target's placed table."""
    from gradaccum_tpu.models.gpt_decode import truncate_draft_params

    got = _same(ranks, "spec")
    draft, dcfg = truncate_draft_params(lm.params, lm.jcfg, 1)
    trace, jrecords, _ = _jax_mesh_run(lm, SPEC, serving_mesh_2, draft_params=draft,
                                       draft_cfg=dcfg)
    assert got["records"] == jrecords
    for item, (_, tokens, status) in zip(trace, got["records"]):
        assert status == "done" and tokens == _jax_solo(lm, item.prompt, item.max_new_tokens)
    assert got["decode_programs"] == 1
    assert got["draft_shape"][2] == lm.cfg.num_heads // TP
    assert got["shared"] == [True]


def test_collectives_per_micro_step_and_cycle_equal_the_design(lm, ranks):
    """A micro-step sums the lookup and, per layer, the attention and FFN
    outputs (``reduce_from``), and gathers the logits once: 2L + 2. A
    speculative cycle runs k + 1 draft steps (L_d = 1) and one verify."""
    layers, k, draft_layers = lm.cfg.num_layers, SPEC["engine"]["speculate_k"], 1
    tick = _same(ranks, "calls_tick")
    block = 2
    assert tick == {"model/all_reduce": block * (1 + 2 * layers),
                    "model/all_reduce:reduce_from": block * (1 + 2 * layers),
                    "model/all_gather": block, "model/all_gather:gather": block}
    cycle = _same(ranks, "calls_cycle")
    sums = (k + 1) * (1 + 2 * draft_layers) + (1 + 2 * layers)
    assert cycle == {"model/all_reduce": sums, "model/all_reduce:reduce_from": sums,
                     "model/all_gather": k + 2, "model/all_gather:gather": k + 2}


def test_recover_after_a_seeded_fault_gives_the_calm_streams(lm, ranks):
    got = _same(ranks, "recover")
    calm, _ = _port_engine_streams(lm, port_prompts())
    assert got["streams"] == calm
    assert got["fired"] == 1 and got["failed"] and got["allocated"] == 0
    for p, (tokens, _) in zip(port_prompts(), got["streams"]):
        assert tokens == _port_solo(lm, p, PORT_NEW)


def test_preemption_through_the_host_swap_store_keeps_the_streams(lm, ranks):
    """Each rank's swap record holds its own heads: half the bytes of the
    tp=1 engine's record of the same preemption."""
    from gradaccum_tpu_torch.serving import Engine

    got = _same(ranks, "swap")
    calm, _ = _port_engine_streams(lm, port_prompts())
    assert got["preempted"] is True and got["streams"] == calm
    e = Engine(lm.tree, lm.cfg, device="cpu", swap="host", **PORT)
    rids = [e.submit(p, PORT_NEW, rng_seed=i) for i, p in enumerate(port_prompts())]
    e.step()
    e.step()
    assert e.preempt(rids[0])
    e.run_until_idle()
    one = e.metrics.summary()
    assert got["swap_bytes_out"] > 0 and got["swap_bytes_out"] * TP == one["swap_bytes_out"]
    assert got["swap_bytes_in"] * TP == one["swap_bytes_in"]


def test_tiered_swap_records_go_to_each_ranks_own_store(lm, ranks):
    """A record demoted to the disk rung holds the rank's heads in the
    rank's own store directory (never a file another rank can see); the
    stream resumes from it unchanged."""
    calm, _ = _port_engine_streams(lm, port_prompts())
    assert len({r["tiered"]["dir"] for r in ranks}) == TP
    for r in ranks:
        assert r["tiered"]["files"] == ["swap_0.npz"]
        assert r["tiered"]["disk_bytes"] > 0
        assert r["tiered"]["streams"] == calm


def test_int8_kv_on_the_paged_pool(lm, ranks):
    got = _same(ranks, "int8")
    want, e = _port_engine_streams(lm, port_prompts(), cache_dtype="int8")
    assert got["streams"] == want
    assert got["shape"][2] * TP == list(e.pool.k.q.shape)[2]


def test_grow_and_checkpoint_swap_with_the_whole_trees_digest(lm, ranks):
    """A grow mid-stream keeps every stream, a count the model axis does
    not divide is refused in JAX's words, and a checkpoint swap serves the
    new weights; ``params_digest`` of the whole tree equals tp=1's, before
    and after."""
    from gradaccum_tpu_torch.serving import reconfig

    got = _same(ranks, "reconfig")
    calm, _ = _port_engine_streams(lm, port_prompts())
    assert got["streams"] == calm
    blocks = PORT["num_slots"] * PORT["max_len"] // PORT["page_size"]
    assert got["refused"] == (f"num_blocks {blocks + 3} not divisible by the model axis (2) — "
                              "the paged pool shards its BLOCK axis")
    assert got["grow"]["ok"] and got["grow"]["preempted"] == 0
    assert got["grow"]["detail"]["new_num_blocks"] == blocks + 8
    assert got["pool_shape"][1] == blocks + 8 + 1
    assert got["pool_shape"][2] == lm.cfg.num_heads // TP
    assert got["swap"]["ok"] and got["swap"]["detail"]["weights_unchanged"] is False
    assert got["digest"] == reconfig.params_digest(lm.tree)
    assert got["digest_after"] == reconfig.params_digest(lm.other_tree)
    for p, (tokens, status) in zip(port_prompts(), got["streams_after"]):
        assert status == "done" and tokens == _port_solo(lm, p, PORT_NEW, tree=lm.other_tree)


def test_replicated_fleet_at_tp2_steps_and_drains_to_parity(lm, ranks):
    """``ReplicatedEngine(replicas=2, tp=2)`` on JAX's fleet trace: solo
    streams, ids on disjoint lattices, one signature and no block left per
    replica, ``mesh`` tags on every ``serve/tick`` span, a group per
    replica and one copy of the weights; ``drain()`` to parity."""
    got = _same(ranks, "fleet")
    trace = trace_of(FLEET)
    for item, (rid, tokens, status) in zip(trace, got["records"]):
        assert status == "done" and tokens == _jax_solo(lm, item.prompt, item.max_new_tokens)
    rids = [r[0] for r in got["records"]]
    assert len(set(rids)) == len(rids) and {r % 2 for r in rids} == {0, 1}
    assert got["per_replica"] == [[1, 0, True]] * 2
    assert got["manifest_mesh"] == {"model": TP} and got["tp"] == TP
    assert got["engine_meshes"] == [{"model": TP}] * 2
    assert got["tick_meshes"] == ["model=2"] and got["tick_replicas"] == [0, 1]
    assert got["tags"] == {"replicas": 2, "mesh": "model=2"}
    assert got["groups_distinct"] and got["weights_shared"]
    assert got["table_rows"] * TP == lm.cfg.vocab_size
    drained = _same(ranks, "drain")
    assert drained["idle"]
    for (p, n), (tokens,) in zip(drain_prompts(), drained["streams"]):
        assert tokens == _port_solo(lm, p, n)


# -- without a spawn ---------------------------------------------------------------------


def test_serving_mesh_refusal_in_jax_words():
    import jax

    from gradaccum_tpu.parallel.mesh import serving_mesh as jax_serving_mesh
    from gradaccum_tpu_torch.parallel.mesh import serving_mesh

    n = len(jax.devices())
    with pytest.raises(ValueError) as want:
        jax_serving_mesh(n + 1)
    with pytest.raises(ValueError) as got:
        serving_mesh(2)  # this process alone: one rank
    assert str(got.value) == str(want.value).replace(str(n), "1").replace(str(n + 1), "2")
    with pytest.raises(ValueError, match=r"serving mesh needs 1 <= tp <= 1 devices, got 0"):
        serving_mesh(0)
    assert serving_mesh(1).shape == {"model": 1}


def test_one_rank_mesh_engine_reads_as_jaxs(lm):
    """``Engine(mesh=serving_mesh(1))``: manifest, tags and the server's
    ``stats()["mesh"]`` as JAX's one-device mesh engine's; solo streams."""
    from gradaccum_tpu.parallel.mesh import serving_mesh as jax_serving_mesh
    from gradaccum_tpu.serving import Engine as JaxEngine
    from gradaccum_tpu_torch.parallel.mesh import serving_mesh
    from gradaccum_tpu_torch.serving import Engine, ServingServer

    want = JaxEngine(lm.params, lm.jcfg, num_slots=2, max_len=32, page_size=4,
                     mesh=jax_serving_mesh(1))
    e = Engine(lm.tree, lm.cfg, num_slots=2, max_len=32, page_size=4, mesh=serving_mesh(1),
               device="cpu")
    assert e.manifest()["mesh"] == want.manifest()["mesh"] == {"model": 1}
    assert e.obs_tags() == want.obs_tags() == {"mesh": "model=1"}
    p = port_prompts()[0]
    with ServingServer(e) as server:
        tokens, reason = server.submit(p, 5).result(timeout=120)
        stats = server.stats()
    assert stats["mesh"] == {"model": 1}
    assert list(tokens) == _port_solo(lm, p, 5) and reason == "length"


def test_serving_smoke_paged_mesh():
    """``serving_smoke --device cpu --paged --mesh dp,tp`` passes."""
    from gradaccum_tpu_torch.examples import serving_smoke

    assert serving_smoke.main(["--device", "cpu", "--paged", "--mesh", "dp,tp"]) == 0
