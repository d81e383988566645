"""The server over a multi-rank serving mesh in the port, against JAX's.

JAX's ``ServingServer`` serves JAX's mesh engine in one GSPMD process. The
port's server leads from rank 0 and every other rank follows it
(``serving/follower.py``): one spawn of two gloo ranks on the CPU
(``test_torch_parallel.spawn_cases``, with a deadline) runs every case on
JAX's tiny LM (JAX's weights carried over through ``interop.py``). Rank 0
serves client threads, rank 1 calls ``follow()``; each rank saves what it
saw, and the tests hold the streams, token for token, to JAX's server over
JAX's ``Engine(mesh=serving_mesh(2))`` (or JAX's ``ReplicatedEngine(tp=2)``)
on the virtual CPU devices, on the same prompts:

- greedy and sampled streams through the lockstep server, and
  ``stats()["mesh"]``;
- a seeded ``MID_DECODE_TICK`` crash on both ranks, recovered and requeued
  through the server (the calm streams);
- a ``reconfigure`` pool grow mid-stream;
- ``ReplicatedEngine(replicas=2, tp=2)`` behind the lockstep and the
  free-running server;
- a follower killed mid-run: rank 0's handles fail with ``FollowerLost``
  within the deadline.

    python -m pytest -m torch tests/test_torch_serving_mesh_server.py
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

if __name__ != "__main__":  # under pytest (a rank imports no JAX)
    from test_torch_serving_mesh import lm  # noqa: F401 — JAX's tiny LM, carried

pytestmark = pytest.mark.torch

TP = 2
DEADLINE_S = 300
WAIT = 120
N_NEW = 8
PAGED = dict(num_slots=4, max_len=32, page_size=4)
SAMPLED = dict(num_slots=3, max_len=32, temperature=0.8, top_k=5)
FLEET = dict(num_slots=3, max_len=32, page_size=4)
FLEET_GROW = 32  # blocks, from 24
FAULT_TICK = 2
GROW = 8
KILL_AFTER_STEPS = 3
KILL_TIMEOUT_S = 10.0


def prompts(seed=41, n=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 96, int(rng.integers(3, 11))).astype(np.int32) for _ in range(n)]


def clients(server, ps, n_new=N_NEW, threads=4):
    """``[[tokens, reason]]`` per prompt, submitted by ``threads`` client
    threads (request ``i`` with ``rng_seed=i``)."""
    out, errors = [None] * len(ps), []

    def work(k):
        try:
            hs = [(i, server.submit(ps[i], n_new, rng_seed=i)) for i in range(k, len(ps), threads)]
            for i, h in hs:
                tokens, reason = h.result(timeout=WAIT)
                out[i] = [[int(t) for t in tokens], reason]
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ths = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    if errors:
        raise errors[0]
    return out


# --------------------------------------------------------------------------
# the ranks: python -m tests.test_torch_serving_mesh_server <outdir>
# --------------------------------------------------------------------------


def _serve(server, rank, body):
    """Rank 0 starts ``server`` and runs ``body(server)``; rank 1 follows."""
    if rank != 0:
        server.follow()
        return None
    server.start()
    try:
        return body(server)
    finally:
        server.stop()


def _rank_cases(outdir, rank):
    from gradaccum_tpu_torch.parallel.mesh import serving_mesh
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import (
        Engine,
        ReplicatedEngine,
        ServingServer,
        reconfig,
    )
    from tests.test_torch_serving_mesh import _cfg, _tree

    cfg, tree, ps = _cfg(), _tree(outdir, "params"), prompts()
    out = {}

    def engine(**kw):
        return Engine(tree, cfg, mesh=serving_mesh(TP), device="cpu", **kw)

    # greedy and sampled through the lockstep server
    for name, knobs in (("greedy", PAGED), ("sampled", SAMPLED)):
        server = ServingServer(engine(**knobs))

        def body(s):
            streams = clients(s, ps)
            return dict(streams=streams, mesh=s.stats()["mesh"], control=s.control_stats())

        out[name] = _serve(server, rank, body)
    # a seeded crash on both ranks at one tick: recovered, requeued
    injector = faults.FaultInjector(faults.FaultSchedule(
        [faults.FaultSpec(faults.MID_DECODE_TICK, at=FAULT_TICK, kind=faults.KIND_CRASH)]))
    server = ServingServer(engine(**PAGED), max_requeues=1)
    with faults.installed(injector):
        if rank == 0:
            handles = [server.submit(p, N_NEW, rng_seed=i) for i, p in enumerate(ps)]
        got = _serve(server, rank, lambda s: [
            [[int(t) for t in h.result(timeout=WAIT)[0]], h.result()[1]] for h in handles])
    out["fault"] = dict(streams=got, fired=len(injector.fired))
    # a pool grow through the server, mid-stream
    eng = engine(**PAGED)
    blocks = eng.num_blocks
    server = ServingServer(eng)

    def grow(s):
        handles = [s.submit(p, N_NEW, rng_seed=i) for i, p in enumerate(ps)]
        res = s.reconfigure(reconfig.pool_resize(blocks + GROW), timeout=WAIT)
        streams = [[[int(t) for t in h.result(timeout=WAIT)[0]], h.result()[1]]
                   for h in handles]
        return dict(streams=streams, ok=res.ok, preempted=res.preempted,
                    new_num_blocks=res.detail["new_num_blocks"])

    out["grow"] = dict(_serve(server, rank, grow) or {}, num_blocks=eng.num_blocks,
                       pool_blocks=int(eng.pool.k.shape[1]))
    # the fleet at tp=2, lockstep and free running
    for name, free in (("fleet", False), ("free", True)):
        fleet = ReplicatedEngine(tree, cfg, replicas=2, tp=TP, device="cpu", **FLEET)
        server = ServingServer(fleet, free_running=free)

        def body(s):
            st = s.stats()
            got = dict(streams=clients(s, ps), per_replica_mesh=[
                p["mesh"] for p in st["per_replica"]], free_running=st.get("free_running", False))
            if free:  # operations across replicas: every follower thread meets
                got.update(fleet_ops(s, reconfig))
            return got

        out[name] = dict(_serve(server, rank, body) or {}, replicas=len(fleet.replicas),
                         issued=sum((sorted(e.results) for e in fleet.replicas), []),
                         blocks=[e.num_blocks for e in fleet.replicas])
    return out


def fleet_ops(server, rc):
    """A drain, a pool grow of the active replicas, an activation and a
    replica add through a fleet's server (``rc``: its package's
    ``serving.reconfig``), then other prompts: ``{"ops": [ok, ...],
    "after": streams}``."""
    specs = [rc.replica_drain(1), rc.pool_resize(FLEET_GROW), rc.replica_activate(1),
             rc.replica_add()]
    ops = [bool(server.reconfigure(spec, timeout=WAIT).ok) for spec in specs]
    return dict(ops=ops, after=clients(server, prompts(seed=43)))


def _kill_case(rank):
    """Rank 1 dies after a few ticks; rank 0's handles must fail with
    ``FollowerLost`` within the deadline instead of hanging the server."""
    from gradaccum_tpu_torch.parallel.mesh import serving_mesh
    from gradaccum_tpu_torch.serving import Engine, ServingServer
    from gradaccum_tpu_torch.serving import follower as follower_lib
    from tests.test_torch_serving_mesh import _cfg, _tree

    cfg = _cfg()
    tree = _tree(os.environ["MESH_SERVER_OUTDIR"], "params")
    server = ServingServer(Engine(tree, cfg, mesh=serving_mesh(TP), device="cpu", **PAGED),
                           follower_timeout=KILL_TIMEOUT_S)
    if rank != 0:
        apply, seen = follower_lib.Follower._apply, []

        def dying(self, op, state, replica):
            if op[0] == "step":
                seen.append(op)
                if len(seen) > KILL_AFTER_STEPS:
                    os._exit(0)  # a follower that dies mid-run
            return apply(self, op, state, replica)

        follower_lib.Follower._apply = dying
        server.follow()
        return None
    server.start()
    t0 = time.monotonic()
    handles = [server.submit(p, 16, rng_seed=i) for i, p in enumerate(prompts(n=4))]
    errors = []
    for h in handles:
        try:
            h.result(timeout=WAIT)
            errors.append(None)
        except RuntimeError as e:
            cause = e.__cause__
            errors.append(type(cause).__name__)
    elapsed = time.monotonic() - t0
    try:
        server.stop()
        stop_error = None
    except RuntimeError as e:
        stop_error = type(e.__cause__).__name__
    return dict(errors=errors, elapsed_s=elapsed, stop_error=stop_error)


def _rank_main(outdir):
    from gradaccum_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    os.environ["MESH_SERVER_OUTDIR"] = outdir
    info = mesh_lib.initialize_multihost(device="cpu", timeout_s=60)
    rank = info["process_index"]
    with torch.no_grad():
        out = _rank_cases(outdir, rank)
        if rank != 0:  # this rank dies in the next case: save first
            np.savez(os.path.join(outdir, f"rank{rank}.npz"), result=np.asarray(json.dumps(out)))
        out["kill"] = _kill_case(rank)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), result=np.asarray(json.dumps(out)))
    try:
        mesh_lib.shutdown()
    except Exception:  # noqa: BLE001 — the peer is gone by design
        pass
    print(json.dumps({"ok": True}))
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    _rank_main(sys.argv[1])


# --------------------------------------------------------------------------
# the tests (JAX on the virtual CPU devices of tests/conftest.py)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(lm, tmp_path_factory):
    from test_torch_parallel import spawn_cases

    outdir = tmp_path_factory.mktemp("serving_mesh_server")
    torch.save(lm.state, outdir / "params.pt")
    got = spawn_cases("tests.test_torch_serving_mesh_server", outdir, world=TP,
                      deadline_s=DEADLINE_S)
    return [json.loads(str(r["result"])) for r in got]


def _jax_serve(lm, engine, body, **server_kw):
    from gradaccum_tpu.serving import ServingServer

    server = ServingServer(engine, **server_kw).start()
    try:
        return body(server)
    finally:
        server.stop()


def _jax_engine(lm, mesh, **kw):
    from gradaccum_tpu.serving import Engine

    return Engine(lm.params, lm.jcfg, mesh=mesh, **kw)


@pytest.mark.parametrize("leg,knobs", [("greedy", PAGED), ("sampled", SAMPLED)])
def test_lockstep_streams_equal_jax_server_over_its_mesh_engine(lm, ranks, serving_mesh_2,
                                                                leg, knobs):
    """Client threads on rank 0 through the lockstep server over
    ``Engine(mesh=serving_mesh(2))``: every stream is JAX's server's over
    JAX's mesh engine; ``stats()["mesh"]`` reports the real width; one
    exchange carried each tick's commands."""
    got = ranks[0][leg]
    want = _jax_serve(lm, _jax_engine(lm, serving_mesh_2, **knobs),
                      lambda s: (clients(s, prompts()), s.stats()["mesh"]))
    assert got["streams"] == want[0]
    assert all(reason == "length" for _, reason in got["streams"])
    assert got["mesh"] == want[1] == {"model": TP}
    ctl = got["control"]
    assert ctl["channels"] == 1 and ctl["exchanges"] >= 1
    # every submit, and one step per tick, went to the follower
    assert ctl["commands"] >= len(prompts()) + N_NEW
    assert ranks[1][leg] is None


def test_seeded_fault_on_both_ranks_requeues_to_the_calm_streams(lm, ranks, serving_mesh_2):
    """A ``MID_DECODE_TICK`` crash at one tick on both ranks: rank 0's
    server recovers and requeues, the follower applies rank 0's recover,
    and every stream is JAX's server's under the same schedule."""
    from gradaccum_tpu.resilience import faults as jfaults

    got = ranks[0]["fault"]
    injector = jfaults.FaultInjector(jfaults.FaultSchedule(
        [jfaults.FaultSpec(jfaults.MID_DECODE_TICK, at=FAULT_TICK, kind=jfaults.KIND_CRASH)]))
    from gradaccum_tpu.serving import ServingServer

    server = ServingServer(_jax_engine(lm, serving_mesh_2, **PAGED), max_requeues=1)
    with jfaults.installed(injector):
        handles = [server.submit(p, N_NEW, rng_seed=i) for i, p in enumerate(prompts())]
        server.start()
        try:
            want = [[[int(t) for t in h.result(timeout=WAIT)[0]], h.result()[1]]
                    for h in handles]
        finally:
            server.stop()
    assert got["streams"] == want
    assert got["fired"] == ranks[1]["fault"]["fired"] == len(injector.fired) == 1


def test_pool_grow_through_the_server_keeps_every_stream(lm, ranks, serving_mesh_2):
    """``server.reconfigure(pool_resize(+8))`` mid-stream: no preemption,
    every stream JAX's, and both ranks' pools grew."""
    from gradaccum_tpu.serving import reconfig as jreconfig

    got = ranks[0]["grow"]
    eng = _jax_engine(lm, serving_mesh_2, **PAGED)
    blocks = eng.pool.num_blocks

    def grow(s):
        handles = [s.submit(p, N_NEW, rng_seed=i) for i, p in enumerate(prompts())]
        res = s.reconfigure(jreconfig.pool_resize(blocks + GROW), timeout=WAIT)
        return res, [[[int(t) for t in h.result(timeout=WAIT)[0]], h.result()[1]]
                     for h in handles]

    res, want = _jax_serve(lm, eng, grow)
    assert got["streams"] == want
    assert got["ok"] and res.ok and got["preempted"] == res.preempted == 0
    assert got["new_num_blocks"] == res.detail["new_num_blocks"] == blocks + GROW
    for r in ranks:
        assert r["grow"]["num_blocks"] == blocks + GROW
        assert r["grow"]["pool_blocks"] == blocks + GROW + 1  # and the trash block


@pytest.mark.parametrize("leg", ["fleet", "free"])
def test_fleet_at_tp2_behind_the_server_equals_jax(lm, ranks, leg):
    """``ReplicatedEngine(replicas=2, tp=2)`` behind the lockstep and the
    free-running server: every stream is JAX's free-running or lockstep
    server's over JAX's ``ReplicatedEngine(tp=2)``; each replica reports
    its mesh; every result was popped on both ranks. Free running, a
    drain, a grow, an activation and a replica add go through the server
    as through JAX's, and the streams after them are JAX's too."""
    from gradaccum_tpu.serving import ReplicatedEngine
    from gradaccum_tpu.serving import reconfig as jreconfig

    got = ranks[0][leg]
    free = leg == "free"
    fleet = ReplicatedEngine(lm.params, lm.jcfg, replicas=2, tp=TP, **FLEET)

    def body(s):
        return clients(s, prompts()), (fleet_ops(s, jreconfig) if free else None)

    want, ops = _jax_serve(lm, fleet, body, free_running=free)
    assert got["streams"] == want
    assert got["per_replica_mesh"] == [{"model": TP}] * 2
    assert got["free_running"] is free
    for r in ranks:
        assert r[leg]["issued"] == []
        assert r[leg]["replicas"] == len(fleet.replicas) == (3 if free else 2)
        assert r[leg]["blocks"] == [e.pool.num_blocks for e in fleet.replicas]
    if free:
        # the drain, grow, activation and add reached the follower's
        # threads through their rendezvous; the newcomer has a channel
        assert got["ops"] == ops["ops"] == [True] * 4
        assert got["after"] == ops["after"]


def test_a_killed_follower_fails_rank_zeros_handles_within_the_deadline(ranks):
    """The follower exits after a few ticks: every handle on rank 0 fails
    with ``FollowerLost`` within ``follower_timeout`` (plus a tick), the
    server's ``stop()`` re-raises it, and nothing hangs."""
    got = ranks[0]["kill"]
    assert got["errors"] == ["FollowerLost"] * 4
    assert got["elapsed_s"] < KILL_TIMEOUT_S + 10
    assert got["stop_error"] == "FollowerLost"


# -- without a spawn ---------------------------------------------------------------------


def test_a_one_rank_server_has_no_followers(lm):
    """Off a multi-rank mesh nothing changes: no channel, ``follow()``
    refuses, ``control_stats()`` is None."""
    from gradaccum_tpu_torch.parallel.mesh import serving_mesh
    from gradaccum_tpu_torch.serving import Engine, ServingServer

    e = Engine(lm.tree, lm.cfg, mesh=serving_mesh(1), device="cpu", **PAGED)
    server = ServingServer(e)
    assert server.control_stats() is None
    with pytest.raises(RuntimeError, match="ranks > 0"):
        server.follow()
    with server:
        tokens, reason = server.submit(prompts()[0], 4).result(timeout=WAIT)
    assert reason == "length" and len(tokens) == 4
