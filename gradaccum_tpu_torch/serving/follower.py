"""The server over a multi-rank serving mesh: rank 0 leads, the others follow.

JAX's mesh engine is one GSPMD process, so JAX's ``ServingServer`` serves it
as it serves any engine. The port's mesh engine runs one process per rank
under the SPMD contract (``parallel/mesh.py :: serving_mesh``): every rank
makes the same engine calls in the same order. A server keeps that
contract as leader and followers:

- every rank builds ``ServingServer(engine, ...)`` with the same arguments
  (the control groups below are created in the same order on every rank);
- rank 0 runs it: its client threads submit, cancel and reconfigure, and
  its loop(s) tick the engine. Each engine call that changes state is
  recorded as a command; before each tick the loop sends the commands
  recorded since its last tick, then the tick itself, to the followers;
- ranks > 0 call :meth:`ServingServer.follow`, which applies each command
  in order and steps when rank 0 steps. A follower holds no handles and
  decides nothing: request ids, recover and requeue decisions, the
  watchdog, the sentinel, the SLO evaluator, the healer's rungs and the
  give-up all run on rank 0 and reach the followers as commands.

The commands of one tick travel as host bytes in ONE all-gather of a
:data:`FRAME`-byte frame over a gloo group of their own (gloo cannot move
a CUDA tensor point to point, and a group of their own never interleaves
with the mesh's collectives); a batch longer than the frame sends the rest
in one broadcast. The all-gather needs every follower, so a follower that
died or hangs fails rank 0's next exchange within the group's timeout
(``follower_timeout``), and rank 0's server then fails every handle with
:class:`FollowerLost`. An idle leader sends an empty batch every quarter
of that timeout, so an idle server never times its followers out.

A free-running fleet (``ReplicatedEngine(tp > 1)``, ``free_running=True``)
has one channel per replica: replica ``i``'s loop on rank 0 pairs with
replica ``i``'s follower thread. An operation across replicas (a
fleet-wide reconfiguration, a hedge of a SUSPECT member's waiting work, an
excision) runs on rank 0 under every replica lock, and is sent on every
channel behind the commands still pending there; the follower threads meet
at a rendezvous and one of them applies it while the others wait, so
every replica on every rank has applied the same commands before it.

A fault injected on every rank at the same tick leaves every rank
recovered the same way: a follower whose tick raised waits for rank 0's
recover command. A follower whose state parts from rank 0's (its tick
differs from the one rank 0 stamps on a step, or it faulted where rank 0
did not) raises :class:`Diverged` and stops following.
"""

from __future__ import annotations

import datetime
import pickle
import threading
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

FRAME = 8192  # bytes of one exchange: an 8-byte length, then the batch
DEFAULT_FOLLOWER_TIMEOUT_S = 60.0


class FollowerLost(RuntimeError):
    """A control exchange with the followers failed or timed out: a
    follower rank died or hangs. Rank 0's server fails every handle."""


class Diverged(RuntimeError):
    """A follower's engine parted from rank 0's (a tick count or a request
    id that differs, or a fault on one side only)."""


class ControlChannel:
    """One control group over the mesh's ranks (rank 0 leads). Every rank
    creates it, in the same order (``dist.new_group``)."""

    def __init__(self, ranks, timeout_s: float = DEFAULT_FOLLOWER_TIMEOUT_S):
        self.ranks = [int(r) for r in ranks]
        self.timeout_s = float(timeout_s)
        self.group = dist.new_group(self.ranks, backend="gloo",
                                    timeout=datetime.timedelta(seconds=self.timeout_s))
        self.leader = dist.get_rank() == self.ranks[0]
        self.pending: List[tuple] = []  # the leader's commands not yet sent
        self.open = True
        self.exchanges = 0
        self.commands = 0
        self.host_s = 0.0
        self.last = time.monotonic()

    def exchange(self, batch: Optional[list] = None) -> list:
        """The leader sends ``batch`` (its pending commands are the caller's
        to include); a follower receives the leader's. Raises
        :class:`FollowerLost` when the exchange fails or times out."""
        t0 = time.perf_counter()
        frame = torch.zeros(FRAME, dtype=torch.uint8)
        payload = b""
        if self.leader:
            payload = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
            head = len(payload).to_bytes(8, "little") + payload[:FRAME - 8]
            frame[:len(head)] = torch.frombuffer(bytearray(head), dtype=torch.uint8)
        frames = [torch.empty_like(frame) for _ in self.ranks]
        try:
            dist.all_gather(frames, frame, group=self.group)
            lead = frames[0].numpy().tobytes()
            n = int.from_bytes(lead[:8], "little")
            body = lead[8:8 + min(n, FRAME - 8)]
            if n > FRAME - 8:
                rest = torch.zeros(n - (FRAME - 8), dtype=torch.uint8)
                if self.leader:
                    rest.copy_(torch.frombuffer(bytearray(payload[FRAME - 8:]), dtype=torch.uint8))
                dist.broadcast(rest, src=self.ranks[0], group=self.group)
                body += rest.numpy().tobytes()
        except Exception as exc:  # noqa: BLE001 — gloo's error or its timeout
            self.open = False
            raise FollowerLost(f"control exchange over ranks {self.ranks} failed: {exc}") from exc
        out = batch if self.leader else pickle.loads(body)
        self.exchanges += 1
        self.commands += len(out)
        self.host_s += time.perf_counter() - t0
        self.last = time.monotonic()
        return out

    def flush(self, *tail) -> None:
        """Leader: send the pending commands and ``tail`` in one exchange."""
        batch, self.pending = self.pending + list(tail), []
        self.exchange(batch)

    def stats(self) -> dict:
        return {"exchanges": self.exchanges, "commands": self.commands,
                "host_s": self.host_s}


class _Rendezvous:
    """Where a free-running follower's replica threads meet for an
    operation across replicas: once every thread still following has
    arrived, the operation is applied once and every thread goes on. A
    thread that stops following leaves; ``abort`` releases every waiter
    with the error."""

    def __init__(self, parties: int):
        self.parties = parties
        self._cond = threading.Condition()
        self._arrived = 0
        self._generation = 0
        self._apply = None
        self._error: Optional[BaseException] = None

    def _release(self) -> None:
        if self._arrived and self._arrived >= self.parties:
            try:
                self._apply()
            except BaseException as exc:  # noqa: BLE001 — every waiter raises it
                self._error = exc
            finally:
                self._arrived = 0
                self._apply = None
                self._generation += 1
                self._cond.notify_all()

    def meet(self, apply) -> None:
        with self._cond:
            gen = self._generation
            self._arrived += 1
            self._apply = apply
            self._release()
            while self._generation == gen and self._error is None:
                self._cond.wait(0.5)
            if self._error is not None:
                raise self._error

    def join(self) -> None:
        """A new thread takes part from the next operation on."""
        self.parties += 1  # called from an apply, under the condition

    def leave(self) -> None:
        with self._cond:
            self.parties -= 1
            self._release()

    def abort(self, error: BaseException) -> None:
        with self._cond:
            if self._error is None:
                self._error = error
            self._cond.notify_all()


def _pop(engine, rid: int) -> None:
    try:
        engine.pop_result(rid)
    except KeyError:
        pass  # already reconciled


class Follower:
    """Applies rank 0's commands on a follower rank (see the module
    docstring). Built by :meth:`ServingServer.follow`; :meth:`run` blocks
    until rank 0's stop, and raises what ended a channel otherwise."""

    def __init__(self, engine, channels: List[ControlChannel], free_running: bool,
                 new_channel=None):
        self.engine = engine
        self.fleet = hasattr(engine, "replicas")
        self.channels = channels
        self.free_running = free_running
        self._new_channel = new_channel
        self._meet = _Rendezvous(len(channels)) if free_running else None
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self.ticks = 0

    def run(self) -> None:
        if not self.free_running:
            self._follow(None)
            return
        for i in range(len(self.channels)):
            self._start(i)
        while True:
            with self._lock:
                live = [t for t in self._threads if t.is_alive()]
            if not live:
                break
            live[0].join(0.1)
        if self._errors:
            raise self._errors[0]

    def _start(self, i: int) -> None:
        th = threading.Thread(target=self._thread, args=(i,), daemon=True,
                              name=f"serving-follower-{i}")
        with self._lock:
            self._threads.append(th)
        th.start()

    def _thread(self, i: int) -> None:
        try:
            self._follow(i)
        except BaseException as exc:  # noqa: BLE001 — raised by run()
            self._errors.append(exc)
            self._meet.abort(exc)
        finally:
            self._meet.leave()

    def _target(self, replica: Optional[int]):
        return self.engine if replica is None else self.engine.replicas[replica]

    def _follow(self, replica: Optional[int]) -> None:
        """One channel's loop: receive a batch, apply it in order."""
        chan = self.channels[0 if replica is None else replica]
        state = {"faulted": None}
        while True:
            for op in chan.exchange():
                if op[0] == "stop":
                    return
                if op[0] == "global":
                    self._meet.meet(lambda op=op: self._apply(op[1], state, replica))
                else:
                    self._apply(op, state, replica)

    def _apply(self, op: tuple, state: dict, replica: Optional[int]) -> None:
        kind, engine = op[0], self.engine
        if kind == "submit":
            _, target, rid, prompt, max_new, kw = op
            e = self._target(target)
            e._next_id = rid  # rank 0 assigns the ids; this rank adopts them
            got = e.submit(prompt, max_new, **kw)
            if got != rid:
                raise Diverged(f"submit issued request id {got}, rank 0 issued {rid}")
            if target is not None:
                engine._note_warmup_admit(target)
        elif kind == "cancel":
            if engine.cancel(op[1]):
                _pop(engine, op[1])
        elif kind == "recover":
            _, target, retired = op
            e = self._target(target)
            for req in e.recover():
                e.results.pop(req.request_id, None)
                e.status.pop(req.request_id, None)
            for rid in retired:
                _pop(e, rid)
            state["faulted"] = None
        elif kind == "step":
            _, target, tick = op
            e = self._target(target)
            if state["faulted"] is not None:
                raise Diverged(f"this rank's tick {e.tick_count} raised "
                               f"{state['faulted']!r} and rank 0 stepped on") \
                    from state["faulted"]
            if e.tick_count != tick:
                raise Diverged(f"rank 0 steps tick {tick}, this rank is at {e.tick_count}")
            try:
                events = e.step()
            except Exception as exc:  # noqa: BLE001 — rank 0 sends the recover
                state["faulted"] = exc
                return
            self.ticks += 1
            for rid, _ in events.finished:
                _pop(engine, rid)
        elif kind == "reconfig":
            self._reconfig(*op[1:])
        elif kind == "hedge":
            for src, plan in op[1]:
                engine._hedge_replica(src, plan=plan)
        elif kind == "pin":
            _, target, tick, ticks = op
            self._target(target).admission_policy.pin(tick, ticks)
        else:
            raise Diverged(f"unknown command {kind!r}")

    def _reconfig(self, spec, cursors, proof) -> None:
        """Apply one reconfiguration as rank 0 applied it. A refusal or an
        injected crash raises here as it raised on rank 0: rank 0's recover
        command follows where its server recovers."""
        from gradaccum_tpu_torch.serving import reconfig as reconfig_lib

        engine = self.engine
        for e, nxt in zip(getattr(engine, "replicas", [engine]), cursors):
            e._next_id = nxt
        scale = self.fleet and spec.kind == reconfig_lib.REPLICA_SCALE
        try:
            if scale and spec.action == "excise":
                engine.excise_replica(spec.replica, proof=proof)
            elif scale and spec.action == "drain":
                engine.reconfigure(spec, resubmit=False)
            else:
                engine.reconfigure(spec)
        except Exception:  # noqa: BLE001 — rank 0 saw the same
            return
        if scale and spec.action == "add" and self.free_running:
            # the newcomer's channel, created where rank 0 creates its own
            self.channels.append(self._new_channel())
            self._meet.join()
            self._start(len(self.channels) - 1)


def command_submit(target: Optional[int], rid: int, prompt, max_new: int, **kw) -> tuple:
    return ("submit", target, int(rid), np.asarray(prompt, np.int32).reshape(-1),
            int(max_new), kw)
