"""Process groups: the port's counterpart of ``gradaccum_tpu/parallel/mesh.py``.

The reference's distribution layer is a two-worker
``MultiWorkerMirroredStrategy`` with ring collectives over a ``TF_CONFIG``
cluster; JAX lays the same workers out as a 1-D ``Mesh`` over the ``data``
axis of one program. In PyTorch each rank is a process of its own, joined
by ``torch.distributed``: NCCL between cards, gloo on the CPU. A
:class:`DataMesh` holds that process group, this process's ``rank`` of
``world`` and its device, under the axis name ``"data"``.

Every collective the data-parallel slice issues lives here, in one place:
the SUM all-reduce (of one tensor, or of a list of tensors flattened into
one buffer per dtype, so that a whole gradient tree costs one call), the
all-gather along a dimension, the broadcast from rank 0, and the pmin of a
boolean flag. Each call adds one to ``DataMesh.calls`` under its op (and
under ``op:tag`` when the caller tags it), so tests and ``chip_smoke.py``
can count the collectives of a step.

Gloo runs on CUDA tensors too (two ranks that share one card use it):
the torch this port runs on the card took all-reduce, broadcast and
all-gather on CUDA tensors directly (``chip_smoke.py`` phase 19 asks it
each run), so no op stages through host memory.

A collective that fails raises: nothing falls back to one rank or to the
CPU. Every group is created with a finite timeout, so a rank whose peer
died stops waiting instead of blocking forever.
"""

from __future__ import annotations

import datetime
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

DEFAULT_TIMEOUT_S = 300.0

_BOUND: Dict[str, "DataMesh"] = {}  # axis name -> the mesh that binds it


class DataMesh:
    """A 1-D data-parallel mesh over the process group of
    :func:`initialize_multihost`: ``world`` ranks, one process and one
    device each. ``shape`` is ``{"data": world}``, as JAX's ``mesh.shape``.
    Build it with :func:`data_parallel_mesh`."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str,
                 axis: str = DATA_AXIS):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.axis = axis
        self.calls: Counter = Counter()

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.world}

    def __repr__(self) -> str:
        return (f"DataMesh({self.axis}={self.world}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    # -- bookkeeping ------------------------------------------------------

    def _count(self, op: str, tag: Optional[str]) -> None:
        self.calls[op] += 1
        if tag:
            self.calls[f"{op}:{tag}"] += 1

    def reset_calls(self) -> None:
        self.calls.clear()

    # -- collectives ------------------------------------------------------

    @staticmethod
    @torch.no_grad()
    def _flat_(tensors: Sequence[torch.Tensor], op) -> None:
        """``op`` on one flat buffer per dtype holding ``tensors``, whose
        values are then copied back in place. The copies move no value (at
        one rank the result is the input bit for bit)."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            op(flat)
            offset = 0
            for t in group:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n

    def all_reduce_(self, tensor: torch.Tensor, tag: Optional[str] = None) -> torch.Tensor:
        """SUM ``tensor`` over the ranks, in place."""
        self._count("all_reduce", tag)
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
        return tensor

    def all_reduce_tensors_(self, tensors: Sequence[torch.Tensor],
                            tag: Optional[str] = None) -> None:
        """SUM every tensor of ``tensors`` over the ranks, in place: one
        collective per dtype, so a whole gradient tree costs one call."""
        self._flat_(tensors, lambda flat: self.all_reduce_(flat, tag))

    def pmean(self, tensor: torch.Tensor, tag: Optional[str] = None) -> torch.Tensor:
        """The mean of ``tensor`` over the ranks (a new tensor)."""
        out = tensor.detach().clone()
        self.all_reduce_(out, tag)
        return out / self.world

    def pmin_flag(self, flag: torch.Tensor, tag: Optional[str] = None) -> torch.Tensor:
        """A 0-d bool: True only where ``flag`` is True on every rank."""
        self._count("pmin", tag)
        x = flag.to(torch.int32).reshape(1)
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        return x.reshape(()) > 0

    def broadcast_(self, tensor: torch.Tensor, src: int = 0,
                   tag: Optional[str] = None) -> torch.Tensor:
        """Overwrite ``tensor`` with rank ``src``'s, in place."""
        self._count("broadcast", tag)
        dist.broadcast(tensor, src=src)
        return tensor

    def broadcast_tensors_(self, tensors: Sequence[torch.Tensor], src: int = 0,
                           tag: Optional[str] = None) -> None:
        """:meth:`broadcast_` of a list of tensors, one call per dtype."""
        self._flat_(tensors, lambda flat: self.broadcast_(flat, src, tag))

    def all_gather(self, tensor: torch.Tensor, dim: int = 0,
                   tag: Optional[str] = None) -> torch.Tensor:
        """Every rank's ``tensor`` concatenated along ``dim`` in rank order
        (JAX's ``all_gather(..., tiled=True)``), in ``tensor``'s dtype."""
        self._count("all_gather", tag)
        src = tensor.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        dist.barrier()


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda", backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join this process to the cluster (the ``TF_CONFIG`` slot).

    ``coordinator_address`` is ``host:port`` of rank 0's store,
    ``num_processes`` the world size and ``process_id`` this rank. Each
    defaults to the variables ``torchrun`` sets (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with neither, it raises.
    ``device="cuda"`` takes ``cuda:{LOCAL_RANK}`` (a card per rank); an
    explicit index (``"cuda:0"``) pins it, as two ranks that share one card
    need. The backend is NCCL for CUDA devices and gloo for the CPU unless
    ``backend`` names one (gloo on CUDA tensors is allowed). The group's
    collectives time out after ``timeout_s`` seconds.

    Returns ``{"process_index", "process_count", "device", "backend"}``.
    Calling it again in an initialized process raises."""
    if dist.is_initialized():
        raise RuntimeError("initialize_multihost: this process already joined a "
                           "process group")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs coordinator_address, num_processes "
                         "and process_id, or the MASTER_ADDR, MASTER_PORT, WORLD_SIZE "
                         "and RANK variables torchrun sets")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost: device 'cuda' was asked for but "
                               "no CUDA device is available; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    backend = backend or _backend_for(dev)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = dev  # binds the communicator eagerly
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _STATE["device"] = dev
    return {"process_index": process_id, "process_count": num_processes,
            "device": dev, "backend": backend}


_STATE: Dict[str, torch.device] = {}


def data_parallel_mesh(num_devices: Optional[int] = None,
                       axis: str = DATA_AXIS) -> DataMesh:
    """The 1-D ``data`` mesh over every rank of the initialized group
    (:func:`initialize_multihost`), bound to ``axis``: a step built with
    ``GradAccumConfig(axis_name=axis)`` reduces over it. ``num_devices``,
    when given, must equal the world size (a rank per device)."""
    if not dist.is_initialized():
        raise RuntimeError("data_parallel_mesh: call initialize_multihost first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"mesh axes {{'{axis}': {num_devices}}} need exactly "
                         f"{num_devices} devices, have {world}")
    mesh = DataMesh(rank, world, _STATE["device"], dist.get_backend(), axis)
    _BOUND[axis] = mesh
    return mesh


def axis_mesh(axis: str) -> DataMesh:
    """The mesh bound to ``axis`` in this process; JAX's error otherwise."""
    mesh = _BOUND.get(axis)
    if mesh is None:
        raise NameError(f"unbound axis name: {axis}")
    return mesh


def shutdown() -> None:
    """Leave the process group and unbind every axis."""
    _BOUND.clear()
    _STATE.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
