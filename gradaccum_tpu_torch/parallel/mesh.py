"""Process groups: the port's counterpart of ``gradaccum_tpu/parallel/mesh.py``.

The reference's distribution layer is a two-worker
``MultiWorkerMirroredStrategy`` with ring collectives over a ``TF_CONFIG``
cluster; JAX lays the same workers out as a 1-D ``Mesh`` over the ``data``
axis of one program. In PyTorch each rank is a process of its own, joined
by ``torch.distributed``: NCCL between cards, gloo on the CPU. A
:class:`DataMesh` holds that process group, this process's ``rank`` of
``world`` and its device, under the axis name ``"data"``.

:func:`make_mesh` lays the ranks out on several named axes (``data``,
``model``, ``expert``: JAX's ``make_mesh``) and gives each rank a
:class:`DataMesh` per axis, over the subgroup of ranks that differ only in
that axis, so tensor and expert parallelism issue their collectives over
the right ranks.

Every collective the mesh paths issue lives here, in one place:
the SUM all-reduce (of one tensor, or of a list of tensors flattened into
one buffer per dtype, so that a whole gradient tree costs one call), the
all-gather along a dimension, the broadcast from rank 0, the MIN of a
boolean flag or of an int vector, and two differentiable ones that
sequence and pipeline parallelism need: :meth:`DataMesh.ppermute` (JAX's
``lax.ppermute``: each rank sends its tensor to one rank of a permutation,
and a rank that receives nothing gets zeros; its backward is the inverse
permutation) and :meth:`DataMesh.all_to_all` (JAX's tiled
``lax.all_to_all``; its backward is the inverse all-to-all). Each call
adds one to ``DataMesh.calls`` under its op (and under ``op:tag`` when the
caller tags it), so tests and ``chip_smoke.py`` can count the collectives
of a step.

Both differentiable ops run on ``all_to_all_single`` on every backend, a
permutation as an all-to-all whose chunks are empty but the one sent and
the one received. Gloo's point-to-point ``send``/``recv`` hand the
tensor's data pointer to the transport as host memory, so they cannot
move a CUDA tensor, while its all-to-all takes CUDA tensors
(``chip_smoke.py`` phase 23 asks both on each run and checks the values
received).

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
import itertools
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

DEFAULT_TIMEOUT_S = 300.0

SOLO = object()  # the group of a one-rank axis: no collective is issued

_BOUND: Dict[str, "DataMesh"] = {}  # axis name -> the mesh that binds it
_MESH: Dict[str, "Mesh"] = {}  # "current" -> the multi-axis mesh of this process


class DataMesh:
    """A 1-D mesh: ``world`` ranks, one process and one device each, under
    one axis name. ``shape`` is ``{axis: world}``, as JAX's ``mesh.shape``.
    :func:`data_parallel_mesh` builds it over the whole process group of
    :func:`initialize_multihost`; :func:`make_mesh` builds one per axis of a
    multi-axis mesh, over the subgroup of ranks that differ only in that
    axis (``group``, with ``ranks`` their global ranks in order). A
    one-rank axis of a multi-axis mesh (``group`` is :data:`SOLO`) issues
    no collective: each op returns its input."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str,
                 axis: str = DATA_AXIS, group=None, ranks: Optional[Sequence[int]] = None):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.axis = axis
        self.group = group
        self.ranks = list(ranks) if ranks is not None else list(range(world))
        self.calls: Counter = Counter()

    @property
    def solo(self) -> bool:
        return self.group is SOLO

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
        if self.solo:
            return tensor
        self._count("all_reduce", tag)
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self.group)
        return tensor

    def all_reduce_tensors_(self, tensors: Sequence[torch.Tensor],
                            tag: Optional[str] = None) -> None:
        """SUM every tensor of ``tensors`` over the ranks, in place: one
        collective per dtype, so a whole gradient tree costs one call."""
        if self.solo:
            return
        self._flat_(tensors, lambda flat: self.all_reduce_(flat, tag))

    def pmean(self, tensor: torch.Tensor, tag: Optional[str] = None) -> torch.Tensor:
        """The mean of ``tensor`` over the ranks (a new tensor)."""
        out = tensor.detach().clone()
        self.all_reduce_(out, tag)
        return out / self.world

    def pmin_flag(self, flag: torch.Tensor, tag: Optional[str] = None) -> torch.Tensor:
        """A 0-d bool: True only where ``flag`` is True on every rank."""
        if self.solo:
            return flag.reshape(()).to(torch.bool)
        self._count("pmin", tag)
        x = flag.to(torch.int32).reshape(1)
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=self.group)
        return x.reshape(()) > 0

    def broadcast_(self, tensor: torch.Tensor, src: int = 0,
                   tag: Optional[str] = None) -> torch.Tensor:
        """Overwrite ``tensor`` with rank ``src``'s, in place."""
        if self.solo:
            return tensor
        self._count("broadcast", tag)
        dist.broadcast(tensor, src=self.ranks[src], group=self.group)
        return tensor

    def broadcast_tensors_(self, tensors: Sequence[torch.Tensor], src: int = 0,
                           tag: Optional[str] = None) -> None:
        """:meth:`broadcast_` of a list of tensors, one call per dtype."""
        self._flat_(tensors, lambda flat: self.broadcast_(flat, src, tag))

    def all_gather(self, tensor: torch.Tensor, dim: int = 0,
                   tag: Optional[str] = None) -> torch.Tensor:
        """Every rank's ``tensor`` concatenated along ``dim`` in rank order
        (JAX's ``all_gather(..., tiled=True)``), in ``tensor``'s dtype."""
        src = tensor.detach().contiguous()
        if self.solo:
            return src
        self._count("all_gather", tag)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=dim)

    def pmin_(self, tensor: torch.Tensor, tag: Optional[str] = None) -> torch.Tensor:
        """MIN of an integer ``tensor`` over the ranks, in place (a
        per-micro-batch verdict vector: bad on one rank is bad on all)."""
        if self.solo:
            return tensor
        self._count("pmin", tag)
        dist.all_reduce(tensor, op=dist.ReduceOp.MIN, group=self.group)
        return tensor

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]],
                 tag: Optional[str] = None) -> torch.Tensor:
        """JAX's ``lax.ppermute`` over this axis: rank ``src`` of each
        ``(src, dst)`` pair sends ``x`` to rank ``dst`` (ranks of this axis);
        a rank that receives nothing gets zeros. Differentiable: the
        gradient goes back along the inverse permutation."""
        if self.solo:
            dst = dict(perm).get(0)
            return x if dst == 0 else torch.zeros_like(x)
        return _PPermute.apply(x, self, tuple(perm), tag)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                   tag: Optional[str] = None) -> torch.Tensor:
        """JAX's tiled ``lax.all_to_all`` over this axis: ``x`` is cut into
        ``world`` chunks along ``split_dim``, chunk j goes to rank j, and the
        chunks received are concatenated along ``concat_dim`` in rank order.
        Differentiable: the backward is the inverse all-to-all."""
        if self.solo:
            return x
        if x.shape[split_dim] % self.world:
            raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(x.shape)} does "
                             f"not split into {self.world} chunks")
        return _AllToAll.apply(x, self, split_dim % x.dim(), concat_dim % x.dim(), tag)

    def _exchange(self, send: torch.Tensor, send_sizes: List[int],
                  recv_sizes: List[int], op: str, tag: Optional[str]) -> torch.Tensor:
        """One ``all_to_all_single`` of the flat ``send``: ``send_sizes[j]``
        elements to rank j, ``recv_sizes[j]`` from it."""
        self._count(op, tag)
        out = torch.empty(sum(recv_sizes), dtype=send.dtype, device=send.device)
        dist.all_to_all_single(out, send.contiguous(), recv_sizes, send_sizes,
                               group=self.group)
        return out

    def barrier(self) -> None:
        if not self.solo:
            dist.barrier(group=self.group)


def _permute(x: torch.Tensor, mesh: DataMesh, perm, tag) -> torch.Tensor:
    """The forward of :meth:`DataMesh.ppermute` (no autograd)."""
    sends = dict(perm)
    recvs = {dst: src for src, dst in perm}
    if len(sends) != len(perm) or len(recvs) != len(perm):
        raise ValueError(f"ppermute: {list(perm)} is not a permutation")
    n = x.numel()
    dst, src = sends.get(mesh.rank), recvs.get(mesh.rank)
    send_sizes = [n if j == dst else 0 for j in range(mesh.world)]
    recv_sizes = [n if j == src else 0 for j in range(mesh.world)]
    flat = x.detach().reshape(-1) if dst is not None else x.detach().reshape(-1)[:0]
    got = mesh._exchange(flat, send_sizes, recv_sizes, "ppermute", tag)
    return got.view(x.shape) if src is not None else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, perm, tag):
        ctx.mesh, ctx.perm, ctx.tag = mesh, perm, tag
        return _permute(x, mesh, perm, tag)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return _permute(g.contiguous(), ctx.mesh, inverse, ctx.tag), None, None, None


def _all_to_all(x: torch.Tensor, mesh: DataMesh, split_dim: int, concat_dim: int,
                tag) -> torch.Tensor:
    """The forward of :meth:`DataMesh.all_to_all` (no autograd)."""
    chunks = torch.stack(x.detach().chunk(mesh.world, dim=split_dim)).contiguous()
    size = chunks[0].numel()
    got = mesh._exchange(chunks.reshape(-1), [size] * mesh.world, [size] * mesh.world,
                         "all_to_all", tag)
    return torch.cat(got.view(chunks.shape).unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split_dim, concat_dim, tag):
        ctx.args = (mesh, split_dim, concat_dim, tag)
        return _all_to_all(x, mesh, split_dim, concat_dim, tag)

    @staticmethod
    def backward(ctx, g):
        mesh, split_dim, concat_dim, tag = ctx.args
        return _all_to_all(g, mesh, concat_dim, split_dim, tag), None, None, None, None


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


class Mesh:
    """A multi-axis mesh over every rank of the process group, JAX's
    ``Mesh`` layout: rank r sits at coordinates ``np.unravel_index(r,
    sizes)`` in the order the axes were given (the first axis varies
    slowest, as ``np.asarray(devices).reshape(sizes)`` lays devices out).

    :meth:`axis` is this rank's :class:`DataMesh` on one axis, over the
    ranks that share every other coordinate; :meth:`over` is the one over
    several axes at once (the ranks that share the remaining coordinates),
    which the norm, the guard and the MoE combine reduce over. Every group
    is created by :func:`make_mesh` on every rank in the same order, as
    ``dist.new_group`` requires. ``shape``, ``rank``, ``world``,
    ``device`` and ``backend`` read as a :class:`DataMesh`'s do; ``calls``
    counts each axis's collectives under ``"<axes>/<op>[:<tag>]"``."""

    def __init__(self, names, sizes, rank: int, device: torch.device, backend: str,
                 groups: Dict[tuple, DataMesh]):
        self.axis_names = tuple(names)
        self.sizes = tuple(sizes)
        self.rank = rank
        self.world = int(np.prod(sizes))
        self.device = torch.device(device)
        self.backend = backend
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
        self._groups = groups

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device}, backend={self.backend})"

    def axis(self, name: str) -> DataMesh:
        """This rank's mesh on axis ``name``; an axis the mesh does not
        have is a one-rank axis (JAX's ``mesh.shape.get(name, 1)``)."""
        return self.over((name,))

    def over(self, names) -> DataMesh:
        """This rank's mesh over the axes ``names`` together (in the
        mesh's axis order); axes of size 1 or absent drop out."""
        key = tuple(n for n in self.axis_names if n in names and self.shape[n] > 1)
        if not key:
            return DataMesh(0, 1, self.device, self.backend, "+".join(names) or DATA_AXIS,
                            group=SOLO, ranks=[self.rank])
        return self._groups[key]

    @property
    def calls(self) -> Counter:
        total: Counter = Counter()
        for key, m in self._groups.items():
            for op, n in m.calls.items():
                total[f"{'+'.join(key)}/{op}"] += n
        return total

    def reset_calls(self) -> None:
        for m in self._groups.values():
            m.reset_calls()

    def barrier(self) -> None:
        dist.barrier()


def _axis_sizes(axis_sizes, axes, n_devices: int):
    """``(names, sizes)`` with a single -1 resolved: JAX's rules and errors."""
    if axis_sizes is None:
        axis_sizes = list(axes.items())
    elif axes:
        raise ValueError("pass axis_sizes or keyword axes, not both")
    if not axis_sizes:
        axis_sizes = [(DATA_AXIS, -1)]
    names = [n for n, _ in axis_sizes]
    sizes = [s for _, s in axis_sizes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n_devices % known:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes {known}")
        sizes[sizes.index(-1)] = n_devices // known
    total = int(np.prod(sizes))
    if total != n_devices:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} need exactly {total} devices, "
            f"have {n_devices}; use -1 to absorb the remainder or pass an "
            "explicit devices= subset")
    return names, sizes


def make_mesh(axis_sizes: Optional[Sequence[Tuple[str, int]]] = None, **axes: int) -> Mesh:
    """The multi-axis mesh over every rank of the initialized group, from
    ``(name, size)`` pairs or keyword axes (``make_mesh(data=-1, model=2)``):
    a single ``-1`` absorbs the remaining ranks; JAX's errors word for word.

    Every rank creates, in the same order, one subgroup per subset of the
    axes of size > 1 and per coordinate of the other axes, and binds each
    one-axis mesh to its name (:func:`axis_mesh`), so a step built with
    ``GradAccumConfig(axis_name="data")`` reduces over the data axis."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_multihost first")
    world, rank = dist.get_world_size(), dist.get_rank()
    names, sizes = _axis_sizes(axis_sizes, axes, world)
    device, backend = _STATE["device"], dist.get_backend()
    grid = np.arange(world).reshape(sizes)
    live = [i for i, s in enumerate(sizes) if s > 1]
    groups: Dict[tuple, DataMesh] = {}
    for count in range(1, len(live) + 1):
        for subset in itertools.combinations(live, count):
            rest = [i for i in range(len(sizes)) if i not in subset]
            # the grid with the subset's axes last, one row per coordinate
            # of the other axes: each row is a group
            rows = np.transpose(grid, rest + list(subset)).reshape(-1, int(np.prod(
                [sizes[i] for i in subset])))
            key = tuple(names[i] for i in subset)
            for row in rows:
                members = [int(r) for r in row]
                if len(members) == world:
                    group = None  # every rank: the default group
                else:
                    group = dist.new_group(members)
                if rank in members:
                    groups[key] = DataMesh(members.index(rank), len(members), device, backend,
                                           "+".join(key), group=group, ranks=members)
    return bind_mesh(Mesh(names, sizes, rank, device, backend, groups))


def bind_mesh(mesh: Mesh) -> Mesh:
    """Make ``mesh`` this process's current mesh: each of its axis names
    binds to its one-axis mesh (:func:`axis_mesh`), as :func:`make_mesh`
    leaves the mesh it builds. A process that built several meshes binds
    the one its next step runs on."""
    for name in mesh.axis_names:
        _BOUND[name] = mesh.axis(name)
        _BOUND[name].axis = name
    _MESH["current"] = mesh
    return mesh


def make_hybrid_mesh(ici_axes: Sequence[Tuple[str, int]],
                     dcn_axes: Sequence[Tuple[str, int]]) -> Mesh:
    """JAX's single-slice case of the hybrid mesh: every DCN axis has size
    1, so the mesh is :func:`make_mesh` over the DCN axes (size 1, first)
    and the ICI axes. One host's ranks form one slice; a DCN axis wider
    than 1 raises."""
    dcn_sizes = [s for _, s in dcn_axes]
    if int(np.prod(dcn_sizes)) != 1:
        raise NotImplementedError(
            f"hybrid mesh dcn axes {list(dcn_axes)}: only one slice (every dcn axis "
            f"of size 1) is supported")
    return make_mesh(list(dcn_axes) + list(ici_axes))


def current_mesh() -> Optional[Mesh]:
    """The multi-axis mesh :func:`make_mesh` built in this process, or None."""
    return _MESH.get("current")


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
    _MESH.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
