"""Continuous-batching inference on the KV-cache decode path, for the port.

The port of ``gradaccum_tpu/serving/`` for the path that serves: a fixed
pool of decode slots (``cache_pool.CachePool``) or a paged pool of blocks
addressed through page tables (``PagedCachePool``), stepped by the engine's
tick of ``decode_block`` micro-steps (``engine``) with admissions
batch-prefilled into free slots; the bounded FIFO with backpressure and
deadlines (``scheduler``); TTFT, throughput and occupancy telemetry
(``metrics``); and the threaded front-end and the seeded simulation driver
(``server``). Prefix sharing with copy-on-write tails
(``cache_pool.PrefixCache``), speculative decoding with a draft model,
admission control with preemption (``admission``: the policy and the victim
ranking; ``swap``: the host store; ``memory/tiers.py``: the host and disk
ladder), int8 KV pools and overlapped prefill ride on the same engine.
Greedy and seeded-sampled outputs equal ``models/gpt_decode.py ::
generate_cached`` token for token, through any preemption (speculative
sampling follows JAX's accept rule draw for draw).

The serving fault contract rides on the same engine: its tick fires the
serving fault points, ``Engine.recover`` releases what a failed tick held,
and the server requeues the recovered requests (bounded), breaks stalled
ticks with a watchdog and feeds the live ops plane (``obs/sentinel.py``,
``obs/slo.py``, ``obs/telemetry.py``). Live reconfiguration (``reconfig``:
pool resize, checkpoint swap, replica scale) parks every in-flight stream
through the preempt path and resumes it token for token at the new shape.
``ReplicatedEngine`` (``replicated``) runs N engines on the one card behind
the same server surface, supervised by ``fleet``'s leases (SUSPECT, DEAD,
proof-gated excision, live ``replica_add``); ``ServingServer(free_running=
True)`` runs one loop thread per replica, and ``ServingServer(healer=)``
polls the self-healing ladder (``resilience/healer.py``) on its loop. The
serving mesh runs an engine tensor-parallel, one process per rank
(``Engine(mesh=parallel.mesh.serving_mesh(tp))``, ``ReplicatedEngine(tp>1)``)
under the SPMD contract in ``engine``'s docstring; a ``ServingServer`` over a
multi-rank mesh raises ``NotImplementedError`` naming ROADMAP.md item 5j.
"""

from gradaccum_tpu_torch.serving.admission import (
    AdmissionPolicy,
    LengthQuantileEstimator,
)

from gradaccum_tpu_torch.serving.cache_pool import (
    BlockTableCorruption,
    CachePool,
    PagedCachePool,
    PoolPressure,
    PrefixCache,
)
from gradaccum_tpu_torch.serving.engine import Engine, StepEvents
from gradaccum_tpu_torch.serving.fleet import ExciseProof, FleetSupervisor
from gradaccum_tpu_torch.serving.metrics import ServingMetrics
from gradaccum_tpu_torch.serving.reconfig import (
    ReconfigError,
    ReconfigResult,
    ReconfigSpec,
    checkpoint_swap,
    pool_resize,
    replica_activate,
    replica_add,
    replica_drain,
    replica_excise,
)
from gradaccum_tpu_torch.serving.replicated import ReplicatedEngine
from gradaccum_tpu_torch.serving.scheduler import QueueFull, Request, Scheduler
from gradaccum_tpu_torch.serving.swap import HostSwapStore, SwapCapacityError, SwapError
from gradaccum_tpu_torch.serving.server import (
    ServingServer,
    SimulationDriver,
    StreamHandle,
    TraceItem,
)

__all__ = [
    "AdmissionPolicy",
    "BlockTableCorruption",
    "CachePool",
    "Engine",
    "ExciseProof",
    "FleetSupervisor",
    "HostSwapStore",
    "LengthQuantileEstimator",
    "PagedCachePool",
    "PoolPressure",
    "PrefixCache",
    "QueueFull",
    "ReconfigError",
    "ReconfigResult",
    "ReconfigSpec",
    "ReplicatedEngine",
    "Request",
    "Scheduler",
    "ServingMetrics",
    "ServingServer",
    "SimulationDriver",
    "StepEvents",
    "StreamHandle",
    "SwapCapacityError",
    "SwapError",
    "TraceItem",
    "checkpoint_swap",
    "pool_resize",
    "replica_activate",
    "replica_add",
    "replica_drain",
    "replica_excise",
]
