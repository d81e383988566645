"""Continuous-batching inference on the KV-cache decode path, for the port.

The port of ``gradaccum_tpu/serving/`` for the path that serves: a fixed
pool of decode slots (``cache_pool.CachePool``) or a paged pool of blocks
addressed through page tables (``PagedCachePool``), stepped by the engine's
tick of ``decode_block`` micro-steps (``engine``) with admissions
batch-prefilled into free slots; the bounded FIFO with backpressure and
deadlines (``scheduler``); TTFT, throughput and occupancy telemetry
(``metrics``); and the threaded front-end and the seeded simulation driver
(``server``). Greedy and seeded-sampled outputs equal
``models/gpt_decode.py :: generate_cached`` token for token.

Prefix sharing, speculation, admission control and swap, int8 KV,
reconfiguration, replica fleets and the serving fault contract are not
ported yet: their knobs raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from gradaccum_tpu_torch.serving.cache_pool import (
    BlockTableCorruption,
    CachePool,
    PagedCachePool,
    PoolPressure,
)
from gradaccum_tpu_torch.serving.engine import Engine, StepEvents
from gradaccum_tpu_torch.serving.metrics import ServingMetrics
from gradaccum_tpu_torch.serving.scheduler import QueueFull, Request, Scheduler
from gradaccum_tpu_torch.serving.server import (
    ServingServer,
    SimulationDriver,
    StreamHandle,
    TraceItem,
)

__all__ = [
    "BlockTableCorruption",
    "CachePool",
    "Engine",
    "PagedCachePool",
    "PoolPressure",
    "QueueFull",
    "Request",
    "Scheduler",
    "ServingMetrics",
    "ServingServer",
    "SimulationDriver",
    "StepEvents",
    "StreamHandle",
    "TraceItem",
]
