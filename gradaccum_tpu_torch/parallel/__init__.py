"""Data parallelism and the attention cores beyond the flash kernels (the
port of ``gradaccum_tpu/parallel``).

Ported: the process-group mesh (``mesh``), batch and parameter placement
(``sharding``), the data-parallel steps (``dp``), ZeRO-1 (``zero``), the
CrossShardOptimizer wrapper (``cross_shard``) and the single-device
``blockwise_attention`` (``ring_attention``). Tensor, sequence, expert and
pipeline parallelism, and the mesh-bound ring and Ulysses cores, wait for
model parallelism (ROADMAP.md).
"""

from gradaccum_tpu_torch.parallel.cross_shard import cross_shard_optimizer
from gradaccum_tpu_torch.parallel.dp import make_dp_train_step, make_pjit_dp_train_step
from gradaccum_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    DataMesh,
    axis_mesh,
    data_parallel_mesh,
    initialize_multihost,
)
from gradaccum_tpu_torch.parallel.ring_attention import blockwise_attention
from gradaccum_tpu_torch.parallel.sharding import (
    batch_shard,
    host_shard,
    replicate_,
    shard_params,
)
from gradaccum_tpu_torch.parallel.zero import (
    make_zero1_placement_step,
    make_zero1_train_step,
    shard_dim,
    zero1_gather_state,
    zero1_optimizer,
    zero1_shard_state,
    zero1_state_specs,
)
