"""Data, tensor, expert, sequence and pipeline parallelism, and the
attention cores beyond the flash kernels (the port of
``gradaccum_tpu/parallel``).

Ported: the process-group meshes (``mesh``: the 1-D data mesh and the
multi-axis ``make_mesh``, with the differentiable ``ppermute`` and
``all_to_all``), batch and parameter placement with JAX's regex rules
(``sharding``), the Megatron rules and collectives (``tp``), the
data-parallel steps (``dp``), ZeRO-1 with or without rules (``zero``), the
CrossShardOptimizer wrapper (``cross_shard``), the blockwise and ring
attention cores (``ring_attention``), Ulysses attention (``ulysses``), the
data × seq step (``sp``) and the GPipe schedule (``pp``).
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
    Mesh,
    axis_mesh,
    data_parallel_mesh,
    initialize_multihost,
    make_hybrid_mesh,
    make_mesh,
)
from gradaccum_tpu_torch.parallel.pp import (
    PipelineParams,
    PipelineSpec,
    PPState,
    make_pp_train_step,
    pipeline_apply,
    pp_global_state,
    pp_init,
    pp_local_state,
    stack_stage_params,
)
from gradaccum_tpu_torch.parallel.ring_attention import (
    SEQ_BATCH_KEYS,
    blockwise_attention,
    make_ring_attention_fn,
    ring_attention,
    shard_seq_batch,
)
from gradaccum_tpu_torch.parallel.sharding import (
    P,
    PartitionSpec,
    batch_shard,
    gather_params,
    host_shard,
    param_shardings,
    replicate_,
    shard_params,
    spec_for,
)
from gradaccum_tpu_torch.parallel.sp import make_dp_sp_train_step
from gradaccum_tpu_torch.parallel.tp import bert_tp_ep_rules, bert_tp_rules, gpt_tp_rules
from gradaccum_tpu_torch.parallel.ulysses import make_ulysses_attention_fn, ulysses_attention
from gradaccum_tpu_torch.parallel.zero import (
    make_zero1_placement_step,
    make_zero1_train_step,
    shard_dim,
    zero1_gather_state,
    zero1_optimizer,
    zero1_partition_specs,
    zero1_shard_state,
    zero1_state_specs,
)
