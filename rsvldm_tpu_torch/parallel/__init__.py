"""The parallel layer (rsvldm_tpu/parallel): process groups, the (data,
tile) mesh and one-axis meshes, the Llama decoder's tensor-parallel
shards, and sequence parallelism (parallel/sequence.py: attention over a
sequence split across ranks, the GPipe pipeline), on torch.distributed."""

from .mesh import (make_mesh, batch_sharding, put_batch, replicate,
                   replicate_state, shard_tiled_gn_apply)
from .sequence import (gpipe_apply, sequence_parallel_attention,
                       stack_stage_params)
