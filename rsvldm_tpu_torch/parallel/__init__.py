"""The parallel layer (rsvldm_tpu/parallel): process groups, the (data,
tile) mesh and the Llama decoder's tensor-parallel shards, on
torch.distributed. The JAX package's sequence parallelism (parallel/
sequence.py: ring attention, GPipe stages) is not ported yet."""

from .mesh import (make_mesh, batch_sharding, put_batch, replicate,
                   replicate_state, shard_tiled_gn_apply)
