"""Data parallelism on ``torch.distributed``: one process a device, each
holding rows of the global batch (counterpart of ``audio2photoreal_tpu/parallel``)."""

from audio2photoreal_tpu_torch.parallel.mesh import (
    MeshSpec,
    create_mesh,
    data_mesh,
    local_mesh,
)
from audio2photoreal_tpu_torch.parallel.sharding import (
    batch_sharding,
    replicated,
    shard_batch,
)
from audio2photoreal_tpu_torch.parallel.distributed import (
    initialize,
    local_batch_size,
    per_process_seed,
    shard_batch_global,
    slice_for_process,
)

__all__ = [
    "MeshSpec",
    "create_mesh",
    "data_mesh",
    "local_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "initialize",
    "local_batch_size",
    "per_process_seed",
    "shard_batch_global",
    "slice_for_process",
]
