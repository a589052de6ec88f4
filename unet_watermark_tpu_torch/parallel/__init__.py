"""More than one card (parallel/ in the JAX package) on torch.distributed:
one process a card, the group formed by torchrun or by initialize()."""
from .distributed import (
    initialize,
    make_slice_aware_mesh,
    process_batch_slice,
)
from .mesh import (
    batch_sharding,
    local_batch_size,
    make_mesh,
    mesh_from_config,
    pad_batch_to,
    replicated,
    shard_batch,
)

__all__ = [
    "batch_sharding",
    "local_batch_size",
    "make_mesh",
    "mesh_from_config",
    "pad_batch_to",
    "replicated",
    "shard_batch",
    "initialize",
    "make_slice_aware_mesh",
    "process_batch_slice",
]
