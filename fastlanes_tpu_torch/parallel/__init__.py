"""Distribution layer: process-group meshes and the sharded codecs.

The port of fastlanes_tpu/parallel/: independent 1024-value blocks are
embarrassingly data-parallel, so the block axis splits over a 1-D mesh of
ranks, one process per device; per-batch scalars (FoR references, a shared
delta base) are replicated; packed outputs can be all-gathered in vector
order. Collectives run over `torch.distributed` (NCCL on CUDA, gloo on the
CPU)."""

from .mesh import local_device_count, make_mesh, setup_distributed
from .shard import (
    all_gather_packed,
    global_max_bits,
    sharded_for_pack,
    sharded_pack,
    sharded_roundtrip_check,
    sharded_undelta_pack,
    sharded_unfor_pack,
    sharded_unpack,
    sharded_unzdelta_pack,
)

__all__ = [
    "make_mesh", "local_device_count", "setup_distributed",
    "sharded_pack", "sharded_unpack", "sharded_undelta_pack", "sharded_unzdelta_pack",
    "sharded_unfor_pack", "sharded_for_pack", "global_max_bits",
    "all_gather_packed", "sharded_roundtrip_check",
]
