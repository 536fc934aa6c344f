"""Multi-process scale-out (counterpart of ``neuma_tpu/parallel``)."""
from .distributed import Mesh, global_mesh, initialize, is_primary
from .halo import (
    make_halo_mpm_step,
    make_halo_sim_step,
    partition_particles,
    slab_width,
    unpartition,
)
from .sharding import (
    make_mesh,
    make_sharded_sim_step,
    pad_to_multiple,
    replicate,
    shard_particles,
)

__all__ = [
    "Mesh",
    "global_mesh",
    "initialize",
    "is_primary",
    "make_halo_mpm_step",
    "make_halo_sim_step",
    "make_mesh",
    "make_sharded_sim_step",
    "pad_to_multiple",
    "partition_particles",
    "replicate",
    "shard_particles",
    "slab_width",
    "unpartition",
]
