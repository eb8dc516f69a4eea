"""Meshes of devices, the spatially sharded PISO step and the process
group (the counterpart of tpufoam/parallel)."""

from .distributed import (DistributedConfig, global_device_mesh,
                          init_distributed, is_multihost)
from .mesh import (Mesh, device_mesh, make_sharded_piso_step,
                   make_sharded_train_step, mlp_partition_specs, shard_case,
                   shard_flow)

__all__ = ["DistributedConfig", "Mesh", "device_mesh", "global_device_mesh",
           "init_distributed", "is_multihost", "make_sharded_piso_step",
           "make_sharded_train_step", "mlp_partition_specs", "shard_case",
           "shard_flow"]
