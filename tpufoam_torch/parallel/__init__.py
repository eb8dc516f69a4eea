"""Meshes of devices, fields resident per block, the domain-decomposed
PISO step and the process group (the counterpart of tpufoam/parallel)."""

from .blocks import BlockField
from .distributed import (DistributedConfig, global_device_mesh,
                          init_distributed, is_multihost)
from .mesh import (AxisType, Mesh, Shards, device_mesh,
                   make_sharded_piso_step, make_sharded_sst_step,
                   make_sharded_train_step, mlp_partition_specs, shard_case,
                   shard_flow, shard_turbulence, unshard_case, unshard_flow,
                   unshard_params, unshard_turbulence)

__all__ = ["AxisType", "BlockField", "DistributedConfig", "Mesh", "Shards",
           "device_mesh", "global_device_mesh", "init_distributed",
           "is_multihost", "make_sharded_piso_step", "make_sharded_sst_step",
           "make_sharded_train_step", "mlp_partition_specs", "shard_case",
           "shard_flow", "shard_turbulence", "unshard_case", "unshard_flow",
           "unshard_params", "unshard_turbulence"]
