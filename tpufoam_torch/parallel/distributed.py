"""Process-group bootstrap for runs across processes: the counterpart of
tpufoam/parallel/distributed.py (jax.distributed).

One process drives every card of its host through the mesh of
parallel.mesh, as JAX's single controller drives every local chip. A run
across processes (several hosts, or one process per card) also needs a
process group, so that every process agrees on the world before any
collective: this module is the one place that knows about that
bootstrap.

Environment contract (torchrun's): MASTER_ADDR and MASTER_PORT name the
rendezvous, WORLD_SIZE the number of processes and RANK this process.
Nothing on a GPU host announces a cluster, so the world is given in full
or not at all: the JAX module's `_on_tpu_pod`, which lets jax detect a
TPU pod's world from its metadata, has no counterpart.

The mesh of parallel.mesh has no exchange between processes yet (the
halo exchange is a copy between the blocks of one process), so
`global_device_mesh` raises in a world of more than one process.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .. import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Resolved bootstrap parameters for torch.distributed."""
    master_addr: str | None = None
    master_port: int | None = None
    world_size: int | None = None
    rank: int | None = None

    @staticmethod
    def from_env(env: dict | None = None) -> "DistributedConfig":
        env = os.environ if env is None else env

        def geti(key):
            v = env.get(key)
            return int(v) if v not in (None, "") else None

        return DistributedConfig(
            master_addr=env.get("MASTER_ADDR") or None,
            master_port=geti("MASTER_PORT"),
            world_size=geti("WORLD_SIZE"),
            rank=geti("RANK"))

    @property
    def explicit(self) -> bool:
        """True when the environment or the arguments give the whole
        world."""
        return None not in (self.master_addr, self.master_port,
                            self.world_size, self.rank)

    @property
    def init_method(self) -> str:
        return f"tcp://{self.master_addr}:{self.master_port}"


def init_distributed(cfg: DistributedConfig | None = None,
                     force: bool = False, device=DEFAULT_DEVICE) -> bool:
    """Join the process group once per process: NCCL for CUDA devices,
    gloo when `device` is the CPU. Returns True if the group is (or
    already was) initialised, False when no world is configured and
    `force` is not set; nothing is touched then. `force` initialises from
    torch.distributed's own environment defaults."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    cfg = cfg or DistributedConfig.from_env()
    if not (cfg.explicit or force):
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if cfg.explicit:
        dist.init_process_group(backend, init_method=cfg.init_method,
                                world_size=cfg.world_size, rank=cfg.rank)
    else:
        dist.init_process_group(backend)
    return True


def is_multihost() -> bool:
    """True in a process group of more than one process."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def global_device_mesh(shape=None, axis_names=("data", "model"),
                       devices=None):
    """`device_mesh` over this process's devices. In a world of one
    process that is every device of the run; in a larger world it
    raises, since the mesh has no exchange between processes."""
    from .mesh import device_mesh
    if is_multihost():
        raise NotImplementedError(
            "global_device_mesh: a mesh across processes needs an exchange "
            "between processes, which is not ported yet")
    return device_mesh(shape=shape, axis_names=axis_names, devices=devices)
