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

In a world of several processes `global_device_mesh` builds one mesh of
every process's devices, in the order JAX's global mesh takes them
(process by process, each its devices in order), and each process owns
the blocks on its own devices. The blocks of the domain-decomposed step
(parallel.blocks) then move their halo strips between processes with
`p2p` (point-to-point copies: NCCL between cards, gloo on the CPU) and
join their reductions with `all_gather_blocks`.
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
    """`device_mesh` over every process's devices: this process's
    `devices` (every visible card when None; ["cpu"] * n names n blocks
    of the CPU) after those of the lower ranks, as JAX's global mesh
    orders them. In a world of one process that is `device_mesh`'s mesh;
    in a larger one each process must give the same number of devices,
    and each owns the blocks on its own (`Mesh.owners`)."""
    from .mesh import Mesh, _device, device_mesh
    if not is_multihost():
        return device_mesh(shape=shape, axis_names=axis_names,
                           devices=devices)
    import torch.distributed as dist
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mine = [str(_device(d)) for d in devices]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if len({len(d) for d in every}) != 1:
        raise ValueError(f"global_device_mesh: the processes give "
                         f"{[len(d) for d in every]} devices")
    # another process's devices stand in its blocks' places; only this
    # process's are ever used here
    whole = device_mesh(shape=shape, axis_names=axis_names,
                        devices=[d for rank in every for d in rank])
    per = len(mine)
    return Mesh(whole.devices, whole.axis_names, whole.axis_types,
                owners=tuple(k // per for k in range(whole.size)),
                rank=dist.get_rank())


def p2p(sends, recvs) -> list:
    """Point-to-point copies between the processes of the world, posted
    together and waited for: `sends` [(tensor, peer, tag)], `recvs`
    [(shape, dtype, device, peer, tag)]; returns the received tensors in
    the order of `recvs`. Every process posts its part of one exchange in
    the same global order, so the copies between two processes pair up
    in order (and by tag)."""
    import torch.distributed as dist
    out = [torch.empty(shape, dtype=dtype, device=device)
           for shape, dtype, device, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer, tag=tag)
           for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, tag=tag)
            for t, (_, _, _, peer, tag) in zip(out, recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def all_gather_blocks(local: torch.Tensor, group=None) -> list:
    """Every process's `local` (one shape and dtype on every process), in
    rank order; over `group`'s processes (a torch.distributed group) when
    given, else over the world."""
    import torch.distributed as dist
    out = [torch.empty_like(local)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, local.contiguous(), group=group)
    return out


def mesh_groups(mesh) -> tuple:
    """The process groups of a world's mesh: (rows, columns), entry i of
    rows the group of the processes that own a block of mesh row i, entry
    j of columns that of mesh column j; None where this process is not in
    the group or is alone in it (nothing to exchange). gloo on the CPU,
    NCCL between cards. Every process of the world calls it at the same
    point (torch.distributed.new_group's contract). The processes own
    their blocks row-major, the same number each, so every process of a
    row's (a column's) group owns as many of its blocks as every other,
    and their ranks run in mesh order; a mesh cut otherwise raises."""
    import torch.distributed as dist
    dy, dx = len(mesh.devices), len(mesh.devices[0])
    per = mesh.owners.count(mesh.rank)
    if dx % per and per % dx:
        raise ValueError(f"mesh_groups: {per} blocks a process do not cut "
                         f"rows of {dx} blocks evenly")
    backend = "nccl" if mesh.lead.type == "cuda" else "gloo"

    def groups(lines):
        out = []
        for line in lines:
            ranks = sorted({mesh.owners[k] for k in line})
            g = dist.new_group(ranks, backend=backend)
            out.append(g if mesh.rank in ranks and len(ranks) > 1 else None)
        return out

    return (groups([[i * dx + j for j in range(dx)] for i in range(dy)]),
            groups([[i * dx + j for i in range(dy)] for j in range(dx)]))
