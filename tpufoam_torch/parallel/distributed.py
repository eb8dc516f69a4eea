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
(parallel.blocks) then move their halo strips and gathered fields
between processes with `exchange` (point-to-point copies, `p2p`: NCCL
between cards, gloo on the CPU) and join their reductions with
`gather_blocks` (an all-gather, `all_gather_blocks`).

Reverse mode across processes. A copy from another process arrives in a
fresh buffer, which autograd cannot follow back to the sender's block.
Inside `world_tape()` (and where autograd records) `exchange` and
`gather_blocks` run as autograd Functions: the backward of a copy sends
each received tensor's gradient back to the process that sent it, which
adds it into the gradient of what it sent; the backward of an
all-gather gives each process the sum over every process of the
gradients of its own entries (an all-reduce of the gradients, each
process keeping its own rows). The forward's values are those of the
plain copies, bit for bit.

The loss convention: each process differentiates the sum of its own
blocks' terms, and the world's gradient is the sum over the processes
(`WorldTape.grad` sums it). A loss every process holds alike (a
`block_sum`, a replicated scalar) is one term of the world, not one a
process: pass it on one process and 0 on the others, as in
`tape.grad(total if dist.get_rank() == 0 else 0, [x])`, so that it is
counted once.

Every process must post every backward exchange, in the same order, or
the world deadlocks: a backward that autograd runs on one process and
skips on another (its outputs reach no loss there, or no input asked
for) would wait for ever. So the tape threads a token through its
Functions in the order the forward called them, and `WorldTape.grad`
takes the gradient of the last token too, with respect to the first:
every Function of the tape then runs on every process, in the reverse
of the forward's order (each waits for the token's gradient from the
next). Outside a tape a world's copies are not differentiable, so a
copy of a tensor that needs a gradient raises: a world's forward that
records a gradient runs inside `world_tape()` (one under
`torch.no_grad()` needs none).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os

import torch
from torch.autograd.function import once_differentiable

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


# ---- reverse mode across processes ------------------------------------------

_TAPE = contextvars.ContextVar("world_tape", default=None)


class WorldTape:
    """The exchanges of one forward over `mesh` across processes,
    chained by a token (see the module docstring): `root` is the chain's
    first token (a leaf that needs a gradient, made at the first
    exchange), `last` its newest. On a mesh of one process it takes a
    plain gradient."""

    def __init__(self, mesh):
        self.world = mesh.owners is not None
        self.root = self.last = None

    def _token(self, device) -> torch.Tensor:
        if self.root is None:
            self.root = self.last = torch.zeros((), device=device,
                                                requires_grad=True)
        return self.last

    def grad(self, loss, inputs) -> tuple:
        """The world's gradient of `loss` (this process's term of the
        world's loss, a tensor or 0) w.r.t. `inputs`, every Function of
        the tape run on every process, summed over the processes (the
        same on every process). Zeros for an input the loss does not
        reach. Ends the chain: the next exchange starts a new one."""
        import torch.distributed as dist
        inputs = list(inputs)
        if not isinstance(loss, torch.Tensor):    # no term of its own: 0
            loss = torch.tensor(float(loss))
        outs, seeds, wrt = [], [], list(inputs)
        if loss.requires_grad:
            outs.append(loss)
            seeds.append(torch.ones_like(loss))
        if self.root is not None:
            outs.append(self.last)
            seeds.append(torch.zeros_like(self.last))
            wrt.append(self.root)
        got = [None] * len(wrt)
        if outs:
            got = torch.autograd.grad(outs, wrt, seeds, allow_unused=True)
        self.root = self.last = None
        got = [torch.zeros_like(x) if g is None else g
               for g, x in zip(got[:len(inputs)], inputs)]
        if self.world:
            for g in got:
                dist.all_reduce(g)
        return tuple(got)


@contextlib.contextmanager
def world_tape(mesh):
    """Inside the block a world's exchanges are differentiable (see the
    module docstring); yields the WorldTape of `mesh`, whose `grad`
    takes the world's gradient. A mesh of one process needs none (its
    copies are PyTorch's own), but may take its gradient alike."""
    tape = WorldTape(mesh)
    token = _TAPE.set(tape)
    try:
        yield tape
    finally:
        _TAPE.reset(token)


def _taping(tensors) -> WorldTape | None:
    """The active tape where autograd records, else None. Raises where
    a tensor that needs a gradient crosses processes untaped: its
    gradient from the other processes would be lost."""
    if not torch.is_grad_enabled():
        return None
    tape = _TAPE.get()
    if tape is None and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "a tensor that needs a gradient crosses processes outside "
            "parallel.distributed.world_tape(): run a world's forward that "
            "records a gradient inside the tape, or under torch.no_grad()")
    return tape


class _Exchange(torch.autograd.Function):
    """p2p as a Function: apply(recvs, peers, token, *sent) -> (token,
    *received); its backward sends each received tensor's gradient back
    to its sender and returns the gradients of what this process sent."""

    @staticmethod
    def forward(ctx, recvs, peers, token, *sent):
        ctx.recvs, ctx.peers = recvs, peers
        ctx.sent = [(t.shape, t.dtype, t.device) for t in sent]
        got = p2p([(t, peer, tag) for t, (peer, tag) in zip(sent, peers)],
                  recvs)
        return (torch.zeros_like(token), *got)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_token, *g_got):
        back = p2p([(g, peer, tag) for g, (_, _, _, peer, tag)
                    in zip(g_got, ctx.recvs)],
                   [(shape, dtype, device, peer, tag)
                    for (shape, dtype, device), (peer, tag)
                    in zip(ctx.sent, ctx.peers)])
        return (None, None, g_token, *back)


class _Gather(torch.autograd.Function):
    """all_gather_blocks as a Function: apply(token, local) -> (token,
    *every process's local); its backward all-reduces the gradients of
    every entry and keeps this process's."""

    @staticmethod
    def forward(ctx, token, local):
        import torch.distributed as dist
        ctx.rank = dist.get_rank()
        return (torch.zeros_like(token), *all_gather_blocks(local))

    @staticmethod
    @once_differentiable
    def backward(ctx, g_token, *g_every):
        import torch.distributed as dist
        total = torch.stack(g_every)
        dist.all_reduce(total)
        return g_token, total[ctx.rank]


def exchange(sends, recvs) -> list:
    """`p2p` for the decomposed step's copies between processes (halo
    strips, gathered blocks): differentiable inside `world_tape()`."""
    tape = _taping([t for t, _, _ in sends])
    if tape is None or not (sends or recvs):
        return p2p(sends, recvs)
    device = sends[0][0].device if sends else recvs[0][2]
    out = _Exchange.apply(list(recvs), [(peer, tag) for _, peer, tag
                                        in sends], tape._token(device),
                          *[t for t, _, _ in sends])
    tape.last = out[0]
    return list(out[1:])


def gather_blocks(local: torch.Tensor) -> list:
    """`all_gather_blocks` over the world for the decomposed step's
    reductions: differentiable inside `world_tape()`."""
    tape = _taping([local])
    if tape is None:
        return all_gather_blocks(local)
    out = _Gather.apply(tape._token(local.device), local)
    tape.last = out[0]
    return list(out[1:])


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
