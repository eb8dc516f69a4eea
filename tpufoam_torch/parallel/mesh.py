"""Meshes of devices, the domain-decomposed PISO step and the
case-parallel fleet: the counterpart of tpufoam/parallel/mesh.py.

A mesh is a (dy, dx) grid of `torch.device`s with the JAX package's axis
names ('data' over y, 'model' over x). One process drives every device of
its blocks, as JAX's single controller does, and a device may repeat: on
one card `device_mesh(4, devices=["cuda:0"] * 4)` is a 2 x 2 mesh of four
blocks on that card; on a host with four cards `device_mesh(4)` puts one
block on each. In a world of processes (`parallel.distributed.
global_device_mesh`) each process owns the blocks on its own devices
(`Mesh.owners`).

What is sharded. The JAX step keeps every field sharded end to end:
GSPMD partitions every stencil and reduction and inserts the halo
exchanges. Here `shard_case`, `shard_flow` and `shard_turbulence` make
every field resident per block (parallel.blocks.BlockField): the cells
split over (y, x), the face fluxes over both axes too (the last block
along an axis owns its extra face: the outlet's column of phi_x, the top
wall's row of phi_y), the inlet profile over y, dt, t, k_in and w_in
replicated, the case's blocks with a stored halo of `CASE_HALO` cells.
The decomposed step (`make_sharded_piso_step`, `make_sharded_sst_step`;
piso.decomposed) runs every stage per block after a halo exchange as
deep as its reach, the momentum kernel once per block, and the pressure
solve on the blocks (solvers.decomposed) with its kernels per block, the
coarsest multigrid levels agglomerated whole on the lead device; only
the surrogate's stage gathers whole fields, for its call. The memory per
device shrinks with the mesh; with a fixed-cycle multigrid the result
equals the single-device step's bit for bit. `unshard_case`,
`unshard_flow` and `unshard_turbulence` are the way back to whole
fields. A mesh whose blocks cannot hold a stage's halo raises.

The fleet is the other layout: its case axis is split over the mesh and
each device steps its own sub-stack of whole cases, with no exchange at
all.

The train step over a mesh (`make_sharded_train_step`) is data
parallel: the batch is split into slices along the mesh's 'data' axis,
each slice's loss gradient is taken on its device, and the gradients are
summed on the lead device in a fixed order, where Adam updates the whole
weights. `mlp_partition_specs` returns the JAX package's tensor-parallel
spec tree; the weights are not split over 'model'.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..fv.case import Case, Flow
from ..piso import decomposed
from ..piso.engine import PisoConfig, piso_step
from ..solvers.backends import CGBackend
from .blocks import BlockField, shard_tree, unshard_tree


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dy, dx) grid of devices; hashable, so that a frozen PisoConfig
    can hold it. `devices[i][j]` holds block (i, j): rows i*ny/dy.. of y
    and columns j*nx/dx.. of x. `owners` (a world of processes,
    parallel.distributed.global_device_mesh) gives the rank that owns
    each block, row-major, and `rank` this process's; None: one process
    owns every block."""
    devices: tuple
    axis_names: tuple = ("data", "model")
    owners: tuple | None = None
    rank: int = 0

    def __post_init__(self):
        rows = tuple(tuple(_device(d) for d in row) for row in self.devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty (dy, dx) grid of devices")
        if len(self.axis_names) != 2:
            raise ValueError(f"a mesh has two axis names, got "
                             f"{self.axis_names!r}")
        object.__setattr__(self, "devices", rows)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        """{axis name: size}, as JAX's `Mesh.shape`."""
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def device_list(self) -> tuple:
        """The devices row-major: (0, 0), (0, 1), ..."""
        return tuple(d for row in self.devices for d in row)

    @property
    def lead(self) -> torch.device:
        """The device that holds whole fields: this process's first
        device (the mesh's first in a world of one process)."""
        return self.device_list[self.local_blocks[0]]

    @property
    def local_blocks(self) -> tuple:
        """The row-major indices of the blocks this process owns."""
        if self.owners is None:
            return tuple(range(self.size))
        return tuple(k for k, r in enumerate(self.owners) if r == self.rank)

    def is_local(self, k: int) -> bool:
        return self.owners is None or self.owners[k] == self.rank


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def device_mesh(n_devices: int | None = None,
                shape: tuple[int, int] | None = None,
                axis_names=("data", "model"), devices=None) -> Mesh:
    """A mesh of the first `n_devices` of `devices` (every visible card
    when None; an explicit list may repeat a device, or name the CPU), of
    `shape`, by default the squarest factorisation, data-major (8 devices
    make a 4 x 2 mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * n) for a mesh without one")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    n = len(devs) if n_devices is None else n_devices
    if not 1 <= n <= len(devs):
        raise ValueError(f"device_mesh: {n} devices asked, {len(devs)} given")
    devs = devs[:n]
    if shape is None:
        d = math.isqrt(n)
        while n % d:
            d -= 1
        shape = (n // d, d)
    dy, dx = shape
    if dy * dx != n:
        raise ValueError(f"device_mesh: shape {shape} does not hold {n} "
                         "devices")
    return Mesh(tuple(tuple(devs[i * dx:(i + 1) * dx]) for i in range(dy)),
                tuple(axis_names))


# ---------------------------------------------------------------------------
# spatially sharded PISO
# ---------------------------------------------------------------------------

# the JAX package's specs (`_case_specs`, `_flow_specs`, `_turb_specs`)
# split every cell field over (y, x), the inlet profile over y and
# replicate dt, t, k_in and w_in; here the face fluxes split over both
# axes too (parallel.blocks): no block holds a whole row of faces
_FACES = {"phi_x": (0, 1), "phi_y": (1, 0)}
# the halo each block of the case stores: the deepest stage of the step
# (the momentum kernel's sweeps; the SST transport's 6)
CASE_HALO = 8


def shard_flow(mesh: Mesh, flow: Flow) -> Flow:
    """`flow` resident per block of `mesh`: every field a
    parallel.blocks.BlockField, its blocks on their mesh devices (phi_x's
    last column and phi_y's last row owned by the last block along that
    axis; dt and t replicated). Raises where a field does not divide."""
    return shard_tree(mesh, flow, _FACES)


def shard_case(mesh: Mesh, case: Case, halo: int = CASE_HALO) -> Case:
    """`case` resident per block of `mesh`: every tensor field a
    BlockField whose blocks store a halo of `halo` cells (their windows,
    clipped at the domain's edges), from which each stage of the
    decomposed step cuts its window as a view. Raises where the grid does
    not divide or a block cannot hold the halo."""
    dy, dx = len(mesh.devices), len(mesh.devices[0])
    return shard_tree(mesh, case, {}, (halo if dy > 1 else 0,
                                       halo if dx > 1 else 0))


def shard_turbulence(mesh: Mesh, turb):
    """The SST state (fv.turbulence.TurbState) resident per block of
    `mesh`: k, omega and nu_t split as cell fields, k_in and w_in
    replicated."""
    return shard_tree(mesh, turb, {})


def unshard_flow(flow: Flow) -> Flow:
    """The whole fields of a sharded Flow on the mesh's lead device: the
    way back from the blocks."""
    return unshard_tree(flow)


def unshard_case(case: Case) -> Case:
    """The whole fields of a sharded Case on the mesh's lead device."""
    return unshard_tree(case)


def unshard_turbulence(turb):
    """The whole fields of a sharded TurbState on the mesh's lead
    device."""
    return unshard_tree(turb)


def make_sharded_piso_step(mesh: Mesh, cfg: PisoConfig = PisoConfig(),
                           backend=None, sm_predict=None):
    """The domain-decomposed PISO step over `mesh`: step(case, flow) ->
    flow, with the case and flow of `shard_case` and `shard_flow`, every
    field resident per block on its mesh device (piso.decomposed). Each
    stencil stage runs per block after a halo exchange as deep as its
    reach, the momentum kernel once per block, and the pressure solve on
    the blocks with its kernels (solvers.decomposed: MGBackend,
    MGCGBackend, CGBackend or AutoBackend), gathering only its coarsest
    levels; `sm_predict` predicts on fields gathered for the call. With a
    fixed-cycle multigrid the result equals `piso_step`'s bit for bit.
    The JAX package downgrades a 'pallas' pressure smoother to 'xla'
    here, because GSPMD cannot partition its kernel; the port keeps its
    kernels, per block. `cfg.shard_mesh` plays no part: the fields are
    already blocks."""
    backend = backend or CGBackend(rtol=1e-5, maxiter=200)
    cfg = dataclasses.replace(cfg, shard_mesh=None)
    predict = None if sm_predict is None else decomposed.SurrogateStage(
        sm_predict)

    def step(case: Case, flow: Flow) -> Flow:
        _check_mesh(mesh, case)
        return decomposed.piso_step(case, flow, cfg=cfg, backend=backend,
                                    sm_predict=predict)

    return step


def _check_mesh(mesh: Mesh, case: Case):
    if not isinstance(case.fluid, BlockField) or case.fluid.mesh != mesh:
        raise ValueError("the sharded step takes the case of "
                         "shard_case(mesh, case) on its own mesh")


def make_sharded_sst_step(mesh: Mesh, cfg: PisoConfig = PisoConfig(),
                          backend=None, sm_predict=None):
    """The domain-decomposed turbulent step over `mesh`: step(case, flow,
    turb) -> (flow, turb), with the case, flow and SST state of
    `shard_case`, `shard_flow` and `shard_turbulence`: the decomposed
    PISO step of `make_sharded_piso_step`, then the SST transport per
    block; k, omega and nu_t stay resident per block."""
    backend = backend or CGBackend(rtol=1e-5, maxiter=200)
    cfg = dataclasses.replace(cfg, shard_mesh=None)
    predict = None if sm_predict is None else decomposed.SurrogateStage(
        sm_predict)

    def step(case: Case, flow: Flow, turb):
        _check_mesh(mesh, case)
        return decomposed.piso_step_sst(case, flow, turb, cfg=cfg,
                                        backend=backend, sm_predict=predict)

    return step


# ---------------------------------------------------------------------------
# case-parallel fleet farming
# ---------------------------------------------------------------------------

def _tensor_fields(tree) -> list[str]:
    return [f.name for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)]


def shard_fleet(mesh: Mesh, tree) -> tuple:
    """Split a stacked fleet Case or Flow (piso.batched.stack_cases /
    stack_flows) on its case axis into `mesh.size` sub-stacks of whole
    cases, sub-stack k on `mesh.device_list[k]`. Requires
    n_cases % mesh.size == 0. Where the JAX function returns one global
    array sharded over the devices, this returns the tuple of sub-stacks;
    `unshard_fleet` joins them."""
    names = _tensor_fields(tree)
    devs = mesh.device_list
    n = getattr(tree, names[0]).shape[0]
    if n % len(devs):
        raise ValueError(f"shard_fleet: {n} cases do not divide over "
                         f"{len(devs)} devices")
    m = n // len(devs)
    return tuple(dataclasses.replace(tree, **{
        name: getattr(tree, name)[k * m:(k + 1) * m].to(d)
        for name in names}) for k, d in enumerate(devs))


def unshard_fleet(mesh: Mesh, parts):
    """The sub-stacks of `shard_fleet` (or of a sharded fleet step) as one
    stacked Case or Flow on the mesh's lead device."""
    return dataclasses.replace(parts[0], **{
        name: torch.cat([getattr(p, name).to(mesh.lead) for p in parts])
        for name in _tensor_fields(parts[0])})


def make_sharded_fleet_step(mesh: Mesh, cfg: PisoConfig = PisoConfig(),
                            backend=None, sm_predict=None):
    """Case-parallel fleet step: step(cases, flows) -> flows on the
    sub-stacks of `shard_fleet`, each advanced by the batched `piso_step`
    on its own device, with no exchange; every case evolves as in
    `run_piso_batched` of the whole fleet. One process issues the
    sub-steps one after another, and the step is bound by the host, so
    this never beats `run_piso_batched` of the whole fleet on one card,
    nor on several until each card has a process of its own. `sm_predict`
    must take a sub-stack on its device."""
    backend = backend or CGBackend(rtol=1e-5, maxiter=200)
    # each device owns whole-domain cases: no spatial dispatch
    cfg = dataclasses.replace(cfg, shard_mesh=None)

    def step(cases, flows) -> tuple:
        return tuple(piso_step(c, f, cfg=cfg, backend=backend,
                               sm_predict=sm_predict)
                     for c, f in zip(cases, flows, strict=True))

    return step


# ---------------------------------------------------------------------------
# the MLP train step over a mesh
# ---------------------------------------------------------------------------

def mlp_partition_specs(params: dict) -> dict:
    """The JAX package's Megatron-style specs of a parameter tree, each a
    tuple of mesh axis names (a PartitionSpec's entries): even dense
    layers split their output dim over 'model', odd layers their input
    dim; the head and every other leaf replicated (())."""
    from ..models.mlp import tree_map
    specs = tree_map(lambda _: (), params)
    for i in range(len(specs["layers"])):
        specs["layers"][i] = ({"w": (None, "model"), "b": ("model",)}
                              if i % 2 == 0 else
                              {"w": ("model", None), "b": ()})
    if "head" in specs:
        specs["head"] = {"w": (None, None), "b": ()}
    return specs


def make_sharded_train_step(mesh: Mesh, mdef, opt, loss_scale: float = 1e6):
    """A data-parallel train step over `mesh`: returns (step, shard).

    shard(params, opt_state, xb, yb) -> (params, opt_state, xs, ys): the
    parameters and optimizer state on the lead device, the batch split
    along its first axis into one slice per row of the mesh (its 'data'
    axis), slice i on devices[i][0]; the batch must divide.

    step(params, opt_state, xs, ys) -> (params, opt_state, loss): each
    slice's share of the gradient of loss_scale * mean((model(x) - y)^2)
    over the whole batch is taken on its device, the shares are summed on
    the lead device in slice order, and `opt` (train.trainer.Adam, or any
    object with its update contract) updates the whole weights there.
    A tensor in place of xs, ys is one slice."""
    from ..models.mlp import apply_model, tree_map
    from ..train.trainer import apply_updates, value_and_grad
    lead = mesh.lead
    rows = [r[0] for r in mesh.devices]

    def shard(params, opt_state, xb, yb):
        def on_lead(tree):
            return tree_map(lambda a: a.to(lead)
                            if isinstance(a, torch.Tensor) else a, tree)

        n = xb.shape[0]
        if n % len(rows):
            raise ValueError(f"batch of {n} does not divide over the "
                             f"mesh's 'data' axis of {len(rows)}")
        m = n // len(rows)
        return (on_lead(params), on_lead(opt_state),
                tuple(xb[i * m:(i + 1) * m].to(d) for i, d in
                      enumerate(rows)),
                tuple(yb[i * m:(i + 1) * m].to(d) for i, d in
                      enumerate(rows)))

    def step(params, opt_state, xs, ys):
        if isinstance(xs, torch.Tensor):
            xs, ys = (xs,), (ys,)
        numel = sum(y.numel() for y in ys)

        def share(p, xb, yb):
            return loss_scale * torch.sum(
                (apply_model(p, mdef, xb) - yb) ** 2) / numel

        loss, grads = None, None
        for xb, yb in zip(xs, ys, strict=True):
            p = tree_map(lambda a: a.to(xb.device), params)
            l_s, g_s = value_and_grad(share, p, xb, yb)
            l_s, g_s = l_s.to(lead), tree_map(lambda a: a.to(lead), g_s)
            if loss is None:
                loss, grads = l_s, g_s
            else:
                loss = loss + l_s
                grads = tree_map(torch.add, grads, g_s)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step, shard
