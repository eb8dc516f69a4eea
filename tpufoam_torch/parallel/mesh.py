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

The train step over a mesh (`make_sharded_train_step`) is data and
tensor parallel, as the JAX package's: the batch is split into slices
along the mesh's 'data' axis, and the dense layers' weights and Adam's
moments are cut over 'model' by `mlp_partition_specs` (Megatron's
column- and row-parallel pairs), each cut leaf a `Shards` whose pieces
live on their mesh column's devices. Where GSPMD inserts the 'model'
all-reduces, the port's forward over the shards calls autograd
collectives that sum and gather in mesh order (`_RowSum`, `_RowCopy`,
`_RowGather`); the gradients of a shard are summed over 'data' in row
order, and Adam updates every shard where it lives. `unshard_params`
joins the pieces again.

`Mesh.axis_types` takes the JAX mesh's sharding axis types (`AxisType`),
validated and kept on the mesh. The port runs eagerly, with no compiler
to annotate, so they change no result.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import math

import torch

from ..fv.case import Case, Flow
from ..models.mlp import (_DTYPES, _layernorm, apply_model,
                          attention_res, tree_leaves, tree_map,
                          tree_unflatten, treedef_str)
from ..piso import decomposed
from ..piso.engine import PisoConfig, piso_step
from ..solvers.backends import CGBackend
from .blocks import BlockField, shard_tree, unshard_tree


class AxisType(enum.Enum):
    """jax.sharding.AxisType: how a compiler may shard along a mesh axis
    (Auto: the partitioner chooses; Explicit: the types say; Manual: the
    program does)."""
    Auto = enum.auto()
    Explicit = enum.auto()
    Manual = enum.auto()

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dy, dx) grid of devices; hashable, so that a frozen PisoConfig
    can hold it. `devices[i][j]` holds block (i, j): rows i*ny/dy.. of y
    and columns j*nx/dx.. of x. `axis_types` is jax.sharding.Mesh's: one
    `AxisType` an axis name (one alone stands for a tuple of one), None
    for every axis Auto, validated as JAX validates it and kept on the
    mesh; the port runs eagerly, with no compiler to annotate, so it
    changes no result. `owners` (a world of processes,
    parallel.distributed.global_device_mesh) gives the rank that owns
    each block, row-major, and `rank` this process's; None: one process
    owns every block."""
    devices: tuple
    axis_names: tuple = ("data", "model")
    axis_types: tuple | None = None
    owners: tuple | None = None
    rank: int = 0

    def __post_init__(self):
        rows = tuple(tuple(_device(d) for d in row) for row in self.devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty (dy, dx) grid of devices")
        if len(self.axis_names) != 2:
            raise ValueError(f"a mesh has two axis names, got "
                             f"{self.axis_names!r}")
        types = self.axis_types
        if types is None:
            types = (AxisType.Auto,) * len(self.axis_names)
        elif not isinstance(types, tuple):
            types = (types,)
        if not all(isinstance(t, AxisType) for t in types):
            raise TypeError(f"axis_types passed to Mesh must be of type "
                            f"AxisType, got {types!r}")
        if len(types) != len(self.axis_names):
            raise ValueError(f"the number of axis names must match the "
                             f"number of axis_types, got "
                             f"{self.axis_names!r} and {types!r}")
        object.__setattr__(self, "devices", rows)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "axis_types", types)

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
    specs = tree_map(lambda _: (), params)
    for i in range(len(specs["layers"])):
        specs["layers"][i] = ({"w": (None, "model"), "b": ("model",)}
                              if i % 2 == 0 else
                              {"w": ("model", None), "b": ()})
    if "head" in specs:
        specs["head"] = {"w": (None, None), "b": ()}
    return specs


@dataclasses.dataclass(frozen=True, eq=False)
class Shards:
    """One leaf of a tree placed on a mesh by its partition spec (what a
    jax.Array's addressable shards are): `blocks[k]` is mesh block k's
    piece (row-major), on `mesh.device_list[k]`, None where another
    process of a world owns the block. A spec that names 'model' at dim d
    cuts the leaf along d into the mesh's columns, piece c on every
    device of column c (one copy a row); a spec without 'model' keeps the
    whole leaf on every device."""
    mesh: Mesh
    spec: tuple
    blocks: tuple


def _model_dim(spec: tuple):
    return spec.index("model") if "model" in spec else None


def _place_leaf(mesh: Mesh, a, spec: tuple) -> Shards:
    if isinstance(a, Shards):
        if a.mesh != mesh or a.spec != tuple(spec):
            raise ValueError("a leaf placed on another mesh or by another "
                             "spec")
        return a
    dx = len(mesh.devices[0])
    d = _model_dim(spec)
    if d is not None and a.shape[d] % dx:
        # jax.device_put of this NamedSharding raises ValueError alike
        raise ValueError(f"dimension {d} of a {tuple(a.shape)} leaf does not "
                         f"divide over the mesh's 'model' axis of {dx}")
    n = None if d is None else a.shape[d] // dx
    blocks = []
    for k, dev in enumerate(mesh.device_list):
        if not mesh.is_local(k):
            blocks.append(None)
            continue
        piece = a if d is None else a.narrow(d, (k % dx) * n, n)
        blocks.append(piece.to(dev).contiguous())
    return Shards(mesh, tuple(spec), tuple(blocks))


def _whole(s: Shards) -> torch.Tensor:
    """The whole leaf on the mesh's lead device, from the first row whose
    blocks are all this process's."""
    mesh, dx = s.mesh, len(s.mesh.devices[0])
    rows = [i for i in range(len(mesh.devices))
            if all(s.blocks[i * dx + c] is not None for c in range(dx))]
    if not rows:
        raise ValueError("this process holds no whole row of the mesh")
    row = s.blocks[rows[0] * dx:(rows[0] + 1) * dx]
    d = _model_dim(s.spec)
    if d is None:
        return row[0].to(mesh.lead)
    return torch.cat([b.to(mesh.lead) for b in row], dim=d)


def unshard_params(tree):
    """A tree that `make_sharded_train_step` placed (the parameters, or
    the optimizer state) as whole tensors on its mesh's lead device: the
    pieces of a cut leaf joined in column order. Leaves that are no
    Shards (Adam's count) come back as they are."""
    return tree_map(lambda a: _whole(a) if isinstance(a, Shards) else a,
                    tree)


def _local(tree, k: int):
    """Mesh block k's tree: each Shards leaf's piece of block k."""
    return tree_map(lambda a: a.blocks[k] if isinstance(a, Shards) else a,
                    tree)


def _from_locals(like, locals_: dict):
    """The placed tree of `like`'s structure and Shards specs whose block k
    is `locals_[k]` (a tree of `like`'s structure); leaves that are no
    Shards from the first local tree."""
    flat = {k: tree_leaves(t) for k, t in locals_.items()}
    first = flat[min(flat)]
    out = []
    for j, a in enumerate(tree_leaves(like)):
        if isinstance(a, Shards):
            a = dataclasses.replace(a, blocks=tuple(
                flat[k][j] if k in flat else None
                for k in range(a.mesh.size)))
        else:
            a = first[j]
        out.append(a)
    return tree_unflatten(like, out)


def _gather(parts: list, group) -> list:
    """Every block's part of a row (a column) of the mesh, in mesh order:
    the local `parts` alone where the group is None (the process owns the
    whole row), else an all-gather of the stacked local parts over the
    group's processes, in rank order (which is mesh order: a world's
    processes own its blocks row-major)."""
    if group is None:
        return list(parts)
    from .distributed import all_gather_blocks
    return [q for every in all_gather_blocks(torch.stack(parts), group)
            for q in every.unbind(0)]


def _ordered_sum(parts: list, device) -> torch.Tensor:
    acc = parts[0].to(device)
    for q in parts[1:]:
        acc = acc + q.to(device)
    return acc


class _RowSum(torch.autograd.Function):
    """The row-parallel layer's sum over the 'model' blocks of a row
    (Megatron's g): forward, each local block's copy of the sum of every
    block's partial product in mesh-column order (a fixed order: a world
    equals one process bit for bit); backward, each block's incoming
    gradient, unchanged, to its own partial. Each block computes the loss
    from its own copy, all copies equal, so each copy's gradient is the
    one loss's where the copies' paths are whole (see `_RowCopy`)."""

    @staticmethod
    def forward(ctx, group, *parts):
        every = _gather(list(parts), group)
        return tuple(_ordered_sum(every, p.device) for p in parts)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _RowCopy(torch.autograd.Function):
    """The input of a column-parallel layer that a row-parallel one feeds
    (Megatron's f): forward, each block's copy as it is; backward, the
    sum over the row of the copies' incoming gradients, in mesh-column
    order, to every copy. Block c's copy reaches the loss only through
    the layer's columns c, so the loss's gradient there is that sum."""

    @staticmethod
    def forward(ctx, group, *hs):
        ctx.group = group
        return tuple(h.view_as(h) for h in hs)

    @staticmethod
    def backward(ctx, *grads):
        every = _gather(list(grads), ctx.group)
        return (None, *(_ordered_sum(every, g.device) for g in grads))


class _RowGather(torch.autograd.Function):
    """The gather of a column-split activation before the head: forward,
    each local block's copy of every block's columns, concatenated in
    mesh-column order; backward, each block's own columns of its incoming
    gradient. `first` is the mesh column of the first local part."""

    @staticmethod
    def forward(ctx, group, first, *parts):
        ctx.first, ctx.width = first, parts[0].shape[-1]
        every = _gather(list(parts), group)
        return tuple(torch.cat([q.to(p.device) for q in every], dim=-1)
                     for p in parts)

    @staticmethod
    def backward(ctx, *grads):
        w = ctx.width
        return (None, None, *(g[..., (ctx.first + j) * w:
                                (ctx.first + j + 1) * w]
                              for j, g in enumerate(grads)))


def _tp_forward(mdef, ps: list, xs: list, group, first: int, dx: int,
                counts) -> list:
    """The Megatron forward of a dense MLP over the local blocks of one
    mesh row: `ps[j]` is the parameter tree of the row's j-th local block
    (mesh column `first + j`), `xs[j]` the row's batch slice on its
    device. An even layer is column-parallel (the local product with the
    block's output columns, + b, relu; its input, where a row-parallel
    layer made it, through `_RowCopy`); an odd layer row-parallel (the
    local partial product over the block's input rows, the ordered sum
    over the row, + b, relu); a stack that ends column-split gathers its
    activations before the replicated head. Products as apply_model's
    dense layers (operands rounded to the compute dtype, the product's
    result too, then float32). Returns each block's prediction."""
    cdt = _DTYPES[mdef.compute_dtype]

    def mm(p, h):
        return (h.to(cdt) @ p["w"].to(cdt)).float()

    hs, split = list(xs), False
    for i in range(len(ps[0]["layers"])):
        lay = [p["layers"][i] for p in ps]
        if i % 2 == 0 and i > 0 and dx > 1:
            hs = _RowCopy.apply(group, *hs)
            counts["row_grad_sum"] += 1
        partial = [mm(q, h) for q, h in zip(lay, hs)]
        if i % 2 and dx > 1:
            partial = _RowSum.apply(group, *partial)
            counts["row_sum"] += 1
        hs = [torch.relu(t + q["b"]) for q, t in zip(lay, partial)]
        split = i % 2 == 0
    if split and dx > 1:
        hs = _RowGather.apply(group, first, *hs)
        counts["row_gather"] += 1
    return [mm(p["head"], h) + p["head"]["b"] for p, h in zip(ps, hs)]


def _tp_attention(mdef, ps: list, xs: list, group, first: int,
                  counts) -> list:
    """apply_model's attention form over the local blocks of one mesh row
    (as `_tp_forward`), with the placement of `mlp_partition_specs`:
    layer 0 column-parallel, its columns gathered (`_RowGather`) before
    the replicated attention and first LayerNorm; then each layer of the
    residual stack on the replicated `res`, which enters it through
    `_RowCopy` (the layer reads only the block's part of its input, so
    the row's gradients of that input are summed, and every replicated
    parameter's gradient comes out whole on every block): an odd layer
    row-parallel (the block's columns of res times its rows of w, the
    ordered sum over the row, + b, relu), an even one column-parallel
    (its columns, + b, relu, gathered); then hh + res and the layer's
    LayerNorm; the head replicated."""
    cdt = _DTYPES[mdef.compute_dtype]

    def mm(p, h):
        return (h.to(cdt) @ p["w"].to(cdt)).float()

    def gather(hs):
        counts["row_gather"] += 1
        return list(_RowGather.apply(group, first, *hs))

    lay = [p["layers"][0] for p in ps]
    hs = gather([torch.relu(mm(q, x) + q["b"]) for q, x in zip(lay, xs)])
    res = [attention_res(p, mdef, h) for p, h in zip(ps, hs)]
    for i in range(1, len(ps[0]["layers"])):
        lay = [p["layers"][i] for p in ps]
        ins = _RowCopy.apply(group, *res)
        counts["row_grad_sum"] += 1
        if i % 2:
            n = lay[0]["w"].shape[0]
            partial = _RowSum.apply(group, *(
                mm(q, h[:, (first + j) * n:(first + j + 1) * n])
                for j, (q, h) in enumerate(zip(lay, ins))))
            counts["row_sum"] += 1
            hh = [torch.relu(t + q["b"]) for q, t in zip(lay, partial)]
        else:
            hh = gather([torch.relu(mm(q, h) + q["b"])
                         for q, h in zip(lay, ins)])
        res = [_layernorm(a + r, p["ln"][i]["g"], p["ln"][i]["b"])
               for p, a, r in zip(ps, hh, res)]
    return [mm(p["head"], r) + p["head"]["b"] for p, r in zip(ps, res)]


def make_sharded_train_step(mesh: Mesh, mdef, opt, loss_scale: float = 1e6):
    """A data- and tensor-parallel train step over `mesh`: returns (step,
    shard), as the JAX package's, with the parameters placed by
    `mlp_partition_specs` over 'model' and the batch over 'data'.

    shard(params, opt_state, xb, yb) -> (params, opt_state, xs, ys):
    every parameter leaf a `Shards` (even dense layers' w and b cut along
    their output dim, odd layers' w along its input dim, a piece on every
    device of its mesh column; odd layers' b and the head whole on every
    device); the optimizer state's subtrees of the parameters' structure
    (Adam's mu and nu) placed as the parameters, its other leaves (Adam's
    count) kept; the batch split along its first axis into one slice per
    mesh row, slice i on the device of this process's first block of row
    i (None for a row it owns no block of). The batch must divide over
    'data', and each cut dim over 'model' (ValueError, as jax.device_put
    raises). Placed leaves pass through unchanged.

    step(params, opt_state, xs, ys) -> (params, opt_state, loss): on each
    row of blocks the forward of a dense MLP over the shards
    (`_tp_forward`; the 'model' collectives are autograd Functions that
    sum and gather in mesh-column order), each block's gradient of its
    row's share
    of loss_scale * mean((model(x) - y)^2) over the whole batch; the
    gradients of each shard summed over 'data' in row order, the sum on
    the first device of its column; then `opt` (train.trainer.Adam, or
    any object with its update contract) updates each shard where it
    lives, every copy alike. The loss is the rows' shares summed in row
    order, on the lead device. With one 'model' column this is the
    data-parallel step (the whole model on each row, apply_model's
    arithmetic). The attention kind takes any 'model' axis, its dense
    layers placed as the dense kind's (`_tp_attention`); the conv1d kind
    only an axis of one (ValueError otherwise, as jax.device_put refuses
    its placement). A tensor in place of xs, ys is one slice.
    `step.collectives` counts the collectives the steps ran: "row_sum",
    "row_gather" and "row_grad_sum" (the 'model' ones, a row each; the
    last in the backward) and "data_sum" (a column's gradients, and the
    loss, over 'data').

    In a world of processes (parallel.distributed.global_device_mesh)
    every process calls both, with the same inputs; each keeps and
    updates the blocks it owns, and the collectives go over the process
    groups of the mesh's rows and columns (`distributed.mesh_groups`),
    gathered and summed in the same order as in one process, so that a
    world equals one process bit for bit."""
    from ..train.trainer import apply_updates
    dy, dx = len(mesh.devices), len(mesh.devices[0])
    if dx > 1 and mdef.kind == "conv1d":
        raise ValueError(f"make_sharded_train_step: the {mdef.kind!r} model "
                         f"has no tensor-parallel placement; its mesh's "
                         f"'model' axis must be 1, not {dx}")
    local = mesh.local_blocks
    rows = sorted({k // dx for k in local})
    row_group, col_group = [None] * dy, [None] * dx
    if mesh.owners is not None:
        from .distributed import mesh_groups
        row_group, col_group = mesh_groups(mesh)
    devs = mesh.device_list

    def shard(params, opt_state, xb, yb):
        specs = mlp_partition_specs(params)

        def place(tree):
            return tree_map(lambda a, sp: _place_leaf(mesh, a, sp), tree,
                            specs)

        def place_state(st):
            if isinstance(st, dict) and treedef_str(st) == treedef_str(
                    params):
                return place(st)
            if isinstance(st, dict):
                return {k: place_state(v) for k, v in st.items()}
            if isinstance(st, (list, tuple)):
                return type(st)(place_state(v) for v in st)
            return st

        n = xb.shape[0]
        if n % dy:
            raise ValueError(f"batch of {n} does not divide over the "
                             f"mesh's 'data' axis of {dy}")
        m = n // dy
        first = {i: min(k for k in local if k // dx == i) for i in rows}
        xs = tuple(xb[i * m:(i + 1) * m].to(devs[first[i]])
                   if i in first else None for i in range(dy))
        ys = tuple(yb[i * m:(i + 1) * m].to(devs[first[i]])
                   if i in first else None for i in range(dy))
        return place(params), place_state(opt_state), xs, ys

    def step(params, opt_state, xs, ys):
        if isinstance(xs, torch.Tensor):
            xs, ys = (xs,), (ys,)
        if len(xs) != dy:
            raise ValueError(f"{len(xs)} batch slices for the mesh's "
                             f"'data' axis of {dy}")
        numel = dy * next(y for y in ys if y is not None).numel()
        counts = step.collectives
        skeleton = _local(params, local[0])
        leaves = {k: [t.detach().requires_grad_()
                      for t in tree_leaves(_local(params, k))]
                  for k in local}
        losses = {}
        with torch.enable_grad():
            for i in rows:
                ks = [k for k in local if k // dx == i]
                ps = [tree_unflatten(skeleton, leaves[k]) for k in ks]
                x = [xs[i].to(devs[k]) for k in ks]
                if mdef.kind == "dense":
                    preds = _tp_forward(mdef, ps, x, row_group[i],
                                        ks[0] % dx, dx, counts)
                elif dx > 1:
                    preds = _tp_attention(mdef, ps, x, row_group[i],
                                          ks[0] % dx, counts)
                else:
                    preds = [apply_model(ps[0], mdef, x[0])]
                for k, pred in zip(ks, preds):
                    y = ys[i].to(pred.device)
                    losses[k] = loss_scale * torch.sum((pred - y) ** 2) \
                        / numel
            inputs = [t for k in local for t in leaves[k]]
            # a leaf no loss reaches (the attention kind's last LayerNorm)
            # has a zero gradient, as under jax.grad
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(inputs, torch.autograd.grad(
                         [losses[k] for k in local], inputs,
                         allow_unused=True))]
        per, at = {}, 0
        for k in local:
            per[k] = [g.reshape(-1) for g in grads[at:at + len(leaves[k])]]
            at += len(leaves[k])

        # each shard's gradient summed over 'data' in row order, on the
        # first device of its column; then every copy takes the sum
        summed = {}
        for c in sorted({k % dx for k in local}):
            ks = [k for k in local if k % dx == c]
            flat = [torch.cat(per[k]) for k in ks]
            every = _gather(flat, col_group[c])
            if len(every) > 1:
                counts["data_sum"] += 1
            total = _ordered_sum(every, devs[ks[0]])
            for k in ks:
                summed[k] = total.to(devs[k])
        new_p, new_s = {}, {}
        for k in local:
            shapes = [t.shape for t in leaves[k]]
            g = list(summed[k].split([t.numel() for t in leaves[k]]))
            g = tree_unflatten(skeleton, [a.reshape(sh)
                                          for a, sh in zip(g, shapes)])
            p_k = _local(params, k)
            updates, new_s[k] = opt.update(g, _local(opt_state, k), p_k)
            new_p[k] = apply_updates(p_k, updates)

        c0 = local[0] % dx
        shares = [losses[k].detach() for k in local if k % dx == c0]
        every = _gather(shares, col_group[c0])
        if len(every) > 1:
            counts["data_sum"] += 1
        loss = _ordered_sum(every, mesh.lead)
        return (_from_locals(params, new_p), _from_locals(opt_state, new_s),
                loss)

    step.collectives = collections.Counter()
    return step, shard
