"""Meshes of devices, the spatially sharded PISO step and the
case-parallel fleet: the counterpart of tpufoam/parallel/mesh.py.

A mesh is a (dy, dx) grid of `torch.device`s with the JAX package's axis
names ('data' over y, 'model' over x). One process drives every device of
the mesh, as JAX's single controller does, and a device may repeat: on
one card `device_mesh(4, devices=["cuda:0"] * 4)` is a 2 x 2 mesh of four
blocks on that card; on a host with four cards `device_mesh(4)` puts one
block on each.

What is sharded. The JAX step keeps every field sharded end to end:
GSPMD partitions every stencil and reduction and inserts the halo
exchanges. PyTorch has no such partitioner, so here the fields stay whole
on the mesh's lead device (`shard_case` and `shard_flow` check the
divisibility the JAX specs demand and place them there), and the one
per-block kernel of the JAX step, the momentum multisweep, runs
decomposed on the mesh (ops.sharded). The numbers equal the single-device
step's; the memory per device does not shrink with the mesh. A
domain-decomposed engine, with fields resident per card and an exchange
between processes, is a later piece of work.

The fleet is the other layout: its case axis is split over the mesh and
each device steps its own sub-stack of whole cases, with no exchange at
all.

The turbulent step over a mesh (`shard_turbulence`,
`make_sharded_sst_step`) is the sharded PISO step with the SST model: the
fields, the SST state and its transport solves stay whole on the lead
device, and the momentum kernel runs per block.

The train step over a mesh (`make_sharded_train_step`) is data
parallel: the batch is split into slices along the mesh's 'data' axis,
each slice's loss gradient is taken on its device, and the gradients are
summed on the lead device in a fixed order, where Adam updates the whole
weights. `mlp_partition_specs` returns the JAX package's tensor-parallel
spec tree; the weights are not split over 'model' (that belongs to the
domain-decomposed engine, with the fields).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..fv.case import Case, Flow
from ..piso.engine import PisoConfig, piso_step, piso_step_sst
from ..solvers.backends import CGBackend


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dy, dx) grid of devices; hashable, so that a frozen PisoConfig
    can hold it. `devices[i][j]` holds block (i, j): rows i*ny/dy.. of y
    and columns j*nx/dx.. of x."""
    devices: tuple
    axis_names: tuple = ("data", "model")

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
        """The device that holds the global fields."""
        return self.devices[0][0]


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

# the axes each field is split along, by the JAX package's specs
# (`_case_specs`, `_flow_specs`): cells over (y, x); the inlet profile
# over y; the face fluxes only along their cell-aligned axis (phi_x has
# nx + 1 columns, phi_y ny + 1 rows); dt and t replicated
_CELL = ("data", "model")
_CASE_SPLIT = {"inlet_u": ("data",)}
_FLOW_SPLIT = {"phi_x": ("data", None), "phi_y": (None, "model"),
               "dt": (), "t": ()}
_TURB_SPLIT = {"k_in": (), "w_in": ()}


def _place(mesh: Mesh, tree, split: dict):
    """Check that every tensor field of `tree` divides along the mesh axes
    of its spec, and place it on the lead device."""
    moved = {}
    for f in dataclasses.fields(tree):
        t = getattr(tree, f.name)
        if not isinstance(t, torch.Tensor):
            continue
        spec = split.get(f.name, _CELL)
        for axis, name in zip(range(-len(spec), 0), spec):
            if name is not None and t.shape[axis] % mesh.shape[name]:
                raise ValueError(
                    f"{f.name} {tuple(t.shape)}: axis {axis} does not divide "
                    f"over the mesh's {name!r} axis of {mesh.shape[name]}")
        moved[f.name] = t.to(mesh.lead)
    return dataclasses.replace(tree, **moved)


def shard_flow(mesh: Mesh, flow: Flow) -> Flow:
    """`flow` on the mesh's lead device, after checking that each field
    divides as the JAX package's `_flow_specs` demand."""
    return _place(mesh, flow, _FLOW_SPLIT)


def shard_case(mesh: Mesh, case: Case) -> Case:
    """`case` on the mesh's lead device, after checking that each field
    divides as the JAX package's `_case_specs` demand."""
    return _place(mesh, case, _CASE_SPLIT)


def make_sharded_piso_step(mesh: Mesh, cfg: PisoConfig = PisoConfig(),
                           backend=None, sm_predict=None):
    """The PISO step over `mesh`: step(case, flow) -> flow, with the case
    and flow of `shard_case` and `shard_flow`. With
    momentum_smoother='kernel' the momentum kernel runs per block of the
    mesh on halo-extended blocks (`cfg.shard_mesh`,
    ops.sharded.momentum_multisweep_sharded); everything else, the
    pressure solve with its kernel smoothers included, runs on the lead
    device as in `piso_step`, and the result equals `piso_step`'s. The
    JAX package downgrades a 'pallas' pressure smoother to 'xla' here,
    because GSPMD cannot partition its kernel; the fields are whole on the
    lead device here, so the backend passes through unchanged."""
    backend = backend or CGBackend(rtol=1e-5, maxiter=200)
    if cfg.momentum_smoother == "kernel" and cfg.shard_mesh is None:
        cfg = dataclasses.replace(cfg, shard_mesh=mesh)

    def step(case: Case, flow: Flow) -> Flow:
        return piso_step(case, flow, cfg=cfg, backend=backend,
                         sm_predict=sm_predict)

    return step


def shard_turbulence(mesh: Mesh, turb):
    """The SST state (fv.turbulence.TurbState) on the mesh's lead device,
    after checking that k, omega and nu_t divide over the mesh as the JAX
    package's `_turb_specs` demand (k_in, w_in replicated)."""
    return _place(mesh, turb, _TURB_SPLIT)


def make_sharded_sst_step(mesh: Mesh, cfg: PisoConfig = PisoConfig(),
                          backend=None, sm_predict=None):
    """The turbulent step over `mesh`: step(case, flow, turb) -> (flow,
    turb), with the case, flow and SST state of `shard_case`, `shard_flow`
    and `shard_turbulence`. As `make_sharded_piso_step`: with
    momentum_smoother='kernel' the momentum kernel runs per block of the
    mesh (`cfg.shard_mesh`), and everything else, the SST transport solves
    included, runs on the lead device as in `piso_step_sst`, whose result
    it equals. (The JAX package lets GSPMD partition the SST stencils; the
    fields are whole on the lead device here, so they need no exchange.)"""
    backend = backend or CGBackend(rtol=1e-5, maxiter=200)
    if cfg.momentum_smoother == "kernel" and cfg.shard_mesh is None:
        cfg = dataclasses.replace(cfg, shard_mesh=mesh)

    def step(case: Case, flow: Flow, turb):
        return piso_step_sst(case, flow, turb, cfg=cfg, backend=backend,
                             sm_predict=sm_predict)

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
