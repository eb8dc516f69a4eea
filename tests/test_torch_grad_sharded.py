"""Reverse mode through the port's mesh steps on the CPU: the gradient of
the domain-decomposed step (parallel.mesh.make_sharded_piso_step over
`devices=["cpu"] * n` meshes), of a world of gloo processes and of the
case-parallel fleet step (make_sharded_fleet_step), against jax.grad of
the JAX package's sharded steps on tests/conftest.py's 8 virtual CPU
devices and against the port's own whole-field gradients. The loss is
tests/test_differentiable.py's, the sum of u^2 over the downstream half
after the steps, as a function of the whole inlet profile before
shard_case (so the split into blocks is on the tape too); the momentum
smoother is the plain one (JAX's "xla"), the backend MGBackend(cycles=2)
with the plain pressure smoother, no surrogate: the configurations JAX
differentiates. JAX's gradients are jax.jit(jax.grad(loss)) of its
steps, the inlet placed as its shard_case places it.

Tolerances, the relative L2 norm of the difference over the gradient:
- Against JAX, tests/test_torch_grad_rollout.py's bounds for the same
  configuration: tests/test_differentiable.py's case (16 x 32, upwind,
  one corrector, fixed dt, two momentum sweeps, 3 steps) 1e-5; bench.py's
  cylinder and PisoConfig at 32 x 128, 2 steps, float32 multigrid 2e-4,
  the bf16 correction form 2e-2. JAX's own sharded gradient lies, from
  its single-device jax.grad, 1.19e-5 on 2 x 2 and 1.25e-5 on 1 x 2 in
  the upwind case (its sharded step is off at the x-blocks' face of
  phi_x, ROADMAP C; 3.8e-7 on 2 x 1), above that case's bound, so on an
  x-split the port is held to JAX's single-device gradient there; in the
  bench cases 3.3e-5 (f32, 2 x 2) and 1.9e-3 (bf16, 2 x 1), within their
  bounds, so the port is held to JAX's sharded gradient. Measured, the
  port against its reference: upwind 2.8e-6 (2 x 1), 2.9e-6 (2 x 2 and
  1 x 2; 1.2e-5 and 1.3e-5 from JAX's sharded gradient), f32 3.5e-5,
  bf16 1.0e-2 (the port's whole step lies 1.05e-2 from JAX's
  single-device gradient in that case).
- The decomposed gradient against the port's whole-step gradient (the
  same run through piso.engine.run_piso): a halo cell's gradient is
  summed per window that reads it and then over the blocks, in another
  order than the whole step's; float32 multigrid 1e-5 (measured 1.1e-6
  on 2 x 2, 1.6e-6 on 2 x 1, 1.1e-6 on 1 x 2), bf16 1e-2 (each partial
  sum rounded to bfloat16: measured 1.1e-3, 9.5e-4, 2.1e-3).
- The t_stop bound (ROADMAP C.8): d(dt)/d(t) exactly -0.5 where t_stop - t
  equals the 1e-6 floor, as jnp.maximum splits a tie.
- The Courant max at a tie of cells on two blocks: the decomposed
  gradient equals the whole step's bit for bit, and jax.grad's within a
  relative 1e-6 per entry.
- The fleet step against run_piso_batched: bit for bit (each case's
  arithmetic is its own); against JAX's sharded fleet step 1e-4 per case
  (tests/test_torch_grad_rollout.py's fleet bound).
- A world of two processes against one process holding every block: the
  world's reverse copies add a halo's gradient in another order than one
  process's, and its all-gather's backward sums the processes'
  gradients; float32 multigrid 1e-5 (measured 1.4e-6, 1.3e-6 for the
  lower row's loss).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tpufoam.core.geometry import ChannelCase as JChannelCase
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.parallel import mesh as jmesh
from tpufoam.piso import batched as jbat
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam_torch.core.geometry import ChannelCase, channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.parallel import blocks as tblk
from tpufoam_torch.parallel import distributed as tdist
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import decomposed as tdec
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend as TMG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = {"upwind": 1e-5, "f32": 2e-4, "bf16": 2e-2}
WHOLE_TOL = {"f32": 1e-5, "bf16": 1e-2}
FLEET = [("cylinder", 0.3), ("rectangle", 0.25), ("triangle", 0.3)]
FLEET_CFG = dict(n_correctors=2, max_co=0.5, max_dt=2e-3)
FLEET_TOL = 1e-4
WORLD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_l2(got, ref):
    got, ref = np.float64(got), np.float64(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _downstream_ke(u, nx):
    return (u[..., nx // 2:] ** 2).sum()


def _config(name):
    """(JAX case, port case, PisoConfig options, steps, dt0, precision)."""
    if name == "upwind":
        kw = dict(length=2.0, height=1.0, shape=None, nu=0.05)
        jc = jcase.build_channel_case(JChannelCase(**kw), delta=1.0 / 16)
        tc = tcase.build_channel_case(ChannelCase(**kw), delta=1.0 / 16,
                                      device="cpu")
        return jc, tc, dict(n_correctors=1, adjust_dt=False,
                            momentum_sweeps=2, convection="upwind"), \
            3, 5e-3, "f32"
    kw = dict(shape_name="cylinder", length=8.0, height=2.0,
              obstacle_size=0.5, nu=8e-3)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=2.0 / 32)
    tc = tcase.build_channel_case(channel_case_geometry(**kw),
                                  delta=2.0 / 32, device="cpu")
    return jc, tc, dict(n_correctors=2, max_co=0.5, max_dt=2e-3), 2, 5e-4, \
        name


@pytest.fixture(scope="module")
def configs():
    return {name: _config(name) for name in ("upwind", "f32", "bf16")}


def _jax_grad(jc, opts, n, dt0, prec, shape=None):
    """jax.grad of the downstream energy after n steps w.r.t. the inlet:
    through JAX's make_sharded_piso_step over a mesh of `shape`, or
    through its run_piso on one device when None."""
    cfg, be = jeng.PisoConfig(**opts), JMG(cycles=2, precision=prec)
    flow0 = jcase.initial_flow(jc, dt0=dt0)
    nx = jc.grid.nx
    if shape is None:
        def loss(inlet):
            f = jeng.run_piso(dataclasses.replace(jc, inlet_u=inlet), flow0,
                              n, cfg=cfg, backend=be)
            return _downstream_ke(f.u, nx)
        return np.asarray(jax.jit(jax.grad(loss))(jc.inlet_u))
    jm = jmesh.device_mesh(shape[0] * shape[1], shape=shape)
    step = jmesh.make_sharded_piso_step(jm, cfg, be)
    case0, f0 = jmesh.shard_case(jm, jc), jmesh.shard_flow(jm, flow0)

    def loss(inlet):
        c, f = dataclasses.replace(case0, inlet_u=inlet), f0
        for _ in range(n):
            f = step(c, f)
        return _downstream_ke(f.u, nx)

    inlet = jax.device_put(jc.inlet_u, NamedSharding(jm, P("data")))
    with jm:
        return np.asarray(jax.jit(jax.grad(loss))(inlet))


def cpu_mesh(shape):
    n = shape[0] * shape[1]
    return tmesh.device_mesh(n, shape=shape, devices=["cpu"] * n)


def _port_grad(tc, opts, n, dt0, prec, shape=None):
    """The port's gradient of the same loss: through the decomposed step
    over a CPU mesh of `shape` (the whole inlet split by shard_case on
    the tape), or through run_piso when None."""
    cfg, be = teng.PisoConfig(**opts), TMG(cycles=2, precision=prec)
    flow0 = tcase.initial_flow(tc, dt0=dt0)
    x = tc.inlet_u.clone().requires_grad_(True)
    case = dataclasses.replace(tc, inlet_u=x)
    if shape is None:
        f = teng.run_piso(case, flow0, n, cfg=cfg, backend=be)
        u = f.u
    else:
        mesh = cpu_mesh(shape)
        step = tmesh.make_sharded_piso_step(mesh, cfg, be)
        sc, sf = tmesh.shard_case(mesh, case), tmesh.shard_flow(mesh, flow0)
        for _ in range(n):
            sf = step(sc, sf)
        u = sf.u.gather()
    loss = _downstream_ke(u, tc.grid.nx)
    g, = torch.autograd.grad(loss, x)
    return g, float(loss.detach())


# (configuration, mesh, JAX reference): the x-splits of the upwind case
# against JAX's single-device gradient (see the module docstring)
JAX_CASES = [("upwind", (2, 1), "sharded"), ("upwind", (2, 2), "single"),
             ("upwind", (1, 2), "single"), ("f32", (2, 2), "sharded"),
             ("bf16", (2, 1), "sharded")]


@pytest.mark.parametrize("name,shape,ref", JAX_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}-{r}"
                              for n, s, r in JAX_CASES])
def test_decomposed_gradient_matches_jax(configs, name, shape, ref):
    """The decomposed step's inlet gradient against jax.grad of JAX's
    sharded step on the same mesh (or its single-device step, above);
    finite, and positive at the centre row, as tests/
    test_differentiable.py asks of JAX's."""
    jc, tc, opts, n, dt0, prec = configs[name]
    want = _jax_grad(jc, opts, n, dt0, prec,
                     shape if ref == "sharded" else None)
    got, _ = _port_grad(tc, opts, n, dt0, prec, shape)
    assert bool(torch.isfinite(got).all())
    assert float(got[tc.grid.ny // 2]) > 0.0
    assert _rel_l2(got.numpy(), want) <= JAX_TOL[name]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2)])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_decomposed_gradient_matches_the_whole_step(configs, shape, prec):
    """The decomposed gradient against the port's whole-step gradient
    (run_piso), bench.py's configuration at 32 x 128; the losses equal
    bit for bit (the forward is piso_step's)."""
    _, tc, opts, n, dt0, _ = configs[prec]
    whole, whole_loss = _port_grad(tc, opts, n, dt0, prec)
    got, loss = _port_grad(tc, opts, n, dt0, prec, shape)
    assert loss == whole_loss
    assert _rel_l2(got.numpy(), whole.numpy()) <= WHOLE_TOL[prec]


def test_t_stop_bound_takes_jax_gradient_at_the_tie():
    """ROADMAP C.8: with t = 0 and t_stop = 1e-6, t_stop - t equals the
    1e-6 floor in float32, and jnp.maximum splits the gradient of a tie
    evenly: d(dt)/d(t) is -0.5 through JAX's piso_step, the port's
    piso_step and the decomposed step (torch.clamp gave -1)."""
    kw = dict(length=2.0, height=1.0, shape=None, nu=0.05)
    jc = jcase.build_channel_case(JChannelCase(**kw), delta=1.0 / 16)
    tc = tcase.build_channel_case(ChannelCase(**kw), delta=1.0 / 16,
                                  device="cpu")
    opts = dict(t_stop=1e-6, n_correctors=1)
    jf0 = jcase.initial_flow(jc, dt0=5e-3)
    want = float(jax.grad(lambda t: jeng.piso_step(
        jc, dataclasses.replace(jf0, t=t), jeng.PisoConfig(**opts),
        JMG(cycles=2)).dt)(jf0.t))
    f0 = tcase.initial_flow(tc, dt0=5e-3)
    assert float(f0.t) == 0.0 and float(torch.tensor(1e-6) - f0.t) == float(
        torch.tensor(1e-6))
    cfg, be = teng.PisoConfig(**opts), TMG(cycles=2)
    t = f0.t.clone().requires_grad_(True)
    whole, = torch.autograd.grad(teng.piso_step(
        tc, dataclasses.replace(f0, t=t), cfg, be).dt, t)
    mesh = cpu_mesh((2, 2))
    t = f0.t.clone().requires_grad_(True)
    out = tmesh.make_sharded_piso_step(mesh, cfg, be)(
        tmesh.shard_case(mesh, tc),
        tmesh.shard_flow(mesh, dataclasses.replace(f0, t=t)))
    dec, = torch.autograd.grad(tmesh.unshard_flow(out).dt, t)
    assert want == -0.5
    assert float(whole) == want and float(dec) == want


def test_block_max_splits_a_tie_as_jnp_max():
    """Three blocks tied at the max share its gradient in thirds, as
    jnp.max's gradient does (pairwise maxima would give 1/4, 1/4, 1/2)."""
    mesh = cpu_mesh((2, 2))
    vals = [1.5, 1.5, 0.5, 1.5]
    xs = [torch.tensor(v, requires_grad=True) for v in vals]
    m = tblk.block_max(mesh, dict(enumerate(xs)))
    got = torch.autograd.grad(m.blocks[0], xs)
    want = jax.grad(jnp.max)(jnp.array(vals))
    assert [float(g) for g in got] == [float(w) for w in want]


def test_courant_tie_splits_over_every_tied_cell():
    """A Courant max tied by three cells of block 0 and one of block 1 on a
    2 x 2 mesh: one phi_x face inside block 0 (two tied cells) and one on
    the face between blocks 0 and 1 (a tied cell on each side). The
    decomposed Courant number's gradient w.r.t. phi_x is the whole
    step's bit for bit and jax.grad's of JAX's courant_number, a quarter
    of the max's gradient to each tied cell (block_max alone would give
    block 0's cells a sixth each and block 1's a half)."""
    kw = dict(length=2.0, height=1.0, shape=None, nu=0.05)
    jc = jcase.build_channel_case(JChannelCase(**kw), delta=1.0 / 16)
    tc = tcase.build_channel_case(ChannelCase(**kw), delta=1.0 / 16,
                                  device="cpu")
    # every face 0.25 (no |phi| at 0, where jnp.abs and torch.abs differ
    # in their gradient), the two faces 1.0
    faces = [(3, 5), (5, tc.grid.nx // 2)]
    phi = np.full((tc.grid.ny, tc.grid.nx + 1), 0.25, np.float32)
    for f in faces:
        phi[f] = 1.0
    f0 = tcase.initial_flow(tc, dt0=5e-3)
    px = torch.tensor(phi, requires_grad=True)
    flow = dataclasses.replace(f0, phi_x=px,
                               phi_y=torch.full_like(f0.phi_y, 0.25))
    whole, = torch.autograd.grad(teng.courant_number(tc, flow), px)
    mesh = cpu_mesh((2, 2))
    co = tdec.courant_number(tmesh.shard_case(mesh, tc),
                             tmesh.shard_flow(mesh, flow))
    assert float(co.blocks[0].detach()) == float(
        teng.courant_number(tc, flow).detach())
    dec, = torch.autograd.grad(co.blocks[0], px)
    jf0 = jcase.initial_flow(jc, dt0=5e-3)
    want = np.asarray(jax.grad(lambda p: jeng.courant_number(
        jc, dataclasses.replace(jf0, phi_x=p,
                                phi_y=jnp.full_like(jf0.phi_y, 0.25))))(
        jnp.asarray(phi)))
    assert torch.equal(dec, whole)
    assert float(dec[faces[0]]) == float(dec[faces[1]]) > 0.0
    np.testing.assert_allclose(dec.numpy(), want, rtol=1e-6, atol=0)


# ---- the case-parallel fleet step -------------------------------------------


def test_sharded_fleet_gradient():
    """The fleet step over a mesh of three CPU devices, one case each (2
    steps), under autograd: each case's inlet gradient equals
    run_piso_batched's of the whole fleet bit for bit, and lies within
    FLEET_TOL of jax.grad of JAX's make_sharded_fleet_step on its own
    mesh of three."""
    jc, tc = [], []
    for shape, size in FLEET:
        kw = dict(shape_name=shape, length=3.0, height=1.0,
                  obstacle_size=size)
        jc.append(jcase.build_channel_case(jax_geom(**kw), delta=1.0 / 24))
        tc.append(tcase.build_channel_case(channel_case_geometry(**kw),
                                           delta=1.0 / 24, device="cpu"))
    nx, n = tc[0].grid.nx, 2
    cases = tbat.stack_cases(tc)
    flows = tbat.stack_flows([tcase.initial_flow(c, dt0=5e-4) for c in tc])
    cfg, be = teng.PisoConfig(**FLEET_CFG), TMG(cycles=2)

    x = cases.inlet_u.clone().requires_grad_(True)
    f = tbat.run_piso_batched(dataclasses.replace(cases, inlet_u=x), flows,
                              n, cfg=cfg, backend=be)
    batched, = torch.autograd.grad(_downstream_ke(f.u, nx), x)

    mesh = cpu_mesh((3, 1))
    step = tmesh.make_sharded_fleet_step(mesh, cfg, be)
    x = cases.inlet_u.clone().requires_grad_(True)
    parts_c = tmesh.shard_fleet(mesh, dataclasses.replace(cases, inlet_u=x))
    parts_f = tmesh.shard_fleet(mesh, flows)
    for _ in range(n):
        parts_f = step(parts_c, parts_f)
    got, = torch.autograd.grad(_downstream_ke(
        tmesh.unshard_fleet(mesh, parts_f).u, nx), x)
    assert torch.equal(got, batched)

    jm = jmesh.device_mesh(3)
    jstep = jmesh.make_sharded_fleet_step(jm, jeng.PisoConfig(**FLEET_CFG),
                                          JMG(cycles=2))
    jcases = jmesh.shard_fleet(jm, jbat.stack_cases(jc))
    jflows = jmesh.shard_fleet(jm, jbat.stack_flows(
        [jcase.initial_flow(c, dt0=5e-4) for c in jc]))

    def loss(inlet):
        c, f_ = dataclasses.replace(jcases, inlet_u=inlet), jflows
        for _ in range(n):
            f_ = jstep(c, f_)
        return _downstream_ke(f_.u, nx)

    with jm:
        want = np.asarray(jax.jit(jax.grad(loss))(jcases.inlet_u))
    for k in range(len(FLEET)):
        assert _rel_l2(got[k].numpy(), want[k]) <= FLEET_TOL, k


# ---- a world of processes ---------------------------------------------------

WORLD = """
import dataclasses
import sys
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.parallel import blocks as tblk
from tpufoam_torch.parallel import distributed as d
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend
assert d.init_distributed(device="cpu") and d.is_multihost()
world = d.global_device_mesh(devices=["cpu"] * 2)
assert world.owners == (0, 0, 1, 1), world.owners
tc = tcase.build_channel_case(channel_case_geometry(
    "cylinder", length=8.0, height=2.0, obstacle_size=0.5, nu=8e-3),
    delta=2.0 / 32, device="cpu")
nx = tc.grid.nx
flow0 = tcase.initial_flow(tc, dt0=5e-4)
cfg = teng.PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3)
step = {{}}


def terms(sf, blocks):
    # the downstream energy of each block of the east column
    return {{k: (u ** 2).sum() for k, u in sf.u.local()
             if k % 2 == 1 and k in blocks}}


def grad(mesh, loss):
    with d.world_tape(mesh) as tape:
        x = tc.inlet_u.clone().requires_grad_(True)
        sc = tmesh.shard_case(mesh, dataclasses.replace(tc, inlet_u=x))
        sf = tmesh.shard_flow(mesh, flow0)
        for _ in range(2):
            sf = step[mesh](sc, sf)
        with torch.no_grad():
            sf_ref = tmesh.shard_flow(mesh, flow0)
            for _ in range(2):
                sf_ref = step[mesh](tmesh.shard_case(mesh, tc), sf_ref)
        for name in ("u", "v", "p", "phi_x", "phi_y", "dt"):
            assert torch.equal(getattr(sf, name).gather().detach(),
                               getattr(sf_ref, name).gather()), name
        return loss(mesh, sf, tape, x)


def own(mesh, sf, tape, x):
    t = terms(sf, mesh.local_blocks)
    return tape.grad(sum(t.values()), [x])[0]


def replicated(mesh, sf, tape, x):
    # every process holds the block_sum: one of them passes it
    t = terms(sf, range(4))
    total = tblk.block_sum(mesh, {{k: t.get(k, torch.zeros(()))
                                   for k in mesh.local_blocks}})
    lead = mesh.owners is None or dist.get_rank() == 0
    return tape.grad(total.blocks[mesh.local_blocks[0]] if lead else 0,
                     [x])[0]


def lower(mesh, sf, tape, x):
    # the upper row's process owns no term: its backward still runs
    t = terms(sf, [1])
    return tape.grad(sum(t.values()) if t else torch.zeros(()), [x])[0]


one = tmesh.device_mesh(4, devices=["cpu"] * 4)
for m in (world, one):
    step[m] = tmesh.make_sharded_piso_step(m, cfg, MGBackend(cycles=2))
# outside a tape a copy of a tensor that needs a gradient raises
x = tc.inlet_u.clone().requires_grad_(True)
try:
    step[world](tmesh.shard_case(world, dataclasses.replace(tc, inlet_u=x)),
                tmesh.shard_flow(world, flow0))
except RuntimeError as e:
    assert "world_tape" in str(e), e
    print("rank", dist.get_rank(), "raised", flush=True)
for loss in (own, replicated, lower):
    gw, go = grad(world, loss), grad(one, loss)
    rel = float((gw.double() - go.double()).norm() / go.double().norm())
    assert rel <= {tol}, (loss.__name__, rel)
    print("rank", dist.get_rank(), loss.__name__, "rel", rel, flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_world_of_two_processes_gradient_equals_one_process():
    """Two gloo processes, each owning one row of blocks of a 2 x 2 mesh,
    take the inlet gradient through 2 decomposed steps inside a
    world_tape: each differentiates its own blocks' terms, the world's
    gradient is their sum, and it lies within WORLD_TOL of one process's
    gradient on a 2 x 2 mesh of its own. A block_sum-replicated loss is
    counted once, and a loss that only the lower row's process holds
    still runs every backward exchange on both (no deadlock). The
    forward inside the tape equals the plain forward bit for bit; outside
    a tape a copy of a tensor that needs a gradient raises."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORLD.format(root=ROOT, tol=WORLD_TOL)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "MASTER_ADDR": "localhost",
             "MASTER_PORT": str(port), "WORLD_SIZE": "2",
             "RANK": str(rank)}) for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out + err
        assert f"rank {rank} raised" in out, out + err
        for name in ("own", "replicated", "lower"):
            assert f"rank {rank} {name} rel" in out, out + err
