"""The parallel layer of tpufoam_torch on the CPU: meshes, the sharded
momentum and pressure multisweeps (ops.sharded), the spatially sharded
PISO step, the case-parallel fleet and the process-group bootstrap,
against the global functions of the port and against the JAX package's
sharded functions on the 8 virtual CPU devices of tests/conftest.py. The
port's meshes here are `devices=["cpu"] * n`, so every block runs the
kernels' plain versions.

Tolerances:
- The sharded plain versions against the global plain versions, and the
  sharded step and fleet against the port's unsharded ones: bit for bit.
  Each kept cell runs the same operations on the same values (the halo
  is as deep as the sweeps), so nothing may differ.
- Against the JAX package's sharded kernels in interpret mode: the
  momentum multisweep within 1e-5 of max |u|, |v| (tests/
  test_torch_momentum_kernel.py: eight float32 sweeps summed in another
  order); the pressure multisweep within 1e-5 of max |x| in float32 and
  one bfloat16 ulp (2^-8) of max |x| in bfloat16 (both round after every
  operation; tests/test_torch_pressure_stencil.py measured them equal).
- The port's sharded step against the JAX package's sharded step (phi_x
  against its single-device step: see that test): tests/
  test_torch_piso.py's f32 tolerance, 1e-4 of each field's max (the same
  float32 step rounded by two frameworks; measured up to 1.4e-6).
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

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.fv.pressure import PressureCoeffs as JCoeffs
from tpufoam.ops import stencil as jst
from tpufoam.parallel import mesh as jmesh
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv import momentum as tfvm
from tpufoam_torch.fv.pressure import PressureCoeffs
from tpufoam_torch.ops import sharded as tsh
from tpufoam_torch.ops.momentum import momentum_multisweep_plain
from tpufoam_torch.ops import stencil as tst
from tpufoam_torch.ops.stencil import jacobi_multisweep_plain
from tpufoam_torch.parallel import distributed as tdist
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend as TMG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]
FIELDS = ("u", "v", "p", "phi_x", "phi_y", "dt", "t")
MOMENTUM_RTOL = 1e-5
JACOBI_TOL = {"f32": 1e-5, "bf16": 2.0 ** -8}
STEP_TOL = 1e-4
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def cpu_mesh(shape):
    return tmesh.device_mesh(shape[0] * shape[1], shape=shape,
                             devices=["cpu"] * (shape[0] * shape[1]))


def momentum_operands(ny, nx, seed):
    """Random structured momentum operands (numpy float32): zero
    conductances out of the domain, diagonally dominant, a few solid
    cells."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return rng.uniform(lo, hi, (ny, nx)).astype(np.float32)

    a_e, a_w, a_n, a_s = (f(0, 1) for _ in range(4))
    a_e[:, -1] = 0
    a_w[:, 0] = 0
    a_n[-1, :] = 0
    a_s[0, :] = 0
    fluid = (f(0, 1) > 0.05).astype(np.float32)
    ap_inv = fluid / (a_e + a_w + a_n + a_s + f(0.5, 2.0))
    return (a_e, a_w, a_n, a_s, ap_inv, f(-1, 1), f(-1, 1), f(-1, 1) * fluid,
            f(-1, 1) * fluid)


def pressure_operands(ny, nx, seed):
    """(c_e, c_w, c_n, c_s, diag, x, b) in numpy float32: conductances
    zero out of the domain, diag above their sum (never 0), x and b."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return rng.uniform(lo, hi, (ny, nx)).astype(np.float32)

    c = [f(0, 1) for _ in range(4)]
    c[0][:, -1] = 0
    c[1][:, 0] = 0
    c[2][-1, :] = 0
    c[3][0, :] = 0
    diag = c[0] + c[1] + c[2] + c[3] + f(0.1, 1.0)
    return (*c, diag, f(-1, 1), f(-1, 1))


def torch_coeffs(arrs, dt):
    c = [torch.as_tensor(a).to(dt) for a in arrs[:5]]
    return PressureCoeffs(*c[:4], torch.zeros_like(c[4]), c[4])


# ---- meshes ----------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_device_mesh_factorises_as_jax(n):
    ref = jmesh.device_mesh(n)
    got = tmesh.device_mesh(n, devices=["cpu"] * n)
    assert got.shape == dict(ref.shape)
    assert got.size == n and got.axis_names == tuple(ref.axis_names)


def test_device_mesh_defaults_to_the_cards():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in tmesh.device_mesh().device_list)
    else:
        with pytest.raises(RuntimeError):
            tmesh.device_mesh()
    with pytest.raises(ValueError):
        tmesh.device_mesh(3, shape=(2, 2), devices=["cpu"] * 4)


def test_mesh_is_hashable_in_a_config():
    mesh = cpu_mesh((2, 2))
    cfg = teng.PisoConfig(shard_mesh=mesh)
    assert hash(cfg) == hash(teng.PisoConfig(shard_mesh=cpu_mesh((2, 2))))
    assert mesh.lead == torch.device("cpu")


# ---- halo exchange ----------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_exchange_halos_equals_windows_of_the_zero_padded_field(shape):
    """Every haloed block is the window of the global stack, zero-padded
    by the halo along the split axes: neighbours' strips, corners and the
    zero edge."""
    dy, dx = shape
    ny, nx, hy, hx = 32, 48, 8 * (dy > 1), 8 * (dx > 1)
    mesh = cpu_mesh(shape)
    g = torch.arange(3 * ny * nx, dtype=torch.float32).reshape(3, ny, nx) + 1
    nyl, nxl = ny // dy, nx // dx
    blocks = [[g[:, i * nyl:(i + 1) * nyl, j * nxl:(j + 1) * nxl]
               for j in range(dx)] for i in range(dy)]
    got = tsh.exchange_halos(blocks, mesh, hy, hx)
    pad = torch.nn.functional.pad(g, (hx, hx, hy, hy))
    for i in range(dy):
        for j in range(dx):
            assert torch.equal(got[i][j], pad[:, i * nyl:i * nyl + nyl + 2 * hy,
                                              j * nxl:j * nxl + nxl + 2 * hx])


# ---- sharded plain versions against the global plain versions ---------------


@pytest.mark.parametrize("sweeps", [1, 4, 8])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_momentum_plain_equals_global_plain(shape, sweeps):
    ops = [torch.as_tensor(a) for a in momentum_operands(32, 64, sweeps)]
    mesh = cpu_mesh(shape)
    ref = momentum_multisweep_plain(*ops, sweeps=sweeps)
    for fn in (tsh.momentum_multisweep_sharded,
               tsh.momentum_multisweep_sharded_plain):
        got = fn(mesh, *ops, sweeps=sweeps)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (fn.__name__, shape, sweeps)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", MESHES + [(4, 1)])
def test_sharded_jacobi_plain_equals_global_plain(shape, prec):
    """Iters 1, 2 and the halo; 96 x 80 keeps bf16's 16-row halo inside
    the (4, ny/4) blocks."""
    dt = DTYPES[prec][0]
    arrs = pressure_operands(96, 80, 7)
    coef = torch_coeffs(arrs, dt)
    x, b = (torch.as_tensor(a).to(dt) for a in arrs[5:])
    mesh = cpu_mesh(shape)
    assert tsh.sharded_available_for((96, 80), mesh, dt, "jacobi")
    for iters in (1, 2, 16 if prec == "bf16" else 8):
        ref = jacobi_multisweep_plain(coef, x, b, iters)
        for fn in (tsh.jacobi_multisweep_sharded,
                   tsh.jacobi_multisweep_sharded_plain):
            assert torch.equal(fn(mesh, coef, x, b, iters), ref), \
                (fn.__name__, iters)


# ---- the routes: window and exchange -----------------------------------------


def test_routes_by_mesh_dtype_and_width(monkeypatch):
    """The operands' card's blocks take the window route (up to
    MAX_WINDOW_BLOCKS of them), every other card's the exchange route;
    the pressure multisweep's window form also needs a block width of
    whole 16-byte runs (4 float32, 8 bfloat16 cells), 16-byte aligned
    operands and a plane the region kernel would not take."""
    cpu = torch.device("cpu")
    for shape in ((2, 2), (4, 1), (1, 4), (4, 2)):
        mesh = cpu_mesh(shape)
        for dt in (torch.float32, torch.bfloat16):
            assert tsh.sharded_routes(mesh, (64, 256), dt) \
                == {cpu: "window"}
            for iters in (1, 2, 16 if dt == torch.bfloat16 else 8):
                assert tsh.sharded_routes(mesh, (64, 256), dt, "jacobi",
                                          iters) == {cpu: "window"}
                assert tsh.sharded_routes(mesh, (64, 256), dt, "jacobi",
                                          iters, aligned=False) \
                    == {cpu: "exchange"}
    m22 = cpu_mesh((2, 2))
    # blocks of 34 columns: no whole number of runs in either dtype; of
    # 36: whole float32 runs, no whole bfloat16 runs
    for dt in (torch.float32, torch.bfloat16):
        assert tsh.sharded_routes(m22, (64, 68), dt, "jacobi", 2) \
            == {cpu: "exchange"}
        assert tsh.sharded_routes(m22, (64, 68), dt) == {cpu: "window"}
    assert tsh.sharded_routes(m22, (64, 72), torch.float32, "jacobi", 2) \
        == {cpu: "window"}
    assert tsh.sharded_routes(m22, (64, 72), torch.bfloat16, "jacobi", 2) \
        == {cpu: "exchange"}
    # blocks on another device than the operands', and more blocks than
    # one window launch takes
    two = tmesh.device_mesh(2, shape=(1, 2), devices=["cpu", "meta"])
    for kernel in ("momentum", "jacobi"):
        assert tsh.sharded_routes(two, (32, 64), kernel=kernel) == {
            cpu: "window", torch.device("meta"): "exchange"}
        assert tsh.sharded_routes(two, (32, 64), kernel=kernel,
                                  operands_on="meta") == {
            cpu: "exchange", torch.device("meta"): "window"}
    big = cpu_mesh((8, 9))
    assert tsh.sharded_routes(big, (128, 576)) == {cpu: "exchange"}
    assert tsh.sharded_routes(cpu_mesh((8, 8)), (128, 512)) \
        == {cpu: "window"}
    # the region kernel forced: the pressure multisweep's exchange route
    monkeypatch.setattr(tsh._st, "_REGION_BELOW_CELLS", 1 << 62)
    assert tsh.sharded_routes(m22, (64, 256), torch.float32, "jacobi",
                              1) == {cpu: "exchange"}
    assert tsh.sharded_routes(m22, (64, 256)) == {cpu: "window"}
    with pytest.raises(ValueError, match="unknown kernel"):
        tsh.sharded_routes(m22, (64, 256), kernel="matvec")


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_exchange_route_equals_the_window_route(prec):
    """On the CPU both routes run the plain version: 96 x 84 over 2 x 2
    (blocks of 42 columns) takes the exchange route, the same operands
    cut to 96 x 80 the window route; each equals the sharded plain
    version and the global plain version bit for bit."""
    dt = DTYPES[prec][0]
    mesh = cpu_mesh((2, 2))
    arrs = pressure_operands(96, 84, 17)
    for nx, route in ((84, "exchange"), (80, "window")):
        cut = [np.ascontiguousarray(a[:, :nx]) for a in arrs]
        coef = torch_coeffs(cut, dt)
        x, b = (torch.as_tensor(a).to(dt) for a in cut[5:])
        for iters in (1, 2, 16 if prec == "bf16" else 8):
            assert tsh.sharded_routes(mesh, (96, nx), dt, "jacobi",
                                      iters) == {torch.device("cpu"): route}
            got = tsh.jacobi_multisweep_sharded(mesh, coef, x, b, iters)
            assert torch.equal(got, tsh.jacobi_multisweep_sharded_plain(
                mesh, coef, x, b, iters))
            assert torch.equal(got, jacobi_multisweep_plain(coef, x, b,
                                                            iters))


# ---- against the JAX package's sharded kernels ------------------------------


def test_sharded_momentum_matches_jax():
    ops = momentum_operands(32, 512, 11)
    jm = jmesh.device_mesh(4)
    assert dict(jm.shape) == {"data": 2, "model": 2}
    with jm:
        ref = jst.momentum_multisweep_pallas_sharded(
            jm, *(jnp.asarray(a) for a in ops), sweeps=8, interpret=True)
    got = tsh.momentum_multisweep_sharded(
        cpu_mesh((2, 2)), *(torch.as_tensor(a) for a in ops), sweeps=8)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= MOMENTUM_RTOL * float(np.abs(r).max()), err


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("grid,shape", [((32, 512), (2, 2)),
                                        ((96, 516), (4, 2))])
def test_sharded_jacobi_matches_jax(grid, shape, prec):
    """32 x 512 over 2 x 2, and 96 x 516 over 4 x 2: local blocks of
    24 x 258, odd for both packages' tiles (tests/test_parallel.py)."""
    dt, jdt = DTYPES[prec]
    arrs = pressure_operands(*grid, 13)
    jm = jmesh.device_mesh(shape[0] * shape[1])
    assert tuple(jm.shape.values()) == shape
    jc = JCoeffs(*(jnp.asarray(a, dtype=jdt) for a in arrs[:4]),
                 c_out=jnp.zeros(grid, dtype=jdt),
                 diag=jnp.asarray(arrs[4], dtype=jdt))
    with jm:
        ref = jst.jacobi_multisweep_pallas_sharded(
            jm, jc, jnp.asarray(arrs[5], dtype=jdt),
            jnp.asarray(arrs[6], dtype=jdt), iters=4, omega=0.8,
            interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = tsh.jacobi_multisweep_sharded(
        cpu_mesh(shape), torch_coeffs(arrs, dt),
        torch.as_tensor(arrs[5]).to(dt), torch.as_tensor(arrs[6]).to(dt),
        iters=4, omega=0.8).float().numpy()
    err = float(np.abs(got - ref).max())
    assert err <= JACOBI_TOL[prec] * float(np.abs(ref).max()), err


# ---- gates --------------------------------------------------------------------


def test_gate_refuses_what_the_blocks_cannot_hold():
    m22, m42 = cpu_mesh((2, 2)), cpu_mesh((4, 2))
    assert tsh.sharded_available_for((32, 64), m22)
    assert not tsh.sharded_available_for((33, 64), m22)      # rows
    assert not tsh.sharded_available_for((32, 63), m22)      # columns
    assert not tsh.sharded_available_for((24, 64), m42)      # 6 rows < 8
    assert tsh.sharded_available_for((32, 64), m42)
    assert not tsh.sharded_available_for((32, 64), m42, torch.bfloat16,
                                         "jacobi")           # 8 rows < 16
    assert tsh.sharded_available_for((64, 64), m42, torch.bfloat16,
                                     "jacobi")
    assert not tsh.sharded_available_for((4, 32, 64), m22)   # a fleet
    assert not tsh.sharded_available_for((32, 64), m22, torch.bfloat16,
                                         "momentum")
    with pytest.raises(ValueError):
        tsh.sharded_available_for((32, 64), m22, kernel="matvec")
    ops = [torch.as_tensor(a) for a in momentum_operands(24, 64, 0)]
    with pytest.raises(ValueError):
        tsh.momentum_multisweep_sharded(m42, *ops)
    with pytest.raises(ValueError):
        tsh.momentum_multisweep_sharded(m22, *ops, sweeps=9)


@pytest.fixture(scope="module")
def channel():
    """A 32 x 512 cylinder channel in both packages (delta 1/64)."""
    kw = dict(shape_name="cylinder", length=8.0, height=0.5,
              obstacle_size=0.2)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=1.0 / 64)
    tc = tcase.build_channel_case(channel_case_geometry(**kw),
                                  delta=1.0 / 64, device="cpu")
    return jc, tc


@pytest.mark.parametrize("shape,dispatch", [((2, 2), "sharded"),
                                            ((3, 2), "single"),
                                            ((8, 1), "single")])
def test_jacobi_momentum_dispatch(channel, shape, dispatch, monkeypatch):
    """A mesh the gate takes runs the sharded kernel, equal to the single
    kernel's plain version; one it refuses (32 rows over 3, blocks of 4
    rows) runs the single kernel on the whole fields; neither runs the
    sweep loop."""
    _, tc = channel
    flow = tcase.initial_flow(tc, 2e-3)
    coef = tfvm.momentum_coeffs(tc, flow.phi_x, flow.phi_y, flow.u, flow.v,
                                flow.dt)
    src = [torch.as_tensor(np.random.default_rng(k).standard_normal(
        tc.grid.shape).astype(np.float32) * 1e-3) for k in range(2)]
    calls = []
    for name in ("momentum_multisweep_sharded", "momentum_multisweep"):
        impl = getattr(tfvm, name)
        monkeypatch.setattr(tfvm, name, lambda *a, _n=name, _f=impl, **kw:
                            calls.append(_n) or _f(*a, **kw))
    loops = tfvm.jacobi_momentum.sweep_loops
    got = tfvm.jacobi_momentum(coef, tc, flow.u, flow.v, *src, sweeps=8,
                               smoother="kernel", mesh=cpu_mesh(shape))
    assert calls == ["momentum_multisweep" if dispatch == "single"
                     else "momentum_multisweep_sharded"]
    ref = tfvm.jacobi_momentum(coef, tc, flow.u, flow.v, *src, sweeps=8,
                               smoother="kernel")
    assert calls[1:] == ["momentum_multisweep"]
    assert tfvm.jacobi_momentum.sweep_loops == loops
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_shard_case_and_flow_check_divisibility(channel):
    _, tc = channel
    flow = tcase.initial_flow(tc, 2e-3)
    mesh = cpu_mesh((4, 2))
    placed = tmesh.shard_case(mesh, tc)
    # resident per block, each block on its device, with its stored halo
    assert [b.device for b in placed.fluid.blocks] == list(mesh.device_list)
    assert placed.fluid.blocks[0].shape == (8 + 8, 256 + 8)
    assert torch.equal(tmesh.unshard_case(placed).fluid, tc.fluid)
    sf = tmesh.shard_flow(mesh, flow)
    assert sf.phi_x.blocks[1].shape == (8, 257)      # the outlet's face
    assert torch.equal(tmesh.unshard_flow(sf).phi_x, flow.phi_x)
    for shape in ((3, 1), (1, 3)):      # 32 rows, 512 columns
        with pytest.raises(ValueError):
            tmesh.shard_case(cpu_mesh(shape), tc)
        with pytest.raises(ValueError):
            tmesh.shard_flow(cpu_mesh(shape), flow)


# ---- the sharded PISO step --------------------------------------------------


def test_sharded_step_matches_jax_and_the_unsharded_step(channel,
                                                         monkeypatch):
    """The JAX package's sharded step is the reference for every field
    but phi_x: with the mesh split along x its phi_x differs from its own
    single-device step at the face between the x blocks (column nx/2, by
    3.4e-3 of max |phi_x| here, with the XLA smoother too), so phi_x is
    held to the JAX package's single-device step, which the sharded step
    is meant to equal (ROADMAP, section C)."""
    jc, tc = channel
    monkeypatch.setattr(jst, "_INTERPRET", True)
    jax.clear_caches()
    jm = jmesh.device_mesh(4)
    jcfg = jeng.PisoConfig(n_correctors=2, momentum_smoother="pallas")
    jflow0 = jcase.initial_flow(jc, 2e-3)
    jstep = jmesh.make_sharded_piso_step(jm, jcfg, JMG(cycles=2))
    with jm:
        ref = jstep(jmesh.shard_case(jm, jc), jmesh.shard_flow(jm, jflow0))
        jax.block_until_ready(ref.u)
    jax.clear_caches()
    ref = dataclasses.replace(ref, phi_x=jeng.piso_step(
        jc, jflow0, jcfg, JMG(cycles=2)).phi_x)

    mesh = cpu_mesh((2, 2))
    calls = []
    for name in ("momentum_multisweep_sharded", "momentum_multisweep"):
        impl = getattr(tfvm, name)
        monkeypatch.setattr(tfvm, name, lambda *a, _n=name, _f=impl, **kw:
                            calls.append((_n, tuple(a[0].shape)))
                            or _f(*a, **kw))
    cfg = teng.PisoConfig(n_correctors=2, momentum_smoother="kernel")
    step = tmesh.make_sharded_piso_step(mesh, cfg, TMG(cycles=2))
    flow0 = tcase.initial_flow(tc, 2e-3)
    got = tmesh.unshard_flow(step(tmesh.shard_case(mesh, tc),
                                  tmesh.shard_flow(mesh, flow0)))
    # the momentum kernel once per block, on its window of 8 cells
    assert calls == [("momentum_multisweep", (24, 264))] * 4
    for name in FIELDS:
        r = np.asarray(getattr(ref, name))
        err = float(np.abs(getattr(got, name).numpy() - r).max())
        assert err <= STEP_TOL * max(float(np.abs(r).max()), 1e-30), \
            (name, err)
    single = teng.piso_step(tc, flow0, cfg, TMG(cycles=2))
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(single, name)), name


@pytest.mark.parametrize("smoother", ["kernel", "kernel-fused"])
def test_sharded_step_keeps_the_kernel_smoother(channel, smoother,
                                                monkeypatch):
    """The pressure solve runs on the blocks with the backend's kernel
    smoother, per block (the JAX package downgrades its 'pallas' smoother
    here), and the step equals `piso_step` with the same backend bit for
    bit."""
    _, tc = channel
    mesh = cpu_mesh((2, 2))
    cfg = teng.PisoConfig(n_correctors=1, momentum_smoother="kernel")
    seen = []
    names = ("jacobi_multisweep",) if smoother == "kernel" \
        else ("smooth_residual", "corr_smooth")
    for name in names:
        impl = getattr(tst, name)
        monkeypatch.setattr(tst, name, lambda c, x, *a, _f=impl, **kw:
                            seen.append(tuple(x.shape)) or _f(c, x, *a, **kw))
    backend = TMG(cycles=1, smoother=smoother)
    step = tmesh.make_sharded_piso_step(mesh, cfg, backend)
    flow0 = tcase.initial_flow(tc, 2e-3)
    got = tmesh.unshard_flow(step(tmesh.shard_case(mesh, tc),
                                  tmesh.shard_flow(mesh, flow0)))
    # every kernel launch on a block's window, none on a whole level
    assert seen and (32, 512) not in seen and (16, 256) not in seen
    ref = teng.piso_step(tc, flow0, cfg, backend)
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


# ---- the case-parallel fleet ------------------------------------------------


@pytest.fixture(scope="module")
def fleet():
    geoms = [("cylinder", 0.3), ("rectangle", 0.25), ("triangle", 0.3),
             ("ellipse", 0.35)]
    cases = [tcase.build_channel_case(channel_case_geometry(
        shape, length=3.0, height=1.0, obstacle_size=size), delta=1.0 / 24,
        device="cpu") for shape, size in geoms]
    return tbat.stack_cases(cases), tbat.stack_flows(
        [tcase.initial_flow(c, 2e-3) for c in cases])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_fleet_equals_the_batched_fleet(fleet, n_dev):
    cases, flows = fleet
    mesh = tmesh.device_mesh(n_dev, devices=["cpu"] * n_dev)
    cfg = teng.PisoConfig(momentum_smoother="kernel", max_dt=2e-3)
    backend = TMG(cycles=2)
    ref = tbat.run_piso_batched(cases, flows, 2, cfg=cfg, backend=backend)
    step = tmesh.make_sharded_fleet_step(mesh, cfg, backend)
    parts_c = tmesh.shard_fleet(mesh, cases)
    parts_f = tmesh.shard_fleet(mesh, flows)
    assert len(parts_c) == n_dev
    assert parts_c[0].fluid.shape[0] == 4 // n_dev
    for _ in range(2):
        parts_f = step(parts_c, parts_f)
    got = tmesh.unshard_fleet(mesh, parts_f)
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    with pytest.raises(ValueError):
        tmesh.shard_fleet(tmesh.device_mesh(3, devices=["cpu"] * 3), cases)


def test_unported_pieces_raise():
    """The mesh's training pieces, once stubs, are ported
    (tests/test_torch_train.py holds them to JAX); they raise only where
    the JAX package's do: a tree without dense layers has no partition
    specs, and a batch must divide over the mesh's 'data' axis."""
    from tpufoam_torch.models.mlp import ModelDef, init_model
    from tpufoam_torch.train.trainer import Adam
    for mod in (tmesh, jmesh):
        with pytest.raises(KeyError):
            mod.mlp_partition_specs({})
    mesh = tmesh.device_mesh(2, shape=(2, 1), devices=["cpu"] * 2)
    mdef = ModelDef.from_arch("MLP_small", in_dim=4, out_dim=2)
    params = init_model(0, mdef, device="cpu")
    opt = Adam(1e-3)
    step, shard = tmesh.make_sharded_train_step(mesh, mdef, opt)
    with pytest.raises(ValueError, match="divide"):
        shard(params, opt.init(params), torch.zeros(3, 4), torch.zeros(3, 2))


# ---- the process group --------------------------------------------------------


def test_distributed_config_from_env():
    cfg = tdist.DistributedConfig.from_env(
        {"MASTER_ADDR": "localhost", "MASTER_PORT": "29500",
         "WORLD_SIZE": "2", "RANK": "1"})
    assert cfg == tdist.DistributedConfig("localhost", 29500, 2, 1)
    assert cfg.explicit and cfg.init_method == "tcp://localhost:29500"
    partial = tdist.DistributedConfig.from_env({"MASTER_ADDR": "h",
                                                "WORLD_SIZE": ""})
    assert not partial.explicit and partial.world_size is None
    assert tdist.init_distributed(tdist.DistributedConfig(),
                                  device="cpu") is False
    assert not tdist.is_multihost()


WORLD = """
import sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
from tpufoam_torch.parallel import distributed as d
assert d.init_distributed(device="cpu")
assert dist.get_backend() == "gloo"
if dist.get_world_size() == 1:
    assert not d.is_multihost()
    mesh = d.global_device_mesh(devices=["cpu"] * 4)
    print("mesh", mesh.shape)
else:
    assert d.is_multihost()
    mesh = d.global_device_mesh(devices=["cpu"] * 2)
    assert mesh.owners == (0, 0, 1, 1)
    assert mesh.local_blocks == ((0, 1) if dist.get_rank() == 0 else (2, 3))
    print("mesh", mesh.shape)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [1, 2])
def test_world_of_processes_with_gloo(world):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORLD.format(root=ROOT)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "MASTER_ADDR": "localhost",
             "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
             "RANK": str(rank)}) for rank in range(world)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
        assert "mesh {'data': 2, 'model': 2}" in out
