"""The domain-decomposed step on the CPU: fields resident per block of a
mesh (parallel.blocks), the stages and the pressure solve on the blocks
(piso.decomposed, solvers.decomposed), against the port's single-device
step and the JAX package's sharded step on tests/conftest.py's 8 virtual
CPU devices. The meshes are `devices=["cpu"] * n`, so every block runs
the kernels' plain versions.

Tolerances:
- The decomposed step against `piso_step` (and `piso_step_sst`) with a
  fixed-cycle multigrid: bit for bit. Every kept cell runs the same
  operations on the same values (each stage's halo is at least its
  reach, the multigrid's transfers keep their parity), and a max is
  exact, so nothing may differ.
- With the solvers that stop on a residual (CGBackend, MGCGBackend,
  MGBackend with rtol, AutoBackend): the dot products and norms are
  summed per block, then over the blocks, which rounds otherwise than
  one whole-field sum; a float32 solve to rtol 1e-6 of an operator of
  this condition then lands within 1e-3 of each field's max of the whole
  solve (measured after one step on 2 x 2 at 32 x 512: CG 2.2e-4 in p,
  MGCG 4.2e-5; AutoBackend, whose escalation stops at rtol 1e-3 after at
  most 6 iterations, 7.1e-3 in phi_y, held to 2e-2).
- Against the JAX package's sharded step: tests/test_torch_piso.py's f32
  tolerance, 1e-4 of each field's max, phi_x against JAX's single-device
  step (its sharded phi_x is off at the x-blocks' face; ROADMAP, C).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.ops import stencil as jst
from tpufoam.parallel import mesh as jmesh
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.eval import benchmark as tbench
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv import turbulence as tturb
from tpufoam_torch.fv import momentum as tfvm
from tpufoam_torch.ops import sharded as tsh
from tpufoam_torch.parallel import blocks as tblk
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso import decomposed as tdec
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers import decomposed as tds
from tpufoam_torch.solvers import multigrid as tmg
from tpufoam_torch.solvers.backends import (AutoBackend, CGBackend,
                                            MGBackend, MGCGBackend)
from tpufoam_torch.surrogate.pipeline import SurrogateBundle, make_predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 1), (1, 2), (2, 2), (4, 2)]
FIELDS = ("u", "v", "p", "phi_x", "phi_y", "dt", "t")
TURB = ("k", "omega", "nu_t", "k_in", "w_in")
STEP_TOL = 1e-4
SOLVE_TOL = 1e-3
AUTO_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def cpu_mesh(shape):
    n = shape[0] * shape[1]
    return tmesh.device_mesh(n, shape=shape, devices=["cpu"] * n)


def assert_equal(got, ref, names):
    for name in names:
        g, r = getattr(got, name), getattr(ref, name)
        assert torch.equal(g, r), (name, float((g - r).abs().max()))


def assert_close(got, ref, names, tol):
    for name in names:
        g, r = getattr(got, name), getattr(ref, name)
        err = float((g - r).abs().max())
        assert err <= tol * max(float(r.abs().max()), 1e-30), (name, err)


def decomposed_steps(mesh, case, flow, n, cfg, backend, sm=None,
                     turb=None):
    """n decomposed steps from the whole state; the whole fields back."""
    sc, sf = tmesh.shard_case(mesh, case), tmesh.shard_flow(mesh, flow)
    if turb is None:
        step = tmesh.make_sharded_piso_step(mesh, cfg, backend, sm)
        with torch.no_grad():
            for _ in range(n):
                sf = step(sc, sf)
        return tmesh.unshard_flow(sf)
    step = tmesh.make_sharded_sst_step(mesh, cfg, backend, sm)
    st = tmesh.shard_turbulence(mesh, turb)
    with torch.no_grad():
        for _ in range(n):
            sf, st = step(sc, sf, st)
    return tmesh.unshard_flow(sf), tmesh.unshard_turbulence(st)


def single_steps(case, flow, n, cfg, backend, sm=None, turb=None):
    with torch.no_grad():
        for _ in range(n):
            if turb is None:
                flow = teng.piso_step(case, flow, cfg, backend, sm)
            else:
                flow, turb = teng.piso_step_sst(case, flow, turb, cfg,
                                                backend, sm)
    return flow if turb is None else (flow, turb)


@pytest.fixture(scope="module")
def channel():
    """A 32 x 512 cylinder channel in both packages (delta 1/64)."""
    kw = dict(shape_name="cylinder", length=8.0, height=0.5,
              obstacle_size=0.2)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=1.0 / 64)
    tc = tcase.build_channel_case(channel_case_geometry(**kw),
                                  delta=1.0 / 64, device="cpu")
    return jc, tc


# ---- the layout ---------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES + [(1, 1)])
@pytest.mark.parametrize("stagger", [(0, 0), (0, 1), (1, 0)])
def test_split_windows_and_gather(shape, stagger):
    """Each block's window of halo h is the whole field's window (clipped
    at the domain), its crop the block's own part, and gather() the whole
    field again; a face field's last face belongs to the last block."""
    mesh = cpu_mesh(shape)
    ny, nx = 32 + stagger[0], 64 + stagger[1]
    whole = torch.arange(ny * nx, dtype=torch.float32).reshape(ny, nx)
    field = tblk.split(mesh, whole, stagger)
    assert torch.equal(field.gather(), whole)
    dy, dx = shape
    for h in (1, 3):
        for k, (w,) in tblk.windows([field], h).items():
            i, j = divmod(k, dx)
            ya, yb = tblk._span(32, dy, i, stagger[0], h if dy > 1 else 0)
            xa, xb = tblk._span(64, dx, j, stagger[1], h if dx > 1 else 0)
            assert torch.equal(w, whole[ya:yb, xa:xb])
            own = tblk.crop(mesh, whole.shape, k, w, h, stagger)
            assert torch.equal(own, field.blocks[k])
    last = field.blocks[-1]
    assert last.shape == (32 // dy + stagger[0], 64 // dx + stagger[1])


def test_stored_halo_and_scalars():
    mesh = cpu_mesh((2, 2))
    whole = torch.randn(16, 32)
    field = tblk.split(mesh, whole, halo=(4, 4))
    assert field.blocks[0].shape == (12, 20)
    assert torch.equal(field.gather(), whole)
    for k, (w,) in tblk.windows([field], 2).items():
        assert w._base is not None          # a view of the stored halo
    dt = tblk.split(mesh, torch.tensor(0.5))
    assert all(torch.equal(b, torch.tensor(0.5)) for b in dt.blocks)
    rows = tblk.split(mesh, torch.arange(16.0), halo=(2, 0))
    assert torch.equal(rows.gather(), torch.arange(16.0))
    with pytest.raises(ValueError):
        tblk.split(mesh, torch.zeros(15, 32))
    with pytest.raises(ValueError):
        tblk.split(mesh, whole, halo=(9, 9))


def test_reductions_combine_blocks_in_mesh_order():
    mesh = cpu_mesh((2, 2))
    a = tblk.split(mesh, torch.randn(16, 32, dtype=torch.float64))
    b = tblk.split(mesh, torch.randn(16, 32, dtype=torch.float64))
    ref = sum(float((a.blocks[k] * b.blocks[k]).sum()) for k in range(4))
    assert tblk.value(tblk.dot(a, b)) == pytest.approx(ref, rel=1e-12)
    assert tblk.value(tblk.norm(a)) == pytest.approx(
        float(a.gather().norm()), rel=1e-12)
    m = tblk.block_max(mesh, {k: t.max() for k, t in a.local()})
    assert tblk.value(m) == float(a.gather().max())


# ---- the pressure solve on the blocks ----------------------------------------


def _operator(tc, seed=0):
    flow = tcase.initial_flow(tc, 2e-3)
    rng = np.random.default_rng(seed)
    rau = torch.as_tensor(rng.uniform(0.5, 1.5, tc.grid.shape).astype(
        np.float32)) * tc.fluid
    from tpufoam_torch.fv.pressure import pressure_coeffs
    coef = pressure_coeffs(tc, rau)
    b = torch.as_tensor(rng.standard_normal(tc.grid.shape).astype(
        np.float32)) * tc.fluid
    return coef, b, flow.p


def _block_op(mesh, coef):
    return tds.BlockOperator(type(coef)(*(
        tblk.split(mesh, getattr(coef, f.name))
        for f in dataclasses.fields(coef))))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("prec,smoother,cycle", [
    ("f32", "plain", "v"), ("bf16", "plain", "w"), ("f32", "kernel", "v"),
    ("bf16", "kernel-fused", "v")])
def test_mg_solve_on_blocks_equals_mg_solve(channel, shape, prec, smoother,
                                            cycle):
    """mg_solve (and a W cycle's correction) on the blocks, agglomerated
    below them, equal the whole solve bit for bit."""
    _, tc = channel
    mesh = cpu_mesh(shape)
    coef, b, x0 = _operator(tc)
    dtype = torch.bfloat16 if prec == "bf16" else None
    op = _block_op(mesh, coef)
    bb, xb = tblk.split(mesh, b), tblk.split(mesh, x0)
    got = tds.mg_solve(op, bb, xb, cycles=2, dtype=dtype,
                       smoother=smoother).gather()
    ref = tmg.mg_solve(coef, b, x0, cycles=2, dtype=dtype, smoother=smoother)
    assert torch.equal(got, ref)
    h = tds.build_hierarchy(op, 1, 1, dtype=dtype)
    levels = tmg.build_hierarchy(coef)
    assert len(h.levels) + len(h.tail) == len(levels)
    lp = tmg._cast_levels(levels, dtype) if dtype is not None else None
    got = tds.v_cycle_correction(h, bb, 1, 1, dtype, cycle_type=cycle)
    ref = tmg.v_cycle_correction(levels, lp, b, 1, 1, dtype,
                                 cycle_type=cycle)
    assert torch.equal(got.gather(), ref)


def test_agglomeration_level_at_the_main_paths_shape():
    """At 512 x 2048 on a 2 x 2 mesh the blocks hold every level but the
    coarsest (8 x 32): blocks of 256 x 1024 .. 8 x 32, the coarsest level
    gathered (shapes only: the operator is a uniform one)."""
    mesh = cpu_mesh((2, 2))
    ones = torch.ones(512, 2048)
    from tpufoam_torch.fv.pressure import PressureCoeffs
    coef = PressureCoeffs(ones, ones, ones, ones, 0 * ones, 4 * ones)
    h = tds.build_hierarchy(_block_op(mesh, coef), 2, 2)
    assert [lv.local_dims() for lv in h.levels] == [
        (256 >> n, 1024 >> n) for n in range(6)]
    assert [tuple(c.diag.shape) for c in h.tail] == [(8, 32)]


# ---- the decomposed step ------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("smoother", ["plain", "kernel", "kernel-fused"])
def test_decomposed_step_equals_piso_step(channel, shape, prec, smoother):
    """Two steps of the decomposed step with a fixed-cycle MGBackend
    equal two piso_step steps bit for bit, the momentum kernel's plain
    version launched once per block a step."""
    _, tc = channel
    cfg = teng.PisoConfig(momentum_smoother="kernel")
    be = MGBackend(cycles=2, precision=prec, smoother=smoother)
    flow0 = tcase.initial_flow(tc, 2e-3)
    ref = single_steps(tc, flow0, 2, cfg, be)
    loops = tfvm.jacobi_momentum.sweep_loops
    got = decomposed_steps(cpu_mesh(shape), tc, flow0, 2, cfg, be)
    assert_equal(got, ref, FIELDS)
    assert tfvm.jacobi_momentum.sweep_loops == loops     # the kernel path


def _ramp(t):
    return torch.clamp(t / 4e-3, max=1.0)


@pytest.mark.parametrize("opts", [
    dict(adjust_dt=False),
    dict(t_stop=3e-3, inlet_scale_fn=_ramp),
    dict(convection="blend", convection_blend=0.5, momentum_sweeps=5),
    dict(convection="upwind", n_correctors=3, momentum_smoother="plain")],
    ids=["fixed-dt", "t-stop-ramp", "blend", "upwind-3-correctors"])
def test_decomposed_step_takes_the_options(channel, opts):
    """The step's options through the decomposed step (2 x 2), two steps
    bit for bit against piso_step."""
    _, tc = channel
    cfg = teng.PisoConfig(**{"momentum_smoother": "kernel", **opts})
    be = MGBackend(cycles=2, precision="bf16")
    flow0 = tcase.initial_flow(tc, 2e-3)
    ref = single_steps(tc, flow0, 2, cfg, be)
    got = decomposed_steps(cpu_mesh((2, 2)), tc, flow0, 2, cfg, be)
    assert_equal(got, ref, FIELDS)


@pytest.fixture(scope="module")
def hybrid():
    """A 128 x 512 cylinder channel, two steps in, and the sm_cyl128
    bundle's predictor (least-squares stitch)."""
    geom = channel_case_geometry("cylinder", length=4.0, height=1.0,
                                 obstacle_size=0.3)
    tc = tcase.build_channel_case(geom, delta=1.0 / 128, device="cpu")
    flow = single_steps(tc, tcase.initial_flow(tc, 2e-3), 2,
                        teng.PisoConfig(momentum_smoother="kernel"),
                        MGBackend(cycles=2))
    bundle = SurrogateBundle.load(os.path.join(ROOT, "artifacts",
                                               "sm_cyl128"), device="cpu")
    return tc, flow, make_predictor(bundle, stitch="lstsq")


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
@pytest.mark.parametrize("alg", ["alg2", "alg1"])
def test_hybrid_step_equals_piso_step(hybrid, shape, alg):
    """The hybrid step (the predictor on gathered fields, its prediction
    split back, the safeguard's norms summed over the blocks) equals
    piso_step bit for bit, with the same rescue solves."""
    tc, flow, pred = hybrid
    cfg = teng.PisoConfig(momentum_smoother="kernel",
                          sm_before_predictor=alg == "alg2",
                          sm_trust=1.0 if alg == "alg1" else 0.0)
    be = MGBackend(cycles=2, precision="bf16")
    rescue = teng._rescue_if_unconverged
    rescue.solves = 0
    calls = pred.calls
    ref = single_steps(tc, flow, 2, cfg, be, pred.bind(tc))
    ref_rescues, ref_calls = rescue.solves, pred.calls - calls
    rescue.solves = 0
    got = decomposed_steps(cpu_mesh(shape), tc, flow, 2, cfg, be, pred)
    assert_equal(got, ref, FIELDS)
    assert rescue.solves == ref_rescues
    assert pred.calls - calls - ref_calls == ref_calls == 2


def test_graded_step_with_every_option_equals_piso_step():
    """A graded 2D-1 case (its blocks' grids the slices of the spacings)
    with BDF2, ddt_corr, the second-order wall shear and the tangential
    link: two steps bit for bit."""
    tc, _ = tbench.schafer_turek_case("2D-1", delta=None,
                                      grading=dict(h_fine=0.008),
                                      device="cpu")
    ny, nx = tc.grid.shape
    cfg = teng.PisoConfig(max_co=0.4, max_dt=2e-3, ddt="backward",
                          ddt_corr=True, wall_order=2,
                          wall_link="tangential", momentum_smoother="kernel")
    be = MGBackend(cycles=2)
    flow0 = tcase.initial_flow(tc, 5e-4)
    ref = single_steps(tc, flow0, 2, cfg, be)
    shape = (2, 2) if ny % 2 == 0 and nx % 2 == 0 else (1, 1)
    assert shape == (2, 2), tc.grid.shape
    got = decomposed_steps(cpu_mesh(shape), tc, flow0, 2, cfg, be)
    assert_equal(got, ref, FIELDS)


@pytest.mark.parametrize("smoother", ["kernel", "plain"])
@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_sst_step_equals_piso_step_sst(shape, smoother):
    """Two decomposed SST steps (k, omega, nu_t resident per block) on
    the cut-cell cylinder equal two piso_step_sst steps bit for bit."""
    kw = dict(shape_name="cylinder", length=4.0, height=2.0,
              obstacle_size=0.5, nu=2e-3)
    tc = tcase.build_channel_case(channel_case_geometry(**kw),
                                  delta=2.0 / 32, device="cpu")
    cfg = teng.PisoConfig(max_co=0.5, max_dt=5e-3, momentum_smoother=smoother)
    be = MGBackend(cycles=2)
    f0, t0 = tcase.initial_flow(tc, 1e-3), tturb.init_turbulence(tc)
    rf, rt = single_steps(tc, f0, 2, cfg, be, turb=t0)
    gf, gt = decomposed_steps(cpu_mesh(shape), tc, f0, 2, cfg, be, turb=t0)
    assert_equal(gf, rf, FIELDS)
    assert_equal(gt, rt, TURB)


def test_sst_step_with_wall_functions_on_the_channel():
    tc, _ = tbench.turbulent_channel_case(nu=5e-5, length=8.0,
                                          delta=2.0 / 32, device="cpu")
    cfg = teng.PisoConfig(turb_wall_fn=True, max_dt=5e-3)
    be = MGBackend(cycles=2, precision="bf16")
    f0, t0 = tcase.initial_flow(tc, 1e-3), tturb.init_turbulence(tc)
    rf, rt = single_steps(tc, f0, 2, cfg, be, turb=t0)
    gf, gt = decomposed_steps(cpu_mesh((2, 2)), tc, f0, 2, cfg, be, turb=t0)
    assert_equal(gf, rf, FIELDS)
    assert_equal(gt, rt, TURB)


@pytest.mark.parametrize("backend,tol", [
    (CGBackend(rtol=1e-6), SOLVE_TOL),
    (MGCGBackend(rtol=1e-6), SOLVE_TOL),
    (MGCGBackend(rtol=1e-6, smoother="kernel", cycle_type="w"), SOLVE_TOL),
    (MGBackend(cycles=4, rtol=0.2, precision="bf16"), 0.0),
    (AutoBackend(), AUTO_TOL)], ids=["cg", "mgcg", "mgcg-w", "mg-rtol",
                                     "auto"])
def test_solvers_that_stop_on_a_residual(channel, backend, tol):
    """One step with block-summed dots and norms, against piso_step
    within the tolerance stated above (the bf16 multigrid to an rtol it
    leaves on its cycle cap: bit for bit)."""
    _, tc = channel
    cfg = teng.PisoConfig(momentum_smoother="kernel")
    flow0 = tcase.initial_flow(tc, 2e-3)
    ref = single_steps(tc, flow0, 1, cfg, backend)
    got = decomposed_steps(cpu_mesh((2, 2)), tc, flow0, 1, cfg, backend)
    if tol == 0.0:
        assert_equal(got, ref, FIELDS)
    else:
        assert_close(got, ref, FIELDS, tol)


def test_decomposed_step_matches_jax(channel, monkeypatch):
    """Against the JAX package's sharded step on its 4-device mesh, every
    field at STEP_TOL; phi_x against JAX's single-device step."""
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
    cfg = teng.PisoConfig(n_correctors=2, momentum_smoother="kernel")
    got = decomposed_steps(cpu_mesh((2, 2)), tc, tcase.initial_flow(tc, 2e-3),
                           1, cfg, MGBackend(cycles=2))
    for name in FIELDS:
        r = np.asarray(getattr(ref, name))
        err = float(np.abs(getattr(got, name).numpy() - r).max())
        assert err <= STEP_TOL * max(float(np.abs(r).max()), 1e-30), \
            (name, err)


# ---- residency ----------------------------------------------------------------


class _Shapes(TorchDispatchMode):
    """Every op output's shape, with the whole-field stage it ran in."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        stage = tblk.current_whole_stage()
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.append((tuple(t.shape), stage, str(func)))
        return out


@pytest.mark.parametrize("with_sm", [False, True])
def test_no_whole_field_outside_the_whole_field_stages(hybrid, with_sm):
    """During one decomposed step on 2 x 2 no op makes a whole-field
    tensor but in the surrogate's gather and the agglomerated levels; the
    surrogate's stage does make them (the check sees what it looks for)."""
    tc, flow, pred = hybrid
    ny, nx = tc.grid.shape
    whole = {(ny, nx), (ny, nx + 1), (ny + 1, nx)}
    mesh = cpu_mesh((2, 2))
    cfg = teng.PisoConfig(momentum_smoother="kernel")
    step = tmesh.make_sharded_piso_step(
        mesh, cfg, MGBackend(cycles=2, precision="bf16"),
        pred if with_sm else None)
    sc, sf = tmesh.shard_case(mesh, tc), tmesh.shard_flow(mesh, flow)
    rec = _Shapes()
    with torch.no_grad(), rec:
        step(sc, sf)
    leaks = [s for s in rec.seen if s[0] in whole and s[1] is None]
    assert not leaks, leaks[:5]
    stages = {s[1] for s in rec.seen if s[0] in whole}
    assert stages == ({"surrogate"} if with_sm else set())
    assert any(s[1] == "coarse" for s in rec.seen)


# ---- gates --------------------------------------------------------------------


def test_meshes_whose_blocks_cannot_hold_a_stage_raise(channel):
    """No path steps whole fields quietly: blocks below the case's halo
    (32 rows over 8) raise at shard_case, a momentum solve deeper than
    the blocks raises, and blocks the multigrid cannot coarsen (odd)
    raise in the solve."""
    _, tc = channel
    with pytest.raises(ValueError):
        tmesh.shard_case(cpu_mesh((8, 1)), tc)
    mesh = cpu_mesh((2, 2))
    sc, sf = tmesh.shard_case(mesh, tc), tmesh.shard_flow(
        mesh, tcase.initial_flow(tc, 2e-3))
    deep = teng.PisoConfig(momentum_sweeps=20)
    with pytest.raises(ValueError):
        tmesh.make_sharded_piso_step(mesh, deep, MGBackend(cycles=1))(sc, sf)
    with pytest.raises(TypeError):
        tmesh.make_sharded_piso_step(
            mesh, teng.PisoConfig(), lambda *a: a[3])(sc, sf)
    odd = tcase.build_channel_case(channel_case_geometry(
        "cylinder", length=8.0, height=0.5625, obstacle_size=0.2),
        delta=1.0 / 64, device="cpu")                       # 36 x 512
    mesh = cpu_mesh((4, 1))                                 # blocks of 9
    with pytest.raises(ValueError, match="multigrid"):
        tmesh.make_sharded_piso_step(mesh, teng.PisoConfig(),
                                     MGBackend(cycles=1))(
            tmesh.shard_case(mesh, odd),
            tmesh.shard_flow(mesh, tcase.initial_flow(odd, 2e-3)))


def test_step_health_reductions(channel):
    """courant_number and continuity_error over the blocks against the
    whole step's (the max exactly, the mean by its sums)."""
    _, tc = channel
    mesh = cpu_mesh((2, 2))
    flow = single_steps(tc, tcase.initial_flow(tc, 2e-3), 1,
                        teng.PisoConfig(), MGBackend(cycles=2))
    sc, sf = tmesh.shard_case(mesh, tc), tmesh.shard_flow(mesh, flow)
    assert tblk.value(tdec.courant_number(sc, sf)) == float(
        teng.courant_number(tc, flow))
    assert tblk.value(tdec.continuity_error(sc, sf)) == pytest.approx(
        float(teng.continuity_error(tc, flow)), rel=1e-5)


# ---- a world of processes ---------------------------------------------------

WORLD = """
import sys
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.parallel import distributed as d
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import CGBackend, MGBackend
assert d.init_distributed(device="cpu") and d.is_multihost()
mesh = d.global_device_mesh(devices=["cpu"] * 2)
assert mesh.shape == {{"data": 2, "model": 2}}
assert mesh.owners == (0, 0, 1, 1), mesh.owners
tc = tcase.build_channel_case(channel_case_geometry(
    "cylinder", length=8.0, height=0.5, obstacle_size=0.2),
    delta=1.0 / 64, device="cpu")
flow0 = tcase.initial_flow(tc, 2e-3)
cfg = teng.PisoConfig(momentum_smoother="kernel")
for be, n in ((MGBackend(cycles=2, precision="bf16"), 2),
              (CGBackend(rtol=1e-4), 1)):
    outs = []
    for m in (mesh, tmesh.device_mesh(4, devices=["cpu"] * 4)):
        sc, sf = tmesh.shard_case(m, tc), tmesh.shard_flow(m, flow0)
        step = tmesh.make_sharded_piso_step(m, cfg, be)
        with torch.no_grad():
            for _ in range(n):
                sf = step(sc, sf)
        outs.append(tmesh.unshard_flow(sf))
    for name in ("u", "v", "p", "phi_x", "phi_y", "dt", "t"):
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name)), \\
            (type(be).__name__, name)
    print("rank", dist.get_rank(), type(be).__name__, "equal")
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_world_of_two_processes_equals_one_process():
    """Two gloo processes, each owning one row of blocks of a 2 x 2 mesh
    (strips between them by point-to-point copies, the per-block sums
    all-gathered), give the one-process 2 x 2 step's fields bit for bit,
    with the fixed-cycle multigrid (two steps) and with CG (one)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORLD.format(root=ROOT)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "MASTER_ADDR": "localhost",
             "MASTER_PORT": str(port), "WORLD_SIZE": "2",
             "RANK": str(rank)}) for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out + err
        for name in ("MGBackend", "CGBackend"):
            assert f"rank {rank} {name} equal" in out, out + err


def test_exchange_route_unchanged_for_the_whole_field_kernels():
    """The extended exchange keeps its zero halo beyond the domain for the
    sharded kernels of whole fields (ops.sharded)."""
    mesh = cpu_mesh((2, 2))
    x = torch.randn(2, 16, 32)
    blocks = [[x[:, i * 8:(i + 1) * 8, j * 16:(j + 1) * 16]
               for j in range(2)] for i in range(2)]
    got = tsh.exchange_halos(blocks, mesh, 3, 3)
    padded = torch.nn.functional.pad(x, (3, 3, 3, 3))
    for i in range(2):
        for j in range(2):
            assert torch.equal(got[i][j], padded[:, i * 8:i * 8 + 14,
                                                 j * 16:j * 16 + 22])
