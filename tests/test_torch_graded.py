"""Graded (stretched tensor-product) grids of tpufoam_torch against the
JAX package, on the CPU: `core.grid`'s graded spacing and grid, the
graded Schaefer-Turek case and its metric terms, the stretched step,
Courant number and pressure probe, and the surrogate's refusal of a
stretched grid.

The case is 2D-1 with grading h_fine 0.008 (44 x 76: h_coarse 0.064,
ratio 1.12, band 0.07), the JAX package's `schafer_turek_case` settings.

Tolerances:
- the spacings, edges, centres, cell indices, the case's masks, inlet and
  SDF, and the metric terms: exact (host numpy in float64 in both, cast
  to float32 where the JAX package casts; the SDF rounds as XLA does on
  the CPU);
- three steps with MGCGBackend(rtol=1e-6) and BDF2: u, v and the fluxes
  within STEP_TOL (1e-4 of each field's max, tests/test_torch_piso.py's
  f32 tolerance); p within 1e-2, as tests/test_torch_piso.py holds the
  pure solver's p (each side stops its CG at a relative residual of
  1e-6, which fixes p only to that residual times the operator's
  condition; measured 6.8e-4 here); t and dt within TIME_TOL (1e-6);
- a stretched grid of equal spacings against the uniform grid, in the
  port: JAX's rtol 2e-5 (tests/test_stretched.py), 2e-6 absolute;
- the Courant number: 1e-6 relative (a maximum of float32 quotients);
- the pressure probe: 1e-12 relative (numpy on the same arrays);
- the fleet against single steps: 1e-6 relative (the fleet's batched
  reductions, as tests/test_torch_piso_options.py); the 2 x 2 mesh step
  against `piso_step`: bit for bit.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.core import grid as jgrid
from tpufoam.eval import benchmark as jbench
from tpufoam.fv import case as jcase
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGCGBackend as JMGCG
from tpufoam_torch.core import grid as tgrid
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.eval import benchmark as tbench
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import CGBackend as TCG
from tpufoam_torch.solvers.backends import MGCGBackend as TMGCG
from tpufoam_torch.solvers.backends import MGBackend as TMG
from tpufoam_torch.surrogate.pipeline import make_predictor
from test_torch_piso import bundle_to_torch

GRADING = dict(h_fine=0.008)
STEP_TOL = 1e-4
P_TOL = 1e-2
TIME_TOL = 1e-6
MASKS = ("fluid", "open_e", "open_w", "open_n", "open_s", "wall_e",
         "wall_w", "wall_n", "wall_s", "inlet_w", "outlet_e", "alpha",
         "wall_ax", "wall_ay", "wall_len", "wall_dist", "inlet_u", "sdf")
METRICS = ("dxc", "dyc", "hx_e", "hx_w", "hy_n", "hy_s", "wx_e", "wx_w",
           "wy_n", "wy_s")
FIELDS = ("u", "v", "p", "phi_x", "phi_y")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, ref, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert err <= rtol * scale, \
        f"{what}: max err {err:.3e} > {rtol:g} * {scale:.3e}"


@functools.lru_cache(maxsize=None)
def graded_cases(bench="2D-1"):
    jc, ju = jbench.schafer_turek_case(bench, delta=None, grading=GRADING)
    tc, tu = tbench.schafer_turek_case(bench, delta=None, grading=GRADING,
                                       device="cpu")
    return jc, tc, ju, tu


SPACINGS = {
    "cylinder-x": (2.2, 0.064, [(0.08, 0.32, 0.008)], 1.12),
    "cylinder-y": (0.41, 0.004, [(0.08, 0.32, 0.0005)], 1.12),
    "two-walls": (1.0, 0.08, [(0.0, 0.05, 0.02), (0.95, 1.0, 0.02)], 1.15),
    "coarse-only": (2.0, 0.1, [], 1.2),
}


@pytest.mark.parametrize("name", list(SPACINGS))
def test_graded_spacing_equals_jax(name):
    length, h_c, bands, ratio = SPACINGS[name]
    got = tgrid.graded_spacing(length, h_c, bands, ratio)
    ref = jgrid.graded_spacing(length, h_c, bands, ratio)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    assert np.isclose(got.sum(), length, rtol=0, atol=1e-12)


def test_graded_spacing_refuses_like_jax():
    for args in ((0.0, 0.1, []), (1.0, -0.1, []),
                 (1.0, 0.1, [(0.2, 0.4, 0.0)])):
        with pytest.raises(ValueError) as jerr:
            jgrid.graded_spacing(*args)
        with pytest.raises(ValueError) as terr:
            tgrid.graded_spacing(*args)
        assert str(terr.value) == str(jerr.value)


def test_make_graded_grid_equals_jax():
    xs = jgrid.graded_spacing(2.2, 0.01, [(0.1, 0.3, 0.002)])
    ys = jgrid.graded_spacing(0.41, 0.01, [(0.15, 0.25, 0.002)])
    jg = jgrid.make_graded_grid(0.0, 2.2, 0.0, 0.41, xs, ys)
    tg = tgrid.make_graded_grid(0.0, 2.2, 0.0, 0.41, xs, ys)
    assert tg.stretched and jg.stretched
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    assert (tg.shape, tg.n_cells, tg.x_max, tg.y_max) \
        == (jg.shape, jg.n_cells, jg.x_max, jg.y_max)
    for got, ref in zip(tg.spacing_arrays(), jg.spacing_arrays(np)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tg.x_edges(), jg.x_edges(np))
    np.testing.assert_array_equal(tg.y_edges(), jg.y_edges(np))
    for got, ref in zip(tg.cell_centers(), jg.cell_centers(np)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tg.cell_centers_flat(),
                                  jg.cell_centers_flat(np))
    rng = np.random.default_rng(1)
    pts = np.concatenate([
        rng.uniform([-0.1, -0.1], [2.3, 0.5], (200, 2)),
        [[0.2, 0.2], [2.15, 0.4], [0.001, 0.001], [0.0, 0.0], [2.2, 0.41]]])
    np.testing.assert_array_equal(tg.point_to_index(pts),
                                  jg.point_to_index(pts))
    # the uniform grid's helpers too
    ju = jgrid.make_grid(0.0, 2.0, 0.0, 1.0, 1.0 / 16)
    tu = tgrid.make_grid(0.0, 2.0, 0.0, 1.0, 1.0 / 16)
    assert not tu.stretched
    np.testing.assert_array_equal(tu.x_edges(), ju.x_edges(np))
    np.testing.assert_array_equal(tu.point_to_index(pts),
                                  ju.point_to_index(pts))
    with pytest.raises(ValueError, match="domain length"):
        tgrid.make_graded_grid(0.0, 2.0, 0.0, 0.41, xs, ys)


def test_graded_schafer_turek_case_leaf_for_leaf():
    jc, tc, ju, tu = graded_cases()
    assert tu == ju
    assert tc.grid.shape == jc.grid.shape == (44, 76)
    assert dataclasses.asdict(tc.grid) == dataclasses.asdict(jc.grid)
    assert (tc.nu, tc.cut) == (jc.nu, jc.cut)
    assert tc.grid.y_max == jc.grid.y_max == pytest.approx(0.41, abs=1e-12)
    for name in MASKS:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)


def test_graded_metrics_equal_jax():
    jc, tc, _, _ = graded_cases()
    jm = jcase.grid_metrics(jc.grid)
    tm = tcase.grid_metrics(tc.grid, tc.device)
    assert tm.stretched and jm.stretched
    for name in METRICS:
        got, ref = getattr(tm, name), np.asarray(getattr(jm, name))
        assert got.dtype == torch.float32 and got.shape == ref.shape, name
        np.testing.assert_array_equal(got.numpy(), ref, name)
    # made once per grid and device
    assert tcase.grid_metrics(tc.grid, "cpu") is tm
    # the uniform grid keeps its Python floats
    um = tcase.grid_metrics(tgrid.make_grid(0.0, 2.0, 0.0, 1.0, 1 / 32))
    assert (um.dxc, um.hx_e, um.wx_e, um.wfx) == (1 / 32, 1 / 32, 0.5, None)


def test_graded_fluxes_match_jax():
    jc, tc, _, _ = graded_cases()
    rng = np.random.default_rng(3)
    fl = np.asarray(jc.fluid)
    u, v = ((rng.standard_normal(fl.shape) * fl).astype(np.float32)
            for _ in range(2))
    ref = jcase.fluxes_from_velocity(jc, jnp.asarray(u), jnp.asarray(v))
    got = tcase.fluxes_from_velocity(tc, T(u), T(v))
    for g, r, name in zip(got, ref, ("phi_x", "phi_y")):
        close(g, r, 1e-6, name)


def test_equal_spacing_stretched_grid_matches_uniform_step():
    """A stretched grid of equal spacings reproduces the uniform grid's
    case and three BDF2 steps (the metric terms reduce to the uniform
    scalars), as tests/test_stretched.py holds the JAX package."""
    geom = channel_case_geometry("cylinder", length=2.0, height=1.0,
                                 obstacle_size=0.3, nu=8e-3)
    d = 1.0 / 32
    case_u = tcase.build_channel_case(geom, delta=d, device="cpu")
    nx, ny = case_u.grid.nx, case_u.grid.ny
    g_s = tgrid.make_graded_grid(0.0, nx * d, 0.0, ny * d,
                                 np.full(nx, d), np.full(ny, d))
    case_s = tcase.build_channel_case(geom, grid=g_s, device="cpu")
    assert case_s.grid.stretched and case_s.grid.shape == case_u.grid.shape
    for name in ("fluid", "alpha", "wall_len"):
        np.testing.assert_allclose(getattr(case_s, name).numpy(),
                                   getattr(case_u, name).numpy(), atol=1e-6)
    cfg = teng.PisoConfig(n_correctors=2, ddt="backward")
    be = TCG(rtol=1e-8, maxiter=400)
    f_u = tcase.initial_flow(case_u, dt0=2e-3)
    f_s = tcase.initial_flow(case_s, dt0=2e-3)
    for _ in range(3):
        f_u = teng.piso_step(case_u, f_u, cfg=cfg, backend=be)
        f_s = teng.piso_step(case_s, f_s, cfg=cfg, backend=be)
    for name in ("u", "p"):
        np.testing.assert_allclose(getattr(f_s, name).numpy(),
                                   getattr(f_u, name).numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=name)


def test_build_channel_case_needs_delta_or_grid():
    geom = channel_case_geometry("cylinder", length=2.0, height=1.0,
                                 obstacle_size=0.3)
    with pytest.raises(ValueError, match="delta"):
        tcase.build_channel_case(geom, device="cpu")


def test_graded_steps_match_jax():
    """Three steps of the artifacts' graded settings (MGCG rtol 1e-6,
    BDF2, maxCo 0.4) on the 44 x 76 graded case, the momentum kernel's
    plain version on the CPU."""
    jc, tc, _, _ = graded_cases()
    kw = dict(max_co=0.4, max_dt=2e-3, ddt="backward")
    jf = jeng.run_piso_eager(
        jc, jcase.initial_flow(jc, 5e-4), 3,
        cfg=jeng.PisoConfig(momentum_smoother="pallas", **kw),
        backend=JMGCG(rtol=1e-6))
    tf = teng.run_piso_eager(
        tc, tcase.initial_flow(tc, 5e-4), 3,
        cfg=teng.PisoConfig(momentum_smoother="kernel", **kw),
        backend=TMGCG(rtol=1e-6))
    for f in FIELDS:
        close(getattr(tf, f), getattr(jf, f), P_TOL if f == "p"
              else STEP_TOL, f)
    for f in ("t", "dt"):
        close(getattr(tf, f), getattr(jf, f), TIME_TOL, f)
    assert float(teng.continuity_error(tc, tf)) < 1e-6


def test_stretched_courant_number_matches_jax():
    jc, tc, _, _ = graded_cases()
    rng = np.random.default_rng(5)
    jf = jcase.initial_flow(jc, 7e-4)
    phi_x = (np.asarray(jf.phi_x)
             * (1 + 0.3 * rng.standard_normal(jf.phi_x.shape))
             ).astype(np.float32)
    jf = jf.replace(phi_x=jnp.asarray(phi_x))
    tf = dataclasses.replace(tcase.initial_flow(tc, 7e-4), phi_x=T(phi_x))
    ref = float(jeng.courant_number(jc, jf))
    got = float(teng.courant_number(tc, tf))
    assert got == pytest.approx(ref, rel=1e-6)
    # the fine cells govern it: above the estimate from the coarsest cell
    xs, ys = tc.grid.spacing_arrays()
    sum_phi = (tf.phi_x[:, 1:].abs() + tf.phi_x[:, :-1].abs()
               + tf.phi_y[1:].abs() + tf.phi_y[:-1].abs())
    coarse = float(0.5 * (sum_phi * tc.fluid).max() / (xs.max() * ys.max())
                   * tf.dt)
    assert got > 1.5 * coarse


def test_stretched_pressure_probe_matches_jax():
    jc, tc, _, _ = graded_cases()
    rng = np.random.default_rng(9)
    p = (rng.standard_normal(tc.grid.shape) * np.asarray(jc.fluid)
         ).astype(np.float32)
    for x, y in ((0.15, 0.2), (0.25, 0.2), (1.0, 0.1), (2.19, 0.4)):
        assert tbench.pressure_probe(tc, T(p), x, y) == pytest.approx(
            jbench.pressure_probe(jc, jnp.asarray(p), x, y), rel=1e-12)


def test_surrogate_refuses_a_stretched_grid():
    _, tc, _, _ = graded_cases()
    z = tc.fluid * 0.0
    aux = dict(u=tc.fluid, v=tc.fluid, p=z, u_prev=tc.fluid,
               v_prev=tc.fluid, p_prev=z, dt=torch.tensor(1e-3))
    bundle = bundle_to_torch(_tiny_bundle(block_size=8))
    for stitch in ("lstsq", "scan"):
        pred = make_predictor(bundle, stitch=stitch)
        with pytest.raises(ValueError, match="uniform"):
            pred(tc, z, aux)
        with pytest.raises(ValueError, match="uniform"):
            pred.bind(tc)
        with pytest.raises(ValueError, match="uniform"):
            teng.run_piso_eager(tc, tcase.initial_flow(tc), 1,
                                sm_predict=pred)
        assert pred.calls == 0


STEP_OPTIONS = dict(max_co=0.4, max_dt=2e-3, ddt="backward", ddt_corr=True,
                    wall_order=2, wall_link="tangential",
                    momentum_smoother="kernel")


def test_graded_fleet_and_mesh_step_equal_single_steps():
    """A fleet of two graded cases on one grid, and the 2 x 2 mesh step,
    with every step option of the slice: the fleet's metrics broadcast
    over (B, ny, nx) and each case steps as if alone; the mesh step
    equals piso_step. The mesh step keeps its fields per block and sums
    MGCG's dot products per block (tests/test_torch_decomposed.py holds
    that to its tolerance), so it is held bit for bit with the
    fixed-cycle multigrid, whose cycle has no reduction."""
    _, tc, _, _ = graded_cases()
    cfg = teng.PisoConfig(**STEP_OPTIONS)
    be = TMGCG(rtol=1e-6)
    flows = [tcase.initial_flow(tc, dt) for dt in (5e-4, 3e-4)]
    singles = [teng.run_piso_eager(tc, f, 2, cfg=cfg, backend=be)
               for f in flows]
    fleet = teng.run_piso_eager(tbat.stack_cases([tc, tc]),
                                tbat.stack_flows(flows), 2, cfg=cfg,
                                backend=be)
    for k, single in enumerate(singles):
        for f in FIELDS + ("t", "dt"):
            close(getattr(fleet, f)[k], getattr(single, f), 1e-6, f"{k} {f}")
    mesh = tmesh.device_mesh(4, shape=(2, 2), devices=["cpu"] * 4)
    be = TMG(cycles=2)
    step = tmesh.make_sharded_piso_step(mesh, cfg, be)
    got = tmesh.unshard_flow(step(tmesh.shard_case(mesh, tc),
                                  tmesh.shard_flow(mesh, flows[0])))
    ref = teng.piso_step(tc, flows[0], cfg, be)
    for f in FIELDS + ("t", "dt"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
