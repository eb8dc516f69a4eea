"""The batched fleet of tpufoam_torch (piso.batched and the leading case
axis it puts on every module of the step) on the CPU: against the stack of
its own single-case results, and against the JAX package's vmapped fleet
(tpufoam.piso.batched).

Three geometries at delta = 1/24 (24 x 72 cells each), as
tests/test_parallel.py's fleet test. Tolerances:
- stacking: exact, but the SDF to 1e-4 (tests/test_torch_fv.py's bound:
  a float32 min-distance on both sides).
- operators, pressure assembly, momentum coefficients and
  sweeps, the diagnostics and the gate, per case against one case at a
  time: exact (the same elementwise arithmetic; maxima and sums over one
  case's cells).
- the solvers and the solver-bound fleet steps per case against one case
  at a time: 1e-6 relative (the inner products and norms are reduced per
  case of a (B, ny, nx) tensor, which may group the float32 sums
  differently from one (ny, nx) tensor; measured 0), with the iteration
  counts equal.
- the fleet against JAX's fleet, max |port - JAX| / max |JAX| per field:
  CG (rtol 1e-5, one corrector, 5 steps) and MGCG (rtol 1e-5, 3 steps)
  1e-3, tighter than test_parallel.py's atol 1e-3 on u and 2e-3 on p for
  JAX's own two fleet runners: each side stops its CG at a relative
  residual of 1e-5, and p is fixed only to that residual times the
  operator's condition (measured: 4.2e-5 and 1.7e-5 on p). The hybrid
  fleet (tiny surrogate, two f32 V-cycles, the momentum kernel; 2 steps)
  1e-3 as well: the surrogate's MLP computes in bf16, where an f32 input
  that differs in its last bit between the frameworks rounds to
  neighbouring bf16 values (2^-8 apart), and the port stitches with a
  host-inverted operator where JAX's vmapped predictor solves in-graph
  (the same least-squares solution, up to rounding); measured 6.4e-6.
- a hybrid fleet step against each case's single step: exact (the
  predictor predicts a fleet case by case, and the rest of the step acts
  per cell or per case).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.ops import stencil as jst
from tpufoam.piso import batched as jbat
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import CGBackend as JCG
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam.surrogate.pipeline import make_predictor as jax_make_predictor
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv import momentum as tmom
from tpufoam_torch.fv import operators as tops
from tpufoam_torch.fv import pressure as tpr
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers import cg as tcg
from tpufoam_torch.solvers import multigrid as tmg
from tpufoam_torch.solvers.backends import (CGBackend, MGBackend,
                                            MGCGBackend)
from tpufoam_torch.surrogate.pipeline import make_predictor
from test_torch_piso import bundle_to_torch

GEOMS = [("cylinder", 0.3), ("rectangle", 0.25), ("triangle", 0.3)]
DELTA = 1.0 / 24
FIELDS = ("u", "v", "p", "phi_x", "phi_y", "dt", "t")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def _geom_kw(shape, size, **kw):
    return dict(shape_name=shape, length=3.0, height=1.0,
                obstacle_size=size, **kw)


@pytest.fixture(scope="module")
def fleet():
    """(JAX cases, port cases, JAX flows, port flows), one per geometry."""
    jc, tc, jf, tf = [], [], [], []
    for shape, size in GEOMS:
        jc.append(jcase.build_channel_case(jax_geom(**_geom_kw(shape, size)),
                                           delta=DELTA))
        tc.append(tcase.build_channel_case(
            channel_case_geometry(**_geom_kw(shape, size)), delta=DELTA,
            device="cpu"))
        jf.append(jcase.initial_flow(jc[-1], dt0=2e-3))
        tf.append(tcase.initial_flow(tc[-1], dt0=2e-3))
    return jc, tc, jf, tf


@pytest.fixture(scope="module")
def state(fleet):
    """A seeded, developed-looking state per case: the initial flow plus
    noise on the fluid cells, a random pressure and consistent fluxes."""
    _, tc, _, tf = fleet
    rng = np.random.default_rng(21)
    flows = []
    for c, f in zip(tc, tf):
        shape = c.grid.shape

        def noise(scale):
            return T(rng.standard_normal(shape).astype(np.float32) * scale) \
                * c.fluid

        u = f.u + noise(0.1)
        v = noise(0.1)
        phi_x, phi_y = tcase.fluxes_from_velocity(c, u, v)
        flows.append(dataclasses.replace(
            f, u=u, v=v, p=noise(1.0), phi_x=phi_x, phi_y=phi_y,
            dt=torch.tensor(1e-3 * (1 + len(flows)))))
    return tbat.stack_cases(tc), tbat.stack_flows(flows), tc, flows


def per_case_equal(batched, singles):
    for k, single in enumerate(singles):
        assert torch.equal(batched[k], single), k


def per_case_close(batched, singles, rtol):
    for k, single in enumerate(singles):
        err = float((batched[k] - single).abs().max())
        assert err <= rtol * float(single.abs().max()), (k, err)


def against_jax(got, ref, tol):
    for name in FIELDS:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.shape == r.shape, (name, g.shape, r.shape)
        err = float(np.abs(g - r).max())
        scale = max(float(np.abs(r).max()), 1e-30)
        assert err <= tol * scale, f"{name}: {err:.3e} / {scale:.3e}"
        assert np.isfinite(g).all(), name


# ---- stacking -------------------------------------------------------------


def test_stacked_leaves_match_jax(fleet):
    jc, tc, jf, tf = fleet
    for jstack, tstack in ((jbat.stack_cases(jc), tbat.stack_cases(tc)),
                           (jbat.stack_flows(jf), tbat.stack_flows(tf))):
        for f in dataclasses.fields(tstack):
            got = getattr(tstack, f.name)
            if f.name == "grid":
                jg = jstack.grid
                assert (got.shape, got.dx, got.dy, got.x0, got.y0) == \
                    (jg.shape, jg.dx, jg.dy, jg.x0, jg.y0)
                continue
            if not isinstance(got, torch.Tensor):
                assert got == getattr(jstack, f.name), f.name
                continue
            ref = np.asarray(getattr(jstack, f.name))
            assert tuple(got.shape) == ref.shape, f.name
            if f.name == "sdf":      # tests/test_torch_fv.py's bound
                np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
            else:
                np.testing.assert_array_equal(got.numpy(), ref, f.name)
    assert tuple(tbat.stack_cases(tc).inlet_u.shape) == (3, 24)
    assert tuple(tbat.stack_flows(tf).dt.shape) == (3,)


@pytest.mark.parametrize("differs", ["grid shape", "nu"])
def test_stacking_refuses_differing_cases(differs):
    kw = _geom_kw("cylinder", 0.3)
    other = dict(delta=1.0 / 20) if differs == "grid shape" else {}
    nu = dict(nu=2e-3) if differs == "nu" else {}
    pair_j = [jcase.build_channel_case(jax_geom(**kw), delta=DELTA),
              jcase.build_channel_case(jax_geom(**kw, **nu),
                                       delta=other.get("delta", DELTA))]
    pair_t = [tcase.build_channel_case(channel_case_geometry(**kw),
                                       delta=DELTA, device="cpu"),
              tcase.build_channel_case(channel_case_geometry(**kw, **nu),
                                       delta=other.get("delta", DELTA),
                                       device="cpu")]
    with pytest.raises(ValueError):
        jbat.stack_cases(pair_j)
    with pytest.raises(ValueError):
        tbat.stack_cases(pair_t)


# ---- each module per case -------------------------------------------------


def test_operators_and_pressure_per_case(state):
    bc, bf, cases, flows = state
    for shift in (tops.nb_e, tops.nb_w, tops.nb_n, tops.nb_s):
        per_case_equal(shift(bf.u), [shift(f.u) for f in flows])
    per_case_equal(tops.divergence(bf.phi_x, bf.phi_y),
                   [tops.divergence(f.phi_x, f.phi_y) for f in flows])
    for k in range(2):
        per_case_equal(tcase.fluxes_from_velocity(bc, bf.u, bf.v)[k],
                       [tcase.fluxes_from_velocity(c, f.u, f.v)[k]
                        for c, f in zip(cases, flows)])
        per_case_equal(tpr.pressure_gradient(bc, bf.p)[k],
                       [tpr.pressure_gradient(c, f.p)[k]
                        for c, f in zip(cases, flows)])
        per_case_equal(tcase.domain_row_masks(bc)[k],
                       [tcase.domain_row_masks(c)[k] for c in cases])
    rau = bc.alpha * 1e-3 * bc.fluid
    bco = tpr.pressure_coeffs(bc, rau)
    sco = [tpr.pressure_coeffs(c, rau[k]) for k, c in enumerate(cases)]
    for f in dataclasses.fields(bco):
        per_case_equal(getattr(bco, f.name), [getattr(s, f.name)
                                              for s in sco])
    per_case_equal(tpr.pressure_matvec(bco, bf.p),
                   [tpr.pressure_matvec(s, f.p) for s, f in zip(sco, flows)])
    per_case_equal(tpr.pressure_rhs(bc, bf.phi_x, bf.phi_y),
                   [tpr.pressure_rhs(c, f.phi_x, f.phi_y)
                    for c, f in zip(cases, flows)])
    for k in range(2):
        per_case_equal(
            tpr.correct_fluxes(bc, bco, bf.p, bf.phi_x, bf.phi_y)[k],
            [tpr.correct_fluxes(c, s, f.p, f.phi_x, f.phi_y)[k]
             for c, s, f in zip(cases, sco, flows)])


def test_momentum_per_case(state):
    bc, bf, cases, flows = state
    bco = tmom.momentum_coeffs(bc, bf.phi_x, bf.phi_y, bf.u, bf.v, bf.dt)
    sco = [tmom.momentum_coeffs(c, f.phi_x, f.phi_y, f.u, f.v, f.dt)
           for c, f in zip(cases, flows)]
    for f in dataclasses.fields(bco):
        per_case_equal(getattr(bco, f.name), [getattr(s, f.name)
                                              for s in sco])
    for k in range(2):
        per_case_equal(tmom.h_operator(bco, bf.u, bf.v)[k],
                       [tmom.h_operator(s, f.u, f.v)[k]
                        for s, f in zip(sco, flows)])
    src = 1e-4 * bf.p
    for smoother, sweeps in (("plain", 4), ("kernel", 8), ("kernel", 12)):
        got = tmom.jacobi_momentum(bco, bc, bf.u, bf.v, src, -src,
                                   sweeps=sweeps, smoother=smoother)
        ref = [tmom.jacobi_momentum(s, c, f.u, f.v, src[k], -src[k],
                                    sweeps=sweeps, smoother=smoother)
               for k, (s, c, f) in enumerate(zip(sco, cases, flows))]
        for i in range(2):
            per_case_equal(got[i], [r[i] for r in ref])


def _pressure_problem(state):
    """A pressure system per case with a known solution, and initial
    guesses at three distances from it, so that the cases stop apart."""
    bc, _, cases, _ = state
    rng = np.random.default_rng(5)

    def field():
        return T(rng.standard_normal(bc.fluid.shape).astype(np.float32)) \
            * bc.fluid

    rau = bc.alpha * bc.fluid * (1.0 + 0.5 * field().abs()) * 1e-3
    bco = tpr.pressure_coeffs(bc, rau)
    x_true = field()
    b = tpr.pressure_matvec(bco, x_true) * bc.fluid
    x0 = x_true + torch.tensor([1.0, 3e-2, 1e-3])[:, None, None] * field()
    sco = [tpr.pressure_coeffs(c, rau[k]) for k, c in enumerate(cases)]
    return bco, sco, b, x0


@pytest.mark.parametrize("solver", ["mg_solve-rtol", "pcg", "mgcg"])
def test_solvers_per_case(state, solver):
    bco, sco, b, x0 = _pressure_problem(state)
    if solver == "mg_solve-rtol":
        def run(coef, b_, x0_):
            c0 = tmg.v_cycle.cycles
            x = tmg.mg_solve(coef, b_, x0_, cycles=30, rtol=1e-3)
            return x, tmg.v_cycle.cycles - c0
    elif solver == "pcg":
        def run(coef, b_, x0_):
            res = tcg.pcg_pressure(coef, b_, x0=x0_, rtol=1e-5, maxiter=400)
            return res.x, res.iters
    else:
        def run(coef, b_, x0_):
            res = tmg.mgcg_pressure(coef, b_, x0=x0_, rtol=1e-6, maxiter=60)
            return res.x, res.iters
    got, n_batched = run(bco, b, x0)
    singles = [run(s, b[k], x0[k]) for k, s in enumerate(sco)]
    per_case_close(got, [x for x, _ in singles], 1e-6)
    counts = [n for _, n in singles]
    assert len(set(counts)) > 1, counts    # the cases stop apart
    if solver == "mg_solve-rtol":
        assert n_batched == max(counts)    # cycles run until the last
    else:
        assert n_batched.tolist() == counts


def test_pcg_fixed_iters_per_case(state):
    bco, sco, b, x0 = _pressure_problem(state)
    got = tcg.pcg_fixed_iters(bco, b, x0, iters=6)
    per_case_close(got.x, [tcg.pcg_fixed_iters(s, b[k], x0[k], 6).x
                           for k, s in enumerate(sco)], 1e-6)


def test_unported_batched_solvers_refuse(state):
    """The kernel smoothers' batched launch, once refused here, is ported:
    a fleet's multigrid with a kernel smoother solves each case as the
    case alone (on the CPU through the kernels' plain versions; the fixed
    cycles bit for bit, MGCG within the per-case solvers' 1e-6 with the
    same iterations; tests/test_torch_fleet_kernels.py holds the fleet to
    JAX's). What still raises is what the JAX package's cycle refuses: an
    unknown smoother."""
    bc, bf, _, _ = state
    bco, sco, b, x0 = _pressure_problem(state)
    for backend in (MGBackend(cycles=1, smoother="kernel"),
                    MGBackend(cycles=1, smoother="kernel-fused"),
                    MGBackend(cycles=2, precision="bf16",
                              smoother="kernel-fused")):
        got = backend(bc, bco, b, x0, {})
        per_case_equal(got, [tmg.mg_solve(s, b[k], x0[k],
                                          **backend.solve_kwargs())
                             * bc.fluid[k] for k, s in enumerate(sco)])
    res = tmg.mgcg_pressure(bco, b, x0=x0, rtol=1e-6, smoother="kernel")
    singles = [tmg.mgcg_pressure(s, b[k], x0=x0[k], rtol=1e-6,
                                 smoother="kernel")
               for k, s in enumerate(sco)]
    per_case_close(res.x, [r.x for r in singles], 1e-6)
    assert res.iters.tolist() == [r.iters for r in singles]
    with pytest.raises(ValueError, match="not in"):
        MGBackend(cycles=1, smoother="pallas")(bc, bco, b, x0, {})


def test_diagnostics_and_gate_per_case(state):
    bc, bf, cases, flows = state
    cfg = teng.PisoConfig(max_co=0.5, max_dt=2e-3)
    for fn in (teng.courant_number, teng.continuity_error,
               lambda c, f: teng._next_dt(c, f, cfg)):
        got = fn(bc, bf)
        assert tuple(got.shape) == (3,)
        per_case_equal(got, [fn(c, f) for c, f in zip(cases, flows)])
    p_sm = bf.p + 1.0
    p_sm[1, 3, 4] = float("nan")
    got = teng._gate_sm_prediction(p_sm, bf.p, bc.fluid)
    per_case_equal(got, [teng._gate_sm_prediction(p_sm[k], f.p, c.fluid)
                         for k, (c, f) in enumerate(zip(cases, flows))])
    assert torch.equal(got[1], bf.p[1] * bc.fluid[1])
    assert torch.equal(got[0], p_sm[0] * bc.fluid[0])


# ---- the fleet against the JAX package's fleet ----------------------------


@pytest.mark.parametrize("backend", ["cg", "mgcg-default"])
def test_fleet_matches_jax(fleet, backend):
    jc, tc, jf, tf = fleet
    if backend == "cg":
        kw_j = dict(cfg=jeng.PisoConfig(n_correctors=1),
                    backend=JCG(rtol=1e-5, maxiter=300))
        kw_t = dict(cfg=teng.PisoConfig(n_correctors=1),
                    backend=CGBackend(rtol=1e-5, maxiter=300))
        steps = 5
    else:
        kw_j, kw_t, steps = {}, {}, 3        # MGCGBackend(rtol=1e-5)
    ref = jbat.run_piso_batched(jbat.stack_cases(jc), jbat.stack_flows(jf),
                                steps, **kw_j)
    got = tbat.run_piso_batched(tbat.stack_cases(tc), tbat.stack_flows(tf),
                                steps, **kw_t)
    against_jax(got, ref, 1e-3)
    u = got.u.numpy()
    assert np.abs(u[0] - u[1]).max() > 1e-3   # the geometries differ


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode (its fleet then
    takes the momentum kernel's batched rule, `_msp_batched`)."""
    monkeypatch.setattr(jst, "_INTERPRET", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_hybrid_fleet_matches_jax(fleet, jax_interpret):
    jc, tc, jf, tf = fleet
    jb = _tiny_bundle(block_size=16)
    jpred = jax_make_predictor(jb, stitch="lstsq")
    tpred = make_predictor(bundle_to_torch(jb), stitch="lstsq")
    ref = jbat.run_piso_batched_eager(
        jbat.stack_cases(jc), jbat.stack_flows(jf), 2,
        cfg=jeng.PisoConfig(n_correctors=1, momentum_smoother="pallas"),
        backend=JMG(cycles=2), sm_predict=jpred)
    got = tbat.run_piso_batched_eager(
        tbat.stack_cases(tc), tbat.stack_flows(tf), 2,
        cfg=teng.PisoConfig(n_correctors=1, momentum_smoother="kernel"),
        backend=MGBackend(cycles=2), sm_predict=tpred)
    assert tpred.calls == 2                   # one per lockstep
    against_jax(got, ref, 1e-3)


def test_fleet_step_with_one_bad_prediction(fleet):
    """Case 1's prediction is non-finite: only case 1 falls back to the
    incoming pressure, and every case equals its own single-case step
    (the safeguard's rescue included)."""
    _, tc, _, tf = fleet
    bundle = bundle_to_torch(_tiny_bundle(block_size=16))
    pred = make_predictor(bundle, stitch="lstsq")
    cfg = teng.PisoConfig(n_correctors=2, momentum_smoother="kernel")
    backend = MGBackend(cycles=2)

    def poisoned(bound, bad):
        def predict(case, p_prev, aux):
            p = bound(case, p_prev, aux)
            if bad is not None:
                p = p.clone()
                p[bad] = float("nan")
            return p
        return predict

    flows = [teng.run_piso_eager(c, f, 1, cfg=cfg, backend=backend,
                                 sm_predict=pred) for c, f in zip(tc, tf)]
    bc, bf = tbat.stack_cases(tc), tbat.stack_flows(flows)
    with torch.no_grad():
        got = teng.piso_step(bc, bf, cfg, backend,
                             poisoned(pred.bind(bc), (1, 5, 7)))
        ref = [teng.piso_step(c, f, cfg, backend,
                              poisoned(pred.bind(c), (5, 7) if k == 1
                                       else None))
               for k, (c, f) in enumerate(zip(tc, flows))]
    for name in FIELDS:
        per_case_equal(getattr(got, name), [getattr(r, name) for r in ref])
    assert all(bool(torch.isfinite(getattr(got, n)).all())
               for n in ("u", "v", "p"))


class _Recording:
    """A pressure backend that records each solve's iteration counts."""

    def __init__(self, solve):
        self.solve, self.iters = solve, []

    def __call__(self, case, coef, rhs, p_prev, aux):
        res = self.solve(coef, rhs, x0=p_prev)
        self.iters.append(res.iters)
        return res.x * case.fluid


@pytest.mark.parametrize("solver", ["mgcg", "pcg"])
def test_fleet_step_iterations_equal_single_steps(state, solver):
    """One lockstep of the fleet against each case stepped alone: the
    same fields, and per pressure solve the same CG iterations per case
    (MGCGBackend(rtol=1e-5)'s solve, and Jacobi-PCG)."""
    bc, bf, cases, flows = state
    solve = (functools.partial(tmg.mgcg_pressure, rtol=1e-5, maxiter=60)
             if solver == "mgcg"
             else functools.partial(tcg.pcg_pressure, rtol=1e-5,
                                    maxiter=300))
    cfg = teng.PisoConfig()
    fleet_be = _Recording(solve)
    got = teng.piso_step(bc, bf, cfg, fleet_be)
    singles = []
    for c, f in zip(cases, flows):
        be = _Recording(solve)
        singles.append((teng.piso_step(c, f, cfg, be), be.iters))
    for name in FIELDS:
        per_case_close(getattr(got, name), [getattr(r, name)
                                            for r, _ in singles], 1e-6)
    assert len(fleet_be.iters) == cfg.n_correctors
    for i, it in enumerate(fleet_be.iters):
        assert it.tolist() == [n[i] for _, n in singles], i
