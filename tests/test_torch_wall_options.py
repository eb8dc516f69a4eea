"""The step options of the laminar solver that act on the embedded wall,
the surrogate's Algorithm 1 and the differentiable rollout, against the
JAX package on the CPU: `fv.momentum`'s wall terms (`wall_unit_normal`,
`wall_normal_release`, `wall_shear2_source`) and `momentum_coeffs`'
`wall_grad_p` and `wall_link`, `fv.forces.obstacle_force`'s matching
terms, `PisoConfig(sm_before_predictor=False)`, the fleet and the 2 x 2
mesh step with these options, and `piso.engine.run_piso`.

Tolerances, max |port - JAX| / max |JAX|:
- the wall terms, elementwise float32: 1e-6;
- coefficients: COEF_TOL 1e-5 (tests/test_torch_piso_options.py);
- forces from the same fields: FORCE_TOL 1e-5 of the largest component
  (tests/test_torch_schafer_turek.py: float32 sums in another order);
- three hybrid steps with MGBackend(cycles=2) in float32: STEP_TOL 1e-4;
  t and dt: TIME_TOL 1e-6;
- the fleet against single steps: 1e-6 (its batched reductions); the
  mesh step against piso_step and run_piso against run_piso_eager: bit
  for bit;
- the gradient of run_piso against a central finite difference of the
  same loss: 1e-3 relative (measured 1.7e-5). Both in float32: every
  pressure matvec goes through the stencil_matvec wrapper, which takes
  float32 or bfloat16 only, as its kernel does. The direction is seeded
  and the convection upwind: the limitedLinearV limiter has a kink at
  the start's x-uniform flow (den = 0 takes the upwind branch), which a
  central difference straddles (0.4% measured with it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.fv import forces as jforces
from tpufoam.fv import momentum as jmom
from tpufoam.fv import pressure as jpres
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam.surrogate.pipeline import make_predictor as jax_make_predictor
from tpufoam_torch.core.geometry import ChannelCase, channel_case_geometry
from tpufoam_torch.eval import benchmark as tbench
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv import forces as tforces
from tpufoam_torch.fv import momentum as tmom
from tpufoam_torch.fv import pressure as tpres
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend as TMG
from tpufoam_torch.surrogate.pipeline import make_predictor
from test_torch_piso import bundle_to_torch

NY, NX = 32, 128
WALL_TOL = 1e-6
COEF_TOL = 1e-5
FORCE_TOL = 1e-5
STEP_TOL = 1e-4
TIME_TOL = 1e-6
GRAD_TOL = 1e-3
COEFS = ("a_e", "a_w", "a_n", "a_s", "a_p", "b_u", "b_v")
FIELDS = ("u", "v", "p", "phi_x", "phi_y")
WALL_OPTIONS = {"shear2": dict(wall_order=2),
                "tangential": dict(wall_link="tangential"),
                "both": dict(wall_order=2, wall_link="tangential")}


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


def _pair(boundary):
    delta = 2.0 / NY
    kw = dict(shape_name="cylinder", length=NX * delta, height=2.0,
              obstacle_size=0.5, nu=8e-3)
    return (jcase.build_channel_case(jax_geom(**kw), delta=delta,
                                     boundary=boundary),
            tcase.build_channel_case(channel_case_geometry(**kw),
                                     delta=delta, boundary=boundary,
                                     device="cpu"))


@pytest.fixture(scope="module")
def cases():
    return _pair("cutcell")


@pytest.fixture(scope="module")
def blank():
    return _pair("blank")


@pytest.fixture(scope="module")
def state(cases):
    """Seeded u, v and p on the fluid, fluxes from the velocity, and the
    JAX package's pressure gradient of p."""
    jc, _ = cases
    rng = np.random.default_rng(11)
    fl = np.asarray(jc.fluid)
    u0 = np.asarray(jcase.initial_flow(jc).u)
    u = ((u0 + 0.1 * rng.standard_normal(fl.shape)) * fl).astype(np.float32)
    v = (0.1 * rng.standard_normal(fl.shape) * fl).astype(np.float32)
    p = (rng.standard_normal(fl.shape) * fl).astype(np.float32)
    phi_x, phi_y = jcase.fluxes_from_velocity(jc, jnp.asarray(u),
                                              jnp.asarray(v))
    gpx, gpy = jpres.pressure_gradient(jc, jnp.asarray(p))
    return dict(u=u, v=v, p=p, phi_x=np.asarray(phi_x),
                phi_y=np.asarray(phi_y), gpx=np.asarray(gpx),
                gpy=np.asarray(gpy), dt=np.float32(6e-4))


def test_wall_terms_match_jax(cases, state):
    jc, tc = cases
    s = state
    close(tpres.pressure_gradient(tc, T(s["p"]))[0], s["gpx"], WALL_TOL,
          "gpx")
    for got, ref, name in zip(tmom.wall_unit_normal(tc),
                              jmom.wall_unit_normal(jc), ("nx", "ny")):
        close(got, ref, WALL_TOL, name)
    a_wall = (jc.nu * jc.wall_len / jc.wall_dist)
    ref = jmom.wall_normal_release(jc, a_wall, jnp.asarray(s["u"]),
                                   jnp.asarray(s["v"]))
    got = tmom.wall_normal_release(
        tc, tc.nu * tc.wall_len / tc.wall_dist, T(s["u"]), T(s["v"]))
    for g, r, name in zip(got, ref, ("release u", "release v")):
        close(g, r, WALL_TOL, name)
    ref = jmom.wall_shear2_source(jc, jnp.asarray(s["gpx"]),
                                  jnp.asarray(s["gpy"]))
    got = tmom.wall_shear2_source(tc, T(s["gpx"]), T(s["gpy"]))
    for g, r, name in zip(got, ref, ("shear2 u", "shear2 v")):
        close(g, r, WALL_TOL, name)
        assert float(g.abs().max()) > 0.0, name


def _coeffs(case, s, grad, **kw):
    args = (s["phi_x"], s["phi_y"], s["u"], s["v"])
    if isinstance(case, tcase.Case):
        return tmom.momentum_coeffs(
            case, *(T(a) for a in args), torch.tensor(s["dt"]), **kw,
            wall_grad_p=(T(s["gpx"]), T(s["gpy"])) if grad else None)
    return jmom.momentum_coeffs(
        case, *(jnp.asarray(a) for a in args), jnp.float32(s["dt"]), **kw,
        wall_grad_p=(jnp.asarray(s["gpx"]), jnp.asarray(s["gpy"]))
        if grad else None)


@pytest.mark.parametrize("name,grad,kw", [
    ("wall-grad-p", True, {}),
    ("tangential", False, dict(wall_link="tangential")),
    ("both", True, dict(wall_link="tangential")),
    ("both-limitedLinear", True, dict(wall_link="tangential",
                                      convection="limitedLinear")),
], ids=["wall-grad-p", "tangential", "both", "both-limitedLinear"])
def test_momentum_coeffs_wall_options_match_jax(cases, state, name, grad,
                                                kw):
    jc, tc = cases
    jco, tco = _coeffs(jc, state, grad, **kw), _coeffs(tc, state, grad, **kw)
    plain = _coeffs(tc, state, False, **{k: v for k, v in kw.items()
                                         if k != "wall_link"})
    for c in COEFS:
        close(getattr(tco, c), getattr(jco, c), COEF_TOL, c)
    # the options act on the explicit source only
    for c in COEFS[:5]:
        assert torch.equal(getattr(tco, c), getattr(plain, c)), c
    assert not torch.equal(tco.b_u, plain.b_u)


def test_wall_options_leave_a_blank_case_alone(blank, state):
    """The wall options act on cut-cell cases only (the stair force
    report has no closure terms), in both packages."""
    jc, tc = blank
    kw = dict(wall_link="tangential")
    got = _coeffs(tc, state, True, **kw)
    ref = _coeffs(tc, state, False)
    for c in COEFS:
        assert torch.equal(getattr(got, c), getattr(ref, c)), c
    jgot, jref = _coeffs(jc, state, True, **kw), _coeffs(jc, state, False)
    np.testing.assert_array_equal(np.asarray(jgot.b_u), np.asarray(jref.b_u))
    with pytest.raises(ValueError, match="wall link"):
        _coeffs(tc, state, False, wall_link="normal")


@pytest.mark.parametrize("boundary", ["cutcell", "blank"])
@pytest.mark.parametrize("option", list(WALL_OPTIONS))
def test_obstacle_force_wall_terms_match_jax(cases, blank, state, boundary,
                                             option):
    jc, tc = cases if boundary == "cutcell" else blank
    fl = np.asarray(jc.fluid)
    u, v, p = ((state[k] * fl).astype(np.float32) for k in ("u", "v", "p"))
    kw = WALL_OPTIONS[option]
    ref = jforces.obstacle_force(jc, jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(p), u_ref=1.0, d_ref=0.5, **kw)
    got = tforces.obstacle_force(tc, T(u), T(v), T(p), u_ref=1.0,
                                 d_ref=0.5, **kw)
    first = tforces.obstacle_force(tc, T(u), T(v), T(p), u_ref=1.0,
                                   d_ref=0.5)
    scale = np.abs(np.asarray(ref.total)).max()
    for name in ("f_pressure", "f_viscous", "total"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=FORCE_TOL * scale, err_msg=name)
    q = 0.5 * 1.0 * 0.5
    np.testing.assert_allclose([float(got.cd), float(got.cl)],
                               [float(ref.cd), float(ref.cl)], rtol=0,
                               atol=FORCE_TOL * scale / q)
    # the terms change the viscous force of a cut-cell report only
    assert torch.equal(got.f_pressure, first.f_pressure)
    assert torch.equal(got.f_viscous, first.f_viscous) \
        == (boundary == "blank")


def test_run_force_series_reports_the_step_wall_terms(cases):
    _, tc = cases
    cfg = teng.PisoConfig(max_dt=2e-3, wall_order=2,
                          wall_link="tangential")
    flow, series = tbench.run_force_series(
        tc, tcase.initial_flow(tc, 5e-4), 1e-3, 1.0, cfg=cfg,
        backend=TMG(cycles=2), sample_steps=2, d_ref=0.5)
    rep = tforces.obstacle_force(tc, flow.u, flow.v, flow.p, u_ref=1.0,
                                 d_ref=0.5, wall_order=2,
                                 wall_link="tangential")
    assert series.cd[-1] == float(rep.cd) and series.cl[-1] == float(rep.cl)


@pytest.fixture(scope="module")
def hybrid(cases):
    jb = _tiny_bundle(block_size=16)
    return (jax_make_predictor(jb, stitch="lstsq"),
            make_predictor(bundle_to_torch(jb), stitch="lstsq"))


ALG1 = dict(n_correctors=2, max_co=0.5, max_dt=2e-3,
            sm_before_predictor=False)


def test_algorithm1_matches_jax(cases, hybrid, monkeypatch):
    """Three hybrid steps with the prediction after the momentum
    predictor: it sees the predicted U* (the momentum solve's output) and
    the old p, and is made once a step, after the momentum solve."""
    jc, tc = cases
    jpred, tpred = hybrid
    jf = jeng.run_piso_eager(
        jc, jcase.initial_flow(jc, 5e-4), 3,
        cfg=jeng.PisoConfig(momentum_smoother="pallas", **ALG1),
        backend=JMG(cycles=2), sm_predict=jpred)
    events = []
    impl = teng.jacobi_momentum

    def momentum(*a, **kw):
        out = impl(*a, **kw)
        events.append(("momentum", out))
        return out

    bound = tpred.bind(tc)

    def predict(case, p_prev, aux):
        events.append(("predict", aux["u"], aux["v"], aux["p"], p_prev))
        return bound(case, p_prev, aux)

    monkeypatch.setattr(teng, "jacobi_momentum", momentum)
    flow = tcase.initial_flow(tc, 5e-4)
    olds = []
    for _ in range(3):
        olds.append(flow.p)
        flow = teng.run_piso_eager(
            tc, flow, 1, cfg=teng.PisoConfig(momentum_smoother="kernel",
                                             **ALG1),
            backend=TMG(cycles=2), sm_predict=predict)
    for f in FIELDS:
        close(getattr(flow, f), getattr(jf, f), STEP_TOL, f)
    for f in ("t", "dt"):
        close(getattr(flow, f), getattr(jf, f), TIME_TOL, f)
    assert [e[0] for e in events] == ["momentum", "predict"] * 3
    for k in range(3):
        (_, (u_star, v_star)), pred = events[2 * k], events[2 * k + 1]
        assert pred[1] is u_star and pred[2] is v_star
        assert pred[3] is olds[k] and pred[4] is olds[k]


FLEET_OPTIONS = dict(max_co=0.5, max_dt=2e-3, ddt="backward", ddt_corr=True,
                     wall_order=2, wall_link="tangential",
                     momentum_smoother="kernel")


@pytest.mark.parametrize("alg", ["alg2-pure", "alg1-hybrid"])
def test_fleet_and_mesh_take_the_options(cases, hybrid, alg):
    """A fleet of two cases from different states, and the 2 x 2 mesh
    step, with every option of the slice (the hybrid with Algorithm 1):
    each fleet case as if alone, the mesh step equal to piso_step."""
    _, tc = cases
    _, tpred = hybrid
    cfg = teng.PisoConfig(**FLEET_OPTIONS,
                          sm_before_predictor=alg == "alg2-pure")
    sm = tpred if alg == "alg1-hybrid" else None
    be = TMG(cycles=2)
    flows = [tcase.initial_flow(tc, dt) for dt in (5e-4, 3e-4)]
    singles = [teng.run_piso_eager(tc, f, 2, cfg=cfg, backend=be,
                                   sm_predict=sm) for f in flows]
    fleet = teng.run_piso_eager(tbat.stack_cases([tc, tc]),
                                tbat.stack_flows(flows), 2, cfg=cfg,
                                backend=be, sm_predict=sm)
    for k, single in enumerate(singles):
        for f in FIELDS + ("t", "dt"):
            close(getattr(fleet, f)[k], getattr(single, f), 1e-6, f"{k} {f}")
    mesh = tmesh.device_mesh(4, shape=(2, 2), devices=["cpu"] * 4)
    step = tmesh.make_sharded_piso_step(
        mesh, cfg, be, sm_predict=None if sm is None else sm.bind(tc))
    got = tmesh.unshard_flow(step(tmesh.shard_case(mesh, tc),
                                  tmesh.shard_flow(mesh, flows[0])))
    ref = teng.piso_step(tc, flows[0], cfg, be,
                         None if sm is None else sm.bind(tc))
    for f in FIELDS + ("t", "dt"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_run_piso_equals_run_piso_eager(cases):
    _, tc = cases
    cfg = teng.PisoConfig(**FLEET_OPTIONS)
    f0 = tcase.initial_flow(tc, 5e-4)
    got = teng.run_piso(tc, f0, 3, cfg=cfg, backend=TMG(cycles=2))
    ref = teng.run_piso_eager(tc, f0, 3, cfg=cfg, backend=TMG(cycles=2))
    for f in FIELDS + ("t", "dt", "u_prev", "p_prev"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert teng.run_piso(tc, f0, 0) is f0


def _differentiable(convection="limitedLinear"):
    """tests/test_differentiable.py's configuration: an empty 2 x 1
    channel at delta 1/16, one corrector, fixed dt, two momentum sweeps,
    MGBackend(cycles=2); the loss is the kinetic energy of the downstream
    half after three steps, as a function of the inlet profile."""
    geom = ChannelCase(length=2.0, height=1.0, shape=None, nu=0.05)
    case = tcase.build_channel_case(geom, delta=1.0 / 16, device="cpu")
    flow0 = tcase.initial_flow(case, dt0=5e-3)
    cfg = teng.PisoConfig(n_correctors=1, adjust_dt=False,
                          momentum_sweeps=2, convection=convection)

    def loss(inlet_u):
        c = dataclasses.replace(case, inlet_u=inlet_u)
        f = teng.run_piso(c, flow0, 3, cfg=cfg, backend=TMG(cycles=2))
        return torch.sum(f.u[:, case.grid.nx // 2:] ** 2)

    return case, loss


def test_grad_through_run_piso():
    case, loss = _differentiable()
    x = case.inlet_u.clone().requires_grad_(True)
    g, = torch.autograd.grad(loss(x), x)
    assert bool(torch.isfinite(g).all())
    assert float(g.abs().max()) > 0.0
    # faster inlet -> more downstream kinetic energy at the centre row
    assert float(g[case.grid.ny // 2]) > 0.0


def test_grad_through_run_piso_matches_finite_difference():
    case, loss = _differentiable(convection="upwind")
    x = case.inlet_u.clone().requires_grad_(True)
    g, = torch.autograd.grad(loss(x), x)
    d = torch.as_tensor(np.random.default_rng(0).standard_normal(
        case.inlet_u.shape), dtype=torch.float32)
    eps = 1e-2
    with torch.no_grad():
        fd = (loss(case.inlet_u + eps * d).double()
              - loss(case.inlet_u - eps * d).double()) / (2 * eps)
    ad = float((g.double() * d.double()).sum())
    assert abs(float(fd) - ad) <= GRAD_TOL * abs(ad), (float(fd), ad)
