"""The step options of the Schaefer-Turek path against the JAX package, on
the CPU: `momentum_coeffs`' convection schemes and its variable-step BDF2
(`ddt="backward"`), the surrogate trust gate (`sm_trust`), the dt options
`adjust_dt=False` and `t_stop`, the in-step inlet scale, and
`run_piso_chunked`.

Tolerances, max |port - JAX| / max |JAX|:
- coefficients: 1e-5 (the same float32 operations in the same order; the
  two frameworks differ only in fused multiply-adds and summation order);
- the gate: exact (a choice between two inputs);
- three steps with MGBackend(cycles=2) in float32: 1e-4, the f32 tolerance
  of tests/test_torch_piso.py; t and dt: 1e-6.
The port's `run_piso_chunked` is its `run_piso_eager`.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.eval.benchmark import ramp_2d3 as jax_ramp
from tpufoam.fv import case as jcase
from tpufoam.fv import momentum as jmom
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.eval.benchmark import ramp_2d3
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv import momentum as tmom
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend as TMG

NY, NX = 32, 128
COEF_TOL = 1e-5
STEP_TOL = 1e-4
TIME_TOL = 1e-6
COEFS = ("a_e", "a_w", "a_n", "a_s", "a_p", "b_u", "b_v")
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


@pytest.fixture(scope="module")
def cases():
    delta = 2.0 / NY
    kw = dict(shape_name="cylinder", length=NX * delta, height=2.0,
              obstacle_size=0.5, nu=8e-3)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=delta)
    tc = tcase.build_channel_case(channel_case_geometry(**kw), delta=delta,
                                  device="cpu")
    return jc, tc


@pytest.fixture(scope="module")
def state(cases):
    """The initial flow plus seeded noise, fluxes from the noisy velocity,
    and a different seeded previous-step velocity."""
    jc, _ = cases
    rng = np.random.default_rng(7)
    fl = np.asarray(jc.fluid)
    u0 = np.asarray(jcase.initial_flow(jc).u)

    def noisy(base, scale):
        return ((base + scale * rng.standard_normal(fl.shape)) * fl
                ).astype(np.float32)

    u, v = noisy(u0, 0.1), noisy(0.0, 0.1)
    phi_x, phi_y = jcase.fluxes_from_velocity(jc, jnp.asarray(u),
                                              jnp.asarray(v))
    return dict(u=u, v=v, phi_x=np.asarray(phi_x), phi_y=np.asarray(phi_y),
                u_nm1=noisy(u0, 0.05), v_nm1=noisy(0.0, 0.05),
                dt=np.float32(6e-4), dt_prev=np.float32(4e-4))


def _coeffs(cases, s, **kw):
    jc, tc = cases
    extra = {}
    if kw.get("ddt") == "backward":
        extra = dict(u_nm1=s["u_nm1"], v_nm1=s["v_nm1"],
                     dt_prev=s["dt_prev"])
    jco = jmom.momentum_coeffs(
        jc, s["phi_x"], s["phi_y"], s["u"], s["v"], jnp.float32(s["dt"]),
        **kw, **{k: jnp.asarray(v) for k, v in extra.items()})
    tco = tmom.momentum_coeffs(
        tc, T(s["phi_x"]), T(s["phi_y"]), T(s["u"]), T(s["v"]),
        torch.tensor(s["dt"]), **kw, **{k: T(v) for k, v in extra.items()})
    return jco, tco


def test_momentum_coeffs_default_convection_matches_jax(cases, state):
    """Both packages' default call: convection="blend" at 0.0, pure
    upwind."""
    jco, tco = _coeffs(cases, state)
    for name in COEFS:
        close(getattr(tco, name), getattr(jco, name), COEF_TOL, name)


@pytest.mark.parametrize("kw", [
    dict(convection="upwind"),
    dict(convection="blend", convection_blend=0.5),
    dict(convection="limitedLinear"),
    dict(convection="limitedLinear", ddt="backward"),
    dict(ddt="backward"),
], ids=["upwind", "blend-0.5", "limitedLinear", "bdf2-limitedLinear",
        "bdf2-upwind"])
def test_momentum_coeffs_options_match_jax(cases, state, kw):
    jco, tco = _coeffs(cases, state, **kw)
    for name in COEFS:
        close(getattr(tco, name), getattr(jco, name), COEF_TOL, name)


def test_bdf2_bootstrap_step_is_consistent(cases, state):
    """u_nm1 == u and dt_prev == dt: the BDF2 source (c2 - c3) u equals
    c1 u, so a_P u - b holds the Euler balance scaled alike."""
    _, tc = cases
    s = state
    u, v, dt = T(s["u"]), T(s["v"]), torch.tensor(s["dt"])
    args = (tc, T(s["phi_x"]), T(s["phi_y"]), u, v, dt)
    eul = tmom.momentum_coeffs(*args, convection="upwind")
    bdf = tmom.momentum_coeffs(*args, convection="upwind", ddt="backward",
                               u_nm1=u, v_nm1=v, dt_prev=dt)
    volc = tc.alpha * (tc.grid.dx * tc.grid.dy) * tc.fluid
    # the implicit coefficient grows by (c1 - 1) volc/dt, the source by
    # the same times u: their difference is unchanged
    close(bdf.a_p - eul.a_p, 0.5 * volc / dt, COEF_TOL, "a_p")
    close(bdf.b_u - eul.b_u, 0.5 * volc / dt * u, COEF_TOL, "b_u")


def test_unknown_scheme_raises(cases, state):
    with pytest.raises(ValueError, match="convection"):
        _coeffs(cases, state, convection="quick")


@pytest.mark.parametrize("which", ["accept", "reject", "cold-start", "nan",
                                   "trust-off"])
def test_sm_trust_gate_matches_jax(cases, which):
    jc, _ = cases
    rng = np.random.default_rng(3)
    fl = np.asarray(jc.fluid)
    p_prev = (rng.standard_normal(fl.shape) * fl).astype(np.float32)
    step = (0.2 if which in ("accept", "cold-start") else 3.0)
    p_sm = (p_prev + step * rng.standard_normal(fl.shape)).astype(np.float32)
    if which == "cold-start":
        p_prev = np.zeros_like(p_prev)
    if which == "nan":
        p_sm[3, 5] = np.nan
    trust = 0.0 if which == "trust-off" else 1.0
    ref = jeng._gate_sm_prediction(jnp.asarray(p_sm), jnp.asarray(p_prev),
                                   jc.fluid, trust=trust)
    got = teng._gate_sm_prediction(T(p_sm), T(p_prev), T(fl), trust=trust)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    took_sm = np.array_equal(got.numpy(), p_sm * fl, equal_nan=True)
    assert took_sm == (which in ("accept", "cold-start", "trust-off"))


JAX_BASE = jeng.PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                           momentum_smoother="pallas")
TORCH_BASE = teng.PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                             momentum_smoother="kernel")
DT0 = 5e-4
OPTIONS = {
    "fixed-dt": dict(adjust_dt=False),
    # the third step is capped to land on t_stop, the fourth takes the
    # floor dt
    "t-stop": dict(adjust_dt=False, t_stop=2.5 * DT0),
    "inlet-ramp": dict(inlet_scale_fn="ramp"),
    "bdf2": dict(ddt="backward"),
    "blend": dict(convection="blend", convection_blend=0.5),
}


def _cfgs(opts):
    j, t = dict(opts), dict(opts)
    if opts.get("inlet_scale_fn") == "ramp":
        j["inlet_scale_fn"], t["inlet_scale_fn"] = jax_ramp, ramp_2d3
    return (dataclasses.replace(JAX_BASE, **j),
            dataclasses.replace(TORCH_BASE, **t))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_steps_with_options_match_jax(cases, name):
    jc, tc = cases
    opts = OPTIONS[name]
    jcfg, tcfg = _cfgs(opts)
    n = 4 if "t_stop" in opts else 3
    jf0, tf0 = jcase.initial_flow(jc, DT0), tcase.initial_flow(tc, DT0)
    if name == "inlet-ramp":
        # the 2D-3 start: the flow from rest, the inlet ramped in the step
        jf0 = jcase.initial_flow(jc.replace(inlet_u=jc.inlet_u * 0.0), DT0)
        tf0 = tcase.initial_flow(
            dataclasses.replace(tc, inlet_u=tc.inlet_u * 0.0), DT0)
    jf = jeng.run_piso_eager(jc, jf0, n, cfg=jcfg, backend=JMG(cycles=2))
    tf = teng.run_piso_eager(tc, tf0, n, cfg=tcfg, backend=TMG(cycles=2))
    for f in FIELDS:
        close(getattr(tf, f), getattr(jf, f), STEP_TOL, f)
    for f in ("t", "dt"):
        close(getattr(tf, f), getattr(jf, f), TIME_TOL, f)
    if name == "fixed-dt":
        assert float(tf.dt) == np.float32(DT0)
    if name == "t-stop":
        # three steps land on t_stop; the fourth adds the 1e-6 floor
        assert float(tf.dt) == pytest.approx(1e-6)
        assert float(tf.t) == pytest.approx(2.5 * DT0 + 1e-6, rel=1e-6)
    if name == "inlet-ramp":
        assert float(tf.u.abs().max()) > 0.0


def test_t_stop_lands_exactly(cases):
    _, tc = cases
    t_stop = 2.5 * DT0
    cfg = dataclasses.replace(TORCH_BASE, adjust_dt=False, t_stop=t_stop)
    f = teng.run_piso_eager(tc, tcase.initial_flow(tc, DT0), 3, cfg=cfg,
                            backend=TMG(cycles=2))
    assert float(f.t) == float(np.float32(t_stop))


def test_run_piso_chunked_equals_eager_and_jax(cases):
    jc, tc = cases
    assert teng.run_piso_chunked is teng.run_piso_eager
    chunked = teng.run_piso_chunked(tc, tcase.initial_flow(tc, DT0), 5,
                                    cfg=TORCH_BASE, backend=TMG(cycles=2))
    ref = jeng.run_piso_chunked(jc, jcase.initial_flow(jc, DT0), 5,
                                cfg=JAX_BASE, backend=JMG(cycles=2), chunk=2)
    for f in FIELDS:
        close(getattr(chunked, f), getattr(ref, f), STEP_TOL, f)


def test_stiff_max_dt_warns(cases):
    _, tc = cases
    f0 = tcase.initial_flow(tc, DT0)
    stiff = dataclasses.replace(TORCH_BASE, max_dt=10.0)
    with pytest.warns(UserWarning, match="diffusion number"):
        teng.run_piso_chunked(tc, f0, 1, cfg=stiff, backend=TMG(cycles=2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        teng.run_piso_chunked(tc, f0, 1, cfg=TORCH_BASE,
                              backend=TMG(cycles=2))


def test_fleet_takes_the_options_per_case(cases):
    """A stacked fleet of two cases from different states, with BDF2, the
    in-step inlet ramp, t_stop and the trust gate: each case as if alone
    (the JAX package vmaps the step), to float32 rounding of the fleet's
    batched reductions (1e-6 relative)."""
    from tpufoam_torch.piso.batched import stack_cases, stack_flows

    _, tc = cases
    cfg = dataclasses.replace(TORCH_BASE, ddt="backward", t_stop=4e-3,
                              inlet_scale_fn=ramp_2d3, sm_trust=1.0)
    flows = [tcase.initial_flow(tc, dt) for dt in (5e-4, 3e-4)]
    singles = [teng.run_piso_eager(tc, f, 3, cfg=cfg, backend=TMG(cycles=2))
               for f in flows]
    fleet = teng.run_piso_eager(stack_cases([tc, tc]), stack_flows(flows),
                                3, cfg=cfg, backend=TMG(cycles=2))
    for k, single in enumerate(singles):
        for f in FIELDS + ("t", "dt"):
            close(getattr(fleet, f)[k], getattr(single, f), 1e-6, f"{k} {f}")
    # the gate per case: one plausible prediction, one rejected
    rng = np.random.default_rng(4)
    fl = tc.fluid
    p_prev = torch.as_tensor(rng.standard_normal(fl.shape),
                             dtype=torch.float32) * fl
    p_sm = torch.stack([p_prev * 1.1, p_prev + 5.0])
    got = teng._gate_sm_prediction(p_sm, torch.stack([p_prev, p_prev]),
                                   torch.stack([fl, fl]), trust=1.0)
    assert torch.equal(got[0], p_sm[0] * fl)
    assert torch.equal(got[1], p_prev * fl)
