"""The k-omega SST model of the PyTorch port against the JAX package on
the CPU: `fv.turbulence` (`init_turbulence`, `sst_step` with both wall
treatments), `fv.momentum`'s `wall_conductance` and `momentum_coeffs`
with `nu_t` and `k_turb`, `fv.forces.obstacle_force` with each,
`piso.engine`'s turbulent rollouts (`run_piso_sst_eager`, `run_piso_sst`),
the SST state in `fv.case`'s state files, `eval.benchmark`'s turbulent
channel (`turbulent_channel_case`, `channel_wall_cf`, `dean_cf`) and the
turbulent step over a mesh (`parallel.mesh.make_sharded_sst_step`).

Inputs are seeded with numpy. Tolerances, max |port - JAX| / max |JAX|:
- elementwise float32 terms (the inlet turbulence, the wall
  conductance): WALL_TOL 1e-6;
- coefficients and one SST step from the same state: COEF_TOL 1e-5 (as
  tests/test_torch_piso_options.py);
- forces from the same fields: FORCE_TOL 1e-5 of the largest component;
- three turbulent steps in float32 (CGBackend, MGBackend f32): STEP_TOL
  1e-4 on u, v, p, the fluxes, k, omega and nu_t; t and dt TIME_TOL 1e-6
  (one step of the channel from its uniform start, whose v is ~1e-5 of u
  and p ~5e-3 of u^2: v and phi_y on the scales of u and phi_x, p on
  u^2);
- the channel's wall-shear summary from the same fields: 1e-4;
- run_piso_sst against run_piso_sst_eager, the mesh step against
  piso_step_sst, a state file read back: bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.eval import benchmark as jbench
from tpufoam.fv import case as jcase
from tpufoam.fv import forces as jforces
from tpufoam.fv import momentum as jmom
from tpufoam.fv import turbulence as jturb
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import CGBackend as JCG
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.eval import benchmark as tbench
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv import forces as tforces
from tpufoam_torch.fv import momentum as tmom
from tpufoam_torch.fv import turbulence as tturb
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import CGBackend as TCG
from tpufoam_torch.solvers.backends import MGBackend as TMG

WALL_TOL = 1e-6
COEF_TOL = 1e-5
FORCE_TOL = 1e-5
STEP_TOL = 1e-4
TIME_TOL = 1e-6
CF_TOL = 1e-4
COEFS = ("a_e", "a_w", "a_n", "a_s", "a_p", "b_u", "b_v")
FIELDS = ("u", "v", "p", "phi_x", "phi_y")
TURB = ("k", "omega", "nu_t", "k_in", "w_in")
# the turbulent channel, cut to 16 x 64 (the published run is 256 x 4096)
CHANNEL = dict(nu=5e-5, length=8.0, delta=2.0 / 16)
CYL_NY, CYL_NX = 32, 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, ref, rtol, what="", scale=None):
    """max |got - ref| <= rtol * scale, by default scale = max |ref|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    if scale is None:
        scale = max(float(np.abs(ref).max()), 1e-30)
    assert err <= rtol * scale, \
        f"{what}: max err {err:.3e} > {rtol:g} * {scale:.3e}"


@pytest.fixture(scope="module")
def cases():
    """{name: (JAX case, port case)}: the turbulent channel and a
    cut-cell cylinder."""
    jch, ju = jbench.turbulent_channel_case(**CHANNEL)
    tch, tu = tbench.turbulent_channel_case(**CHANNEL, device="cpu")
    assert ju == tu
    delta = 2.0 / CYL_NY
    kw = dict(shape_name="cylinder", length=CYL_NX * delta, height=2.0,
              obstacle_size=0.5, nu=2e-3)
    jcy = jcase.build_channel_case(jax_geom(**kw), delta=delta)
    tcy = tcase.build_channel_case(channel_case_geometry(**kw), delta=delta,
                                   device="cpu")
    return {"channel": (jch, tch), "cylinder": (jcy, tcy)}


def _state(jc, seed):
    """The initial flow plus seeded noise and the fluxes of the noisy
    velocity; a turbulent state from init_turbulence with seeded noise in
    k and omega."""
    rng = np.random.default_rng(seed)
    fl = np.asarray(jc.fluid)
    u0 = np.asarray(jcase.initial_flow(jc).u)

    def noisy(base, scale):
        return ((base + scale * rng.standard_normal(fl.shape)) * fl
                ).astype(np.float32)

    u, v = noisy(u0, 0.1), noisy(0.0, 0.1)
    phi_x, phi_y = jcase.fluxes_from_velocity(jc, jnp.asarray(u),
                                              jnp.asarray(v))
    t0 = jturb.init_turbulence(jc)
    k = (np.asarray(t0.k) * (1.0 + 0.5 * rng.random(fl.shape))
         ).astype(np.float32)
    w = (np.asarray(t0.omega) * (1.0 + 0.5 * rng.random(fl.shape))
         ).astype(np.float32)
    nu_t = (k / np.maximum(w, 1e-8) * fl).astype(np.float32)
    return dict(u=u, v=v, phi_x=np.asarray(phi_x), phi_y=np.asarray(phi_y),
                k=k, omega=w, nu_t=nu_t, k_in=np.asarray(t0.k_in),
                w_in=np.asarray(t0.w_in), dt=np.float32(4e-3))


def _jturb(s):
    return jturb.TurbState(**{f: jnp.asarray(s[f]) for f in TURB})


def _tturb(s):
    return tturb.TurbState(**{f: T(s[f]) for f in TURB})


# ---- (h) the model's pieces ----------------------------------------------


@pytest.mark.parametrize("name", ["channel", "cylinder"])
def test_init_turbulence_matches_jax(cases, name):
    jc, tc = cases[name]
    ref, got = jturb.init_turbulence(jc), tturb.init_turbulence(tc)
    for f in TURB:
        close(getattr(got, f), getattr(ref, f), WALL_TOL, f)
    ref = jturb.init_turbulence(jc, intensity=0.1, length_frac=0.05)
    got = tturb.init_turbulence(tc, intensity=0.1, length_frac=0.05)
    for f in TURB:
        close(getattr(got, f), getattr(ref, f), WALL_TOL, f)


def test_init_turbulence_refuses_a_stretched_grid():
    from tpufoam_torch.core.grid import make_graded_grid
    geom = channel_case_geometry("cylinder", length=2.0, height=1.0,
                                 obstacle_size=0.3, nu=1e-3)
    xs = np.full(16, 2.0 / 16)
    ys = np.concatenate([np.full(4, 0.05), np.full(6, 0.1),
                         np.full(4, 0.05)])
    grid = make_graded_grid(0.0, 2.0, 0.0, 1.0, xs, ys)
    tc = tcase.build_channel_case(geom, grid=grid, device="cpu")
    with pytest.raises(ValueError):
        tturb.init_turbulence(tc)


def test_wall_conductance_matches_jax():
    rng = np.random.default_rng(3)
    k = (10.0 ** rng.uniform(-9, 0, (8, 64))).astype(np.float32)
    k[0, :4] = [0.0, -1e-6, 1e-12, 1e-30]
    d = (10.0 ** rng.uniform(-4, -1, (8, 64))).astype(np.float32)
    for nu in (5e-5, 1e-3):
        close(tmom.wall_conductance(nu, T(k), T(d)),
              jmom.wall_conductance(nu, jnp.asarray(k), jnp.asarray(d)),
              WALL_TOL, f"tensor d, nu {nu}")
        close(tmom.wall_conductance(nu, T(k), 0.0078125),
              jmom.wall_conductance(nu, jnp.asarray(k), 0.0078125),
              WALL_TOL, f"scalar d, nu {nu}")
        close(tmom.wall_conductance(nu, T(k), T(d), kappa=0.4, e_rough=9.0,
                                    cmu=0.08),
              jmom.wall_conductance(nu, jnp.asarray(k), jnp.asarray(d),
                                    kappa=0.4, e_rough=9.0, cmu=0.08),
              WALL_TOL, "options")


@pytest.mark.parametrize("name", ["channel", "cylinder"])
def test_wall_cell_masks_match_jax(cases, name):
    jc, tc = cases[name]
    for got, ref in zip(tturb.wall_cell_masks(tc), jturb.wall_cell_masks(jc)):
        close(got, ref, 0.0)


@pytest.mark.parametrize("wall_fn", [False, True])
@pytest.mark.parametrize("name", ["channel", "cylinder"])
def test_sst_step_matches_jax(cases, name, wall_fn):
    jc, tc = cases[name]
    s = _state(jc, 11)
    ref = jturb.sst_step(jc, _jturb(s), jnp.asarray(s["u"]),
                         jnp.asarray(s["v"]), jnp.asarray(s["phi_x"]),
                         jnp.asarray(s["phi_y"]), jnp.float32(s["dt"]),
                         wall_fn=wall_fn)
    got = tturb.sst_step(tc, _tturb(s), T(s["u"]), T(s["v"]),
                         T(s["phi_x"]), T(s["phi_y"]), torch.tensor(s["dt"]),
                         wall_fn=wall_fn)
    for f in TURB:
        close(getattr(got, f), getattr(ref, f), COEF_TOL, f)
    assert bool(torch.all(got.k >= 0)) and bool(torch.all(got.omega > 0))
    # more sweeps change the result, as in JAX
    ref2 = jturb.sst_step(jc, _jturb(s), jnp.asarray(s["u"]),
                          jnp.asarray(s["v"]), jnp.asarray(s["phi_x"]),
                          jnp.asarray(s["phi_y"]), jnp.float32(s["dt"]),
                          sweeps=8, wall_fn=wall_fn)
    got2 = tturb.sst_step(tc, _tturb(s), T(s["u"]), T(s["v"]),
                          T(s["phi_x"]), T(s["phi_y"]),
                          torch.tensor(s["dt"]), sweeps=8, wall_fn=wall_fn)
    close(got2.k, ref2.k, COEF_TOL, "k, 8 sweeps")
    close(got2.omega, ref2.omega, COEF_TOL, "omega, 8 sweeps")


@pytest.mark.parametrize("turb", ["nu_t", "k_turb", "both"])
@pytest.mark.parametrize("name", ["channel", "cylinder"])
def test_momentum_coeffs_with_turbulence_match_jax(cases, name, turb):
    jc, tc = cases[name]
    s = _state(jc, 5)
    kw_j, kw_t = {}, {}
    if turb in ("nu_t", "both"):
        kw_j["nu_t"], kw_t["nu_t"] = jnp.asarray(s["nu_t"]), T(s["nu_t"])
    if turb in ("k_turb", "both"):
        kw_j["k_turb"], kw_t["k_turb"] = jnp.asarray(s["k"]), T(s["k"])
    # the laminar wall options are off under the wall functions
    opts = dict(wall_link="tangential") if turb != "nu_t" else {}
    ref = jmom.momentum_coeffs(jc, s["phi_x"], s["phi_y"], s["u"], s["v"],
                               jnp.float32(s["dt"]), **kw_j, **opts)
    got = tmom.momentum_coeffs(tc, T(s["phi_x"]), T(s["phi_y"]), T(s["u"]),
                               T(s["v"]), torch.tensor(s["dt"]), **kw_t,
                               **opts)
    for c in COEFS:
        close(getattr(got, c), getattr(ref, c), COEF_TOL, c)
    lam = tmom.momentum_coeffs(tc, T(s["phi_x"]), T(s["phi_y"]), T(s["u"]),
                               T(s["v"]), torch.tensor(s["dt"]))
    assert not torch.equal(got.a_p, lam.a_p)


@pytest.mark.parametrize("turb", ["laminar", "nu_t", "k_turb"])
def test_obstacle_force_with_turbulence_matches_jax(cases, turb):
    jc, tc = cases["cylinder"]
    s = _state(jc, 9)
    p = (np.random.default_rng(2).standard_normal(s["u"].shape)
         * np.asarray(jc.fluid)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if turb == "nu_t":
        kw_j["nu_t"], kw_t["nu_t"] = jnp.asarray(s["nu_t"]), T(s["nu_t"])
    if turb == "k_turb":
        kw_j = dict(nu_t=jnp.asarray(s["nu_t"]), k_turb=jnp.asarray(s["k"]),
                    wall_order=2, wall_link="tangential")
        kw_t = dict(nu_t=T(s["nu_t"]), k_turb=T(s["k"]), wall_order=2,
                    wall_link="tangential")
    ref = jforces.obstacle_force(jc, jnp.asarray(s["u"]), jnp.asarray(s["v"]),
                                 jnp.asarray(p), u_ref=1.0, d_ref=0.5, **kw_j)
    got = tforces.obstacle_force(tc, T(s["u"]), T(s["v"]), T(p), u_ref=1.0,
                                 d_ref=0.5, **kw_t)
    scale = float(np.abs(np.asarray(ref.total)).max())
    for f in ("f_pressure", "f_viscous"):
        err = float(np.abs(getattr(got, f).numpy()
                           - np.asarray(getattr(ref, f))).max())
        assert err <= FORCE_TOL * scale, (f, err, scale)


# ---- (i) rollouts ----------------------------------------------------------

ROLLOUTS = {
    # (case, turb_wall_fn, JAX backend, port backend)
    "channel-wall-fn-cg": ("channel", True, JCG(rtol=1e-6, maxiter=400),
                           TCG(rtol=1e-6, maxiter=400)),
    "cylinder-mg-f32": ("cylinder", False, JMG(cycles=2, precision="f32"),
                        TMG(cycles=2, precision="f32")),
}


def _cfgs(wall_fn):
    kw = dict(max_co=0.5, max_dt=5e-3, turb_wall_fn=wall_fn)
    return jeng.PisoConfig(**kw), teng.PisoConfig(**kw)


@pytest.fixture(scope="module", params=list(ROLLOUTS))
def rollout(request, cases):
    name, wall_fn, jbe, tbe = ROLLOUTS[request.param]
    jc, tc = cases[name]
    jcfg, tcfg = _cfgs(wall_fn)
    jf0 = jcase.initial_flow(jc, 1e-3)
    jt0 = jturb.init_turbulence(jc)
    jf, jt = jeng.run_piso_sst_eager(jc, jf0, jt0, 3, cfg=jcfg, backend=jbe)
    tf0, tt0 = tcase.initial_flow(tc, 1e-3), tturb.init_turbulence(tc)
    tf, tt = teng.run_piso_sst_eager(tc, tf0, tt0, 3, cfg=tcfg, backend=tbe)
    return request.param, (jc, tc), (jf, jt), (tf, tt), (tf0, tt0, tcfg, tbe)


def test_sst_rollout_matches_jax(rollout):
    name, _, (jf, jt), (tf, tt), _ = rollout
    for f in FIELDS:
        close(getattr(tf, f), getattr(jf, f), STEP_TOL, f"{name} {f}")
    for f in ("k", "omega", "nu_t"):
        close(getattr(tt, f), getattr(jt, f), STEP_TOL, f"{name} {f}")
    close(tf.t, jf.t, TIME_TOL, "t")
    close(tf.dt, jf.dt, TIME_TOL, "dt")
    assert bool(torch.all(tt.k >= tturb.K_FLOOR * 0.999 * (tt.k > 0)))


def test_run_piso_sst_equals_eager(rollout):
    _, (_, tc), _, (tf, tt), (tf0, tt0, tcfg, tbe) = rollout
    gf, gt = teng.run_piso_sst(tc, tf0, tt0, 3, cfg=tcfg, backend=tbe)
    for f in FIELDS:
        assert torch.equal(getattr(gf, f), getattr(tf, f)), f
    for f in TURB:
        assert torch.equal(getattr(gt, f), getattr(tt, f)), f
    same = teng.run_piso_sst_eager(tc, tf0, tt0, 0, cfg=tcfg, backend=tbe)
    assert same[0] is tf0 and same[1] is tt0


def test_piso_step_with_eddy_viscosity_matches_jax(cases):
    """piso_step's nu_t and k_turb (k_turb only with turb_wall_fn)."""
    jc, tc = cases["channel"]
    s = _state(jc, 13)
    jf0, tf0 = jcase.initial_flow(jc, 1e-3), tcase.initial_flow(tc, 1e-3)
    for wall_fn in (False, True):
        jcfg, tcfg = _cfgs(wall_fn)
        ref = jeng.piso_step(jc, jf0, cfg=jcfg,
                             backend=JMG(cycles=2, precision="f32"),
                             nu_t=jnp.asarray(s["nu_t"]),
                             k_turb=jnp.asarray(s["k"]))
        got = teng.piso_step(tc, tf0, cfg=tcfg,
                             backend=TMG(cycles=2, precision="f32"),
                             nu_t=T(s["nu_t"]), k_turb=T(s["k"]))
        # the channel's v is ~1e-5 of u and its p ~5e-3 of u^2 after one
        # step from the uniform start (the two frameworks' pressure solves
        # differ by ~5e-6 of u^2): v and phi_y are held on the scales of
        # u and phi_x, the kinematic pressure on u^2
        u_scale = float(np.abs(np.asarray(ref.u)).max())
        scales = {"v": u_scale, "p": u_scale**2,
                  "phi_y": float(np.abs(np.asarray(ref.phi_x)).max())}
        for f in FIELDS:
            close(getattr(got, f), getattr(ref, f), STEP_TOL,
                  f"wall_fn {wall_fn} {f}", scale=scales.get(f))


# ---- (k) the turbulent channel ---------------------------------------------


def test_turbulent_channel_case_matches_jax(cases):
    jc, tc = cases["channel"]
    assert tc.grid.shape == jc.grid.shape == (16, 64)
    for f in ("inlet_u", "sdf", "fluid", "open_e", "wall_len", "wall_dist"):
        assert np.array_equal(getattr(tc, f).numpy(),
                              np.asarray(getattr(jc, f))), f
    assert tbench.dean_cf(4e4) == jbench.dean_cf(4e4)


def test_channel_wall_cf_matches_jax(cases):
    jc, tc = cases["channel"]
    s = _state(jc, 17)
    p = np.cumsum(np.full(s["u"].shape, -1e-3, np.float32), axis=1)
    jf = jcase.initial_flow(jc, 1e-3).replace(
        u=jnp.asarray(s["u"]), v=jnp.asarray(s["v"]), p=jnp.asarray(p))
    tf = dataclasses.replace(tcase.initial_flow(tc, 1e-3), u=T(s["u"]),
                             v=T(s["v"]), p=T(p))
    for window in ((0.6, 0.9), (0.25, 0.75)):
        ref = jbench.channel_wall_cf(jc, jf, _jturb(s), 1.0, x_window=window)
        got = tbench.channel_wall_cf(tc, tf, _tturb(s), 1.0, x_window=window)
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= CF_TOL * max(abs(ref[k]), 1e-12), \
                (window, k, got[k], ref[k])


# ---- (j) state files -------------------------------------------------------


def test_state_files_carry_the_sst_state(cases, rollout, tmp_path):
    _, (jc, tc), (jf, jt), (tf, tt), _ = rollout
    path = str(tmp_path / "port.npz")
    tcase.save_flow(path, tf, turb=tt, extra={"x": np.arange(3)})
    back = tcase.load_turbulence(path, device="cpu")
    for f in TURB:
        assert torch.equal(getattr(back, f), getattr(tt, f)), f
    jback = jcase.load_turbulence(path)
    for f in TURB:
        assert np.array_equal(np.asarray(getattr(jback, f)),
                              getattr(tt, f).numpy()), f
    # a JAX-written state file loads into the port
    jpath = str(tmp_path / "jax.npz")
    jcase.save_flow(jpath, jf, turb=jt)
    got = tcase.load_turbulence(jpath, device="cpu")
    for f in TURB:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(jt, f))), f
    flow = tcase.load_flow(jpath, device="cpu")
    assert np.array_equal(flow.u.numpy(), np.asarray(jf.u))
    # a laminar file has none
    lam = str(tmp_path / "laminar.npz")
    tcase.save_flow(lam, tf)
    assert tcase.load_turbulence(lam, device="cpu") is None
    # the force-series restart file carries it too
    ser = tbench.ForceSeries(t=np.zeros(2), cd=np.ones(2), cl=np.ones(2),
                             n_steps=2)
    run = str(tmp_path / "run.npz")
    tbench.save_run_state(run, tf, ser, turb=tt, meta={"bench": "turb"})
    back = tcase.load_turbulence(run, device="cpu")
    assert torch.equal(back.nu_t, tt.nu_t)


# ---- (l) the turbulent step over a mesh ------------------------------------


@pytest.mark.parametrize("smoother", ["kernel", "plain"])
def test_sharded_sst_step_equals_piso_step_sst(cases, smoother):
    _, tc = cases["cylinder"]
    cfg = teng.PisoConfig(max_co=0.5, max_dt=5e-3, momentum_smoother=smoother)
    be = TMG(cycles=2, precision="f32")
    mesh = tmesh.device_mesh(4, devices=["cpu"] * 4)
    f0, t0 = tcase.initial_flow(tc, 1e-3), tturb.init_turbulence(tc)
    f1, t1 = teng.run_piso_sst_eager(tc, f0, t0, 2, cfg=cfg, backend=be)
    step = tmesh.make_sharded_sst_step(mesh, cfg=cfg, backend=be)
    sc, sf = tmesh.shard_case(mesh, tc), tmesh.shard_flow(mesh, f1)
    st_ = tmesh.shard_turbulence(mesh, t1)
    with torch.no_grad():
        got_f, got_t = step(sc, sf, st_)
        got_f = tmesh.unshard_flow(got_f)
        got_t = tmesh.unshard_turbulence(got_t)
        ref_f, ref_t = teng.piso_step_sst(tc, f1, t1, cfg=cfg, backend=be)
    for f in FIELDS:
        assert torch.equal(getattr(got_f, f), getattr(ref_f, f)), f
    for f in TURB:
        assert torch.equal(getattr(got_t, f), getattr(ref_t, f)), f
    with pytest.raises(ValueError):
        tmesh.shard_turbulence(tmesh.device_mesh(3, shape=(3, 1),
                                                 devices=["cpu"] * 3), t1)
