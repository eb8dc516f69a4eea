"""tpufoam_torch case building and finite-volume assembly against the JAX
package, on the CPU.

The same numpy inputs go through both; results are compared in float32 at
1e-5 relative to the reference's max magnitude (both sides run the same
float32 operations in the same order; only the summation and fused
multiply-add choices of the two frameworks differ). Masks built on the
host must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.fv import momentum as jmom
from tpufoam.fv import operators as jops
from tpufoam.fv import pressure as jpres
from tpufoam.piso import engine as jeng
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.core.sdf import sdf_min_distance
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv import momentum as tmom
from tpufoam_torch.fv import operators as tops
from tpufoam_torch.fv import pressure as tpres
from tpufoam_torch.piso import engine as teng

RTOL = 1e-5
NY, NX = 64, 256
MASKS = ("fluid", "open_e", "open_w", "open_n", "open_s", "wall_e",
         "wall_w", "wall_n", "wall_s", "inlet_w", "outlet_e", "alpha",
         "wall_ax", "wall_ay", "wall_len", "wall_dist", "inlet_u")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def close(got, ref, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"max err {err:.3e} > {rtol:g} * {scale:.3e}"


def T(a):
    return torch.as_tensor(np.array(a))


J = jnp.asarray


def _geom_kw(shape="cylinder"):
    delta = 2.0 / NY
    return delta, dict(shape_name=shape, length=NX * delta, height=2.0,
                       obstacle_size=0.5, nu=8e-3)


@pytest.fixture(scope="module")
def cases():
    delta, kw = _geom_kw()
    jc = jcase.build_channel_case(jax_geom(**kw), delta=delta)
    tc = tcase.build_channel_case(channel_case_geometry(**kw), delta=delta,
                                  device="cpu")
    return jc, tc


@pytest.fixture(scope="module")
def state(cases):
    """A developed-looking flow: the initial flow plus seeded noise, with
    fluxes from the noisy velocity."""
    jc, tc = cases
    rng = np.random.default_rng(5)
    f0 = jcase.initial_flow(jc, dt0=5e-4)
    fl = np.asarray(jc.fluid)
    u = (np.asarray(f0.u) + 0.1 * rng.standard_normal(fl.shape)) * fl
    v = 0.1 * rng.standard_normal(fl.shape) * fl
    p = rng.standard_normal(fl.shape) * fl
    u, v, p = (a.astype(np.float32) for a in (u, v, p))
    phi_x, phi_y = jcase.fluxes_from_velocity(jc, jnp.asarray(u),
                                              jnp.asarray(v))
    return dict(u=u, v=v, p=p, phi_x=np.asarray(phi_x),
                phi_y=np.asarray(phi_y), dt=np.float32(6e-4))


@pytest.mark.parametrize("shape", ["cylinder", "rectangle", "triangle"])
@pytest.mark.parametrize("boundary", ["cutcell", "blank"])
def test_build_channel_case_masks_match_exactly(shape, boundary):
    delta, kw = _geom_kw(shape)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=delta,
                                  boundary=boundary)
    tc = tcase.build_channel_case(channel_case_geometry(**kw), delta=delta,
                                  boundary=boundary, device="cpu")
    assert tc.grid.shape == jc.grid.shape and tc.cut == jc.cut
    for name in MASKS:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    # the SDF is a float32 |x|^2 + |p|^2 - 2 x.p min-distance on both
    # sides; its rounding error grows like eps * |x|^2 / d near a wall
    np.testing.assert_allclose(tc.sdf.numpy(), np.asarray(jc.sdf), atol=1e-4)


def test_sealed_channel_is_rejected():
    kw = dict(length=4.0, height=1.0, obstacle_size=1.2)
    with pytest.raises(ValueError, match="ill-posed"):
        tcase.build_channel_case(channel_case_geometry("rectangle", **kw),
                                 delta=1.0 / 32, device="cpu")


def test_sdf_min_distance_chunks_match_brute_force():
    """A chunk size that does not divide the query count. The expansion
    |x|^2 + |p|^2 - 2 x.p rounds at float32 eps * (|x|^2 + |p|^2), so the
    squared distances are held to a few of those."""
    rng = np.random.default_rng(1)
    q = rng.uniform(0, 4, (1000, 2)).astype(np.float32)
    b = rng.uniform(0, 4, (37, 2)).astype(np.float32)
    ref2 = ((q[:, None, :].astype(np.float64) - b[None]) ** 2).sum(-1).min(1)
    got = sdf_min_distance(T(q), T(b), chunk=64).numpy()
    scale = (q**2).sum(1).max() + (b**2).sum(1).max()
    np.testing.assert_allclose(got.astype(np.float64) ** 2, ref2,
                               atol=8 * 2.0**-24 * scale)


def test_initial_flow_matches(cases):
    jc, tc = cases
    jf = jcase.initial_flow(jc, dt0=5e-4)
    tf = tcase.initial_flow(tc, dt0=5e-4)
    for name in ("u", "v", "p", "phi_x", "phi_y", "dt", "t", "u_prev"):
        close(getattr(tf, name), getattr(jf, name))


@pytest.mark.parametrize("name", ["nb_e", "nb_w", "nb_n", "nb_s"])
def test_neighbour_shifts_pad_with_zeros(name):
    x = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    got = getattr(tops, name)(T(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(jops, name)(x)))


def test_divergence_and_fluxes(cases, state):
    jc, tc = cases
    u, v = state["u"], state["v"]
    tpx, tpy = tcase.fluxes_from_velocity(tc, T(u), T(v))
    close(tpx, state["phi_x"])
    close(tpy, state["phi_y"])
    close(tops.divergence(T(state["phi_x"]), T(state["phi_y"])),
          jops.divergence(state["phi_x"], state["phi_y"]))


def test_pressure_assembly(cases, state):
    jc, tc = cases
    rng = np.random.default_rng(9)
    rau = (rng.uniform(0.5, 1.5, state["u"].shape) * 1e-4
           * np.asarray(jc.fluid)).astype(np.float32)
    jco = jpres.pressure_coeffs(jc, jnp.asarray(rau))
    tco = tpres.pressure_coeffs(tc, T(rau))
    for f in ("c_e", "c_w", "c_n", "c_s", "c_out", "diag"):
        close(getattr(tco, f), getattr(jco, f))
    p, px, py = state["p"], state["phi_x"], state["phi_y"]
    close(tpres.pressure_matvec(tco, T(p)), jpres.pressure_matvec(jco, J(p)))
    close(tpres.pressure_rhs(tc, T(px), T(py)),
          jpres.pressure_rhs(jc, J(px), J(py)))
    for got, ref in zip(tpres.correct_fluxes(tc, tco, T(p), T(px), T(py)),
                        jpres.correct_fluxes(jc, jco, J(p), J(px), J(py))):
        close(got, ref)
    for got, ref in zip(tpres.pressure_gradient(tc, T(p)),
                        jpres.pressure_gradient(jc, J(p))):
        close(got, ref)


@pytest.fixture(scope="module")
def mom(cases, state):
    jc, tc = cases
    s = state
    jco = jmom.momentum_coeffs(jc, s["phi_x"], s["phi_y"], s["u"], s["v"],
                               jnp.float32(s["dt"]),
                               convection="limitedLinear")
    tco = tmom.momentum_coeffs(tc, T(s["phi_x"]), T(s["phi_y"]), T(s["u"]),
                               T(s["v"]), torch.tensor(s["dt"]),
                               convection="limitedLinear")
    return jco, tco


@pytest.mark.parametrize("field", ["a_e", "a_w", "a_n", "a_s", "a_p",
                                   "b_u", "b_v"])
def test_momentum_coeffs_limited_linear_euler(mom, field):
    jco, tco = mom
    close(getattr(tco, field), getattr(jco, field))


def test_h_operator(mom, state):
    jco, tco = mom
    for got, ref in zip(tmom.h_operator(tco, T(state["u"]), T(state["v"])),
                        jmom.h_operator(jco, state["u"], state["v"])):
        close(got, ref)


@pytest.mark.parametrize("smoother", ["plain", "kernel"])
def test_jacobi_momentum(cases, mom, state, smoother):
    """Both smoothers on a CPU tensor against the JAX sweep loop (the
    'kernel' smoother runs the kernel's plain version on the CPU)."""
    jc, tc = cases
    jco, tco = mom
    rng = np.random.default_rng(4)
    src_u, src_v = (rng.standard_normal(state["u"].shape).astype(np.float32)
                    * 1e-4 for _ in range(2))
    ref = jmom.jacobi_momentum(jco, jc, state["u"], state["v"], src_u, src_v,
                               sweeps=8)
    got = tmom.jacobi_momentum(tco, tc, T(state["u"]), T(state["v"]),
                               T(src_u), T(src_v), sweeps=8,
                               smoother=smoother)
    for g, r in zip(got, ref):
        close(g, r)


def test_courant_continuity_next_dt(cases, state):
    jc, tc = cases
    s = state
    jf = jcase.Flow(u=s["u"], v=s["v"], p=s["p"], phi_x=s["phi_x"],
                    phi_y=s["phi_y"], dt=jnp.float32(s["dt"]),
                    t=jnp.float32(0.0), u_prev=s["u"], v_prev=s["v"],
                    p_prev=s["p"])
    tf = tcase.Flow(**{k: T(getattr(jf, k)) for k in
                       ("u", "v", "p", "phi_x", "phi_y", "dt", "t",
                        "u_prev", "v_prev", "p_prev")})
    close(teng.courant_number(tc, tf), jeng.courant_number(jc, jf))
    close(teng.continuity_error(tc, tf), jeng.continuity_error(jc, jf))
    jcfg = jeng.PisoConfig(max_co=0.5, max_dt=2e-3)
    tcfg = teng.PisoConfig(max_co=0.5, max_dt=2e-3)
    close(teng._next_dt(tc, tf, tcfg), jeng._next_dt(jc, jf, jcfg))


def test_binary_masks_from_fluid():
    from tpufoam.core.grid import make_grid as jax_make_grid
    from tpufoam.fv.cutcell import binary_masks_from_fluid as jax_bmf
    from tpufoam_torch.core.grid import make_grid
    from tpufoam_torch.fv.cutcell import binary_masks_from_fluid
    fluid = (np.random.default_rng(3).uniform(size=(24, 40)) > 0.2) \
        .astype(np.float32)
    ref = jax_bmf(jax_make_grid(0, 2.0, 0, 1.2, 0.05), fluid)
    got = binary_masks_from_fluid(make_grid(0, 2.0, 0, 1.2, 0.05), fluid)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], k)
