"""tpufoam_torch geometric multigrid against the JAX package, on the CPU.

Transfers and coarsening are held at 1e-5 relative (float32, the same
operations). Whole solves in float32 are held at 1e-4 relative to max |x|:
two V-cycles with 40 coarse sweeps each chain a few hundred float32
stencil passes, whose rounding differs between the frameworks. The bf16
correction form is held against JAX's bf16 path at 2e-2 relative: each
side rounds its bf16 intermediates at different places (PyTorch after
every operation, XLA after each fused group), so the two corrections
differ by a few bf16 ulps (2^-8 = 3.9e-3); both must reduce the residual
alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv.case import build_channel_case as jax_build
from tpufoam.fv.pressure import pressure_coeffs as jax_pressure_coeffs
from tpufoam.fv.pressure import pressure_matvec as jax_matvec
from tpufoam.solvers import backends as jback
from tpufoam.solvers import multigrid as jmg
from tpufoam_torch.fv.pressure import PressureCoeffs, pressure_matvec
from tpufoam_torch.solvers import backends as tback
from tpufoam_torch.solvers import multigrid as tmg

FIELDS = ("c_e", "c_w", "c_n", "c_s", "c_out", "diag")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, ref, rtol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, dtype=np.float32)
    err = float(np.abs(got - ref).max())
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert err <= rtol * scale, f"max err {err:.3e} > {rtol:g} * {scale:.3e}"


def to_torch(coef) -> PressureCoeffs:
    return PressureCoeffs(*(T(getattr(coef, f)) for f in FIELDS))


@pytest.fixture(scope="module", params=[(64, 256), (50, 146)],
            ids=["64x256", "odd-50x146"])
def problem(request):
    """A cut-cell channel pressure operator (even and odd sizes) with a
    seeded rAU, right-hand side and initial guess."""
    ny, nx = request.param
    delta = 2.0 / ny
    geom = jax_geom("cylinder", length=nx * delta, height=2.0,
                    obstacle_size=0.5)
    case = jax_build(geom, delta=delta)
    rng = np.random.default_rng(ny)
    fluid = np.asarray(case.fluid)
    rau = (rng.uniform(0.5, 1.5, fluid.shape) * 1e-4 * fluid)
    coef = jax_pressure_coeffs(case, jnp.asarray(rau, dtype=jnp.float32))
    b = (rng.standard_normal(fluid.shape) * fluid).astype(np.float32)
    x0 = (rng.standard_normal(fluid.shape) * fluid).astype(np.float32)
    return case, coef, b, x0


def test_hierarchy_coarsens_like_jax(problem):
    _, coef, _, _ = problem
    jl = jmg.build_hierarchy(coef)
    tl = tmg.build_hierarchy(to_torch(coef))
    assert [c.diag.shape for c in jl] == [tuple(c.diag.shape) for c in tl]
    for jc, tc in zip(jl, tl):
        for f in FIELDS:
            close(getattr(tc, f), getattr(jc, f), 1e-5)


@pytest.mark.parametrize("shape", [(16, 32), (15, 33), (9, 8)])
def test_restrict_and_prolong(shape):
    rng = np.random.default_rng(shape[0])
    r = rng.standard_normal(shape).astype(np.float32)
    close(tmg.restrict(T(r)), jmg.restrict(jnp.asarray(r)), 1e-6)
    e = rng.standard_normal(shape).astype(np.float32)
    close(tmg.prolong(T(e)), jmg.prolong(jnp.asarray(e)), 1e-6)


def test_restrict_is_the_adjoint_of_prolong():
    rng = np.random.default_rng(0)
    r = torch.as_tensor(rng.standard_normal((14, 22)), dtype=torch.float64)
    e = torch.as_tensor(rng.standard_normal((7, 11)), dtype=torch.float64)
    lhs = (tmg.restrict(r) * e).sum()
    rhs = (r * tmg.prolong(e)).sum()
    torch.testing.assert_close(lhs, rhs)


def test_jacobi_smooth_and_v_cycle(problem):
    _, coef, b, x0 = problem
    tcoef = to_torch(coef)
    close(tmg.jacobi_smooth(tcoef, T(x0), T(b), 6),
          jmg.jacobi_smooth(coef, jnp.asarray(x0), jnp.asarray(b), 6), 1e-5)
    jl = jmg.build_hierarchy(coef)
    tl = tmg.build_hierarchy(tcoef)
    close(tmg.v_cycle(tl, T(b), T(x0)),
          jax.jit(jmg.v_cycle)(jl, jnp.asarray(b), jnp.asarray(x0)), 1e-4)


def _rel_residual(matvec, coef, x, b):
    return float(np.linalg.norm(np.asarray(b) - np.asarray(matvec(coef, x)))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("rtol", [0.0, 0.3])
def test_mg_solve_f32(problem, rtol):
    _, coef, b, x0 = problem
    ref = jmg.mg_solve(coef, jnp.asarray(b), jnp.asarray(x0), cycles=2,
                       rtol=rtol)
    got = tmg.mg_solve(to_torch(coef), T(b), T(x0), cycles=2, rtol=rtol)
    close(got, ref, 1e-4)


def test_mg_solve_bf16_against_jax_bf16(problem):
    _, coef, b, x0 = problem
    ref = jmg.mg_solve(coef, jnp.asarray(b), jnp.asarray(x0), cycles=2,
                       dtype=jnp.bfloat16)
    tcoef = to_torch(coef)
    got = tmg.mg_solve(tcoef, T(b), T(x0), cycles=2, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    close(got, ref, 2e-2)
    r_ref = _rel_residual(jax_matvec, coef, ref, b)
    r_got = _rel_residual(pressure_matvec, tcoef, got, T(b))
    assert r_got <= 1.5 * r_ref + 1e-3, (r_got, r_ref)


def test_mg_backend_matches_and_masks_solids(problem):
    case, coef, b, x0 = problem
    jp = jback.MGBackend(cycles=2, precision="bf16")(
        case, coef, jnp.asarray(b), jnp.asarray(x0), {})

    class _Case:
        fluid = T(case.fluid)

    tp = tback.MGBackend(cycles=2, precision="bf16")(
        _Case, to_torch(coef), T(b), T(x0), {})
    close(tp, jp, 2e-2)
    assert float(tp[_Case.fluid == 0].abs().max()) == 0.0


def test_mg_backend_clamps_unsafe_cycles(problem):
    case, coef, b, x0 = problem

    class _Case:
        fluid = T(case.fluid)

    with pytest.warns(UserWarning, match="clamping"):
        tback.MGBackend(cycles=1, pre=1, post=1)(_Case, to_torch(coef),
                                                 T(b), T(x0), {})
