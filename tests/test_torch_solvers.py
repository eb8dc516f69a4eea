"""tpufoam_torch's multigrid smoothers, MGCG, CG and pressure backends
against the JAX package, on the CPU.

The JAX side runs its Pallas smoothers in interpret mode: `_INTERPRET` is
set, the jit caches are cleared around each test (a trace made before the
flag was set would silently keep XLA), and a counting wrapper around each
Pallas entry point shows that the JAX trace really entered the kernel.
The port's "kernel" smoothers run their plain versions on the CPU.

Tolerances, max |port - JAX| / max |JAX|:
- float32 cycles and solves: 1e-4 (two V-cycles chain a few hundred
  float32 stencil passes, whose rounding differs between the frameworks;
  tests/test_torch_multigrid.py holds the plain smoother to the same).
- bfloat16 correction form: 2e-2, a few bf16 ulps (2^-8 = 3.9e-3) of the
  correction, because PyTorch and XLA round the bf16 transfers at
  different places; the residual must drop alike (within 1.5x).
- MGCG to rtol 1e-6: x to 1e-4, and the same iteration count within
  one. Jacobi-preconditioned CG: x to 1e-4 (see its test for the count).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv.case import build_channel_case as jax_build
from tpufoam.fv.pressure import pressure_coeffs as jax_pressure_coeffs
from tpufoam.fv.pressure import pressure_matvec as jax_matvec
from tpufoam.ops import stencil as jst
from tpufoam.solvers import backends as jback
from tpufoam.solvers import cg as jcg
from tpufoam.solvers import multigrid as jmg
from tpufoam_torch.fv.pressure import PressureCoeffs, pressure_matvec
from tpufoam_torch.solvers import backends as tback
from tpufoam_torch.solvers import cg as tcg
from tpufoam_torch.solvers import multigrid as tmg

FIELDS = ("c_e", "c_w", "c_n", "c_s", "c_out", "diag")
JAX_NAME = {"plain": "xla", "kernel": "pallas",
            "kernel-fused": "pallas-fused"}


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


class _Case:
    """The one field of a case that the backends read."""

    def __init__(self, fluid):
        self.fluid = fluid


@pytest.fixture(scope="module", params=[(64, 256), (50, 146)],
                ids=["64x256", "odd-50x146"])
def problem(request):
    """A cut-cell channel pressure operator with a seeded rAU, right-hand
    side and initial guess."""
    ny, nx = request.param
    delta = 2.0 / ny
    geom = jax_geom("cylinder", length=nx * delta, height=2.0,
                    obstacle_size=0.5)
    case = jax_build(geom, delta=delta)
    rng = np.random.default_rng(ny + 1)
    fluid = np.asarray(case.fluid)
    rau = rng.uniform(0.5, 1.5, fluid.shape) * 1e-4 * fluid
    coef = jax_pressure_coeffs(case, jnp.asarray(rau, dtype=jnp.float32))
    b = (rng.standard_normal(fluid.shape) * fluid).astype(np.float32)
    x0 = (rng.standard_normal(fluid.shape) * fluid).astype(np.float32)
    return case, coef, b, x0


@pytest.fixture
def jax_kernels(monkeypatch):
    """Run the JAX package's Pallas smoothers in interpret mode and count
    the calls its traces make to each."""
    calls = {"jacobi_multisweep": 0, "smooth_residual": 0, "corr_smooth": 0}

    def counted(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            calls[name] += 1
            kw["interpret"] = True
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(jst, "_INTERPRET", True)
    for name in calls:
        monkeypatch.setattr(jst, f"{name}_pallas",
                            counted(name, getattr(jst, f"{name}_pallas")))
    jax.clear_caches()
    yield calls
    jax.clear_caches()


def _assert_entered(calls, smoother):
    if smoother == "kernel":
        assert calls["jacobi_multisweep"] > 0, calls
    if smoother == "kernel-fused":
        assert calls["smooth_residual"] > 0 and calls["corr_smooth"] > 0, \
            calls


def _rel_residual(matvec, coef, x, b):
    return float(np.linalg.norm(np.asarray(b) - np.asarray(matvec(coef, x)))
                 / np.linalg.norm(np.asarray(b)))


# ---- cycles and solves ----------------------------------------------------


@pytest.mark.parametrize("cycle_type", ["v", "w"])
@pytest.mark.parametrize("smoother", ["kernel", "kernel-fused"])
def test_cycle_with_kernel_smoothers(problem, jax_kernels, smoother,
                                     cycle_type):
    _, coef, b, x0 = problem
    jl = jmg.build_hierarchy(coef)
    ref = jax.jit(functools.partial(
        jmg.v_cycle, smoother=JAX_NAME[smoother], cycle_type=cycle_type))(
            jl, jnp.asarray(b), jnp.asarray(x0))
    _assert_entered(jax_kernels, smoother)
    before = tmg.v_cycle.cycles
    got = tmg.v_cycle(tmg.build_hierarchy(to_torch(coef)), T(b), T(x0),
                      smoother=smoother, cycle_type=cycle_type)
    assert tmg.v_cycle.cycles == before + 1
    close(got, ref, 1e-4)


def test_w_cycle_plain_matches_jax(problem):
    _, coef, b, x0 = problem
    ref = jax.jit(functools.partial(jmg.v_cycle, cycle_type="w"))(
        jmg.build_hierarchy(coef), jnp.asarray(b), jnp.asarray(x0))
    got = tmg.v_cycle(tmg.build_hierarchy(to_torch(coef)), T(b), T(x0),
                      cycle_type="w")
    close(got, ref, 1e-4)


def test_kernel_smoothers_count_their_launch_sites(problem):
    """On the CPU the wrappers count nothing; the cycle counter does."""
    _, coef, b, x0 = problem
    levels = tmg.build_hierarchy(to_torch(coef))
    before = tmg.v_cycle.cycles
    tmg.mg_solve(to_torch(coef), T(b), T(x0), cycles=3,
                 smoother="kernel-fused")
    assert tmg.v_cycle.cycles == before + 3
    with pytest.raises(ValueError, match="smoother"):
        tmg.v_cycle(levels, T(b), T(x0), smoother="pallas")


@pytest.mark.parametrize("smoother", ["kernel", "kernel-fused"])
def test_mg_solve_bf16_with_kernel_smoothers(problem, jax_kernels,
                                             smoother):
    _, coef, b, x0 = problem
    ref = jmg.mg_solve(coef, jnp.asarray(b), jnp.asarray(x0), cycles=2,
                       dtype=jnp.bfloat16, smoother=JAX_NAME[smoother])
    _assert_entered(jax_kernels, smoother)
    tcoef = to_torch(coef)
    got = tmg.mg_solve(tcoef, T(b), T(x0), cycles=2, dtype=torch.bfloat16,
                       smoother=smoother)
    assert got.dtype == torch.float32
    close(got, ref, 2e-2)
    r_ref = _rel_residual(jax_matvec, coef, ref, b)
    r_got = _rel_residual(pressure_matvec, tcoef, got, T(b))
    assert r_got <= 1.5 * r_ref + 1e-3, (r_got, r_ref)


def test_mg_solve_f32_kernel_fused(problem, jax_kernels):
    _, coef, b, x0 = problem
    ref = jmg.mg_solve(coef, jnp.asarray(b), jnp.asarray(x0), cycles=2,
                       smoother="pallas-fused")
    _assert_entered(jax_kernels, "kernel-fused")
    got = tmg.mg_solve(to_torch(coef), T(b), T(x0), cycles=2,
                       smoother="kernel-fused")
    close(got, ref, 1e-4)


@pytest.mark.parametrize("smoother", ["plain", "kernel"])
def test_mgcg_pressure_matches_jax(problem, jax_kernels, smoother):
    _, coef, b, x0 = problem
    ref = jmg.mgcg_pressure(coef, jnp.asarray(b), x0=jnp.asarray(x0),
                            rtol=1e-6, maxiter=60,
                            smoother=JAX_NAME[smoother])
    _assert_entered(jax_kernels, smoother)
    before = tmg.v_cycle.cycles
    got = tmg.mgcg_pressure(to_torch(coef), T(b), x0=T(x0), rtol=1e-6,
                            maxiter=60, smoother=smoother)
    assert abs(got.iters - int(ref.iters)) <= 1, (got.iters, ref.iters)
    assert tmg.v_cycle.cycles == before + got.iters + 1
    assert float(got.residual) <= 1e-6
    close(got.x, ref.x, 1e-4)


def test_mgcg_w_cycle_and_maxiter(problem):
    _, coef, b, x0 = problem
    ref = jmg.mgcg_pressure(coef, jnp.asarray(b), x0=jnp.asarray(x0),
                            maxiter=3, pre=2, post=2, cycle_type="w")
    got = tmg.mgcg_pressure(to_torch(coef), T(b), x0=T(x0), maxiter=3,
                            pre=2, post=2, cycle_type="w")
    assert got.iters == int(ref.iters) == 3
    close(got.x, ref.x, 1e-4)
    close(got.residual, ref.residual, 1e-3)


def test_pcg_pressure_matches_jax(problem):
    """Capped at 25 iterations the two loops agree step for step. Run to
    rtol 1e-6, Jacobi-preconditioned CG takes hundreds of iterations here,
    and float32 rounding moves its count between the frameworks (measured
    685 against 939): the converged x and the residual are compared."""
    _, coef, b, x0 = problem
    tcoef = to_torch(coef)
    ref = jcg.pcg_pressure(coef, jnp.asarray(b), x0=jnp.asarray(x0),
                           maxiter=25)
    got = tcg.pcg_pressure(tcoef, T(b), x0=T(x0), maxiter=25)
    assert got.iters == int(ref.iters) == 25
    close(got.x, ref.x, 1e-4)
    ref = jcg.pcg_pressure(coef, jnp.asarray(b), x0=jnp.asarray(x0),
                           rtol=1e-6, maxiter=2000)
    got = tcg.pcg_pressure(tcoef, T(b), x0=T(x0), rtol=1e-6, maxiter=2000)
    assert got.iters < 2000 and float(got.residual) <= 1e-6
    close(got.x, ref.x, 1e-4)


def test_pcg_fixed_iters_matches_jax(problem):
    _, coef, b, x0 = problem
    ref = jcg.pcg_fixed_iters(coef, jnp.asarray(b), jnp.asarray(x0),
                              iters=6)
    got = tcg.pcg_fixed_iters(to_torch(coef), T(b), T(x0), iters=6)
    assert got.iters == 6
    close(got.x, ref.x, 1e-4)
    close(got.residual, ref.residual, 1e-3)
    close(tcg.diag_precond(to_torch(coef)), jcg.diag_precond(coef), 1e-6)


# ---- backends ---------------------------------------------------------------


def _both(problem, jbe, tbe, rtol):
    case, coef, b, x0 = problem
    jp = jbe(case, coef, jnp.asarray(b), jnp.asarray(x0), {})
    tcase = _Case(T(case.fluid))
    tp = tbe(tcase, to_torch(coef), T(b), T(x0), {})
    close(tp, jp, rtol)
    assert float(tp[tcase.fluid == 0].abs().max()) == 0.0
    return tp


def test_cg_backend(problem):
    _both(problem, jback.CGBackend(), tback.CGBackend(), 1e-4)


@pytest.mark.parametrize("smoother", ["plain", "kernel", "kernel-fused"])
def test_mg_backend_smoothers(problem, jax_kernels, smoother):
    _both(problem, jback.MGBackend(cycles=2, precision="bf16",
                                   smoother=JAX_NAME[smoother]),
          tback.MGBackend(cycles=2, precision="bf16", smoother=smoother),
          2e-2)
    _assert_entered(jax_kernels, smoother)


@pytest.mark.parametrize("cycle_type", ["v", "w"])
def test_mgcg_backend(problem, jax_kernels, cycle_type):
    _both(problem, jback.MGCGBackend(smoother="pallas",
                                     cycle_type=cycle_type),
          tback.MGCGBackend(smoother="kernel", cycle_type=cycle_type), 1e-4)
    _assert_entered(jax_kernels, "kernel")


def test_mgcg_backend_refuses_an_asymmetric_cycle(problem):
    case, coef, b, x0 = problem
    for be in (jback.MGCGBackend(pre=2), tback.MGCGBackend(pre=2)):
        with pytest.raises(ValueError, match="asymmetric"):
            conv = (jnp.asarray if isinstance(be, jback.MGCGBackend)
                    else T)
            be(_Case(conv(case.fluid)),
               coef if conv is jnp.asarray else to_torch(coef),
               conv(b), conv(x0), {})


@pytest.mark.parametrize("tau", [0.0, 1e9], ids=["escalates", "keeps"])
def test_auto_backend_branches(problem, tau, monkeypatch):
    escalations = []
    real = tback.mgcg_pressure

    def counted(*a, **kw):
        escalations.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tback, "mgcg_pressure", counted)
    # the kept branch returns the bf16 polish itself (2e-2); the escalated
    # branch polishes it further in f32 MGCG
    _both(problem, jback.AutoBackend(tau=tau), tback.AutoBackend(tau=tau),
          2e-2)
    assert len(escalations) == (1 if tau == 0.0 else 0)


def test_auto_backend_escalates_on_a_non_finite_residual(problem,
                                                         monkeypatch):
    case, coef, b, _ = problem
    escalations = []
    real = tback.mgcg_pressure

    def counted(*a, **kw):
        escalations.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tback, "mgcg_pressure", counted)
    prev = np.full_like(b, np.nan)
    tback.AutoBackend(tau=1e9)(_Case(T(case.fluid)), to_torch(coef), T(b),
                               T(prev), {})
    assert len(escalations) == 1


def _predictor(problem, conv):
    """A stand-in surrogate, the same function in both frameworks."""
    case, _, _, _ = problem
    y = np.linspace(0.0, 1.0, case.fluid.shape[0], dtype=np.float32)
    guess = conv(np.outer(y, np.ones(case.fluid.shape[1], np.float32)))

    def predict(case, p_prev, aux):
        return 0.5 * p_prev + guess
    return predict


def test_surrogate_backend(problem):
    _both(problem, jback.SurrogateBackend(_predictor(problem, jnp.asarray)),
          tback.SurrogateBackend(_predictor(problem, T)), 1e-6)


def test_hybrid_backend(problem):
    _both(problem, jback.HybridBackend(_predictor(problem, jnp.asarray)),
          tback.HybridBackend(_predictor(problem, T)), 1e-4)
