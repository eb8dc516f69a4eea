"""Reverse mode through the PISO step on the CPU: the gradient of
`piso.engine.run_piso` and `piso.batched.run_piso_batched` against
jax.grad of the JAX package's `run_piso` (its lax.scan, "the form for
AD") and `run_piso_batched` (a vmapped scan), and the fleet's gradient
against its cases stepped alone. Every pressure matvec goes through
`ops.stencil.StencilMatvec` (its plain forward and backward on the CPU);
the momentum smoother is the plain one (JAX's "xla") and the pressure
backend MGBackend(cycles=2), the configurations JAX differentiates. The
loss is tests/test_differentiable.py's: the sum of u^2 over the
downstream half after the steps, as a function of the inlet profile.

Tolerances, the relative L2 norm of port - JAX over the gradient:
- tests/test_differentiable.py's case (an empty 2 x 1 channel at delta
  1/16, one corrector, fixed dt, two momentum sweeps), 3 steps, float32
  multigrid: 1e-5 with upwind convection (measured 2.9e-6). With its
  limitedLinear convection 1e-2: the limiter's clip has kinks that the
  start's uniform flow sits on, so a rounding of the forward moves the
  gradient (JAX's own scan and its loop of jitted steps differ by 1.3e-3
  there; the port measured 3.1e-3 against the scan).
- bench.py's cylinder and PisoConfig at 64 x 256, 2 steps: float32
  multigrid 2e-4 (measured 3.3e-5), the bf16 correction form 2e-2
  (measured 4.2e-3: both sides round the correction to bfloat16, at
  other places).
- the fleet (three geometries at delta 1/24, bench.py's PisoConfig, 2
  steps, float32 multigrid) against JAX's vmapped fleet: 1e-4 per case
  (measured 1.7e-6: no limiter kink binds on these starts); against its
  cases alone: bit for bit (each case's arithmetic is its own).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core.geometry import ChannelCase as JChannelCase
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.piso import batched as jbat
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam_torch.core.geometry import ChannelCase, channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.ops import stencil as st
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend as TMG

DIFF_TOL = {"upwind": 1e-5, "limitedLinear": 1e-2}
BENCH_TOL = {"f32": 2e-4, "bf16": 2e-2}
FLEET = [("cylinder", 0.3), ("rectangle", 0.25), ("triangle", 0.3)]
FLEET_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel_l2(got, ref):
    got, ref = np.float64(got), np.float64(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _downstream_ke(u, nx):
    return (u[..., nx // 2:] ** 2).sum()


def _jax_grad(case, flow0, n, cfg, backend, run=jeng.run_piso):
    def loss(inlet_u):
        f = run(dataclasses.replace(case, inlet_u=inlet_u), flow0, n,
                cfg=cfg, backend=backend)
        return _downstream_ke(f.u, case.grid.nx)

    return np.asarray(jax.grad(loss)(case.inlet_u))


def _port_grad(case, flow0, n, cfg, backend, run=teng.run_piso):
    def loss(inlet_u):
        f = run(dataclasses.replace(case, inlet_u=inlet_u), flow0, n,
                cfg=cfg, backend=backend)
        return _downstream_ke(f.u, case.grid.nx)

    x = case.inlet_u.clone().requires_grad_(True)
    g, = torch.autograd.grad(loss(x), x)
    return g


@pytest.mark.parametrize("convection", list(DIFF_TOL))
def test_run_piso_gradient_matches_jax(convection):
    """tests/test_differentiable.py's case and loss, 3 steps: the port's
    gradient against jax.grad of JAX's run_piso; finite, nonzero, and
    positive at the centre row (a faster inlet carries more energy
    downstream), as that test asks of JAX's."""
    kw = dict(length=2.0, height=1.0, shape=None, nu=0.05)
    jc = jcase.build_channel_case(JChannelCase(**kw), delta=1.0 / 16)
    tc = tcase.build_channel_case(ChannelCase(**kw), delta=1.0 / 16,
                                  device="cpu")
    opts = dict(n_correctors=1, adjust_dt=False, momentum_sweeps=2,
                convection=convection)
    ref = _jax_grad(jc, jcase.initial_flow(jc, dt0=5e-3), 3,
                    jeng.PisoConfig(**opts), JMG(cycles=2))
    before = st.stencil_matvec_grad.launches
    got = _port_grad(tc, tcase.initial_flow(tc, dt0=5e-3), 3,
                     teng.PisoConfig(**opts), TMG(cycles=2))
    assert st.stencil_matvec_grad.launches == before   # the CPU's plain
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0
    assert float(got[tc.grid.ny // 2]) > 0.0
    assert _rel_l2(got.numpy(), ref) <= DIFF_TOL[convection]


@pytest.mark.parametrize("precision", list(BENCH_TOL))
def test_run_piso_gradient_on_the_bench_configuration(precision):
    """bench.py's main path in the configuration JAX differentiates (its
    cylinder and PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3),
    the plain momentum smoother, MGBackend(cycles=2, precision), no
    surrogate) at 64 x 256, 2 steps, adaptive dt: against jax.grad."""
    ny = 64
    kw = dict(shape_name="cylinder", length=4 * ny * 2.0 / ny, height=2.0,
              obstacle_size=0.5, nu=8e-3)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=2.0 / ny)
    tc = tcase.build_channel_case(channel_case_geometry(**kw),
                                  delta=2.0 / ny, device="cpu")
    opts = dict(n_correctors=2, max_co=0.5, max_dt=2e-3)
    ref = _jax_grad(jc, jcase.initial_flow(jc, dt0=5e-4), 2,
                    jeng.PisoConfig(**opts),
                    JMG(cycles=2, precision=precision))
    got = _port_grad(tc, tcase.initial_flow(tc, dt0=5e-4), 2,
                     teng.PisoConfig(**opts),
                     TMG(cycles=2, precision=precision))
    assert bool(torch.isfinite(got).all())
    assert float(got[ny // 2]) > 0.0
    assert _rel_l2(got.numpy(), ref) <= BENCH_TOL[precision]


def _fleet():
    """(JAX cases, port cases), three geometries at delta 1/24."""
    jc, tc = [], []
    for shape, size in FLEET:
        kw = dict(shape_name=shape, length=3.0, height=1.0,
                  obstacle_size=size)
        jc.append(jcase.build_channel_case(jax_geom(**kw), delta=1.0 / 24))
        tc.append(tcase.build_channel_case(channel_case_geometry(**kw),
                                           delta=1.0 / 24, device="cpu"))
    return jc, tc


FLEET_CFG = dict(n_correctors=2, max_co=0.5, max_dt=2e-3)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_run_piso_batched_gradient_equals_the_cases_alone(precision):
    """The gradient of the fleet's summed loss through run_piso_batched,
    one stacked launch a matvec, equals each case's gradient through
    run_piso alone, bit for bit."""
    _, tc = _fleet()
    cfg = teng.PisoConfig(**FLEET_CFG)
    be = TMG(cycles=2, precision=precision)
    flows = [tcase.initial_flow(c, dt0=5e-4) for c in tc]
    got = _port_grad(tbat.stack_cases(tc), tbat.stack_flows(flows), 2, cfg,
                     be, run=tbat.run_piso_batched)
    for k, (c, f) in enumerate(zip(tc, flows)):
        assert torch.equal(got[k], _port_grad(c, f, 2, cfg, be)), k


def test_run_piso_batched_gradient_matches_jax():
    """The fleet's gradient against jax.grad of JAX's run_piso_batched
    (the vmapped scan) with MGBackend(cycles=2), float32."""
    jc, tc = _fleet()
    jf = [jcase.initial_flow(c, dt0=5e-4) for c in jc]
    tf = [tcase.initial_flow(c, dt0=5e-4) for c in tc]
    ref = _jax_grad(jbat.stack_cases(jc), jbat.stack_flows(jf), 2,
                    jeng.PisoConfig(**FLEET_CFG), JMG(cycles=2),
                    run=jbat.run_piso_batched)
    got = _port_grad(tbat.stack_cases(tc), tbat.stack_flows(tf), 2,
                     teng.PisoConfig(**FLEET_CFG), TMG(cycles=2),
                     run=tbat.run_piso_batched)
    assert got.shape == (3, tc[0].grid.ny)
    for k in range(3):
        assert _rel_l2(got[k].numpy(), ref[k]) <= FLEET_TOL, k
