"""The pressure multisweep kernels' case axis (ops.stencil
`jacobi_multisweep`, `smooth_residual`, `corr_smooth` on (B, ny, nx)) and
the fleet that runs the kernel smoothers, on the CPU.

- The wrappers on a stack against the same wrappers case by case (on the
  CPU both run the plain versions): bit for bit, odd widths included
  (elementwise arithmetic, per cell).
- The launch geometry of a stack is each case's, its cases along z, and
  `kernel_available_for` takes a stack as its cases.
- The fleet (`run_piso_batched_eager`, MGBackend(cycles=2) with
  "kernel-fused" and with "kernel") against the JAX package's vmapped
  fleet with "pallas-fused" and "pallas", its Pallas kernels in interpret
  mode under vmap (their batching rule): max |port - JAX| / max |JAX| per
  field within 1e-3, as tests/test_torch_batched.py's hybrid fleet (the
  momentum kernel and the multigrid in float32 on two frameworks,
  2 steps); and the port's fleet against its cases stepped alone with
  the same smoother: bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.piso import batched as jbat
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv.pressure import PressureCoeffs
from tpufoam_torch.ops import stencil as ts
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend
# the JAX Pallas smoothers in interpret mode (under vmap, their batching
# rule), with a count of the calls its traces make
from test_torch_solvers import jax_kernels  # noqa: F401

FIELDS = ("u", "v", "p", "phi_x", "phi_y", "dt", "t")
GEOMS = [("cylinder", 0.3), ("triangle", 0.3)]
DELTA = 1.0 / 32                    # 32 x 96: kernel levels 32x96, 16x48
SHAPES = [(24, 64), (40, 129), (43, 8)]
SMOOTHERS = {"kernel-fused": "pallas-fused", "kernel": "pallas"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _stack(b, ny, nx, dtype, seed):
    """B cases of random operators (conductances pointing out of the
    domain zero, diag above their sum), x, b and a correction."""
    rng = np.random.default_rng(seed)

    def f(scale=1.0):
        return rng.random((b, ny, nx)).astype(np.float32) * scale

    ce, cw, cn, cs = f(), f(), f(), f()
    ce[..., -1] = 0
    cw[..., 0] = 0
    cn[..., -1, :] = 0
    cs[..., 0, :] = 0
    diag = ce + cw + cn + cs + 0.5 + f(0.5)

    def t(a):
        return torch.as_tensor(a).to(dtype).contiguous()

    coef = PressureCoeffs(c_e=t(ce), c_w=t(cw), c_n=t(cn), c_s=t(cs),
                          c_out=t(np.zeros_like(ce)), diag=t(diag))
    return coef, t(f() - 0.5), t(f() - 0.5), t(0.1 * (f() - 0.5))


def _case(coef, k):
    return PressureCoeffs(*(getattr(coef, fl.name)[k].contiguous()
                            for fl in dataclasses.fields(coef)))


def _calls(coef, x, b, corr, iters):
    return {"jacobi_multisweep": ts.jacobi_multisweep(coef, x, b, iters),
            "smooth_residual": ts.smooth_residual(coef, x, b, iters),
            "corr_smooth": ts.corr_smooth(coef, x, corr, b, iters)}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_stacked_calls_equal_the_cases_alone(shape, dtype):
    coef, x, b, corr = _stack(3, *shape, dtype, seed=sum(shape))
    for iters in (1, 2, ts._halo_for(dtype) - 1):
        got = _calls(coef, x, b, corr, iters)
        for k in range(3):
            ref = _calls(_case(coef, k), x[k].contiguous(),
                         b[k].contiguous(), corr[k].contiguous(), iters)
            for name, out in got.items():
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref[name] if isinstance(ref[name], tuple) \
                    else (ref[name],)
                for o, r in zip(outs, refs):
                    assert o.shape[1:] == r.shape
                    assert torch.equal(o[k], r), (name, iters, k)


def test_stack_geometry_is_each_cases():
    """A stack launches each case in the geometry of the case alone, its
    cases the grid's third entry; the choice follows the plane."""
    for dt in (torch.float32, torch.bfloat16):
        for shape in [(512, 2048), (64, 256), (8, 32), (256, 1375)]:
            for kernel in ("jacobi_multisweep", "smooth_residual",
                           "corr_smooth"):
                for iters in (1, 2, ts._max_iters(dt, kernel)):
                    for aligned in (True, False):
                        one = ts.multisweep_geometry(shape, dt, iters,
                                                     aligned, kernel)
                        four = ts.multisweep_geometry((4, *shape), dt,
                                                      iters, aligned, kernel)
                        if isinstance(one, ts.PassGeometry):
                            # one sweep: the single-pass launch of a stack
                            assert four == ts.pass_geometry(
                                (4, *shape), dt, aligned)
                            continue
                        assert four.grid == (*one.grid[:2], 4)
                        assert four == dataclasses.replace(
                            one, grid=four.grid)
    for kernel in ("jacobi", "smooth_residual", "corr_smooth"):
        for shape in [(1, 1), (43, 8), (512, 2048)]:
            assert ts.kernel_available_for((4, *shape), kernel=kernel) \
                == ts.kernel_available_for(shape, kernel=kernel)


def test_kernel_smoothers_choose_on_a_cases_plane(monkeypatch):
    """A fleet's level takes the kernel where the case alone would:
    `kernel_available_for` of a case's (ny, nx) (JAX's vmapped
    `pallas_available_for` sees the same)."""
    from tpufoam_torch.solvers import multigrid as tmg
    coef, x, b, corr = _stack(2, 24, 64, torch.float32, seed=3)
    calls = []
    real = ts.kernel_available_for

    def spy(shape, dtype=torch.float32, kernel="jacobi"):
        calls.append(tuple(shape))
        return real(shape, dtype, kernel)

    monkeypatch.setattr(ts, "kernel_available_for", spy)
    tmg._smooth(coef, x, b, 2, "kernel")
    assert tmg._fused_ok(coef, 2, "kernel-fused")
    assert calls[0] == (24, 64) and calls[-1] == (24, 64)
    assert (2, 24, 64) in calls        # the wrapper's check of the stack


# ---- the fleet against the JAX package's vmapped fleet -------------------


def _geom_kw(shape, size):
    return dict(shape_name=shape, length=3.0, height=1.0,
                obstacle_size=size)


@pytest.fixture(scope="module")
def fleet():
    jc = [jcase.build_channel_case(jax_geom(**_geom_kw(s, z)), delta=DELTA)
          for s, z in GEOMS]
    tc = [tcase.build_channel_case(channel_case_geometry(**_geom_kw(s, z)),
                                   delta=DELTA, device="cpu")
          for s, z in GEOMS]
    return jc, tc


@pytest.mark.parametrize("smoother", ["kernel-fused", "kernel"])
def test_kernel_smoother_fleet_matches_jax(fleet, jax_kernels, smoother):
    jc, tc = fleet
    steps = 2
    ref = jbat.run_piso_batched_eager(
        jbat.stack_cases(jc),
        jbat.stack_flows([jcase.initial_flow(c, 2e-3) for c in jc]), steps,
        cfg=jeng.PisoConfig(n_correctors=1, momentum_smoother="pallas"),
        backend=JMG(cycles=2, smoother=SMOOTHERS[smoother]))
    entered = ("smooth_residual", "corr_smooth") \
        if smoother == "kernel-fused" else ("jacobi_multisweep",)
    assert all(jax_kernels[k] > 0 for k in entered), jax_kernels
    cfg = teng.PisoConfig(n_correctors=1, momentum_smoother="kernel")
    backend = MGBackend(cycles=2, smoother=smoother)
    flows = [tcase.initial_flow(c, 2e-3) for c in tc]
    got = tbat.run_piso_batched_eager(tbat.stack_cases(tc),
                                      tbat.stack_flows(flows), steps,
                                      cfg=cfg, backend=backend)
    for name in FIELDS:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        err = float(np.abs(g - r).max())
        scale = max(float(np.abs(r).max()), 1e-30)
        assert err <= 1e-3 * scale, f"{smoother} {name}: {err:.3e}"
    # the fleet equals its cases stepped alone with the same smoother
    for k, (c, f) in enumerate(zip(tc, flows)):
        alone = teng.run_piso_eager(c, f, steps, cfg=cfg, backend=backend)
        for name in FIELDS:
            assert torch.equal(getattr(got, name)[k], getattr(alone, name)), \
                (smoother, k, name)
