"""The pressure-stencil kernels of tpufoam_torch (`ops.stencil`) on the CPU.

1. Each plain version against the JAX package's Pallas kernel run in
   interpret mode (`jacobi_multisweep_pallas`, `smooth_residual_pallas`,
   `corr_smooth_pallas`), on the 64 x 256 channel operator of
   tests/test_pallas_ops.py and on a 50 x 130 one that JAX pads inside its
   kernels, in float32 and bfloat16, for iters from 1 to the maximum.
   Tolerances, max |port - JAX| / max |JAX|: float32 1e-5 (the same
   operations in the same order; XLA may contract or reorder some float32
   roundings, measured up to 4e-7); bfloat16 1e-2, under three bfloat16
   ulps (2^-8 = 3.9e-3 each; both sides round after every operation and
   measured equal).
2. A CPU emulation of the CUDA kernels' schedule (csrc/pressure_stencil.cu):
   square regions of `REGION` cells, 2-D output tiles, a halo of iters
   (iters + 1 for smooth_residual), a frozen outer ring, and operands
   beyond the domain read as 0 with diag 1. It must equal the plain
   version exactly, in float32 and bfloat16: that is the trapezoid and
   padding argument the kernels rest on. Two mutations show the emulation
   can fail: a halo one short, and diag read as 0 beyond the domain.
3. The wrappers' checks and the fit gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv.case import build_channel_case as jax_build
from tpufoam.fv.pressure import pressure_coeffs as jax_pressure_coeffs
from tpufoam.fv.pressure import PressureCoeffs as JCoeffs
from tpufoam.ops import stencil as jst
from tpufoam_torch.fv.pressure import PressureCoeffs
from tpufoam_torch.ops import stencil as ts

FIELDS = ("c_e", "c_w", "c_n", "c_s", "c_out", "diag")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 1e-2}
KERNELS = ("jacobi_multisweep", "smooth_residual", "corr_smooth")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _max_iters(kernel, prec):
    halo = 16 if prec == "bf16" else 8
    return halo - 1 if kernel == "smooth_residual" else halo


@pytest.fixture(scope="module", params=[(64, 256), (50, 130)],
                ids=["64x256", "padded-50x130"])
def problem(request):
    """A cut-cell channel pressure operator with a seeded rAU, and seeded
    x, b and a correction field, as numpy arrays."""
    ny, nx = request.param
    delta = 2.0 / ny
    geom = jax_geom("cylinder", length=nx * delta, height=2.0,
                    obstacle_size=0.5)
    case = jax_build(geom, delta=delta)
    rng = np.random.default_rng(ny)
    fluid = np.asarray(case.fluid)
    rau = rng.uniform(0.5, 1.5, fluid.shape).astype(np.float32) * fluid
    coef = jax_pressure_coeffs(case, jnp.asarray(rau))
    ops = {f: np.array(getattr(coef, f)) for f in FIELDS}
    for name in ("x", "b", "corr"):
        ops[name] = rng.standard_normal(fluid.shape).astype(np.float32)
    return ops


def _torch_ops(ops, dtype):
    coef = PressureCoeffs(*(torch.as_tensor(ops[f]).to(dtype)
                            for f in FIELDS))
    return coef, {k: torch.as_tensor(ops[k]).to(dtype)
                  for k in ("x", "b", "corr")}


def _jax_ops(ops, dtype):
    coef = JCoeffs(*(jnp.asarray(ops[f]).astype(dtype) for f in FIELDS))
    return coef, {k: jnp.asarray(ops[k]).astype(dtype)
                  for k in ("x", "b", "corr")}


def _run_port(kernel, coef, v, iters):
    if kernel == "jacobi_multisweep":
        return (ts.jacobi_multisweep(coef, v["x"], v["b"], iters=iters),)
    if kernel == "smooth_residual":
        return ts.smooth_residual(coef, v["x"], v["b"], iters=iters)
    return (ts.corr_smooth(coef, v["x"], v["corr"], v["b"], iters=iters),)


def _run_jax(kernel, coef, v, iters):
    if kernel == "jacobi_multisweep":
        return (jst.jacobi_multisweep_pallas(coef, v["x"], v["b"],
                                             iters=iters, interpret=True),)
    if kernel == "smooth_residual":
        return jst.smooth_residual_pallas(coef, v["x"], v["b"], iters=iters,
                                          interpret=True)
    return (jst.corr_smooth_pallas(coef, v["x"], v["corr"], v["b"],
                                   iters=iters, interpret=True),)


def _rel_err(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("which_iters", ["1", "2", "half", "max"])
def test_plain_matches_pallas_kernel(problem, kernel, prec, which_iters):
    top = _max_iters(kernel, prec)
    iters = {"1": 1, "2": 2, "half": top // 2, "max": top}[which_iters]
    tdt, jdt = DTYPES[prec]
    tcoef, tv = _torch_ops(problem, tdt)
    jcoef, jv = _jax_ops(problem, jdt)
    got = _run_port(kernel, tcoef, tv, iters)
    ref = _run_jax(kernel, jcoef, jv, iters)
    assert all(g.dtype == tdt for g in got)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= TOL[prec], (kernel, prec, iters)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_iters_above_the_halo_are_rejected_like_jax(problem, kernel, prec):
    iters = _max_iters(kernel, prec) + 1
    tdt, jdt = DTYPES[prec]
    tcoef, tv = _torch_ops(problem, tdt)
    jcoef, jv = _jax_ops(problem, jdt)
    with pytest.raises(ValueError):
        _run_jax(kernel, jcoef, jv, iters)
    with pytest.raises(ValueError):
        _run_port(kernel, tcoef, tv, iters)


# ---- the CUDA kernels' schedule, emulated ---------------------------------


def emulate(kernel, coef, x, b, corr=None, iters=2, omega=0.8,
            region=ts.REGION, halo=None, diag_fill=1.0):
    """What csrc/pressure_stencil.cu computes, block by block, in PyTorch
    with the plain version's operations: each block loads a region x
    region square (operands beyond the domain 0, diag `diag_fill`), sweeps
    every cell but the region's outer ring `iters` times, and writes its
    centre tile of (region - 2 halo)^2 cells."""
    ny, nx = x.shape
    h = (iters + 1 if kernel == "smooth_residual" else iters) \
        if halo is None else halo
    tile = region - 2 * h
    ty, tx = -(-ny // tile), -(-nx // tile)
    om = ts._omega(omega, x.dtype)
    x0 = x + corr if kernel == "corr_smooth" else x

    def pad(f, fill=0.0):
        return F.pad(f, (h, tx * tile + h - nx, h, ty * tile + h - ny),
                     value=fill)

    xp, bp = pad(x0), pad(b)
    cp = [pad(getattr(coef, f)) for f in ("c_e", "c_w", "c_n", "c_s")]
    dp = pad(coef.diag, diag_fill)

    def a_of(xr, sl, k):
        """A x on the cells `sl` of the region, from region neighbours."""
        ce, cw, cn, cs, d = k
        (r0, r1), (c0, c1) = sl
        xc = xr[r0:r1, c0:c1]
        return (d * xc - ce * xr[r0:r1, c0 + 1:c1 + 1]
                - cw * xr[r0:r1, c0 - 1:c1 - 1]
                - cn * xr[r0 + 1:r1 + 1, c0:c1]
                - cs * xr[r0 - 1:r1 - 1, c0:c1])

    x_out = torch.empty_like(x)
    r_out = torch.empty_like(x)
    for i in range(ty):
        for j in range(tx):
            win = (slice(i * tile, i * tile + region),
                   slice(j * tile, j * tile + region))
            xr = xp[win].clone()
            inner = (slice(1, region - 1), slice(1, region - 1))
            k_in = [f[win][inner] for f in (*cp, dp)]
            b_in = bp[win][inner]
            for _ in range(iters):
                ax = a_of(xr, ((1, region - 1), (1, region - 1)), k_in)
                y = xr.clone()
                y[inner] = xr[inner] + om * (b_in - ax) / k_in[4]
                xr = y
            y0, x0_ = i * tile, j * tile
            hy, hx = min(tile, ny - y0), min(tile, nx - x0_)
            centre = (slice(h, h + hy), slice(h, h + hx))
            x_out[y0:y0 + hy, x0_:x0_ + hx] = xr[centre]
            if kernel == "smooth_residual":
                k_c = [f[win][centre] for f in (*cp, dp)]
                r_out[y0:y0 + hy, x0_:x0_ + hx] = bp[win][centre] - a_of(
                    xr, ((h, h + hy), (h, h + hx)), k_c)
    return (x_out, r_out) if kernel == "smooth_residual" else (x_out,)


def _plain(kernel, coef, x, b, corr, iters):
    if kernel == "jacobi_multisweep":
        return (ts.jacobi_multisweep_plain(coef, x, b, iters),)
    if kernel == "smooth_residual":
        return ts.smooth_residual_plain(coef, x, b, iters)
    return (ts.corr_smooth_plain(coef, x, corr, b, iters),)


def _random_operands(ny, nx, dtype, seed):
    """Random operands with nonzero conductances on every edge too, so the
    zero beyond the domain is what keeps the edge cells right."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (ny, nx)).astype(
            np.float32)).to(dtype)

    c = [f(0.0, 1.0) for _ in range(4)]
    diag = (c[0] + c[1] + c[2] + c[3] + f(0.1, 1.0)).to(dtype)
    coef = PressureCoeffs(*c, torch.zeros_like(diag), diag)
    return coef, f(-1, 1), f(-1, 1), f(-0.1, 0.1)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_tile_schedule_equals_plain_exactly(problem, kernel, prec):
    tdt = DTYPES[prec][0]
    coef, v = _torch_ops(problem, tdt)
    for iters in (1, 2, _max_iters(kernel, prec)):
        got = emulate(kernel, coef, v["x"], v["b"], v["corr"], iters)
        ref = _plain(kernel, coef, v["x"], v["b"], v["corr"], iters)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (kernel, prec, iters)


@pytest.mark.parametrize("shape", [(1, 70), (70, 1), (130, 61)],
                         ids=["one-row", "one-column", "odd"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_tile_schedule_on_edge_shapes(shape, kernel):
    for tdt in (torch.float32, torch.bfloat16):
        coef, x, b, corr = _random_operands(*shape, tdt, seed=sum(shape))
        for iters in (1, 3):
            got = emulate(kernel, coef, x, b, corr, iters)
            ref = _plain(kernel, coef, x, b, corr, iters)
            for g, r in zip(got, ref):
                assert torch.equal(g, r), (kernel, tdt, iters)


def test_a_short_halo_breaks_the_tile_schedule():
    coef, x, b, corr = _random_operands(70, 130, torch.float32, seed=1)
    ref = _plain("jacobi_multisweep", coef, x, b, corr, 3)[0]
    got = emulate("jacobi_multisweep", coef, x, b, iters=3, halo=2)[0]
    assert not torch.equal(got, ref)
    ref = _plain("smooth_residual", coef, x, b, corr, 3)
    got = emulate("smooth_residual", coef, x, b, iters=3, halo=3)
    assert torch.equal(got[0], ref[0]) and not torch.equal(got[1], ref[1])


def test_zero_diag_beyond_the_domain_poisons_the_tile(problem):
    """With diag read as 0 beyond the domain, (b - A x)/diag is 0/0 there,
    and the NaN enters the domain through 0 * NaN on the edge's zero
    conductance: the kernels load diag 1 beyond the domain."""
    coef, v = _torch_ops(problem, torch.float32)
    got = emulate("jacobi_multisweep", coef, v["x"], v["b"], iters=2,
                  diag_fill=0.0)[0]
    assert not bool(torch.isfinite(got).all())
    good = emulate("jacobi_multisweep", coef, v["x"], v["b"], iters=2)[0]
    assert bool(torch.isfinite(good).all())


# ---- wrappers and gate ------------------------------------------------------


def test_cpu_wrappers_take_the_plain_version_and_count_nothing(problem):
    coef, v = _torch_ops(problem, torch.float32)
    before = (ts.jacobi_multisweep.launches, ts.smooth_residual.launches,
              ts.corr_smooth.launches)
    for kernel in KERNELS:
        got = _run_port(kernel, coef, v, 2)
        ref = _plain(kernel, coef, v["x"], v["b"], v["corr"], 2)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert (ts.jacobi_multisweep.launches, ts.smooth_residual.launches,
            ts.corr_smooth.launches) == before


def test_wrappers_reject_what_no_kernel_takes(problem):
    coef, v = _torch_ops(problem, torch.float32)
    x, b = v["x"], v["b"]
    with pytest.raises(ValueError):
        ts.jacobi_multisweep(coef, x.double(), b.double())
    with pytest.raises(ValueError):
        ts.smooth_residual(coef, x, b.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ts.corr_smooth(coef, x, v["corr"][:, :-1], b)
    with pytest.raises(ValueError):
        ts.jacobi_multisweep(coef, x, b, iters=-1)
    with pytest.raises(ValueError, match="contiguous"):
        ts.corr_smooth(coef, x, v["corr"].t().contiguous().t(), b)
    meta = PressureCoeffs(*(getattr(coef, f).to("meta") for f in FIELDS))
    with pytest.raises(ValueError, match="no jacobi_multisweep kernel"):
        ts.jacobi_multisweep(meta, x.to("meta"), b.to("meta"))


def test_fit_gate_takes_every_2d_shape():
    for shape in [(1, 1), (1, 70), (50, 130), (512, 2048), (8, 131072)]:
        for dt in (torch.float32, torch.bfloat16):
            for kernel in ("jacobi", "smooth_residual", "corr_smooth"):
                assert ts.kernel_available_for(shape, dt, kernel)
    assert not ts.kernel_available_for((4, 4), torch.float64)
    assert not ts.kernel_available_for((2, 4, 4))
    assert not ts.kernel_available_for((0, 4))
    assert not ts.kernel_available_for((2**22, 4))
    with pytest.raises(ValueError):
        ts.kernel_available_for((4, 4), kernel="matvec")
    assert ts._halo_for(torch.float32) == jst._halo_for(jnp.float32)
    assert ts._halo_for(torch.bfloat16) == jst._halo_for(jnp.bfloat16)
