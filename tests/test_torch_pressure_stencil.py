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
5. The single-pass kernels' launch geometry (`pass_geometry`): every
   cell of every plane written exactly once, at the paths' widths, and a
   CPU emulation of the strip schedule of csrc/pressure_stencil.cu
   (`stencil_run_kernel`, `stencil_cell_kernel`: x rows kept per thread,
   E/W from the thread's own cells, its neighbouring lanes and, at a
   segment's ends, one scalar read) in both variants, equal to
   `stencil_matvec_plain` bit for bit.
4. The single-pass kernels' plain versions: `stencil_matvec_plain`
   against JAX's `stencil_matvec_pallas` in interpret mode and against
   its `pressure_matvec`, on odd shapes whose out-of-domain conductances
   are zero (tests/test_pallas_ops.py's `_odd_shape_operands` pattern),
   one case and a stack of three; `jacobi_sweep_plain` against
   `jacobi_sweep_pallas` in interpret mode. The tolerances of 1. apply;
   the port's `pressure_matvec` is `stencil_matvec` and equals the plain
   version exactly on the CPU.
6. The multisweep run kernel of all three (`multisweep_run_kernel`): a
   CPU emulation of its schedule (regions of three rows or one a warp and
   32 runs, halo iters rows (smooth_residual: iters + 1) and whole runs >=
   that many columns, the neighbours its threads read, the frozen ring and
   cells beyond the domain, and smooth_residual's residual pass) equal to
   the plain versions bit for bit, both outputs, in both dtypes, on the
   channel operators, on edge shapes and in the schedule the geometry
   picks; mutations that it catches (an x halo one cell short; for
   smooth_residual the sweeps' halo, iters, in rows or in columns); and
   `multisweep_geometry` writing every cell once, in both outputs, and
   sending unaligned rows and odd widths to the region kernel, one sweep
   of jacobi_multisweep to one pass of the single-pass kernels, with the
   fit gate taking exactly the planes whose every launch fits the grid.
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
from tpufoam.fv.pressure import pressure_matvec as jax_matvec
from tpufoam.ops import stencil as jst
from tpufoam_torch.fv.pressure import PressureCoeffs, pressure_matvec
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
    assert not ts.kernel_available_for((0, 4))
    assert not ts.kernel_available_for((2**22, 4))
    assert not ts.kernel_available_for((2, 2, 4, 4))
    # every kernel also takes a leading case axis, up to CUDA's 65,535
    # blocks along z
    for kernel in ("jacobi", "smooth_residual", "corr_smooth", "matvec",
                   "jacobi_sweep"):
        assert ts.kernel_available_for((50, 130), kernel=kernel)
        assert ts.kernel_available_for((3, 50, 130), torch.bfloat16, kernel)
        assert ts.kernel_available_for((2, 4, 4), kernel=kernel)
        assert ts.kernel_available_for((65535, 1, 70), kernel=kernel)
        assert not ts.kernel_available_for((65536, 1, 70), kernel=kernel)
        assert not ts.kernel_available_for((2**22, 4), kernel=kernel)
        assert not ts.kernel_available_for((2, 2**22, 4), kernel=kernel)
    with pytest.raises(ValueError):
        ts.kernel_available_for((4, 4), kernel="momentum")
    assert ts._halo_for(torch.float32) == jst._halo_for(jnp.float32)
    assert ts._halo_for(torch.bfloat16) == jst._halo_for(jnp.bfloat16)


# ---- the single-pass kernels: stencil_matvec, jacobi_sweep -----------------

ODD_SHAPES = [(56, 318), (40, 129), (43, 8)]


def _odd_operands(ny, nx, seed):
    """Conductances pointing out of the domain are zero, as on every real
    case; diag above the sum of the conductances; x and b."""
    rng = np.random.default_rng(seed)

    def f(scale=1.0):
        return (rng.standard_normal((ny, nx)) * scale).astype(np.float32)

    ce, cw, cn, cs = (np.abs(f()) for _ in range(4))
    ce[:, -1] = 0.0
    cw[:, 0] = 0.0
    cn[-1, :] = 0.0
    cs[0, :] = 0.0
    diag = ce + cw + cn + cs + 1.0 + np.abs(f())
    return dict(c_e=ce, c_w=cw, c_n=cn, c_s=cs, c_out=np.zeros_like(ce),
                diag=diag, x=f(), b=f(), corr=f(0.1))


def _stack_ops(ops_list):
    return {k: np.stack([o[k] for o in ops_list]) for k in ops_list[0]}


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stencil_matvec_plain_matches_jax(shape, prec):
    tdt, jdt = DTYPES[prec]
    probs = [_odd_operands(*shape, seed=k) for k in range(3)]
    for ops in probs:
        tcoef, tv = _torch_ops(ops, tdt)
        jcoef, jv = _jax_ops(ops, jdt)
        got = ts.stencil_matvec_plain(tcoef, tv["x"])
        assert got.dtype == tdt
        assert torch.equal(pressure_matvec(tcoef, tv["x"]), got)
        pallas = jst.stencil_matvec_pallas(jcoef, jv["x"], interpret=True)
        assert _rel_err(got, pallas) <= TOL[prec]
        assert _rel_err(got, jax_matvec(jcoef, jv["x"])) <= TOL[prec]
    # a fleet's (3, ny, nx) stack: each case as if alone
    tcoef, tv = _torch_ops(_stack_ops(probs), tdt)
    stacked = ts.stencil_matvec(tcoef, tv["x"])
    for k, ops in enumerate(probs):
        one_coef, one_v = _torch_ops(ops, tdt)
        assert torch.equal(stacked[k],
                           ts.stencil_matvec_plain(one_coef, one_v["x"]))


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("iters", [1, 2, 3])
def test_jacobi_sweep_plain_matches_pallas(problem, iters, prec):
    tdt, jdt = DTYPES[prec]
    tcoef, tv = _torch_ops(problem, tdt)
    jcoef, jv = _jax_ops(problem, jdt)
    got = ts.jacobi_sweep(tcoef, tv["x"], tv["b"], iters=iters)
    ref = jst.jacobi_sweep_pallas(jcoef, jv["x"], jv["b"], iters=iters,
                                  interpret=True)
    assert got.dtype == tdt
    assert _rel_err(got, ref) <= TOL[prec]
    # the one-sweep-per-launch kernel's arithmetic is the multisweep's
    assert torch.equal(got, ts.jacobi_multisweep_plain(tcoef, tv["x"],
                                                       tv["b"], iters))


def test_jacobi_sweep_takes_any_iters_and_a_case_axis():
    probs = [_odd_operands(40, 129, seed=k) for k in range(2)]
    tcoef, tv = _torch_ops(_stack_ops(probs), torch.float32)
    got = ts.jacobi_sweep(tcoef, tv["x"], tv["b"], iters=20)
    for k, ops in enumerate(probs):
        one_coef, one_v = _torch_ops(ops, torch.float32)
        assert torch.equal(got[k], ts.jacobi_sweep_plain(
            one_coef, one_v["x"], one_v["b"], iters=20))
    assert torch.equal(ts.jacobi_sweep(tcoef, tv["x"], tv["b"], iters=0),
                       tv["x"])


def test_single_pass_wrappers_check_like_the_kernels(problem):
    coef, v = _torch_ops(problem, torch.float32)
    x, b = v["x"], v["b"]
    before = (ts.stencil_matvec.launches, ts.jacobi_sweep.launches)
    assert torch.equal(ts.stencil_matvec(coef, x),
                       ts.stencil_matvec_plain(coef, x))
    assert (ts.stencil_matvec.launches, ts.jacobi_sweep.launches) == before
    with pytest.raises(ValueError, match="contiguous"):
        ts.stencil_matvec(coef, x.t().contiguous().t())
    with pytest.raises(ValueError):
        ts.stencil_matvec(coef, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ts.stencil_matvec(coef, x.double())
    with pytest.raises(ValueError):      # a coefficient broadcast on a fleet
        ts.stencil_matvec(coef, torch.stack([x, x]))
    with pytest.raises(ValueError):
        ts.jacobi_sweep(coef, x, b, iters=-1)
    meta = PressureCoeffs(*(getattr(coef, f).to("meta") for f in FIELDS))
    with pytest.raises(ValueError, match="no stencil_matvec kernel"):
        ts.stencil_matvec(meta, x.to("meta"))


# ---- the single-pass kernels' launch geometry and strip schedule ---------

GEOMETRY_WIDTHS = (43, 688, 1040, 1375, 2048)


def _thread_cells(geom, ny, nx):
    """(plane, y, x) index arrays of every cell each thread of `geom`
    writes, in the kernels' mapping (csrc/pressure_stencil.cu: thread
    (bx, by) of block (gx, gy) owns cells x0 = (gx*bx_dim + bx) * cells
    ... + cells - 1 of rows y0 = (gy*by_dim + by) * rows ... + rows - 1),
    cells beyond the plane dropped."""
    (bx, by), (gx, gy, planes) = geom.block, geom.grid
    xs = (np.arange(gx * bx)[:, None] * geom.cells
          + np.arange(geom.cells)[None]).ravel()
    ys = (np.arange(gy * by)[:, None] * geom.rows
          + np.arange(geom.rows)[None]).ravel()
    p, y, x = np.meshgrid(np.arange(planes), ys, xs, indexing="ij")
    keep = (y < ny) & (x < nx)
    return p[keep], y[keep], x[keep]


@pytest.mark.parametrize("planes", [1, 4])
@pytest.mark.parametrize("nx", GEOMETRY_WIDTHS)
def test_pass_geometry_writes_every_cell_once(nx, planes):
    """The kernels' thread-to-cell mapping over the grid of
    `pass_geometry`: every cell of every plane exactly once, in both
    dtypes, both variants, at heights from one row to the main path's
    512."""
    for ny in (1, 8, 37, 272, 512):
        shape = (planes, ny, nx) if planes > 1 else (ny, nx)
        for dt in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                g = ts.pass_geometry(shape, dt, aligned)
                bx, by = g.block
                assert bx * by % 32 == 0 and bx * by <= 256
                assert g.grid[2] == planes
                run = 16 // torch.tensor([], dtype=dt).element_size()
                assert g.vector == (aligned and nx % run == 0
                                    and ny * nx >= ts._VECTOR_MIN_CELLS)
                if g.vector:
                    assert g.cells == run and g.seg == min(bx, 32)
                else:
                    assert (g.cells, g.rows, g.seg, g.block) \
                        == (1, 1, 1, (32, 8))
                p, y, x = _thread_cells(g, ny, nx)
                hits = np.bincount((p * ny + y) * nx + x,
                                   minlength=planes * ny * nx)
                assert (hits == 1).all(), (shape, dt, aligned, g)


def test_pass_geometry_of_the_main_path():
    """The finest level of the hybrid main path (512 x 2048) takes the
    vector variant in both dtypes, and its coarser levels the cell
    variant; so do odd widths and operands off 16 bytes."""
    for dt in (torch.float32, torch.bfloat16):
        assert ts.pass_geometry((512, 2048), dt).vector
        assert ts.pass_geometry((4, 512, 2048), dt).vector
        assert not ts.pass_geometry((256, 1024), dt).vector
        assert not ts.pass_geometry((512, 2048), dt, aligned=False).vector
        assert not ts.pass_geometry((1024, 1375), dt).vector


def emulate_pass(coef, x, geom, edge_rule=True):
    """What the single-pass kernels compute for stencil_matvec, thread by
    thread, in PyTorch with the plain version's operations: each thread's
    run of `geom.cells` consecutive cells, x of rows y-1, y, y+1 over the
    run, E/W from the run itself, from the neighbouring lanes of its
    segment (the shuffles) and, at the segment's ends, one scalar read of
    the row; zeros beyond the plane. The cell variant (one cell, segments
    of one lane) reads all four neighbours.
    `edge_rule=False` lets a segment's last lane take what its shuffle
    returns there (its own first cell) instead of reading the cell after
    the segment (a mutation: the emulation must then fail)."""
    squeeze = x.dim() == 2
    if squeeze:
        coef = PressureCoeffs(*(t[None] for t in (
            coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.c_out, coef.diag)))
        x = x[None]
    planes, ny, nx = x.shape
    (bx, by), (gx, gy, _) = geom.block, geom.grid
    v, seg = geom.cells, geom.seg
    runs = np.arange(gx * bx)
    lane = runs % seg
    col = runs[:, None] * v + np.arange(v)[None]             # (runs, v)
    width = int(col.max()) + 2
    rows_total = gy * by * geom.rows

    def padded(f):
        """f on rows -1 .. rows_total and columns 0 .. width - 1, zero
        beyond the plane (row r + 1 of the result is row r)."""
        return F.pad(f, (0, width - nx, 1, rows_total + 1 - ny))

    xp = padded(x)

    def runs_of(fp, row_shift=0):
        """(planes, rows_total, runs, v): each run's cells."""
        rows = fp[:, 1 + row_shift:1 + row_shift + rows_total]
        return rows[:, :, torch.as_tensor(col)]

    xc, xn, xs = runs_of(xp), runs_of(xp, 1), runs_of(xp, -1)
    rows_x = xp[:, 1:1 + rows_total]
    zero = torch.zeros((), dtype=x.dtype)
    east = torch.as_tensor(runs * v + v)
    west = torch.as_tensor(runs * v - 1)
    east = torch.where(east < nx, rows_x[:, :, east.clamp(max=width - 1)],
                       zero)
    west = torch.where(west >= 0, rows_x[:, :, west.clamp(min=0)], zero)
    last = torch.as_tensor(lane == seg - 1)[None, None]
    first = torch.as_tensor(lane == 0)[None, None]
    nxt = torch.as_tensor(np.minimum(runs + 1, runs[-1]))
    prv = torch.as_tensor(np.maximum(runs - 1, 0))
    xe, xw = torch.empty_like(xc), torch.empty_like(xc)
    for k in range(v):
        xe[..., k] = xc[..., k + 1] if k + 1 < v else torch.where(
            last, east if edge_rule else xc[..., 0], xc[:, :, nxt, 0])
        xw[..., k] = xc[..., k - 1] if k > 0 else torch.where(
            first, west, xc[:, :, prv, v - 1])
    c = [runs_of(padded(t)) for t in (coef.c_e, coef.c_w, coef.c_n,
                                      coef.c_s, coef.diag)]
    ax = (c[4] * xc - c[0] * xe - c[1] * xw - c[2] * xn - c[3] * xs)
    out = torch.zeros(planes, rows_total, width, dtype=x.dtype)
    out[:, :, torch.as_tensor(col)] = ax
    out = out[:, :ny, :nx]
    return out[0] if squeeze else out


EMULATED_SHAPES = [(8, 43), (16, 86), (37, 70), (1, 70), (70, 1),
                   (9, 1375), (3, 24, 40), (12, 688), (2, 9, 2048)]


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape", EMULATED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_strip_run_schedule_equals_plain_exactly(shape, prec):
    """Both variants of the single-pass schedule equal
    `stencil_matvec_plain` bit for bit: the variant `pass_geometry` picks
    (the cell variant at these sizes), and the vector variant (16-byte
    runs) on every width that is a whole number of runs, with strips of 1
    to 4 rows."""
    tdt = DTYPES[prec][0]
    probs = [_odd_operands(*shape[-2:], seed=k) for k in range(
        shape[0] if len(shape) == 3 else 1)]
    tcoef, tv = _torch_ops(_stack_ops(probs) if len(shape) == 3
                           else probs[0], tdt)
    ref = ts.stencil_matvec_plain(tcoef, tv["x"])
    geom = ts.pass_geometry(tuple(tv["x"].shape), tdt)
    assert torch.equal(emulate_pass(tcoef, tv["x"], geom), ref), geom
    run = 16 // torch.tensor([], dtype=tdt).element_size()
    ny, nx = shape[-2:]
    if nx % run == 0:
        for rows, bx in ((1, 4), (2, 32), (4, 128)):
            bx = min(bx, max(4, 1 << (-(-nx // run) - 1).bit_length()))
            strips = -(-ny // rows)
            vec = ts.PassGeometry(
                vector=True, cells=run, rows=rows, seg=min(bx, 32),
                block=(bx, max(1, 32 // bx)),
                grid=(-(-(nx // run) // bx),
                      -(-strips // max(1, 32 // bx)), len(probs)))
            assert torch.equal(emulate_pass(tcoef, tv["x"], vec), ref), vec


def test_strip_run_emulation_has_teeth():
    """A segment's last lane must read the cell after the segment: taking
    what its shuffle returns there (its own first cell) breaks the east
    neighbours, in both variants; strips of 2 and 16 rows equal the plain
    version (the rotation of x rows)."""
    probs = _odd_operands(40, 256, seed=5)
    tcoef, tv = _torch_ops(probs, torch.float32)
    ref = ts.stencil_matvec_plain(tcoef, tv["x"])
    cell = ts.pass_geometry((40, 256), torch.float32)
    assert not cell.vector
    vec = ts.PassGeometry(vector=True, cells=4, rows=2, seg=32,
                          block=(32, 8), grid=(2, 3, 1))
    for geom in (cell, vec):
        assert torch.equal(emulate_pass(tcoef, tv["x"], geom), ref)
        assert not torch.equal(emulate_pass(tcoef, tv["x"], geom,
                                            edge_rule=False), ref)
    tall = ts.PassGeometry(vector=True, cells=4, rows=16, seg=16,
                           block=(16, 2), grid=(4, 2, 1))
    assert torch.equal(emulate_pass(tcoef, tv["x"], tall), ref)


# ---- the multisweep run kernel: all three multisweep kernels ----------------


def emulate_run(kernel, coef, x, b, corr=None, iters=2, omega=0.8,
                geom=None, hx=None, hy=None):
    """What csrc/pressure_stencil.cu's `multisweep_run_kernel` computes,
    block by block, in PyTorch with the plain version's operations: each
    block's region of `warps * rows` rows and `_RUN_LANES` runs, operands
    beyond the domain 0; every cell but the region's outer ring and the
    cells beyond the domain swept `iters` times, with the neighbours the
    kernel's threads see (E/W: the run and the neighbouring lanes, the
    last lane's shuffle returning its own first cell and the first lane's
    its own last; N/S: the thread's rows and the neighbouring warps' edge
    rows, the outermost warps reading their own); for smooth_residual,
    b - A x of the final x with the same neighbours; the tile written (x,
    and r for smooth_residual). `hx` and `hy` override the halo
    (mutations: one short must fail). Returns a tuple, as `_plain`."""
    ny, nx = x.shape
    g = geom or ts._run_geometry((ny, nx), x.dtype,
                                 iters + (kernel == "smooth_residual"))
    run, rows = g.cells, g.rows
    hy = g.halo[0] if hy is None else hy
    hx = g.halo[1] if hx is None else hx
    height, width = g.warps * rows, ts._RUN_LANES * run
    ty, tx = height - 2 * hy, width - 2 * hx
    by, bx = -(-ny // ty), -(-nx // tx)
    om = ts._omega(omega, x.dtype)
    x0 = x + corr if kernel == "corr_smooth" else x
    pad = (hx, bx * tx + width - nx, hy, by * ty + height - ny)
    fields = [F.pad(f, pad) for f in (x0, b, coef.c_e, coef.c_w, coef.c_n,
                                      coef.c_s, coef.diag)]
    inside = F.pad(torch.ones(ny, nx, dtype=torch.bool), pad)
    ring = torch.zeros(height, width, dtype=torch.bool)
    ring[[0, -1]] = True
    ring[:, [0, -1]] = True
    top = (g.warps - 1) * rows
    outs = [torch.empty_like(x)
            for _ in range(1 + (kernel == "smooth_residual"))]
    for i in range(by):
        for j in range(bx):
            win = (slice(i * ty, i * ty + height),
                   slice(j * tx, j * tx + width))
            xr, bb, ce, cw, cn, cs, d = (f[win].clone() for f in fields)
            live = inside[win] & ~ring

            def a_of(xr):
                xe = torch.cat([xr[:, 1:], xr[:, width - run:][:, :1]], 1)
                xw = torch.cat([xr[:, run - 1:run], xr[:, :-1]], 1)
                xn = torch.cat([xr[1:], xr[top:top + 1]], 0)
                xs = torch.cat([xr[rows - 1:rows], xr[:-1]], 0)
                return d * xr - ce * xe - cw * xw - cn * xn - cs * xs

            for _ in range(iters):
                xr = torch.where(live, xr + om * (bb - a_of(xr)) / d, xr)
            region = [xr] if len(outs) == 1 else [xr, bb - a_of(xr)]
            y0, x0_ = i * ty, j * tx
            h, w = min(ty, ny - y0), min(tx, nx - x0_)
            for out, f in zip(outs, region):
                out[y0:y0 + h, x0_:x0_ + w] = f[hy:hy + h, hx:hx + w]
    return tuple(outs)


RUN_KERNELS = KERNELS


def emulate_picked(kernel, coef, x, b, corr, iters):
    """The schedule `multisweep_geometry` picks, emulated: the run kernel,
    the region kernel, or for one sweep of jacobi_multisweep one pass of
    the single-pass kernels (their A x, then the sweep's operations)."""
    geom = ts.multisweep_geometry(tuple(x.shape), x.dtype, iters,
                                  kernel=kernel)
    if geom.variant == "run":
        return emulate_run(kernel, coef, x, b, corr, iters, geom=geom)
    if geom.variant == "region":
        return emulate(kernel, coef, x, b, corr, iters)
    assert kernel == "jacobi_multisweep" and iters == 1
    om = ts._omega(0.8, x.dtype)
    return (x + om * (b - emulate_pass(coef, x, geom)) / coef.diag,)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", RUN_KERNELS)
def test_run_schedule_equals_plain_exactly(problem, kernel, prec):
    """The run kernel's schedule on the channel operators, iters 1, 2 and
    the halo; and the schedule `multisweep_geometry` picks for them (the
    50 x 130 plane's width is no whole number of 16-byte runs in either
    dtype: the region kernel, or one pass of the cell kernel)."""
    tdt = DTYPES[prec][0]
    coef, v = _torch_ops(problem, tdt)
    for iters in (1, 2, _max_iters(kernel, prec)):
        ref = _plain(kernel, coef, v["x"], v["b"], v["corr"], iters)
        got = emulate_run(kernel, coef, v["x"], v["b"], v["corr"], iters)
        picked = emulate_picked(kernel, coef, v["x"], v["b"], v["corr"],
                                iters)
        assert len(got) == len(picked) == len(ref)
        for g, p, r in zip(got, picked, ref):
            assert torch.equal(g, r), (kernel, prec, iters)
            assert torch.equal(p, r), (kernel, prec, iters)


@pytest.mark.parametrize("shape", ["one-run", "one-row", "ragged"])
@pytest.mark.parametrize("kernel", RUN_KERNELS)
def test_run_schedule_on_edge_shapes(shape, kernel):
    """A plane one run wide, one row high, and one whose width and height
    are not a whole number of tiles (two blocks along x, the last partly
    beyond the domain), in both dtypes, iters 1, 2 and the most the kernel
    takes, in blocks of three rows a thread and, where the halo leaves a
    16-row block a tile, of one."""
    for prec in ("f32", "bf16"):
        tdt = DTYPES[prec][0]
        run = 16 // torch.tensor([], dtype=tdt).element_size()
        ny, nx = {"one-run": (37, run), "one-row": (1, 70 * run // 2),
                  "ragged": (53, 34 * run)}[shape]
        coef, x, b, corr = _random_operands(ny, nx, tdt, seed=ny + nx)
        for iters in (1, 2, _max_iters(kernel, prec)):
            ref = _plain(kernel, coef, x, b, corr, iters)
            halo = iters + (kernel == "smooth_residual")
            for rows in (3, 1) if 2 * halo < 16 else (3,):
                geom = ts._run_geometry((ny, nx), tdt, halo, rows)
                got = emulate_run(kernel, coef, x, b, corr, iters,
                                  geom=geom)
                assert len(got) == len(ref)
                for g, r in zip(got, ref):
                    assert torch.equal(g, r), (prec, (ny, nx), iters, rows)


def test_run_schedule_with_a_short_x_halo_fails():
    """An x halo one cell short (iters - 1, iters a whole number of runs):
    the second block's tile then starts iters - 1 cells inside its frozen
    ring column. With x = 0 and b = 0 but for b = 1 on that column, the
    plain version carries the column's update iters - 1 cells east, into
    the tile, while the short-haloed block sees only zeros; with the right
    halo the emulation equals the plain version. Both dtypes, iters from
    one to all of the halo's runs."""
    for tdt, iters in ((torch.float32, 4), (torch.float32, 8),
                       (torch.bfloat16, 8), (torch.bfloat16, 16)):
        coef, _, _, _ = _random_operands(40, 512, tdt, seed=iters)
        geom = ts._run_geometry((40, 512), tdt, iters)
        column = geom.region[1] - 2 * (iters - 1) - (iters - 1)
        x = torch.zeros(40, 512, dtype=tdt)
        b = torch.zeros_like(x)
        b[:, column] = 1.0
        ref = _plain("jacobi_multisweep", coef, x, b, None, iters)[0]
        assert torch.equal(emulate_run("jacobi_multisweep", coef, x, b,
                                       iters=iters)[0], ref)
        short = emulate_run("jacobi_multisweep", coef, x, b, iters=iters,
                            hx=iters - 1)[0]
        assert not torch.equal(short, ref), (tdt, iters)


@pytest.mark.parametrize("axis", ["rows", "columns"])
def test_residual_schedule_with_the_sweeps_halo_fails(axis):
    """smooth_residual's halo is iters + 1 rows and whole runs >= iters +
    1 columns: its residual reads one ring beyond the cells the sweeps
    leave exact. With the sweeps' halo instead (iters rows, or whole runs
    >= iters columns, iters a whole number of runs), the second block's
    tile starts iters cells inside its frozen ring row (column). With x =
    0 and b = 0 but for b = 1 on that ring, the plain version carries the
    ring's update iters - 1 cells in, next to the tile, so r is nonzero on
    the tile's first row (column), where the short-haloed block sees only
    zeros; x is 0 there in both. With the right halo the emulation equals
    the plain version. Both dtypes, iters of one and two runs."""
    for tdt, iters in ((torch.float32, 4), (torch.float32, 8),
                       (torch.bfloat16, 8), (torch.bfloat16, 15)):
        if axis == "columns" and iters == 15:
            continue                  # no whole number of runs
        halo = iters + 1
        coef, _, _, _ = _random_operands(53, 640, tdt, seed=iters)
        geom = ts._run_geometry((53, 640), tdt, halo)
        height, width = geom.region
        x = torch.zeros(53, 640, dtype=tdt)
        b = torch.zeros_like(x)
        if axis == "rows":
            b[height - 3 * iters] = 1.0
            short = dict(hy=iters)
        else:
            b[:, width - 3 * iters] = 1.0
            short = dict(hx=iters)
        ref = _plain("smooth_residual", coef, x, b, None, iters)
        got = emulate_run("smooth_residual", coef, x, b, iters=iters)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        got = emulate_run("smooth_residual", coef, x, b, iters=iters,
                          **short)
        assert torch.equal(got[0], ref[0]), (tdt, iters)
        assert not torch.equal(got[1], ref[1]), (tdt, iters)


def _run_hits(geom, ny, nx):
    """How often the run kernel's threads store each cell: thread (warp w,
    lane l) of block (bx, by) stores its row i (region row r = w*rows+i)
    and run (region column c = l*cells) where hy <= r < height - hy and
    hx <= c < width - hx, inside the plane
    (csrc/pressure_stencil.cu `multisweep_run_kernel`)."""
    (hy, hx), (ty, tx), (gx, gy, _) = geom.halo, geom.tile, geom.grid
    height, width = geom.region
    r = np.arange(geom.warps * ts._RUN_ROWS)
    c = np.arange(ts._RUN_LANES)[:, None] * geom.cells \
        + np.arange(geom.cells)[None]
    r = r[(r >= hy) & (r < height - hy)]
    c = c[(c[:, 0] >= hx) & (c[:, 0] < width - hx)].ravel()
    ys = (np.arange(gy)[:, None] * ty - hy + r[None]).ravel()
    xs = (np.arange(gx)[:, None] * tx - hx + c[None]).ravel()
    y, x = np.meshgrid(ys, xs, indexing="ij")
    keep = (y >= 0) & (y < ny) & (x >= 0) & (x < nx)
    return np.bincount((y[keep] * nx + x[keep]).ravel(), minlength=ny * nx)


@pytest.mark.parametrize("kernel", RUN_KERNELS)
@pytest.mark.parametrize("nx", [8, 43, 64, 688, 1040, 1375, 2048])
def test_multisweep_geometry_writes_every_cell_once(nx, kernel):
    """Every cell exactly once (smooth_residual: x and r), in every
    variant and both dtypes, for every iters the wrappers accept, at
    heights from one row to 512; widths that are not a whole number of
    16-byte runs, and operands off 16 bytes, take the region kernel; one
    sweep of jacobi_multisweep one pass of the single-pass kernels
    (`pass_geometry`'s launch). The halo is iters, and iters + 1 for
    smooth_residual."""
    for ny in (1, 37, 272, 512):
        for dt in (torch.float32, torch.bfloat16):
            run = 16 // torch.tensor([], dtype=dt).element_size()
            for iters in range(ts._max_iters(dt, kernel) + 1):
                halo = iters + (kernel == "smooth_residual")
                for aligned in (True, False):
                    g = ts.multisweep_geometry((ny, nx), dt, iters, aligned,
                                               kernel=kernel)
                    if kernel == "jacobi_multisweep" and iters == 1:
                        assert g == ts.pass_geometry((ny, nx), dt, aligned)
                        p, y, x = _thread_cells(g, ny, nx)
                        hits = np.bincount(y * nx + x, minlength=ny * nx)
                        assert (hits == 1).all()
                        continue
                    if not aligned or nx % run:
                        assert g.variant == "region"
                    if g.variant == "region":
                        t = ts.REGION - 2 * halo
                        assert (g.tile, g.halo) == ((t, t), (halo, halo))
                        ys = np.arange(g.grid[1] * t)
                        xs = np.arange(g.grid[0] * t)
                        assert ys[-1] >= ny - 1 and ys[-1] - t < ny - 1
                        assert xs[-1] >= nx - 1 and xs[-1] - t < nx - 1
                        continue
                    assert g.cells == run and g.halo[0] == halo
                    assert g.halo[1] % run == 0 \
                        and halo <= g.halo[1] < halo + run
                    assert g.warps * 32 <= 512 and min(g.tile) > 0
                    hits = _run_hits(g, ny, nx)
                    assert (hits == 1).all(), (ny, nx, dt, iters, g)


def _launchable(shape, dt, kernel):
    """Whether every launch the wrapper of `kernel` can make on `shape`
    (each iters it accepts, from aligned or unaligned operands) has a grid
    within CUDA's limit on blocks in y."""
    return all(
        ts.multisweep_geometry(shape, dt, iters, aligned,
                               kernel=kernel).grid[1] <= ts._MAX_GRID_Y
        for iters in range(ts._max_iters(dt, kernel) + 1)
        for aligned in (True, False))


@pytest.mark.parametrize("kernel", RUN_KERNELS)
def test_fit_gate_agrees_with_the_geometry(kernel):
    """`kernel_available_for` takes a plane exactly when every geometry
    the wrapper can launch on it fits CUDA's grid: at the heights where
    some tile's grid reaches the limit, from both sides, for widths of
    whole runs and odd ones."""
    gate = "jacobi" if kernel == "jacobi_multisweep" else kernel
    for dt in (torch.float32, torch.bfloat16):
        tiles = {g.tile[0] for iters in range(ts._max_iters(dt, kernel) + 1)
                 for aligned in (True, False)
                 for g in [ts.multisweep_geometry((64, 64), dt, iters,
                                                  aligned, kernel=kernel)]
                 if isinstance(g, ts.MultisweepGeometry)}
        for nx in (16, 43):
            for t in sorted(tiles):
                for ny in (t * ts._MAX_GRID_Y, t * ts._MAX_GRID_Y + 1):
                    assert ts.kernel_available_for((ny, nx), dt, gate) \
                        == _launchable((ny, nx), dt, kernel), (dt, nx, ny)


# ---- the window launch of the sharded multisweep ---------------------------


def _window_bounds(shape, mesh, halo, short=0):
    """[(oy, ox, (y_lo, y_hi, x_lo, x_hi))] for each block of the (dy, dx)
    mesh, row-major: its origin, and its haloed window (`halo` along a
    split axis, 0 along a whole one) clipped to the domain; `short` cuts
    the window that many rows short along y (a mutation)."""
    (ny, nx), (dy, dx) = shape, mesh
    nyl, nxl = ny // dy, nx // dx
    hy, hx = (halo - short) * (dy > 1), halo * (dx > 1)
    return [(i * nyl, j * nxl, (max(i * nyl - hy, 0),
                                min((i + 1) * nyl + hy, ny),
                                max(j * nxl - hx, 0),
                                min((j + 1) * nxl + hx, nx)))
            for i in range(dy) for j in range(dx)]


def _window_load(f, rows, cols, bounds):
    """f at (rows, cols) (broadcast), 0 outside the window `bounds` (the
    kernels' loads, read in place from the global operands)."""
    y_lo, y_hi, x_lo, x_hi = bounds
    ny, nx = f.shape
    inside = (rows >= y_lo) & (rows < y_hi) & (cols >= x_lo) & (cols < x_hi)
    return torch.where(inside, f[rows.clamp(0, ny - 1),
                                 cols.clamp(0, nx - 1)],
                       torch.zeros((), dtype=f.dtype))


def _filled(coef, mesh):
    """The diag every window load sees: its zeros made 1 when the mesh
    splits an axis, as the sharded wrappers fill the haloed diag."""
    if mesh == (1, 1):
        return coef.diag
    return coef.diag.masked_fill(coef.diag == 0, 1.0)


def emulate_window_pass(coef, x, b, geom, mesh, omega=0.8, short=0):
    """One sweep of the window launch in the single-pass kernels' schedule
    (`stencil_run_kernel` / `stencil_cell_kernel` with WINDOW), in
    PyTorch with the plain version's operations: for each block (a plane
    of `geom`, counted from the block's origin), each thread's run of
    `geom.cells` cells on each row of its strip; x of rows y-1, y, y+1
    over the run, the neighbouring lanes' runs (beyond the block too),
    and at a segment's ends one scalar read, all from the global x with
    zeros outside the block's haloed window; the block's cells stored."""
    ny, nx = x.shape
    nyl, nxl = ny // mesh[0], nx // mesh[1]
    (bx, by), (gx, gy, planes) = geom.block, geom.grid
    assert planes == mesh[0] * mesh[1]
    v, seg = geom.cells, geom.seg
    runs = torch.arange(gx * bx)
    last = (runs % seg == seg - 1)[None]
    first = (runs % seg == 0)[None]
    rows = torch.arange(gy * by * geom.rows)
    om = ts._omega(omega, x.dtype)
    diag = _filled(coef, mesh)
    out = torch.full_like(x, float("nan"))
    for oy, ox, bounds in _window_bounds((ny, nx), mesh,
                                         ts._halo_for(x.dtype), short):
        r = (oy + rows)[:, None, None]
        c = (ox + runs[:, None] * v + torch.arange(v)[None])[None]
        xc, xn, xs = (_window_load(x, r + k, c, bounds) for k in (0, 1, -1))
        east = _window_load(x, r[..., 0], (ox + runs * v + v)[None], bounds)
        west = _window_load(x, r[..., 0], (ox + runs * v - 1)[None], bounds)
        nxt = xc[:, (runs + 1).clamp(max=len(runs) - 1), 0]
        prv = xc[:, (runs - 1).clamp(min=0), v - 1]
        xe = torch.cat([xc[..., 1:], torch.where(last, east, nxt)[..., None]],
                       -1)
        xw = torch.cat([torch.where(first, west, prv)[..., None],
                        xc[..., :-1]], -1)
        keep = (rows[:, None, None] < nyl) & (c - ox < nxl)
        rr, cc = r.clamp(max=ny - 1), c.clamp(max=nx - 1)
        ce, cw, cn, cs, d, bb = (f[rr, cc] for f in (
            coef.c_e, coef.c_w, coef.c_n, coef.c_s, diag, b))
        ax = d * xc - ce * xe - cw * xw - cn * xn - cs * xs
        res = xc + om * (bb - ax) / d
        out[r.expand_as(keep)[keep], c.expand_as(keep)[keep]] = res[keep]
    return out


def emulate_window_run(coef, x, b, iters, mesh, geom, omega=0.8, short=0):
    """`iters` sweeps of the window launch in the run kernel's schedule
    (`multisweep_run_kernel` with WINDOW), in PyTorch with the plain
    version's operations: for each block, tiles of `geom` from the block's
    origin over its interior, each region loaded from the global operands
    with zeros outside the block's haloed window (and so frozen), the
    neighbours the kernel's threads read (as `emulate_run`), the frozen
    outer ring; each tile's cells inside the block stored."""
    ny, nx = x.shape
    nyl, nxl = ny // mesh[0], nx // mesh[1]
    run, rows = geom.cells, geom.rows
    hy, hx = geom.halo
    height, width = geom.region
    ty, tx = geom.tile
    top = (geom.warps - 1) * rows
    om = ts._omega(omega, x.dtype)
    fields = (x, b, coef.c_e, coef.c_w, coef.c_n, coef.c_s,
              _filled(coef, mesh))
    ring = torch.zeros(height, width, dtype=torch.bool)
    ring[[0, -1]] = True
    ring[:, [0, -1]] = True
    out = torch.full_like(x, float("nan"))
    for oy, ox, bounds in _window_bounds((ny, nx), mesh,
                                         ts._halo_for(x.dtype), short):
        for y0 in range(oy, oy + nyl, ty):
            for x0 in range(ox, ox + nxl, tx):
                r = torch.arange(y0 - hy, y0 - hy + height)[:, None]
                c = torch.arange(x0 - hx, x0 - hx + width)[None]
                xr, bb, ce, cw, cn, cs, d = (_window_load(f, r, c, bounds)
                                             for f in fields)
                y_lo, y_hi, x_lo, x_hi = bounds
                live = ((r >= y_lo) & (r < y_hi) & (c >= x_lo)
                        & (c < x_hi)) & ~ring

                def a_of(xr):
                    xe = torch.cat([xr[:, 1:], xr[:, width - run:][:, :1]], 1)
                    xw = torch.cat([xr[:, run - 1:run], xr[:, :-1]], 1)
                    xn = torch.cat([xr[1:], xr[top:top + 1]], 0)
                    xs = torch.cat([xr[rows - 1:rows], xr[:-1]], 0)
                    return d * xr - ce * xe - cw * xw - cn * xn - cs * xs

                for _ in range(iters):
                    xr = torch.where(live, xr + om * (bb - a_of(xr)) / d, xr)
                h, w = min(ty, oy + nyl - y0), min(tx, ox + nxl - x0)
                out[y0:y0 + h, x0:x0 + w] = xr[hy:hy + h, hx:hx + w]
    return out


def emulate_window(coef, x, b, iters, mesh, geom=None, short=0):
    """The window launch `ts.window_geometry` picks (or `geom`),
    emulated."""
    ny, nx = x.shape
    blocks, shape = mesh[0] * mesh[1], (ny // mesh[0], nx // mesh[1])
    geom = geom or ts.window_geometry(blocks, shape, x.dtype, iters)
    if isinstance(geom, ts.PassGeometry):
        assert iters == 1
        return emulate_window_pass(coef, x, b, geom, mesh, short=short)
    return emulate_window_run(coef, x, b, iters, mesh, geom, short=short)


def _disc_operands(ny, nx, dtype, seed):
    """`_random_operands` with the conductances out of the domain 0 and a
    solid disc (a quarter of the height across, a quarter of the length
    in) of no conductance, x = b = 0 and a zero diag: the cells whose
    diag the sharded wrappers fill."""
    coef, x, b, _ = _random_operands(ny, nx, torch.float32, seed)
    yy = torch.arange(ny)[:, None] - ny / 2
    xx = torch.arange(nx)[None] - nx / 4
    fl = (yy * yy + xx * xx >= (ny / 8) ** 2).float()
    c = [t * fl for t in (coef.c_e, coef.c_w, coef.c_n, coef.c_s)]
    c[0][:, -1] = 0
    c[1][:, 0] = 0
    c[2][-1, :] = 0
    c[3][0, :] = 0
    return (PressureCoeffs(*(t.to(dtype) for t in c),
                           torch.zeros(ny, nx, dtype=dtype),
                           (coef.diag * fl).to(dtype)),
            (x * fl).to(dtype), (b * fl).to(dtype))


WINDOW_MESHES = [(2, 2), (4, 1), (1, 4), (4, 2)]


def _cpu_mesh(shape):
    from tpufoam_torch.parallel.mesh import device_mesh
    return device_mesh(shape[0] * shape[1], shape=shape,
                       devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("mesh", WINDOW_MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_window_schedule_equals_the_sharded_plain_version(mesh, prec):
    """The window launch's schedule, bit for bit against
    `jacobi_multisweep_sharded_plain` (the plain sweeps on each block's
    haloed window, its diag filled), at iters 1, 2 and the halo, in the
    geometry `window_geometry` picks, and for one sweep in the vector
    variant too: on the 64 x 256 channel operator (blocks of 128, 256 and
    64 columns, no whole number of the run kernel's tiles) and on random
    operands of 96 x 480 with a solid disc of zero diag (blocks of 240 and
    120 columns: whole tiles at 2 sweeps in both dtypes)."""
    from tpufoam_torch.ops import sharded as tsh

    tdt = DTYPES[prec][0]
    geom = jax_geom("cylinder", length=8.0, height=2.0, obstacle_size=0.5)
    case = jax_build(geom, delta=2.0 / 64)
    rng = np.random.default_rng(64)
    rau = rng.uniform(0.5, 1.5, case.grid.shape).astype(np.float32) \
        * np.asarray(case.fluid)
    jc = jax_pressure_coeffs(case, jnp.asarray(rau))
    chan = PressureCoeffs(*(torch.as_tensor(np.array(getattr(jc, f))).to(tdt)
                            for f in FIELDS))
    operands = [(chan, *(torch.as_tensor(rng.standard_normal(
                     case.grid.shape).astype(np.float32)).to(tdt)
                     for _ in range(2))),
                _disc_operands(96, 480, tdt, seed=7)]
    cpu = _cpu_mesh(mesh)
    for coef, x, b in operands:
        ny, nx = x.shape
        blocks, shape = mesh[0] * mesh[1], (ny // mesh[0], nx // mesh[1])
        for iters in (1, 2, ts._halo_for(tdt)):
            ref = tsh.jacobi_multisweep_sharded_plain(cpu, coef, x, b, iters)
            assert bool(torch.isfinite(ref).all())
            assert torch.equal(emulate_window(coef, x, b, iters, mesh),
                               ref), (shape, iters)
            if iters == 1:
                vec = ts.pass_geometry((blocks, *shape), tdt, cells=1 << 62)
                assert vec.vector
                assert torch.equal(emulate_window(coef, x, b, 1, mesh, vec),
                                   ref), shape


def test_window_schedule_one_row_short_fails():
    """The check above has teeth: a window one row short along y at the
    full halo leaves out the row `halo` cells beyond the block, which
    reaches the block's first row on the last sweep. x = 0 but for 1 on
    that row, b = 0, and a coupling of omega / 2 = 0.4 a hop along y
    (c_n = c_s = 1, diag 2, no E/W conductance) keep that reach (0.4^16
    in bfloat16) above zero: the short window leaves a 0 there. With the
    right window the schedule equals the sharded plain version. Both
    dtypes, the run kernel, on a 2 x 2 mesh."""
    from tpufoam_torch.ops import sharded as tsh

    ny, nx = 96, 256
    for tdt in (torch.float32, torch.bfloat16):
        halo = ts._halo_for(tdt)
        one = torch.ones(ny, nx, dtype=tdt)
        coef = PressureCoeffs(0 * one, 0 * one, one, one, 0 * one, 2 * one)
        x = torch.zeros(ny, nx, dtype=tdt)
        x[ny // 2 - halo] = 1.0
        b = torch.zeros_like(x)
        ref = tsh.jacobi_multisweep_sharded_plain(_cpu_mesh((2, 2)), coef,
                                                  x, b, halo)
        assert float(ref[ny // 2].abs().min()) > 0
        assert torch.equal(emulate_window(coef, x, b, halo, (2, 2)), ref)
        short = emulate_window(coef, x, b, halo, (2, 2), short=1)
        assert not torch.equal(short, ref), tdt
        assert float(short[ny // 2].abs().max()) == 0


def test_window_geometry_sizes_the_launch_by_its_cells():
    """One sweep: the single-pass kernels over (blocks, nyl, nxl), the
    vector variant from 2^19 cells in all (the 2 x 2 mesh of 512 x 2048),
    else the cell variant; two or more: the run kernel over one block,
    its rows a thread by the launch's cells. None where the region
    kernel would take the plane: widths that are no whole number of
    16-byte runs, operands off 16 bytes, more than MAX_WINDOW_BLOCKS
    blocks, or the region kernel forced."""
    for dt in (torch.float32, torch.bfloat16):
        g = ts.window_geometry(4, (256, 1024), dt, 1)
        assert isinstance(g, ts.PassGeometry) and g.vector \
            and g.grid[2] == 4
        g = ts.window_geometry(4, (64, 256), dt, 1)
        assert isinstance(g, ts.PassGeometry) and not g.vector
        for iters in (2, ts._halo_for(dt)):
            g = ts.window_geometry(4, (256, 1024), dt, iters)
            whole = ts.multisweep_geometry((1024, 1024), dt, iters)
            assert g == ts._run_geometry((4, 256, 1024), dt, iters,
                                         whole.rows)
            assert g.grid == (-(-1024 // g.tile[1]), -(-256 // g.tile[0]),
                              4)
        assert ts.window_geometry(4, (256, 1030), dt, 2) is None
        assert ts.window_geometry(4, (256, 1024), dt, 2,
                                  aligned=False) is None
        assert ts.window_geometry(ts.MAX_WINDOW_BLOCKS + 1, (16, 64), dt,
                                  2) is None
    saved = ts._REGION_BELOW_CELLS
    try:
        ts._REGION_BELOW_CELLS = 1 << 62
        assert ts.window_geometry(4, (256, 1024), torch.float32, 2) is None
        assert ts.window_geometry(4, (256, 1024), torch.float32, 1) is None
    finally:
        ts._REGION_BELOW_CELLS = saved
