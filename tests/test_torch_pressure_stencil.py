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
    assert not ts.kernel_available_for((2, 4, 4))
    assert not ts.kernel_available_for((0, 4))
    assert not ts.kernel_available_for((2**22, 4))
    # the single-pass kernels also take a leading case axis
    for kernel in ("matvec", "jacobi_sweep"):
        assert ts.kernel_available_for((50, 130), kernel=kernel)
        assert ts.kernel_available_for((3, 50, 130), torch.bfloat16, kernel)
        assert not ts.kernel_available_for((2**22, 4), kernel=kernel)
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
