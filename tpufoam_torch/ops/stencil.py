"""Pressure-stencil kernels of the multigrid: the hand-written CUDA kernels
and their plain PyTorch versions.

The pressure operator is the variable-coefficient 5-point stencil

    A x = diag*x - c_e*E(x) - c_w*W(x) - c_n*N(x) - c_s*S(x)

with neighbours beyond the domain read as 0, and the multigrid smoother is
damped Jacobi, x <- x + omega*(b - A x)/diag. The kernels of
csrc/pressure_stencil.cu:

  stencil_matvec     A x in one pass          (fv.pressure.pressure_matvec)
  jacobi_sweep       one sweep per launch, `iters` launches
  jacobi_multisweep  `iters` sweeps                 (multigrid._smooth)
  smooth_residual    `iters` sweeps, then r = b - A x  (V-cycle down leg)
  corr_smooth        x + corr, then `iters` sweeps     (V-cycle up leg)

Every kernel takes (ny, nx) operands or a fleet's (B, ny, nx), each case
computed as if alone, in one launch for the stack (blockIdx.z the case).
The two single-pass kernels launch in the geometry of `pass_geometry` (a
strip of rows per thread, and a 16-byte run of cells on large aligned
planes, one cell elsewhere); the multisweep kernels in the geometry of
`multisweep_geometry`, chosen by a case's plane: the run kernel (16-byte
runs over a few rows a thread, every operand read once and kept on chip
for all the sweeps, smooth_residual's residual in one more pass over a
halo one ring deeper; in bfloat16 too the division skips a zero dividend's
slow path) on aligned planes whose width is a whole number of runs, the
region kernel elsewhere, and for one sweep of jacobi_multisweep one pass
of jacobi_sweep's kernels. The sharded multisweep (ops/sharded.py)
launches jacobi_multisweep's window form over a card's mesh blocks of
global operands, in the geometry of `window_geometry`.

On CUDA tensors each wrapper launches its kernel (or raises); on CPU
tensors it runs the `*_plain` version beside it. The plain versions repeat
the kernels' arithmetic operation by operation: the division by diag (not
a multiply by 1/diag), omega rounded to the operand dtype, and a rounding
to the operand dtype after every operation, as the TPU kernels do
("arithmetic stays in the operand dtype"). Operands are float32 or
bfloat16, all of one dtype, contiguous.

Reverse mode: `stencil_matvec` is differentiable. Under autograd it runs
as `StencilMatvec`, whose forward is the same launch and whose backward
is the kernel of csrc/stencil_grad.cu (`stencil_matvec_grad`: the
transposed stencil for x and the products for the coefficients; on CPU
tensors `stencil_matvec_grad_plain`). The JAX package differentiates its
plain matvec through XLA; its Pallas kernels have no reverse mode, and
here the multisweep and sweep kernels have none either: on CUDA they
refuse operands that require a gradient.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch
from torch.autograd.function import once_differentiable

from ..fv.operators import nb_e, nb_n, nb_s, nb_w
from . import build

_NAME = "pressure_stencil"
_GRAD_NAME = "stencil_grad"
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The kernels' output tile depends on the halo; its region is at most
# REGION x REGION cells and the grid's y extent is capped by CUDA.
REGION = 64
_MAX_GRID_Y = 65535
_MAX_GRID_Z = 65535          # the cases of one stacked launch


def _halo_for(dtype) -> int:
    """The TPU kernels' halo (16 rows for 2-byte dtypes, else 8). It sets
    the iterations the kernels accept: iters <= halo for jacobi_multisweep
    and corr_smooth, iters <= halo - 1 for smooth_residual (its residual
    needs one more ring)."""
    return 16 if dtype.itemsize == 2 else 8


def _max_iters(dtype, kernel: str) -> int:
    return _halo_for(dtype) - (kernel == "smooth_residual")


# the kernels that take one pass per launch
_PASS_KERNELS = ("matvec", "jacobi_sweep")
_PASS_THREADS = 256          # the most threads of a block
_PASS_MAX_ROWS = 16          # the most rows of a thread's strip
# vector variant: threads to have in flight, 256 per SM of the H100's 132
_PASS_TARGET_THREADS = 132 * 256
# planes of fewer cells take the cell variant even when aligned: there a
# launch costs about its floor, and the one-cell thread finishes first
_VECTOR_MIN_CELLS = 1 << 19
_CELL_BLOCK = (32, 8)        # the cell variant's block (one cell a thread)


@dataclasses.dataclass(frozen=True)
class PassGeometry:
    """The launch of a single-pass kernel (stencil_matvec, jacobi_sweep)
    over (planes, ny, nx) operands. `vector`: a thread owns a run of
    `cells` consecutive cells of a row (16 bytes), moved as one vector per
    field, down a strip of `rows` rows (csrc/pressure_stencil.cu
    `stencil_run_kernel`), and `seg` lanes of a warp share a row and pass
    neighbours by shuffles; else one cell a thread (`stencil_cell_kernel`:
    cells, rows and seg 1, each thread reads its own neighbours). `block`
    is (threads along a row, rows of threads), `grid` (blocks along x,
    blocks along y, planes)."""
    vector: bool
    cells: int
    rows: int
    seg: int
    block: tuple
    grid: tuple

    @property
    def variant(self) -> str:
        return "vector" if self.vector else "cell"


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def pass_geometry(shape, dtype, aligned: bool = True,
                  cells: int | None = None) -> PassGeometry:
    """The launch geometry of the single-pass kernels for operands of
    `shape` ((ny, nx) or (B, ny, nx)) and `dtype`. `aligned`: every
    operand's base address is a multiple of 16 bytes. The vector variant
    needs that, rows of a whole number of 16-byte runs and `cells` (a
    plane's, by default) of at least `_VECTOR_MIN_CELLS`; the cell variant
    takes anything. Vector
    variant: threads along a row 128, 64 or 32, whichever leaves the
    fewest idle (one segment for a row of fewer than 32 runs), and the
    most rows per thread (up to 16, powers of two) that still puts
    `_PASS_TARGET_THREADS` threads on the card."""
    *lead, ny, nx = shape
    planes = lead[0] if lead else 1
    run = 16 // dtype.itemsize
    cells = ny * nx if cells is None else cells
    if not (aligned and nx % run == 0 and cells >= _VECTOR_MIN_CELLS):
        bx, by = _CELL_BLOCK
        return PassGeometry(vector=False, cells=1, rows=1, seg=1,
                            block=_CELL_BLOCK,
                            grid=(-(-nx // bx), -(-ny // by), planes))
    runs = nx // run
    bx = _pow2_at_least(runs) if runs < 32 else min(
        (128, 64, 32), key=lambda b: (-(-runs // b) * b, -b))
    gx = -(-runs // bx)
    rows = _PASS_MAX_ROWS
    while rows > 1 and gx * bx * planes * -(-ny // rows) \
            < _PASS_TARGET_THREADS:
        rows //= 2
    strips = -(-ny // rows)
    by = max(32 // bx, min(_PASS_THREADS // bx, _pow2_at_least(strips)))
    return PassGeometry(vector=True, cells=run, rows=rows, seg=min(bx, 32),
                        block=(bx, by), grid=(gx, -(-strips // by), planes))


# the multisweep run kernel (csrc/pressure_stencil.cu
# `multisweep_run_kernel`): rows of a thread, lanes of a warp along a row
_RUN_ROWS = 3
_RUN_LANES = 32
# planes of fewer cells take the region kernel whatever their alignment
# (0: none; tools/kernel_times.py and chip_smoke.py set it unbounded to
# time the region kernel on the same operands)
_REGION_BELOW_CELLS = 0
# the run kernel takes one row a thread for halos up to
# `_ONE_ROW_MAX_HALO` on planes of fewer than `_ONE_ROW_BELOW_CELLS`
# cells, and up to one less on larger planes (tools/kernel_times.py sets
# them to time either block shape everywhere)
_ONE_ROW_MAX_HALO = 3
_ONE_ROW_BELOW_CELLS = 1 << 20
_REGION_THREADS = 256      # the region kernel's block


def _run_rows(shape, halo: int) -> int:
    """Rows a thread of the run kernel: one, in blocks of 16 warps (16
    rows), up to a halo of 2, and of 3 on planes of fewer than 2^20 cells;
    else three. One row gives a thread a third of the dependent arithmetic
    a sweep, so the small planes, where a launch is a chain of latencies,
    ran 0.7-2.4 us faster at 2 sweeps; at 512 x 2048 it also won by 1.3-
    3.1 us up to a halo of 2, and at 3 lost 0.1-0.2 us in bfloat16
    (smooth_residual on the fused path; it won 1.0-1.3 in float32), where
    a 16-row block keeps 10 rows of tile against 18 of 24
    (tools/kernel_times.py --variants on the H100). `shape` is a case's
    (ny, nx), or a stack's (B, ny, nx): the rows follow the plane."""
    big = shape[-2] * shape[-1] >= _ONE_ROW_BELOW_CELLS
    return 1 if halo <= _ONE_ROW_MAX_HALO - big else _RUN_ROWS


def _run_warps(halo: int, rows: int = _RUN_ROWS) -> int:
    """Warps of a run-kernel block (stacked in y) for a halo of `halo`
    rows and `rows` rows a thread. Three rows: 8 (24 rows) up to a halo
    of 3, so that the tile keeps at least 3/4 of the region's rows, and
    16 (48 rows, one block an SM) for the deeper halos; at 2 sweeps, 4 and
    8 warps timed alike and 16 up to 1.3 us slower a launch at 256 x 1024.
    One row: 16 (32 lost 0.3-3.4 us at every level but one, a tie).
    tools/kernel_times.py --variants on the H100."""
    if rows == 1:
        return 16
    return 8 if halo <= 3 else 16


@dataclasses.dataclass(frozen=True)
class MultisweepGeometry:
    """The launch of a multisweep kernel (jacobi_multisweep of two or more
    sweeps, smooth_residual, corr_smooth) over (ny, nx) operands. `run`:
    a thread owns a run of `cells` consecutive cells (16 bytes) on `rows`
    rows, a block `warps` warps stacked in y and `_RUN_LANES` runs along x
    (csrc/pressure_stencil.cu `multisweep_run_kernel`); `region`: the
    region kernel (`pressure_stencil_kernel`, square regions of `REGION`
    cells, one cell a thread at a time, `cells` and `rows` 1). `halo` is
    (rows, columns) on each side of the output `tile` (rows, columns);
    `grid` (blocks along x, blocks along y, planes: the cases of a stack,
    1 for one case)."""
    variant: str
    cells: int
    rows: int
    warps: int
    halo: tuple
    tile: tuple
    grid: tuple

    @property
    def region(self) -> tuple:
        return (self.tile[0] + 2 * self.halo[0],
                self.tile[1] + 2 * self.halo[1])


def _run_geometry(shape, dtype, halo: int,
                  rows: int = _RUN_ROWS) -> MultisweepGeometry:
    """The run kernel's geometry: a halo of `halo` rows and of the
    smallest whole number of runs >= halo columns; `rows` rows a thread,
    in blocks of `_run_warps(halo, rows)` warps; a plane a case of a
    (B, ny, nx) `shape`."""
    *lead, ny, nx = shape
    run = 16 // dtype.itemsize
    warps = _run_warps(halo, rows)
    hx = -(-halo // run) * run
    tile = (warps * rows - 2 * halo, _RUN_LANES * run - 2 * hx)
    return MultisweepGeometry("run", run, rows, warps, (halo, hx), tile,
                              (-(-nx // tile[1]), -(-ny // tile[0]),
                               lead[0] if lead else 1))


def _region_geometry(shape, halo: int) -> MultisweepGeometry:
    *lead, ny, nx = shape
    t = REGION - 2 * halo
    return MultisweepGeometry("region", 1, 1, _REGION_THREADS // 32,
                              (halo, halo), (t, t),
                              (-(-nx // t), -(-ny // t),
                               lead[0] if lead else 1))


def multisweep_geometry(shape, dtype, iters: int, aligned: bool = True,
                        kernel: str = "jacobi_multisweep"):
    """The launch geometry of `kernel` ("jacobi_multisweep",
    "smooth_residual" or "corr_smooth") for (ny, nx) or (B, ny, nx)
    operands of `dtype` and `iters` sweeps. `aligned`: every operand's
    base address is a multiple of 16 bytes. The choice below follows a
    case's plane, and a stack's grid takes its cases along z. The halo
    is `iters` rows, and `iters` + 1 for smooth_residual (its residual
    reads one more ring).
    - One sweep of jacobi_multisweep is one pass of the single-pass
      kernels (jacobi_sweep's, bit for bit the same arithmetic): the
      `PassGeometry` of `pass_geometry`, vector or cell variant. It
      measured faster than the run kernel at every float32 level of the
      512 x 2048 hierarchy (tools/kernel_times.py on the H100: 16.1
      against 17.6 us at 512 x 2048, 1.7 against 3.0 us at 16 x 64).
    - Otherwise the run kernel on aligned rows of whole 16-byte runs, one
      or three rows a thread (`_run_rows`);
    - the region kernel on the rest (odd widths such as the
      Schaefer-Turek levels, offset views) and on planes of fewer than
      `_REGION_BELOW_CELLS` cells."""
    ny, nx = shape[-2:]
    halo = iters + (kernel == "smooth_residual")
    if ny * nx < _REGION_BELOW_CELLS:
        return _region_geometry(shape, halo)
    if kernel == "jacobi_multisweep" and iters == 1:
        return pass_geometry(shape, dtype, aligned)
    if aligned and nx % (16 // dtype.itemsize) == 0:
        return _run_geometry(shape, dtype, halo, _run_rows(shape, halo))
    return _region_geometry(shape, halo)


# the most blocks of one window launch (csrc/pressure_stencil.cu and
# csrc/momentum_multisweep.cu `MAX_WINDOW_BLOCKS`)
MAX_WINDOW_BLOCKS = 64


def window_geometry(blocks: int, shape, dtype, iters: int,
                    aligned: bool = True):
    """The geometry of jacobi_multisweep's window launch (the sharded
    multisweep, ops/sharded.py) over `blocks` mesh blocks of `shape`
    (nyl, nxl) of one card, or None where the window form cannot take
    them. The launch is sized by its cells, all the blocks', as one plane
    of (blocks * nyl, nxl) would be by `multisweep_geometry`:
    - one sweep: the single-pass kernels (`pass_geometry` over (blocks,
      nyl, nxl), the vector variant from `_VECTOR_MIN_CELLS` cells in
      all);
    - two or more: the run kernel over one block (`_run_geometry`, its
      rows a thread by `_run_rows` of the launch's cells), the blocks
      along z (its grid's third entry).
    None (the exchange route) where the region kernel would take that
    plane (`_REGION_BELOW_CELLS`), where a block's width is no whole
    number of 16-byte runs or an operand is off 16 bytes (a window's
    origin must start a run), and beyond `MAX_WINDOW_BLOCKS` blocks."""
    nyl, nxl = shape
    if not (aligned and nxl % (16 // dtype.itemsize) == 0
            and 0 < blocks <= MAX_WINDOW_BLOCKS):
        return None
    whole = multisweep_geometry((blocks * nyl, nxl), dtype, iters)
    if isinstance(whole, PassGeometry):
        return pass_geometry((blocks, nyl, nxl), dtype,
                             cells=blocks * nyl * nxl)
    if whole.variant != "run":
        return None
    return _run_geometry((blocks, nyl, nxl), dtype, iters, whole.rows)


def kernel_available_for(shape, dtype=torch.float32,
                         kernel: str = "jacobi") -> bool:
    """True when the named kernel takes fields of `shape` and `dtype`.
    The counterpart of the TPU package's `pallas_available_for` (its
    scoped-VMEM fit of row bands): the CUDA kernels tile in 2-D with
    bounds-checked reads, so every (ny, nx) fits, up to CUDA's grid limit
    on the number of tiles in y and on the cases of a (B, ny, nx) shape
    (every kernel takes a stack, its cases along z). `kernel` is "jacobi"
    (the multisweep), "smooth_residual", "corr_smooth", "matvec" or
    "jacobi_sweep"."""
    if kernel not in ("jacobi", "smooth_residual", "corr_smooth",
                      *_PASS_KERNELS):
        raise ValueError(f"unknown kernel {kernel!r}")
    if len(shape) not in (2, 3) or min(shape) < 1 or dtype not in _DTYPES \
            or (len(shape) == 3 and shape[0] > _MAX_GRID_Z):
        return False
    if kernel in _PASS_KERNELS:
        # both variants: the operands' alignment picks one at launch
        return all(pass_geometry(shape, dtype, aligned).grid[1]
                   <= _MAX_GRID_Y for aligned in (True, False))
    # every tile has a row at least, and one pass of jacobi_multisweep a
    # block row per row of cells at most; taller planes: every geometry
    # the wrapper can launch (each iters, either alignment) must fit
    if shape[-2] <= _MAX_GRID_Y:
        return True
    name = "jacobi_multisweep" if kernel == "jacobi" else kernel
    return all(multisweep_geometry(shape, dtype, iters, aligned,
                                   kernel=name).grid[1] <= _MAX_GRID_Y
               for iters in range(_max_iters(dtype, name) + 1)
               for aligned in (True, False))


# ---- plain versions ----------------------------------------------------


def _omega(omega: float, dtype) -> float:
    """omega rounded to the operand dtype, as the TPU kernels pass it."""
    return float(torch.tensor(omega, dtype=dtype))


def stencil_matvec_plain(coef, x):
    """A x = diag*x - c_e*E(x) - c_w*W(x) - c_n*N(x) - c_s*S(x), evaluated
    left to right: the one plain expression of the pressure operator."""
    return (coef.diag * x - coef.c_e * nb_e(x) - coef.c_w * nb_w(x)
            - coef.c_n * nb_n(x) - coef.c_s * nb_s(x))


def stencil_matvec_grad_plain(coef, x, g, need=(True,) * 6):
    """The reverse of `stencil_matvec_plain` at x for the upstream
    gradient g: (dx, dc_e, dc_w, dc_n, dc_s, ddiag), each None where
    `need` (a StencilMatvec's needs_input_grad: x, c_e, c_w, c_n, c_s,
    diag) says False. A need not be symmetric: dx = A^T g, the transposed
    stencil, zero beyond the domain and across the planes of a stack;
    each coefficient's gradient is g times the x it multiplies. Evaluated
    left to right in the operand dtype, rounded after every operation, as
    the kernel of csrc/stencil_grad.cu computes it."""
    want_x, want_e, want_w, want_n, want_s, want_d = need
    dx = (coef.diag * g - nb_w(coef.c_e * g) - nb_e(coef.c_w * g)
          - nb_s(coef.c_n * g) - nb_n(coef.c_s * g)) if want_x else None
    return (dx,
            -(g * nb_e(x)) if want_e else None,
            -(g * nb_w(x)) if want_w else None,
            -(g * nb_n(x)) if want_n else None,
            -(g * nb_s(x)) if want_s else None,
            g * x if want_d else None)


def _sweeps(coef, x, b, iters, om):
    for _ in range(iters):
        x = x + om * (b - stencil_matvec_plain(coef, x)) / coef.diag
    return x


def jacobi_multisweep_plain(coef, x, b, iters: int = 2, omega: float = 0.8):
    """`iters` damped-Jacobi sweeps x <- x + omega*(b - A x)/diag."""
    return _sweeps(coef, x, b, iters, _omega(omega, x.dtype))


# one sweep a launch or all in one launch: the same arithmetic
jacobi_sweep_plain = jacobi_multisweep_plain


def smooth_residual_plain(coef, x, b, iters: int = 2, omega: float = 0.8):
    """(x after `iters` sweeps, b - A x of that x)."""
    x = _sweeps(coef, x, b, iters, _omega(omega, x.dtype))
    return x, b - stencil_matvec_plain(coef, x)


def corr_smooth_plain(coef, x, corr, b, iters: int = 2, omega: float = 0.8):
    """`iters` sweeps from x + corr (rounded to the operand dtype)."""
    return _sweeps(coef, x + corr, b, iters, _omega(omega, x.dtype))


# ---- kernels -------------------------------------------------------------


def _fn(entry: str, n_ptr: int, scalars):
    lib = build.load(_NAME)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + list(scalars) \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pressure_stencil_error_string.argtypes = [ctypes.c_int]
        lib.pressure_stencil_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(name, coef, fields, iters, kernel):
    """Returns True for CPU operands (take the plain version), False for
    CUDA operands the kernel takes; raises on anything else: another
    dtype, mixed dtypes, shapes or devices, a strided operand, too many
    iterations, and on CUDA an operand that requires a gradient, but for
    the matvec (its backward is `stencil_matvec_grad`)."""
    x = fields[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    top = None if kernel in _PASS_KERNELS else _max_iters(x.dtype, kernel)
    if iters < 0 or (top is not None and iters > top):
        raise ValueError(f"{name}: iters={iters} outside [0, {top}] for "
                         f"{x.dtype}")
    ops = (*fields, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag)
    for t in ops:
        if t.device != x.device or t.dtype != x.dtype \
                or t.shape != x.shape:
            raise ValueError(
                f"{name} takes operands of one shape and dtype on one "
                f"device; got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"beside {x.dtype} {tuple(x.shape)} on {x.device}")
    # the same layout contract on both devices, so that CPU runs catch a
    # caller that would hand the kernel a strided or broadcast view
    if not kernel_available_for(tuple(x.shape), x.dtype, kernel):
        raise ValueError(f"{name} kernel cannot take shape {tuple(x.shape)}")
    for t in ops:
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous operands")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")
    if kernel != "matvec" and torch.is_grad_enabled() \
            and any(t.requires_grad for t in ops):
        raise ValueError(
            f"the {name} kernel has no backward (nor has the JAX package's "
            "Pallas kernel: it has no reverse mode); call it under "
            "torch.no_grad(), or differentiate through the plain smoother")
    return False


def _launch_multisweep(name, entry, coef, fields, outs, iters, omega):
    """One launch of the multisweep kernel `entry` over every case of the
    operands ((ny, nx) or (B, ny, nx)) in the geometry of
    `multisweep_geometry`, into `outs` (x, and r for smooth_residual);
    returns that geometry."""
    x = fields[0]
    ny, nx = x.shape[-2:]
    ptrs = [t.data_ptr() for t in (*fields, coef.c_e, coef.c_w, coef.c_n,
                                   coef.c_s, coef.diag, *outs)]
    geom = multisweep_geometry(tuple(x.shape), x.dtype, iters,
                               aligned=all(p % 16 == 0 for p in ptrs),
                               kernel=entry)
    if isinstance(geom, PassGeometry):    # one sweep: a single pass
        return _launch_pass(name, "jacobi_sweep", coef, fields, outs[0],
                            omega, geom)
    lib, fn = _fn(f"{entry}_{_DTYPES[x.dtype]}", len(ptrs),
                  (ctypes.c_int,) * 12 + (ctypes.c_float,))
    args = (geom.grid[2], ny, nx, iters, int(geom.variant == "run"),
            geom.rows, geom.warps, geom.halo[1], *geom.tile, *geom.grid[:2],
            _omega(omega, x.dtype))
    with torch.cuda.device(x.device):   # launch on the operands' card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptrs, *args, stream)
    _raise_on(lib, name, err)
    return geom


def _launch_pass(name, entry, coef, fields, out, omega=None, geom=None):
    """One launch of a single-pass kernel over every plane of `out`, in
    the geometry of `pass_geometry` (or `geom`, computed for these
    operands); returns that geometry."""
    x = fields[0]
    scalars = (ctypes.c_int,) * 10 + ((ctypes.c_float,) if omega is not None
                                      else ())
    lib, fn = _fn(f"{entry}_{_DTYPES[x.dtype]}", len(fields) + 6, scalars)
    *lead, ny, nx = x.shape
    ops = (*fields, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag, out)
    ptrs = [t.data_ptr() for t in ops]
    if geom is None:
        geom = pass_geometry(x.shape, x.dtype,
                             aligned=all(p % 16 == 0 for p in ptrs))
    args = (geom.grid[2], ny, nx, int(geom.vector), geom.cells, geom.rows,
            *geom.block, *geom.grid[:2]) \
        + ((_omega(omega, x.dtype),) if omega is not None else ())
    with torch.cuda.device(x.device):   # launch on the operands' card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptrs, *args, stream)
    _raise_on(lib, name, err)
    return geom


def _launch_window(coef, x, b, out, iters, omega, block, origins, halo,
                  geom):
    """One window launch of jacobi_multisweep in `geom` (`window_geometry`)
    over the mesh blocks of shape `block` = (nyl, nxl) at the (row,
    column) `origins` in the global (ny, nx) operands, each reaching
    `halo` = (hy, hx) cells beyond it; writes those blocks' interiors of
    `out`. The caller checks the operands and counts the launch."""
    ny, nx = x.shape
    ops = (x, b, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag, out)
    pairs = (ctypes.c_int * (2 * len(origins)))(*(c for o in origins
                                                   for c in o))
    window = (ny, nx, *block, *halo, len(origins), pairs)
    dt = _DTYPES[x.dtype]
    if isinstance(geom, PassGeometry):
        lib, fn = _fn(f"jacobi_sweep_window_{dt}", len(ops),
                      (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
                      + (ctypes.c_int,) * 7 + (ctypes.c_float,))
        args = (int(geom.vector), geom.cells, geom.rows, *geom.block,
                *geom.grid[:2])
    else:
        lib, fn = _fn(f"jacobi_multisweep_window_{dt}", len(ops),
                      (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
                      + (ctypes.c_int,) * 9 + (ctypes.c_float,))
        args = (iters, 1, geom.rows, geom.warps, geom.halo[1], *geom.tile,
                *geom.grid[:2])
    with torch.cuda.device(x.device):   # launch on the operands' card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ops), *window, *args,
                 _omega(omega, x.dtype), stream)
    _raise_on(lib, "jacobi_multisweep_sharded", err)


def _count(fn, variant, x):
    """One launch of a kernel: its count, and its count by variant, dtype
    and plane shape."""
    fn.launches += 1
    fn.by_shape[variant, _DTYPES[x.dtype], tuple(x.shape[-2:])] += 1


def _raise_on(lib, name, err):
    if err != 0:
        msg = lib.pressure_stencil_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


# the five operands of the matvec, as StencilMatvec takes them apart
_Operator = collections.namedtuple("_Operator", "c_e c_w c_n c_s diag")


def _matvec(coef, x):
    if _check("stencil_matvec", coef, (x,), 0, "matvec"):
        return stencil_matvec_plain(coef, x)
    out = torch.empty_like(x)
    geom = _launch_pass("stencil_matvec", "stencil_matvec", coef, (x,), out)
    _count(stencil_matvec, geom.variant, x)
    return out


class StencilMatvec(torch.autograd.Function):
    """A x with a reverse mode: apply(x, c_e, c_w, c_n, c_s, diag). The
    forward is `stencil_matvec`'s launch (its plain version on CPU
    tensors), the backward `stencil_matvec_grad` for the inputs that need
    a gradient (its kernel on CUDA tensors, its plain version on CPU
    tensors). Once differentiable: no second derivative is taken.
    `taped` counts the forwards (on either device): a backward launches
    stencil_matvec_grad once for each that reaches the differentiated
    output, and a matvec with no operand that needs a gradient is not
    taped."""

    taped = 0

    @staticmethod
    def forward(ctx, x, c_e, c_w, c_n, c_s, diag):
        ctx.save_for_backward(x, c_e, c_w, c_n, c_s, diag)
        StencilMatvec.taped += 1
        return _matvec(_Operator(c_e, c_w, c_n, c_s, diag), x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *coef = ctx.saved_tensors
        return stencil_matvec_grad(_Operator(*coef), x, g.contiguous(),
                                   ctx.needs_input_grad)


def stencil_matvec(coef, x):
    """A x in one launch of csrc/pressure_stencil.cu on (ny, nx) or
    (B, ny, nx) operands (replaces the TPU kernel `stencil_matvec_pallas`,
    tpufoam/ops/stencil.py:221). On CPU tensors: `stencil_matvec_plain`.
    Where autograd records (an operand requires a gradient) the same
    launch runs as `StencilMatvec`, whose backward launches
    `stencil_matvec_grad`."""
    ops = (x, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return StencilMatvec.apply(*ops)
    return _matvec(coef, x)


def stencil_matvec_grad(coef, x, g, need=(True,) * 6):
    """The reverse of `stencil_matvec` at x for the upstream gradient g
    (as `stencil_matvec_grad_plain`: (dx, dc_e, dc_w, dc_n, dc_s, ddiag),
    None where `need` says False) in one launch of csrc/stencil_grad.cu
    on (ny, nx) or (B, ny, nx) operands; a gradient not asked for is not
    computed. It replaces no TPU kernel: the JAX package differentiates
    its plain matvec through XLA. On CPU tensors:
    `stencil_matvec_grad_plain`."""
    need = tuple(bool(n) for n in need)
    if _check("stencil_matvec_grad", coef, (x, g), 0, "matvec"):
        return stencil_matvec_grad_plain(coef, x, g, need)
    outs = tuple(torch.empty_like(x) if n else None for n in need)
    if not any(need):
        return outs
    lib = build.load(_GRAD_NAME)
    fn = getattr(lib, f"stencil_matvec_grad_{_DTYPES[x.dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.stencil_grad_error_string.argtypes = [ctypes.c_int]
        lib.stencil_grad_error_string.restype = ctypes.c_char_p
    *lead, ny, nx = x.shape
    ptrs = [t.data_ptr() for t in (g, x, coef.c_e, coef.c_w, coef.c_n,
                                   coef.c_s, coef.diag)] \
        + [None if t is None else t.data_ptr() for t in outs]
    with torch.cuda.device(x.device):   # launch on the operands' card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptrs, lead[0] if lead else 1, ny, nx, stream)
    if err != 0:
        msg = lib.stencil_grad_error_string(err).decode()
        raise RuntimeError(f"stencil_matvec_grad launch failed: {msg}")
    _count(stencil_matvec_grad, "cell", x)
    return outs


def jacobi_sweep(coef, x, b, iters: int = 2, omega: float = 0.8):
    """`iters` damped-Jacobi sweeps, one launch of csrc/pressure_stencil.cu
    each, through two ping-pong buffers: one device-memory round trip of x
    per sweep, as the TPU kernel `jacobi_sweep_pallas`
    (tpufoam/ops/stencil.py:245) it replaces. Takes (ny, nx) or
    (B, ny, nx) operands and any iters >= 0. On CPU tensors:
    `jacobi_sweep_plain`."""
    if _check("jacobi_sweep", coef, (x, b), iters, "jacobi_sweep"):
        return jacobi_sweep_plain(coef, x, b, iters, omega)
    bufs = [torch.empty_like(x) for _ in range(min(iters, 2))]
    for k in range(iters):
        geom = _launch_pass("jacobi_sweep", "jacobi_sweep", coef, (x, b),
                            bufs[k % 2], omega)
        _count(jacobi_sweep, geom.variant, x)
        x = bufs[k % 2]
    return x


def jacobi_multisweep(coef, x, b, iters: int = 2, omega: float = 0.8):
    """`iters` <= halo damped-Jacobi sweeps in one launch of
    csrc/pressure_stencil.cu on (ny, nx) or (B, ny, nx) operands, in the
    geometry of `multisweep_geometry` (replaces the TPU kernel
    `jacobi_multisweep_pallas`, tpufoam/ops/stencil.py:520, and its
    vmapped form). On CPU tensors: `jacobi_multisweep_plain`."""
    if _check("jacobi_multisweep", coef, (x, b), iters, "jacobi"):
        return jacobi_multisweep_plain(coef, x, b, iters, omega)
    out = torch.empty_like(x)
    geom = _launch_multisweep("jacobi_multisweep", "jacobi_multisweep", coef,
                              (x, b), (out,), iters, omega)
    _count(jacobi_multisweep, geom.variant, x)
    return out


def smooth_residual(coef, x, b, iters: int = 2, omega: float = 0.8):
    """The V-cycle down leg, `iters` <= halo - 1 sweeps then the residual,
    in one launch on (ny, nx) or (B, ny, nx) operands in the geometry of
    `multisweep_geometry`; returns (x, r). Replaces the TPU kernel
    `smooth_residual_pallas`, tpufoam/ops/stencil.py:629, and its vmapped
    form. On CPU tensors: `smooth_residual_plain`."""
    if _check("smooth_residual", coef, (x, b), iters, "smooth_residual"):
        return smooth_residual_plain(coef, x, b, iters, omega)
    outs = (torch.empty_like(x), torch.empty_like(x))
    geom = _launch_multisweep("smooth_residual", "smooth_residual", coef,
                              (x, b), outs, iters, omega)
    _count(smooth_residual, geom.variant, x)
    return outs


def corr_smooth(coef, x, corr, b, iters: int = 2, omega: float = 0.8):
    """The V-cycle up leg, x + corr then `iters` <= halo sweeps, in one
    launch on (ny, nx) or (B, ny, nx) operands in the geometry of
    `multisweep_geometry`. Replaces the TPU kernel `corr_smooth_pallas`,
    tpufoam/ops/stencil.py:722, and its vmapped form. On CPU tensors:
    `corr_smooth_plain`."""
    if _check("corr_smooth", coef, (x, corr, b), iters, "corr_smooth"):
        return corr_smooth_plain(coef, x, corr, b, iters, omega)
    out = torch.empty_like(x)
    geom = _launch_multisweep("corr_smooth", "corr_smooth", coef,
                              (x, corr, b), (out,), iters, omega)
    _count(corr_smooth, geom.variant, x)
    return out


# launches, and launches by (variant, dtype, (ny, nx)): "vector" or "cell"
# for the single-pass kernels (and one sweep of jacobi_multisweep), "run"
# or "region" for the multisweep kernels (all three), "cell" for the
# matvec's backward
for _fn_ in (stencil_matvec, stencil_matvec_grad, jacobi_sweep,
             jacobi_multisweep, smooth_residual, corr_smooth):
    _fn_.launches = 0
    _fn_.by_shape = collections.Counter()
del _fn_
