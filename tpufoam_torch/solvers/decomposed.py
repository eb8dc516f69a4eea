"""The pressure solvers on fields resident per block of a mesh
(parallel.blocks): the multigrid cycle, fixed and to a residual, V-cycle-
preconditioned CG, Jacobi-preconditioned CG and the AutoBackend, each
equal in its arithmetic to its whole-field form (solvers.multigrid,
solvers.cg, solvers.backends).

Every cell of a block runs the whole solver's operations on the same
values:
- `pressure_matvec` runs per block on a window of one cell, with the
  stencil_matvec kernel on the card;
- the smoothers run on a window as deep as their sweeps and one more
  ring, which the down leg's residual reads (the trapezoid argument:
  after s sweeps a cell s or more cells inside the window is exact), with
  the kernel the whole level would take (`multigrid._smooth`,
  `_fused_ok`, decided on the level's whole shape), launched per block;
- `restrict` runs per block on a window of two fine cells (an even
  offset keeps its parity), `prolong` on a window of one coarse cell, and
  `coarsen_coeffs` on each block alone, while the blocks' dims are even.
So a fixed number of cycles equals the whole solve bit for bit. The
solves that stop on a residual read norms summed per block, then over
the blocks in mesh order (parallel.blocks.dot, norm); their sums round
differently from one whole-field reduction, so their iterates and exits
may differ by the solver's tolerance.

Agglomeration. A level stays on the blocks while it is not the coarsest
and its blocks are even and at least `min_size` cells (and the down
leg's window) along each axis. From the first level that is not, the
level's operands are gathered whole to the lead device (each process's,
in a world: every process solves the tail alike), the rest of the
hierarchy is built and cycled whole there, the coarsest level's
`coarse_iters` sweeps included, and the correction goes back to the
blocks (`parallel.blocks.whole_field_stage("coarse")`). At 512 x 2048 on
a 2 x 2 mesh that is the coarsest level, 8 x 32. A mesh whose blocks
cannot hold the finest level raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fv.pressure import PressureCoeffs, pressure_matvec
from ..ops import stencil
from ..parallel.blocks import (BlockField, bmap, crop, dot, norm, split,
                               value, whole_field_stage, windows)
from . import multigrid as mg
from .backends import AutoBackend, CGBackend, MGBackend, MGCGBackend
from .cg import CGResult

# the operands the stencil kernels read (c_out is folded into diag)
_STENCIL = ("c_e", "c_w", "c_n", "c_s", "diag")


class BlockOperator:
    """A pressure operator of BlockFields (halo-free blocks), with each
    block's window of its coefficients for a halo, exchanged once and
    kept (`window(h)`): what the per-block stencils read."""

    def __init__(self, coef: PressureCoeffs):
        self.coef = coef
        self.mesh = coef.diag.mesh
        self.shape = coef.diag.shape
        self._wins: dict = {}

    def window(self, h: int) -> dict:
        """{k: PressureCoeffs of block k's windows of halo h} (c_out
        None: no kernel reads it)."""
        if h not in self._wins:
            per = windows([getattr(self.coef, n) for n in _STENCIL], h)
            self._wins[h] = {k: PressureCoeffs(
                c_e=w[0], c_w=w[1], c_n=w[2], c_s=w[3], c_out=None,
                diag=w[4]) for k, w in per.items()}
        return self._wins[h]

    def local_dims(self) -> tuple[int, int]:
        k = self.mesh.local_blocks[0]
        return tuple(self.coef.diag.blocks[k].shape[-2:])


def _on_windows(op: BlockOperator, h: int, fn, fields, n_out: int = 1):
    """fn(coef window, *field windows) per block, each output cropped to
    the block's own cells."""
    cw = op.window(h)
    per = windows(fields, h)
    # the kernels take contiguous operands (a window is, but for a block
    # that no exchange touched)
    outs = {k: fn(cw[k], *(t.contiguous() for t in w))
            for k, w in per.items()}
    res = []
    for n in range(n_out):
        blocks = [None] * op.mesh.size
        for k, o in outs.items():
            t = o[n] if n_out > 1 else o
            blocks[k] = crop(op.mesh, op.shape, k, t, h)
        res.append(BlockField(op.mesh, op.shape, blocks))
    return res if n_out > 1 else res[0]


def matvec(op: BlockOperator, x: BlockField) -> BlockField:
    """A x per block (`pressure_matvec` on windows of one cell)."""
    return _on_windows(op, 1, pressure_matvec, [x])


def residual(op: BlockOperator, b: BlockField, x: BlockField) -> BlockField:
    return bmap(torch.sub, b, matvec(op, x))


# ---- the hierarchy -------------------------------------------------------


@dataclasses.dataclass
class Hierarchy:
    """The block levels (BlockOperators, finest first) and the whole
    levels below them (`tail`, PressureCoeffs on the lead device, the
    first one the agglomerated level); `lp` and `tail_lp` the same cast
    to the correction's dtype, or None."""
    levels: list
    tail: list
    lp: list | None = None
    tail_lp: list | None = None


def _block_level_ok(op: BlockOperator, pre: int, post: int,
                    min_size: int) -> bool:
    ny, nx = op.local_dims()
    need = max(min_size, pre + 1, post, 2)
    return ny % 2 == 0 and nx % 2 == 0 and ny >= need and nx >= need


def _coarsen(op: BlockOperator) -> BlockOperator:
    """coarsen_coeffs of each block alone (its dims even: the 2 x 2
    agglomerates never straddle two blocks)."""
    names = [f.name for f in dataclasses.fields(PressureCoeffs)]
    per = {k: mg.coarsen_coeffs(PressureCoeffs(
        *(getattr(op.coef, n).blocks[k] for n in names)))
        for k in op.mesh.local_blocks}
    ny, nx = op.shape
    shape = ((ny + 1) // 2, (nx + 1) // 2)
    return BlockOperator(PressureCoeffs(*(BlockField(
        op.mesh, shape, [getattr(per[k], n) if k in per else None
                         for k in range(op.mesh.size)])
        for n in names)))


def _cast(op: BlockOperator, dtype) -> BlockOperator:
    return BlockOperator(PressureCoeffs(*(
        bmap(lambda t: t.to(dtype), getattr(op.coef, f.name))
        for f in dataclasses.fields(PressureCoeffs))))


def _gather(op: BlockOperator) -> PressureCoeffs:
    return PressureCoeffs(*(getattr(op.coef, f.name).gather()
                            for f in dataclasses.fields(PressureCoeffs)))


def build_hierarchy(op: BlockOperator, pre: int, post: int,
                    min_size: int = 8, max_levels: int = 12,
                    dtype=None) -> Hierarchy:
    """The levels of `multigrid.build_hierarchy` (the same count: each
    level's whole dims decide, as there), on the blocks down to the
    agglomerated level and whole from it."""
    shape, n = op.shape, 1
    while n < max_levels and mg._can_coarsen(*shape, min_size):
        n += 1
        shape = ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    if n == 1 or not _block_level_ok(op, pre, post, min_size):
        raise ValueError(
            f"the mesh's blocks of {op.local_dims()} cells cannot hold the "
            f"multigrid's finest level (blocks of even dims, at least "
            f"{max(min_size, pre + 1, post, 2)} cells a side)")
    levels = [op]
    while True:
        nxt = _coarsen(levels[-1])
        if len(levels) + 1 == n or not _block_level_ok(nxt, pre, post,
                                                       min_size):
            break
        levels.append(nxt)
    with whole_field_stage("coarse"):
        tail = [_gather(nxt)]
        while len(levels) + len(tail) < n:
            tail.append(mg.coarsen_coeffs(tail[-1]))
        tail_lp = mg._cast_levels(tail, dtype) if dtype is not None \
            else None
    lp = [_cast(lv, dtype) for lv in levels] if dtype is not None else None
    return Hierarchy(levels, tail, lp, tail_lp)


# ---- the cycle -----------------------------------------------------------


def _restrict(op_fine: BlockOperator, r: BlockField) -> BlockField:
    """restrict per block on a window of two fine cells; each block's own
    coarse cells."""
    ny, nx = op_fine.shape
    coarse = ((ny + 1) // 2, (nx + 1) // 2)
    mesh = op_fine.mesh
    blocks = [None] * mesh.size
    for k, (w,) in windows([r], 2).items():
        blocks[k] = crop(mesh, coarse, k, mg.restrict(w), 1)
    return BlockField(mesh, coarse, blocks)


def _prolong(op_fine: BlockOperator, e: BlockField) -> BlockField:
    """prolong per block on a window of one coarse cell; each block's own
    fine cells, masked with the level's fluid cells, contiguous."""
    mesh = op_fine.mesh
    blocks = [None] * mesh.size
    for k, (w,) in windows([e], 1).items():
        c = PressureCoeffs(*(getattr(op_fine.coef, f.name).blocks[k]
                             for f in dataclasses.fields(PressureCoeffs)))
        blocks[k] = (crop(mesh, op_fine.shape, k, mg.prolong(w), 2)
                     * mg.fluid_mask(c, w.dtype)).contiguous()
    return BlockField(mesh, op_fine.shape, blocks)


def _cycle(levels, tail, lvl: int, b: BlockField, x: BlockField, pre: int,
           post: int, coarse_iters: int, smoother: str,
           cycle_type: str) -> BlockField:
    """multigrid._cycle on the block levels from `lvl` down, the whole
    tail below them."""
    op = levels[lvl]
    shape = op.shape
    fused = mg._fused_ok(op.coef, pre, smoother, shape=shape)

    def down(c, xw, bw):
        if fused:
            return stencil.smooth_residual(c, xw, bw, iters=pre)
        xw = mg._smooth(c, xw, bw, pre, smoother, shape=shape)
        return xw, bw - pressure_matvec(c, xw)

    x, r = _on_windows(op, pre + 1, down, [x, b], n_out=2)
    rc = _restrict(op, r)
    args = (pre, post, coarse_iters, smoother, cycle_type)
    w_cycle = cycle_type == "w" and lvl + 1 < len(levels) + len(tail) - 1
    if lvl + 1 < len(levels):
        ec = _cycle(levels, tail, lvl + 1, rc, bmap(torch.zeros_like, rc),
                    *args)
        if w_cycle:
            ec = _cycle(levels, tail, lvl + 1, rc, ec, *args)
    else:
        with whole_field_stage("coarse"):
            rw = rc.gather()
            ew = mg._cycle(tail, 0, rw, torch.zeros_like(rw), *args)
            if w_cycle:
                ew = mg._cycle(tail, 0, rw, ew, *args)
            ec = split(op.mesh, ew, halo=(1, 1))
    corr = _prolong(op, ec)
    if fused:
        return _on_windows(op, post, lambda c, xw, cw, bw:
                           stencil.corr_smooth(c, xw, cw, bw, iters=post),
                           [x, corr, b])
    return _on_windows(op, post, lambda c, xw, bw: mg._smooth(
        c, xw, bw, post, smoother, shape=shape),
        [bmap(torch.add, x, corr), b])


def v_cycle(h: Hierarchy, b: BlockField, x: BlockField, pre: int = 2,
            post: int = 2, coarse_iters: int = 40, smoother: str = "plain",
            cycle_type: str = "v", low: bool = False) -> BlockField:
    """One cycle (multigrid.v_cycle, counted there) on `h`'s levels, or on
    its reduced-precision levels with `low`."""
    mg._check_smoother(smoother)
    mg.v_cycle.cycles += 1
    levels, tail = (h.lp, h.tail_lp) if low else (h.levels, h.tail)
    return _cycle(levels, tail, 0, b, x, pre, post, coarse_iters, smoother,
                  cycle_type)


def v_cycle_correction(h: Hierarchy, r: BlockField, pre: int, post: int,
                       dtype, smoother: str = "plain",
                       cycle_type: str = "v",
                       coarse_iters: int = 40) -> BlockField:
    """multigrid.v_cycle_correction on the blocks."""
    if dtype is None:
        return v_cycle(h, r, bmap(torch.zeros_like, r), pre, post,
                       coarse_iters, smoother, cycle_type)
    r_lp = bmap(lambda t: t.to(dtype), r)
    e = v_cycle(h, r_lp, bmap(torch.zeros_like, r_lp), pre, post,
                coarse_iters, smoother, cycle_type, low=True)
    return bmap(lambda t: t.to(r.dtype), e)


def _larger(a: BlockField, b: BlockField) -> bool:
    return bool(value(bmap(torch.gt, a, b)))


def mg_solve(op: BlockOperator, b: BlockField, x0: BlockField,
             cycles: int = 4, pre: int = 2, post: int = 2, min_size: int = 8,
             dtype=None, smoother: str = "plain", max_levels: int = 12,
             coarse_iters: int = 40, rtol: float = 0.0) -> BlockField:
    """multigrid.mg_solve on the blocks."""
    h = build_hierarchy(op, pre, post, min_size, max_levels, dtype)

    def correction(r):
        return v_cycle_correction(h, r, pre, post, dtype, smoother,
                                  coarse_iters=coarse_iters)

    x = x0
    if rtol and rtol > 0.0:
        gate = bmap(lambda n: rtol * (n + 1e-30), norm(b))
        r = residual(op, b, x)
        k = 0
        while k < cycles and _larger(norm(r), gate):
            x = bmap(torch.add, x, correction(r))
            r = residual(op, b, x)
            k += 1
        return x
    for _ in range(cycles):
        if dtype is None:
            x = v_cycle(h, b, x, pre, post, coarse_iters, smoother)
        else:
            x = bmap(torch.add, x, correction(residual(op, b, x)))
    return x


def mgcg_pressure(op: BlockOperator, b: BlockField, x0: BlockField = None,
                  rtol: float = 1e-6, atol: float = 1e-12,
                  maxiter: int = 60, pre: int = 1, post: int = 1,
                  min_size: int = 8, dtype=None, smoother: str = "plain",
                  cycle_type: str = "v") -> CGResult:
    """multigrid.mgcg_pressure on the blocks (dots summed per block, then
    over the blocks in mesh order)."""
    h = build_hierarchy(op, pre, post, min_size, dtype=dtype)
    x = bmap(torch.zeros_like, b) if x0 is None else x0

    def precond(r):
        return v_cycle_correction(h, r, pre, post, dtype, smoother,
                                  cycle_type=cycle_type)

    return _cg(op, b, x, precond, rtol, atol, maxiter, clamp_pap=True)


def _cg(op, b, x, precond, rtol, atol, maxiter, clamp_pap):
    """The CG loop of solvers.cg / mgcg_pressure on the blocks."""
    r = residual(op, b, x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    b_norm = bmap(lambda n: torch.clamp(n, min=atol), norm(b))
    gate = bmap(lambda n: torch.clamp(rtol * n, min=atol), b_norm)
    k = 0
    while k < maxiter and _larger(norm(r), gate):
        ap = matvec(op, p)
        pap = dot(p, ap)
        alpha = bmap(lambda a, c: a / (torch.clamp(c, min=1e-30)
                                          if clamp_pap else c), rz, pap)
        x = bmap(lambda x_, a, p_: x_ + a * p_, x, alpha, p)
        r = bmap(lambda r_, a, q: r_ - a * q, r, alpha, ap)
        z = precond(r)
        rz_new = dot(r, z)
        beta = bmap(lambda a, c: a / (torch.clamp(c, min=1e-30)
                                         if clamp_pap else c), rz_new, rz)
        p = bmap(lambda z_, bt, p_: z_ + bt * p_, z, beta, p)
        rz = rz_new
        k += 1
    return CGResult(x=x, iters=k,
                    residual=bmap(torch.div, norm(r), b_norm))


def pcg_pressure(op: BlockOperator, b: BlockField, x0: BlockField = None,
                 rtol: float = 1e-6, atol: float = 1e-12,
                 maxiter: int = 500) -> CGResult:
    """cg.pcg_pressure on the blocks."""
    x = bmap(torch.zeros_like, b) if x0 is None else x0
    minv = bmap(lambda d: 1.0 / d, op.coef.diag)
    return _cg(op, b, x, lambda r: bmap(torch.mul, minv, r), rtol, atol,
               maxiter, clamp_pap=False)


def solve(backend, case, op: BlockOperator, rhs: BlockField,
          p_prev: BlockField) -> BlockField:
    """backend(case, coef, rhs, p_prev, aux) on the blocks, for the
    backends that have a decomposed form: MGBackend, MGCGBackend,
    CGBackend and AutoBackend. Any other raises."""
    def masked(p):
        return bmap(torch.mul, p, case.fluid)

    if isinstance(backend, MGBackend):
        return masked(mg_solve(op, rhs, p_prev, **backend.solve_kwargs()))
    if isinstance(backend, MGCGBackend):
        return masked(mgcg_pressure(op, rhs, x0=p_prev,
                                    **backend.solve_kwargs()).x)
    if isinstance(backend, CGBackend):
        return masked(pcg_pressure(op, rhs, x0=p_prev, rtol=backend.rtol,
                                   maxiter=backend.maxiter).x)
    if isinstance(backend, AutoBackend):
        dtype = torch.bfloat16 if backend.precision == "bf16" else None
        p1 = masked(mg_solve(op, rhs, p_prev, cycles=backend.cycles,
                             dtype=dtype))
        r = norm(masked(residual(op, rhs, p1)))
        bn = norm(masked(rhs))
        if value(bmap(lambda a, c: a <= backend.tau * c, r, bn)):
            return p1
        edtype = torch.bfloat16 if backend.escalate_precision == "bf16" \
            else None
        return masked(mgcg_pressure(op, rhs, x0=p1, rtol=backend.rtol,
                                    maxiter=backend.maxiter,
                                    dtype=edtype).x)
    raise TypeError(f"{type(backend).__name__} has no decomposed form; "
                    "the decomposed step takes MGBackend, MGCGBackend, "
                    "CGBackend or AutoBackend")
