"""Geometric multigrid for the pressure Poisson equation.

On a structured grid the agglomeration is 2x2 cell coarsening and every
smoother and transfer is a stencil pass; the smoother is damped Jacobi.

Galerkin-lite coarsening: coarse-level face conductances are built by
summing the fine conductances across each coarse face, so solid-blanked
cells and Dirichlet outlet coefficients coarsen without re-discretization.
Odd level sizes are zero-padded to even with solid cells (`_pad_even`).

The smoother of every level but the coarsest is chosen by `smoother`
(the JAX package's name in brackets):
  "plain"         (xla)           `jacobi_smooth`, plain PyTorch;
  "kernel"        (pallas)        the `ops.stencil.jacobi_multisweep`
                                  kernel, all sweeps in one launch;
  "kernel-fused"  (pallas-fused)  the fused legs `ops.stencil.
                                  smooth_residual` (pre-smooth + residual)
                                  and `ops.stencil.corr_smooth` (correction
                                  add + post-smooth).
The coarsest level always takes `coarse_iters` sweeps of `jacobi_smooth`.
Used standalone (`mg_solve`) or as the preconditioner of CG
(`mgcg_pressure`).

Every function takes ([B,] ny, nx) operands: a leading case axis (the
batched fleet) or none. The kernel smoothers take a fleet's stack in one
launch a level (the kernels' case axis), each level choosing its kernel on
a case's (ny, nx), as the JAX package's vmapped cycle sees it: each case
takes the route it would take alone. The loops that stop on a residual
(`mg_solve` with rtol, `mgcg_pressure`) stop per case: a finished case is
frozen while any other still runs, as a batched lax.while_loop freezes it,
so each case takes the iterations it would take alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..fv.case import per_case
from ..fv.pressure import PressureCoeffs, pressure_matvec
from ..ops import stencil
from .cg import CGResult, _dot, _iters, _keep, _norm, _running

SMOOTHERS = ("plain", "kernel", "kernel-fused")


def _can_coarsen(ny: int, nx: int, min_size: int = 8) -> bool:
    return ny >= 2 * min_size and nx >= 2 * min_size


def _pool2x2(f: torch.Tensor) -> torch.Tensor:
    *lead, ny, nx = f.shape
    return f.reshape(*lead, ny // 2, 2, nx // 2, 2).sum(dim=(-3, -1))


def _pad_even(a: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Pad the high end of any odd axis to even size with `fill`. Padded
    cells are solid (zero conductance, diag 1); zero-padding the residual
    before restriction and cropping the prolonged correction are adjoint
    maps, so the cycle stays symmetric."""
    ny, nx = a.shape[-2:]
    py, px = ny % 2, nx % 2
    if py or px:
        a = F.pad(a, (0, px, 0, py), value=fill)
    return a


def _pad_coeffs_even(coef: PressureCoeffs) -> PressureCoeffs:
    ny, nx = coef.diag.shape[-2:]
    if ny % 2 == 0 and nx % 2 == 0:
        return coef
    return PressureCoeffs(
        c_e=_pad_even(coef.c_e), c_w=_pad_even(coef.c_w),
        c_n=_pad_even(coef.c_n), c_s=_pad_even(coef.c_s),
        c_out=_pad_even(coef.c_out), diag=_pad_even(coef.diag, fill=1.0))


def _parity(n: int, like: torch.Tensor) -> torch.Tensor:
    """(n,) 0/1 parity of the index, in `like`'s dtype and device."""
    return (torch.arange(n, device=like.device) % 2).to(like.dtype)


def coarsen_coeffs(coef: PressureCoeffs) -> PressureCoeffs:
    """Agglomerate 2x2 fine cells into one coarse cell.

    Coarse face conductance = half the sum of the fine conductances
    crossing that face (a coarse face is twice as wide and twice as long
    in the normal direction); conductances interior to an agglomerate
    vanish. Odd input sizes are padded to even with solid cells first; the
    coarse level has shape (ceil(ny/2), ceil(nx/2)).
    """
    coef = _pad_coeffs_even(coef)
    ny, nx = coef.diag.shape[-2:]
    col_odd = _parity(nx, coef.diag)[None, :]
    row_odd = _parity(ny, coef.diag)[:, None]

    # east faces of a coarse cell = east faces of its right (odd) column
    c_e = 0.5 * _pool2x2(coef.c_e * col_odd)
    c_w = 0.5 * _pool2x2(coef.c_w * (1.0 - col_odd))
    c_n = 0.5 * _pool2x2(coef.c_n * row_odd)
    c_s = 0.5 * _pool2x2(coef.c_s * (1.0 - row_odd))
    c_out = 0.5 * _pool2x2(coef.c_out)

    interior = c_e + c_w + c_n + c_s + c_out
    solid = interior <= 0.0
    diag = torch.where(solid, 1.0, interior)
    z = torch.zeros_like(diag)
    return PressureCoeffs(
        c_e=torch.where(solid, z, c_e), c_w=torch.where(solid, z, c_w),
        c_n=torch.where(solid, z, c_n), c_s=torch.where(solid, z, c_s),
        c_out=torch.where(solid, z, c_out), diag=diag)


def _prolong1d(e: torch.Tensor, axis: int) -> torch.Tensor:
    """Cell-centred linear interpolation along one axis (-2: y, -1: x;
    weights 3/4, 1/4; edge-replicated at boundaries)."""
    e = torch.movedim(e, axis, 0)
    up = torch.cat([e[:1], e[:-1]], dim=0)      # e[I-1]
    dn = torch.cat([e[1:], e[-1:]], dim=0)      # e[I+1]
    even = 0.75 * e + 0.25 * up
    odd = 0.75 * e + 0.25 * dn
    out = torch.stack([even, odd], dim=1).reshape(2 * e.shape[0],
                                                  *e.shape[1:])
    return torch.movedim(out, 0, axis)


def _restrict1d_gather(r: torch.Tensor, axis: int) -> torch.Tensor:
    """Adjoint of `_prolong1d` along one axis (-2: y, -1: x), pre-pool form: g such that
    coarse[I] = g[2I] + g[2I+1]. The cross-pair taps land on parity slots
    (r[2I-1] on the even slot, r[2I+2] on the odd slot), with edge
    replication at the boundary rows."""
    r = torch.movedim(r, axis, 0)
    dn = torch.cat([r[:1], r[:-1]], dim=0)    # r[i-1], edge-repl.
    up = torch.cat([r[1:], r[-1:]], dim=0)    # r[i+1], edge-repl.
    par = _parity(r.shape[0], r).reshape(-1, *([1] * (r.dim() - 1)))
    g = 0.75 * r + 0.25 * ((1.0 - par) * dn + par * up)
    return torch.movedim(g, 0, axis)


def restrict(r: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction = adjoint of bilinear prolongation (row
    sums 2, pairing with the summed coarse operator). Odd inputs are
    zero-padded to even (adjoint of the crop in v_cycle)."""
    return _pool2x2(_restrict1d_gather(
        _restrict1d_gather(_pad_even(r), -2), -1))


def prolong(e: torch.Tensor) -> torch.Tensor:
    """Cell-centred bilinear prolongation (9/16, 3/16, 3/16, 1/16)."""
    return _prolong1d(_prolong1d(e, -2), -1)


def jacobi_smooth(coef: PressureCoeffs, x: torch.Tensor, b: torch.Tensor,
                  iters: int, omega: float = 0.8) -> torch.Tensor:
    inv_d = 1.0 / coef.diag
    for _ in range(iters):
        r = b - pressure_matvec(coef, x)
        x = x + omega * inv_d * r
    return x


def build_hierarchy(coef: PressureCoeffs, min_size: int = 8,
                    max_levels: int = 12) -> list[PressureCoeffs]:
    levels = [coef]
    while len(levels) < max_levels:
        ny, nx = levels[-1].diag.shape[-2:]
        if not _can_coarsen(ny, nx, min_size):
            break
        levels.append(coarsen_coeffs(levels[-1]))
    return levels


def _smooth(coef: PressureCoeffs, x: torch.Tensor, b: torch.Tensor,
            iters: int, smoother: str = "plain", omega: float = 0.8,
            shape=None) -> torch.Tensor:
    """One level's smoother. smoother="kernel" takes the multisweep kernel
    where the JAX package takes its Pallas kernel: when the kernel fits the
    level (`kernel_available_for` of a case's (ny, nx)) and iters <=
    `_halo_for(dtype)`; other levels, and other smoothers, take
    `jacobi_smooth`. This is the same deterministic choice the JAX package
    makes, not a fallback on failure: on a CUDA tensor the kernel launches
    (once for a fleet's stack) or raises. `shape` is the level's whole
    shape where x is one block's window of it (the decomposed solve: the
    block takes the whole level's choice)."""
    shape = tuple(x.shape[-2:]) if shape is None else tuple(shape)
    if (smoother == "kernel"
            and stencil.kernel_available_for(shape, x.dtype, "jacobi")
            and iters <= stencil._halo_for(x.dtype)):
        return stencil.jacobi_multisweep(coef, x, b, iters=iters,
                                         omega=omega)
    return jacobi_smooth(coef, x, b, iters, omega)


def _fused_ok(coef: PressureCoeffs, pre: int, smoother: str,
              shape=None) -> bool:
    """Whether a level takes the fused legs (smoother="kernel-fused"): both
    kernels fit the level and the down leg's extra residual ring stays
    inside the halo. Otherwise the level takes `_smooth` and a plain
    residual, as in the JAX package. `shape` as in `_smooth`; by default
    a case's (ny, nx)."""
    if smoother != "kernel-fused":
        return False
    shape = tuple(coef.diag.shape[-2:]) if shape is None else tuple(shape)
    dt = coef.diag.dtype
    return (pre <= stencil._halo_for(dt) - 1
            and stencil.kernel_available_for(shape, dt, "smooth_residual")
            and stencil.kernel_available_for(shape, dt, "corr_smooth"))


def fluid_mask(coef: PressureCoeffs, dtype) -> torch.Tensor:
    """1 where a level's cell has an open face, else 0: the prolonged
    correction is masked with it."""
    return ((coef.c_e + coef.c_w + coef.c_n + coef.c_s + coef.c_out)
            > 0).to(dtype)


def _cycle(levels: list[PressureCoeffs], lvl: int, b: torch.Tensor,
           x: torch.Tensor, pre: int, post: int, coarse_iters: int,
           smoother: str, cycle_type: str) -> torch.Tensor:
    """The cycle from level `lvl` down (see v_cycle)."""
    coef = levels[lvl]
    if lvl == len(levels) - 1:
        return jacobi_smooth(coef, x, b, coarse_iters)
    fused = _fused_ok(coef, pre, smoother)
    if fused:
        x, r = stencil.smooth_residual(coef, x, b, iters=pre)
    else:
        x = _smooth(coef, x, b, pre, smoother)
        r = b - pressure_matvec(coef, x)
    rc = restrict(r)
    args = (pre, post, coarse_iters, smoother, cycle_type)
    ec = _cycle(levels, lvl + 1, rc, torch.zeros_like(rc), *args)
    if cycle_type == "w" and lvl + 1 < len(levels) - 1:
        ec = _cycle(levels, lvl + 1, rc, ec, *args)
    # mask the interpolated correction so it cannot leak into solid
    # cells; crop it back to the (possibly odd) fine shape; make it
    # contiguous for the kernels (prolong's movedim leaves it strided)
    ny, nx = coef.diag.shape[-2:]
    corr = (prolong(ec)[..., :ny, :nx]
            * fluid_mask(coef, b.dtype)).contiguous()
    if fused:
        return stencil.corr_smooth(coef, x, corr, b, iters=post)
    return _smooth(coef, x + corr, b, post, smoother)


def _check_smoother(smoother: str):
    if smoother not in SMOOTHERS:
        raise ValueError(f"smoother {smoother!r} not in {SMOOTHERS}")


def v_cycle(levels: list[PressureCoeffs], b: torch.Tensor, x: torch.Tensor,
            pre: int = 2, post: int = 2, coarse_iters: int = 40,
            smoother: str = "plain", cycle_type: str = "v") -> torch.Tensor:
    """One V(pre, post) cycle over the level list, or a W cycle with
    cycle_type="w" (each coarse level visited twice per visit of the level
    above; with pre == post it stays a symmetric preconditioner).
    `v_cycle.cycles` counts the cycles run."""
    _check_smoother(smoother)
    v_cycle.cycles += 1
    return _cycle(levels, 0, b, x, pre, post, coarse_iters, smoother,
                  cycle_type)


v_cycle.cycles = 0


def _cast_levels(levels: list[PressureCoeffs],
                 dtype) -> list[PressureCoeffs]:
    return [PressureCoeffs(*(getattr(c, f.name).to(dtype)
                             for f in dataclasses.fields(c)))
            for c in levels]


def v_cycle_correction(levels: list[PressureCoeffs], levels_lp,
                       r: torch.Tensor, pre: int, post: int, dtype,
                       smoother: str = "plain", cycle_type: str = "v",
                       coarse_iters: int = 40) -> torch.Tensor:
    """e ~= A^-1 r by one cycle from a zero guess, in `dtype` when given
    (the correction is built in reduced precision from an f32 residual;
    the outer iterate and residual stay f32)."""
    if dtype is None:
        return v_cycle(levels, r, torch.zeros_like(r), pre, post,
                       coarse_iters=coarse_iters, smoother=smoother,
                       cycle_type=cycle_type)
    e = v_cycle(levels_lp, r.to(dtype), torch.zeros_like(r, dtype=dtype),
                pre, post, coarse_iters=coarse_iters, smoother=smoother,
                cycle_type=cycle_type)
    return e.to(r.dtype)


def mg_solve(coef: PressureCoeffs, b: torch.Tensor, x0: torch.Tensor,
             cycles: int = 4, pre: int = 2, post: int = 2,
             min_size: int = 8, dtype=None, smoother: str = "plain",
             max_levels: int = 12, coarse_iters: int = 40,
             rtol: float = 0.0) -> torch.Tensor:
    """A fixed number of V-cycles. With `dtype` (e.g. torch.bfloat16) each
    cycle runs in residual-correction form: f32 residual, reduced-precision
    correction.

    `rtol > 0` (residual-correction form, any `dtype`): `cycles` becomes
    the maximum and the loop exits once ||b - A x|| <= rtol * ||b||. The
    bf16 correction form has a noise floor near 0.10 relative residual;
    an rtol below it runs the full cycle cap. With a case axis each case
    exits on its own residual."""
    levels = build_hierarchy(coef, min_size=min_size, max_levels=max_levels)
    levels_lp = _cast_levels(levels, dtype) if dtype is not None else None
    if rtol and rtol > 0.0:
        gate = rtol * (_norm(b) + 1e-30)
        x = x0
        r = b - pressure_matvec(coef, x)
        k = np.zeros(b.shape[:-2], dtype=np.int64)
        while (active := _running(_norm(r) > gate, k, cycles)).any():
            x_new = x + v_cycle_correction(levels, levels_lp, r, pre, post,
                                           dtype, smoother=smoother,
                                           coarse_iters=coarse_iters)
            x, = _keep(active, (x_new,), (x,))
            r = b - pressure_matvec(coef, x)
            k += active
        return x
    x = x0
    for _ in range(cycles):
        if dtype is None:
            x = v_cycle(levels, b, x, pre, post, coarse_iters=coarse_iters,
                        smoother=smoother)
        else:
            r = b - pressure_matvec(coef, x)
            x = x + v_cycle_correction(levels, levels_lp, r, pre, post,
                                       dtype, smoother=smoother,
                                       coarse_iters=coarse_iters)
    return x


def mgcg_pressure(coef: PressureCoeffs, b: torch.Tensor,
                  x0: torch.Tensor | None = None, rtol: float = 1e-6,
                  atol: float = 1e-12, maxiter: int = 60, pre: int = 1,
                  post: int = 1, min_size: int = 8, dtype=None,
                  smoother: str = "plain",
                  cycle_type: str = "v") -> CGResult:
    """CG preconditioned by one V-cycle (a W cycle with cycle_type="w").
    `dtype` runs the preconditioner cycle in reduced precision; the CG
    vectors stay f32. Keep pre == post: an asymmetric cycle is not a
    symmetric preconditioner and stalls plain CG. The loop reads the
    residual norms on the host once per iteration; with a case axis each
    case stops on its own residual and `iters` counts per case."""
    levels = build_hierarchy(coef, min_size=min_size)
    levels_lp = _cast_levels(levels, dtype) if dtype is not None else None
    x = torch.zeros_like(b) if x0 is None else x0

    def precond(r):
        return v_cycle_correction(levels, levels_lp, r, pre, post, dtype,
                                  smoother=smoother, cycle_type=cycle_type)

    r = b - pressure_matvec(coef, x)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    b_norm = torch.clamp(_norm(b), min=atol)
    gate = torch.clamp(rtol * b_norm, min=atol)
    k = np.zeros(b.shape[:-2], dtype=np.int64)
    while (active := _running(_norm(r) > gate, k, maxiter)).any():
        ap = pressure_matvec(coef, p)
        alpha = per_case(rz / torch.clamp(_dot(p, ap), min=1e-30))
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z = precond(r_new)
        rz_new = _dot(r_new, z)
        beta = per_case(rz_new / torch.clamp(rz, min=1e-30))
        p_new = z + beta * p
        x, r, p, rz = _keep(active, (x_new, r_new, p_new, rz_new),
                            (x, r, p, rz))
        k += active
    return CGResult(x=x, iters=_iters(k), residual=_norm(r) / b_norm)
