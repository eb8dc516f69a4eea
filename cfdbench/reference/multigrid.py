"""Geometric multigrid for the pressure Poisson equation.

On a structured grid the agglomeration is 2x2 cell coarsening and every
smoother and transfer is a stencil pass; the smoother is damped Jacobi,
in plain PyTorch on every level (the program's kernel smoothers run the
same sweeps). The coarsest level takes `coarse_iters` sweeps.

Galerkin-lite coarsening: coarse-level face conductances are built by
summing the fine conductances across each coarse face, so solid-blanked
cells and Dirichlet outlet coefficients coarsen without re-discretization.
Odd level sizes are zero-padded to even with solid cells (`_pad_even`).
Operands are (ny, nx), or ([B,] ny, nx) with a leading case axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .pressure import PressureCoeffs, pressure_matvec


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


def fluid_mask(coef: PressureCoeffs, dtype) -> torch.Tensor:
    """1 where a level's cell has an open face, else 0: the prolonged
    correction is masked with it."""
    return ((coef.c_e + coef.c_w + coef.c_n + coef.c_s + coef.c_out)
            > 0).to(dtype)


def _cycle(levels: list[PressureCoeffs], lvl: int, b: torch.Tensor,
           x: torch.Tensor, pre: int, post: int,
           coarse_iters: int) -> torch.Tensor:
    """The V cycle from level `lvl` down."""
    coef = levels[lvl]
    if lvl == len(levels) - 1:
        return jacobi_smooth(coef, x, b, coarse_iters)
    x = jacobi_smooth(coef, x, b, pre)
    r = b - pressure_matvec(coef, x)
    rc = restrict(r)
    ec = _cycle(levels, lvl + 1, rc, torch.zeros_like(rc), pre, post,
                coarse_iters)
    # mask the interpolated correction so it cannot leak into solid
    # cells; crop it back to the (possibly odd) fine shape
    ny, nx = coef.diag.shape[-2:]
    corr = (prolong(ec)[..., :ny, :nx]
            * fluid_mask(coef, b.dtype)).contiguous()
    return jacobi_smooth(coef, x + corr, b, post)


def _cast_levels(levels: list[PressureCoeffs],
                 dtype) -> list[PressureCoeffs]:
    return [PressureCoeffs(*(getattr(c, f.name).to(dtype)
                             for f in dataclasses.fields(c)))
            for c in levels]


def mg_solve(coef: PressureCoeffs, b: torch.Tensor, x0: torch.Tensor,
             cycles: int = 4, pre: int = 2, post: int = 2,
             min_size: int = 8, dtype=None, max_levels: int = 12,
             coarse_iters: int = 40) -> torch.Tensor:
    """A fixed number of V(pre, post) cycles. With `dtype` (e.g.
    torch.bfloat16) each cycle runs in residual-correction form: an f32
    residual, a correction built in `dtype` from a zero guess, the
    iterate kept in f32."""
    levels = build_hierarchy(coef, min_size=min_size, max_levels=max_levels)
    levels_lp = _cast_levels(levels, dtype) if dtype is not None else None
    x = x0
    for _ in range(cycles):
        if dtype is None:
            x = _cycle(levels, 0, b, x, pre, post, coarse_iters)
        else:
            r = b - pressure_matvec(coef, x)
            e = _cycle(levels_lp, 0, r.to(dtype),
                       torch.zeros_like(r, dtype=dtype), pre, post,
                       coarse_iters)
            x = x + e.to(r.dtype)
    return x
