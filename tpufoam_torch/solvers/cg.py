"""Jacobi-preconditioned conjugate gradient for the pressure Poisson solve.

Two exit modes: rtol/atol convergence (`pcg_pressure`, a Python loop that
reads the residual norms on the host once per iteration), and a fixed
iteration count (`pcg_fixed_iters`, the capped polish of a warm start; no
host read).

Operands are (ny, nx) or (B, ny, nx). With a case axis the norms, inner
products and step lengths are per case (each case reduced as it would be
alone), and a case that has converged is frozen while the others iterate
(a batched lax.while_loop's semantics), so each case takes the
iterations it would take alone.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fv.case import per_case
from ..fv.pressure import PressureCoeffs, pressure_matvec


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int | torch.Tensor   # per case (B,) for a batched solve
    residual: torch.Tensor      # final |r| / |b|, per case


def diag_precond(coef: PressureCoeffs) -> torch.Tensor:
    return 1.0 / coef.diag


def _per_case(reduce, x: torch.Tensor) -> torch.Tensor:
    """`reduce` of each case's (ny, nx) field: () or (B,). A stack is
    reduced case by case, so that each case's sum is grouped as it would
    be alone (one reduction over a (B, ny, nx) tensor may group a case's
    float32 sum differently, and the bf16 multigrid after an escalated
    solve turns that last bit into percents)."""
    if x.dim() == 2:
        return reduce(x)
    return torch.stack([reduce(x[k]) for k in range(x.shape[0])])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-case inner product over the last two dims: () or (B,)."""
    return _per_case(lambda x: x.sum(dim=(-2, -1)), a * b)


def _norm(a: torch.Tensor) -> torch.Tensor:
    """Per-case 2-norm over the last two dims: () or (B,)."""
    return _per_case(lambda x: torch.linalg.vector_norm(x, dim=(-2, -1)), a)


def _running(more: torch.Tensor, k: np.ndarray, limit: int) -> np.ndarray:
    """Host copy of the per-case loop condition `more & (k < limit)`: the
    loop's one host read per iteration."""
    return more.cpu().numpy() & (k < limit)


def _keep(active: np.ndarray, new: tuple, old: tuple) -> tuple:
    """Each case's new value where it is still active, its old one where
    it has stopped (per-case scalars and fields alike)."""
    if active.all():
        return new
    mask = torch.as_tensor(active, device=new[0].device)
    return tuple(torch.where(mask.reshape(mask.shape + (1,) * (n.dim()
                                                             - mask.dim())),
                             n, o) for n, o in zip(new, old))


def _iters(k: np.ndarray) -> int | torch.Tensor:
    return int(k) if k.ndim == 0 else torch.as_tensor(k)


def pcg_pressure(coef: PressureCoeffs, b: torch.Tensor,
                 x0: torch.Tensor | None = None, rtol: float = 1e-6,
                 atol: float = 1e-12, maxiter: int = 500) -> CGResult:
    """Solve A x = b with A the SPD pressure operator."""
    x = torch.zeros_like(b) if x0 is None else x0
    minv = diag_precond(coef)

    r = b - pressure_matvec(coef, x)
    z = minv * r
    p = z
    rz = _dot(r, z)
    b_norm = torch.clamp(_norm(b), min=atol)
    gate = torch.clamp(rtol * b_norm, min=atol)
    k = np.zeros(b.shape[:-2], dtype=np.int64)
    while (active := _running(_norm(r) > gate, k, maxiter)).any():
        ap = pressure_matvec(coef, p)
        alpha = per_case(rz / _dot(p, ap))
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z = minv * r_new
        rz_new = _dot(r_new, z)
        p_new = z + per_case(rz_new / rz) * p
        x, r, p, rz = _keep(active, (x_new, r_new, p_new, rz_new),
                            (x, r, p, rz))
        k += active
    return CGResult(x=x, iters=_iters(k), residual=_norm(r) / b_norm)


def pcg_fixed_iters(coef: PressureCoeffs, b: torch.Tensor, x0: torch.Tensor,
                    iters: int = 6) -> CGResult:
    """Exactly `iters` PCG iterations: the capped polish of a warm start."""
    minv = diag_precond(coef)
    x = x0
    r = b - pressure_matvec(coef, x)
    z = minv * r
    p = z
    rz = _dot(r, z)
    for _ in range(iters):
        ap = pressure_matvec(coef, p)
        alpha = per_case(rz / torch.clamp(_dot(p, ap), min=1e-30))
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = _dot(r, z)
        p = z + per_case(rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
    b_norm = torch.clamp(_norm(b), min=1e-30)
    return CGResult(x=x, iters=iters, residual=_norm(r) / b_norm)
