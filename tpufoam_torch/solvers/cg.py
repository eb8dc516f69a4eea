"""Jacobi-preconditioned conjugate gradient for the pressure Poisson solve.

Two exit modes: rtol/atol convergence (`pcg_pressure`, a Python loop that
reads the residual norm on the host once per iteration), and a fixed
iteration count (`pcg_fixed_iters`, the capped polish of a warm start; no
host read).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fv.pressure import PressureCoeffs, pressure_matvec


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor  # final |r| / |b|


def diag_precond(coef: PressureCoeffs) -> torch.Tensor:
    return 1.0 / coef.diag


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.flatten(), b.flatten())


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
    b_norm = torch.clamp(torch.linalg.norm(b), min=atol)
    gate = float(torch.clamp(rtol * b_norm, min=atol))
    k = 0
    while k < maxiter and float(torch.linalg.norm(r)) > gate:
        ap = pressure_matvec(coef, p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return CGResult(x=x, iters=k, residual=torch.linalg.norm(r) / b_norm)


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
        alpha = rz / torch.clamp(_dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = _dot(r, z)
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
    b_norm = torch.clamp(torch.linalg.norm(b), min=1e-30)
    return CGResult(x=x, iters=iters, residual=torch.linalg.norm(r) / b_norm)
