"""Pressure-equation assembly: Rhie-Chow collocated flux splitting.

  rAU      = 1/A(UEqn)                      -> inv_ap * V here
  HbyA     = rAU * H(UEqn)                  -> h/a_p
  phiHbyA  = fvc::flux(HbyA)                -> face_fluxes_hbya
  laplacian(rAU, p) == fvc::div(phiHbyA)    -> pressure_coeffs/matvec + rhs
  phi      = phiHbyA - pEqn.flux()          -> correct_fluxes
  U        = HbyA - rAU*fvc::grad(p)        -> pressure_gradient

BCs: zero-grad p on walls/inlet (closed coefficient), fixed p = 0 on the
outlet via a half-distance Dirichlet coefficient folded into the diagonal.
Every function takes ([B,] ny, nx) fields (a leading case axis or none).
"""

from __future__ import annotations

import dataclasses

import torch

from .case import Case, domain_row_masks, fluxes_from_velocity, grid_metrics
from . import stencil
from .operators import divergence, nb_e, nb_n, nb_s, nb_w


@dataclasses.dataclass
class PressureCoeffs:
    """5-point SPD operator A p = -laplacian(rAU, p) on fluid cells.

    c_* are the per-cell face conductances [s] toward each neighbour;
    diag = sum(c_*) + c_dirichlet. Solid cells have diag 1, c 0.
    """
    c_e: torch.Tensor
    c_w: torch.Tensor
    c_n: torch.Tensor
    c_s: torch.Tensor
    c_out: torch.Tensor   # Dirichlet (outlet) conductance, folded into diag
    diag: torch.Tensor


def pressure_coeffs(case: Case, rau: torch.Tensor) -> PressureCoeffs:
    m = grid_metrics(case.grid)

    rau_e = m.wx_e * rau + (1.0 - m.wx_e) * nb_e(rau)
    rau_w = m.wx_w * rau + (1.0 - m.wx_w) * nb_w(rau)
    rau_n = m.wy_n * rau + (1.0 - m.wy_n) * nb_n(rau)
    rau_s = m.wy_s * rau + (1.0 - m.wy_s) * nb_s(rau)

    c_e = case.open_e * rau_e * (m.dyc / m.hx_e)
    c_w = case.open_w * rau_w * (m.dyc / m.hx_w)
    c_n = case.open_n * rau_n * (m.dxc / m.hy_n)
    c_s = case.open_s * rau_s * (m.dxc / m.hy_s)
    c_out = case.outlet_e * rau * (2.0 * (m.dyc / m.dxc))  # half-distance Dirichlet

    diag = (c_e + c_w + c_n + c_s + c_out) * case.fluid + (1.0 - case.fluid)
    return PressureCoeffs(c_e=c_e, c_w=c_w, c_n=c_n, c_s=c_s,
                          c_out=c_out, diag=diag)


def pressure_matvec(coef: PressureCoeffs, p: torch.Tensor) -> torch.Tensor:
    """A @ p for the SPD pressure operator: the `ops.stencil.stencil_matvec`
    kernel on CUDA tensors, its plain expression on CPU tensors. The
    operands are contiguous and of one dtype and shape."""
    return stencil.stencil_matvec(coef, p)


def face_fluxes_hbya(case: Case, hbya_u: torch.Tensor, hbya_v: torch.Tensor):
    """phiHbyA = fvc::flux(HbyA) with boundary values constrained (the
    fixed-value inlet keeps the BC flux)."""
    return fluxes_from_velocity(case, hbya_u, hbya_v)


def pressure_rhs(case: Case, phi_x: torch.Tensor,
                 phi_y: torch.Tensor) -> torch.Tensor:
    """RHS of A p = b: b = -div(phiHbyA) on fluid cells (sign flipped
    because A = -laplacian)."""
    return -divergence(phi_x, phi_y) * case.fluid


def correct_fluxes(case: Case, coef: PressureCoeffs, p: torch.Tensor,
                   phi_x: torch.Tensor, phi_y: torch.Tensor):
    """phi = phiHbyA - pEqn.flux(): conservative face fluxes that satisfy
    discrete continuity at solver convergence. Returns new tensors."""
    phi_x = phi_x.clone()
    phi_y = phi_y.clone()
    # x-faces j=1..nx-1 between cells j-1, j: flux_p = c*(p_j - p_{j-1})
    phi_x[..., 1:-1] += -(coef.c_w[..., 1:] * (p[..., 1:] - p[..., :-1]))
    # outlet faces: p_face = 0 Dirichlet
    phi_x[..., -1] += -(coef.c_out[..., -1] * (0.0 - p[..., -1]))
    phi_y[..., 1:-1, :] += -(coef.c_s[..., 1:, :]
                             * (p[..., 1:, :] - p[..., :-1, :]))
    return phi_x, phi_y


def pressure_gradient(case: Case, p: torch.Tensor):
    """Gauss cell-centred grad(p) = (1/V_fluid) * sum_f p_f theta_f A_f n_f,
    including the embedded-wall closure term p_P * A_wall (zero-grad wall
    pressure). BC face values: zero-grad at walls/inlet (p_f = p_P),
    Dirichlet 0 at the outlet."""
    m = grid_metrics(case.grid)

    s_e = case.open_e * (m.wx_e * p + (1.0 - m.wx_e) * nb_e(p))
    s_w = case.open_w * (m.wx_w * p + (1.0 - m.wx_w) * nb_w(p)) \
        + case.inlet_w * p
    # outlet face: Dirichlet p = 0 -> contributes nothing
    dom_n, dom_s = domain_row_masks(case)
    s_n = case.open_n * (m.wy_n * p + (1.0 - m.wy_n) * nb_n(p)) + dom_n * p
    s_s = case.open_s * (m.wy_s * p + (1.0 - m.wy_s) * nb_s(p)) + dom_s * p

    sx = (s_e - s_w) * m.dyc + p * case.wall_ax
    sy = (s_n - s_s) * m.dxc + p * case.wall_ay
    inv_v = 1.0 / (torch.clamp(case.alpha, min=1e-6) * m.dxc * m.dyc)
    gpx = sx * inv_v * case.fluid
    gpy = sy * inv_v * case.fluid
    return gpx, gpy


def _norm(a: torch.Tensor) -> torch.Tensor:
    """Per-case 2-norm over the last two dims: () or (B,). A stack is
    reduced case by case, so that each case's sum is grouped as it would
    be alone."""
    if a.dim() == 2:
        return torch.linalg.vector_norm(a, dim=(-2, -1))
    return torch.stack([torch.linalg.vector_norm(a[k], dim=(-2, -1))
                        for k in range(a.shape[0])])
