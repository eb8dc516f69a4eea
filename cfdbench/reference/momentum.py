"""Momentum-predictor finite-volume coefficients (the UEqn).

Implicit FV discretization of
    ddt(U) + div(phi, U) - laplacian(nu, U) == -grad(p)
with Euler ddt, upwind implicit convection plus the limitedLinearV
deferred correction, and central diffusion on a uniform cut-cell grid,
laminar. The solve is a fixed number of Jacobi sweeps. Fields are
([B,] ny, nx): a leading case axis, or none.

Units: integrated FV (a in m^2/s for 2D unit depth); aP/V == UEqn.A(),
(sum a_nb U_nb + b)/V == UEqn.H().
"""

from __future__ import annotations

import dataclasses

import torch

from .stencil import MAX_SWEEPS, momentum_multisweep
from .case import Case, domain_row_masks, grid_metrics, per_case
from .operators import clip, maximum, nb_e, nb_n, nb_s, nb_w


@dataclasses.dataclass
class MomentumCoeffs:
    a_e: torch.Tensor
    a_w: torch.Tensor
    a_n: torch.Tensor
    a_s: torch.Tensor
    a_p: torch.Tensor
    b_u: torch.Tensor  # explicit source for u (ddt old + inlet BC)
    b_v: torch.Tensor


_SHIFTS = {"e": nb_e, "w": nb_w, "n": nb_n, "s": nb_s}


def _apply_shift(spec, x):
    if spec is None:
        return x
    for d in (spec if isinstance(spec, tuple) else (spec,)):
        x = _SHIFTS[d](x)
    return x


def _safe_ratio(num, den, tiny=1e-12):
    ok = torch.abs(den) > tiny
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def _limited_linear_corrections(case: Case, f_e, f_w, f_n, f_s,
                                u: torch.Tensor, v: torch.Tensor,
                                k: float = 1.0):
    """limitedLinearV deferred correction for both velocity components.

    Per face the limiter psi = clip(2 r / k, 0, 1) scales the
    central-minus-upwind correction, with r the upwind gradient ratio
        r = (phi_U - phi_UU) / (phi_D - phi_U).
    One limiter per face for both components (the min over components);
    faces whose far-upwind cell is solid/outside fall back to upwind."""
    fl = case.fluid

    def psi_face(F, L, R, LL, RR, mLL, mRR):
        r_p = _safe_ratio(L - LL, R - L)
        r_m = _safe_ratio(R - RR, L - R)
        psi_p = clip(2.0 * r_p / k, 0.0, 1.0) * mLL
        psi_m = clip(2.0 * r_m / k, 0.0, 1.0) * mRR
        return torch.where(F > 0, psi_p, psi_m)

    def face_corr(F, L, R, psi, open_mask, w_left):
        central = w_left * L + (1.0 - w_left) * R
        upwind = torch.where(F > 0, L, R)
        # F already carries the face aperture — only gate on open
        return torch.where(open_mask > 0, F * psi * (central - upwind), 0.0)

    m = grid_metrics(case.grid)
    # (face flux, L-shift, R-shift, LL-shift, RR-shift, open mask, sign,
    #  left-cell interpolation weight)
    faces = (
        (f_e, None, "e", "w", ("e", "e"), case.open_e, +1.0, m.wx_e),
        (f_w, "w", None, ("w", "w"), "e", case.open_w, -1.0, 1.0 - m.wx_w),
        (f_n, None, "n", "s", ("n", "n"), case.open_n, +1.0, m.wy_n),
        (f_s, "s", None, ("s", "s"), "n", case.open_s, -1.0, 1.0 - m.wy_s),
    )
    corr_u = torch.zeros_like(u)
    corr_v = torch.zeros_like(v)
    for F, sl, sr, sll, srr, open_m, sign, w_left in faces:
        mLL = _apply_shift(sll, fl)
        mRR = _apply_shift(srr, fl)
        uL, uR = _apply_shift(sl, u), _apply_shift(sr, u)
        vL, vR = _apply_shift(sl, v), _apply_shift(sr, v)
        psi_u = psi_face(F, uL, uR, _apply_shift(sll, u),
                         _apply_shift(srr, u), mLL, mRR)
        psi_v = psi_face(F, vL, vR, _apply_shift(sll, v),
                         _apply_shift(srr, v), mLL, mRR)
        psi = torch.minimum(psi_u, psi_v)   # the shared V-scheme limiter
        corr_u = corr_u + sign * face_corr(F, uL, uR, psi, open_m, w_left)
        corr_v = corr_v + sign * face_corr(F, vL, vR, psi, open_m, w_left)
    return -corr_u, -corr_v


def momentum_coeffs(case: Case, phi_x: torch.Tensor, phi_y: torch.Tensor,
                    u_old: torch.Tensor, v_old: torch.Tensor,
                    dt: torch.Tensor) -> MomentumCoeffs:
    """UEqn coefficients: an upwind implicit matrix, no-slip walls
    (half-cell domain walls, embedded-wall link nu L_w / d_w on the
    obstacle), fixed-velocity inlet, Euler ddt, and the limitedLinearV-1
    deferred correction in the explicit source. `dt` is one per case: ()
    or (B,)."""
    dt = per_case(dt)
    nu = case.nu
    m = grid_metrics(case.grid)
    dx, dy = m.dxc, m.dyc
    vol = dx * dy
    # conductances: face area / centre-to-centre distance
    d_e = nu * m.dyc / m.hx_e
    d_w = nu * m.dyc / m.hx_w
    d_n = nu * m.dxc / m.hy_n
    d_s = nu * m.dxc / m.hy_s
    d_cx = nu * dy / dx
    d_cy = nu * dx / dy

    f_e = phi_x[..., 1:]
    f_w = phi_x[..., :-1]
    f_n = phi_y[..., 1:, :]
    f_s = phi_y[..., :-1, :]

    # face apertures scale the diffusive conductances; the convective
    # fluxes already carry the aperture, so the upwind coefficients only
    # need the open/closed gate
    a_e = case.open_e * d_e + torch.where(case.open_e > 0,
                                          maximum(-f_e, 0.0), 0.0)
    a_w = case.open_w * d_w + torch.where(case.open_w > 0,
                                          maximum(f_w, 0.0), 0.0)
    a_n = case.open_n * d_n + torch.where(case.open_n > 0,
                                          maximum(-f_n, 0.0), 0.0)
    a_s = case.open_s * d_s + torch.where(case.open_s > 0,
                                          maximum(f_s, 0.0), 0.0)

    dom_n, dom_s = domain_row_masks(case)
    wall_contrib = 2.0 * d_cy * (dom_n + dom_s)
    a_wall = nu * case.wall_len / case.wall_dist

    # inlet (fixed U): diffusion at half distance + upwinded inflow
    a_in = case.inlet_w * (2.0 * d_cx + maximum(f_w, 0.0))

    volc = case.alpha * vol
    div_f = f_e - f_w + f_n - f_s
    c1 = 1.0
    ddt_u = (volc / dt) * u_old
    ddt_v = (volc / dt) * v_old
    a_p = (a_e + a_w + a_n + a_s + wall_contrib + a_wall + a_in + div_f
           + c1 * volc / dt) * case.fluid + (1.0 - case.fluid)
    b_u = (ddt_u + a_in * case.inlet_u[..., :, None]) * case.fluid
    b_v = ddt_v * case.fluid
    cu, cv = _limited_linear_corrections(case, f_e, f_w, f_n, f_s,
                                         u_old, v_old)
    b_u = b_u + cu * case.fluid
    b_v = b_v + cv * case.fluid
    return MomentumCoeffs(a_e=a_e, a_w=a_w, a_n=a_n, a_s=a_s, a_p=a_p,
                          b_u=b_u, b_v=b_v)


def h_operator(coef: MomentumCoeffs, u: torch.Tensor, v: torch.Tensor):
    """H(U)*V = sum(a_nb U_nb) + b — the off-diagonal + source part."""
    hu = (coef.a_e * nb_e(u) + coef.a_w * nb_w(u)
          + coef.a_n * nb_n(u) + coef.a_s * nb_s(u) + coef.b_u)
    hv = (coef.a_e * nb_e(v) + coef.a_w * nb_w(v)
          + coef.a_n * nb_n(v) + coef.a_s * nb_s(v) + coef.b_v)
    return hu, hv


def jacobi_momentum(coef: MomentumCoeffs, case: Case,
                    u0: torch.Tensor, v0: torch.Tensor,
                    src_u: torch.Tensor, src_v: torch.Tensor,
                    sweeps: int = 4, smoother: str = "plain"):
    """Solve a_P U - sum a_nb U_nb = b + src by `sweeps` Jacobi sweeps.

    `src_*` carries the -grad(p)*V term. smoother='kernel' runs all sweeps
    as the program's multisweep kernel orders them (`stencil.
    momentum_multisweep`, its plain form); 'plain' runs the sweep loop, as
    does, as in the JAX package, a kernel smoother beyond the kernel's
    MAX_SWEEPS."""
    if smoother not in ("kernel", "plain"):
        raise ValueError(f"unknown momentum smoother {smoother!r}")
    inv_ap = 1.0 / coef.a_p
    if smoother == "kernel" and sweeps <= MAX_SWEEPS:
        ops = (coef.a_e, coef.a_w, coef.a_n, coef.a_s, inv_ap * case.fluid,
               coef.b_u + src_u, coef.b_v + src_v, u0, v0)
        return momentum_multisweep(*ops, sweeps=sweeps)
    u, v = u0, v0
    for _ in range(sweeps):
        hu, hv = h_operator(coef, u, v)
        u, v = ((hu + src_u) * inv_ap * case.fluid,
                (hv + src_v) * inv_ap * case.fluid)
    return u, v

