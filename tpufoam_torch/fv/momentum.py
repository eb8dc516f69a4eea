"""Momentum-predictor finite-volume coefficients (the UEqn).

Implicit FV discretization of
    ddt(U) + div(phi, U) - laplacian(nu, U) == -grad(p)
with Euler or variable-step BDF2 ddt, upwind implicit convection plus a
deferred correction (limitedLinearV, or an unlimited central blend), and
central diffusion on a cut-cell grid, uniform or stretched, laminar or
with an eddy viscosity nu_t (nu_eff = nu + nu_t, with the transpose
term of div(nu_eff (grad U)^T)) and the log-law wall functions; the
embedded wall's no-slip link optionally carries a second-order shear
correction or acts on the tangential velocity only. The solve is a fixed
number of Jacobi sweeps. Fields are ([B,] ny, nx): a leading case
axis, or none.

Units: integrated FV (a in m^2/s for 2D unit depth); aP/V == UEqn.A(),
(sum a_nb U_nb + b)/V == UEqn.H().
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.momentum import MAX_SWEEPS, momentum_multisweep
from ..ops.sharded import momentum_multisweep_sharded, sharded_available_for
from .case import Case, domain_row_masks, grid_metrics, per_case
from .operators import clip, maximum, nb_e, nb_n, nb_s, nb_w, rdiv


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


def _deferred_central_correction(case: Case, f_e, f_w, f_n, f_s,
                                 phi: torch.Tensor,
                                 gamma: float) -> torch.Tensor:
    """Explicit deferred correction toward central differencing,
    -gamma * sum_f F_f (phi_f^central - phi_f^upwind) per cell; the
    implicit matrix stays upwind. Faces are oriented L->R along the
    positive axis: for a cell's east/north face the cell is L, for its
    west/south face the cell is R."""
    m = grid_metrics(case.grid, case.device)

    def face_corr(f_flux, left, right, open_mask, w_left):
        central = w_left * left + (1.0 - w_left) * right
        upwind = torch.where(f_flux > 0, left, right)
        # the flux already carries the face aperture: only gate on open
        return torch.where(open_mask > 0, f_flux * (central - upwind), 0.0)

    out = (face_corr(f_e, phi, nb_e(phi), case.open_e, m.wx_e)
           - face_corr(f_w, nb_w(phi), phi, case.open_w, 1.0 - m.wx_w)
           + face_corr(f_n, phi, nb_n(phi), case.open_n, m.wy_n)
           - face_corr(f_s, nb_s(phi), phi, case.open_s, 1.0 - m.wy_s))
    return -gamma * out


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

    m = grid_metrics(case.grid, case.device)
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


def _transpose_diffusion_source(case: Case, nu_t: torch.Tensor,
                                u: torch.Tensor, v: torch.Tensor):
    """div(nu_eff (grad U)^T), the transpose term of
    `turbulence->divDevSigma(U)`. For incompressible flow it reduces
    pointwise to (grad nu_t . d U_j/d x_i), nonzero only where the eddy
    viscosity varies:
        s_u = dnut/dx * du/dx + dnut/dy * dv/dx
        s_v = dnut/dx * du/dy + dnut/dy * dv/dy
    Per unit volume; the caller multiplies by V."""
    m = grid_metrics(case.grid, case.device)
    me, mw = nb_e(case.fluid), nb_w(case.fluid)
    mn, ms = nb_n(case.fluid), nb_s(case.fluid)

    def grad(f):
        fe = torch.where(me > 0, nb_e(f), f)
        fw = torch.where(mw > 0, nb_w(f), f)
        fn = torch.where(mn > 0, nb_n(f), f)
        fs = torch.where(ms > 0, nb_s(f), f)
        if not m.stretched:
            gx = (fe - fw) / (torch.clamp(me + mw, min=1.0) * m.dxc)
            gy = (fn - fs) / (torch.clamp(mn + ms, min=1.0) * m.dyc)
        else:
            # the actual centre spans; a one-sided (masked) neighbour
            # contributes its own distance
            gx = (fe - fw) / torch.maximum(me * m.hx_e + mw * m.hx_w,
                                           0.5 * m.dxc)
            gy = (fn - fs) / torch.maximum(mn * m.hy_n + ms * m.hy_s,
                                           0.5 * m.dyc)
        return gx, gy

    ntx, nty = grad(nu_t)
    dudx, dudy = grad(u)
    dvdx, dvdy = grad(v)
    s_u = ntx * dudx + nty * dvdx
    s_v = ntx * dudy + nty * dvdy
    return s_u * case.fluid, s_v * case.fluid


def wall_conductance(nu: float, k_wall: torch.Tensor, d,
                     kappa: float = 0.41, e_rough: float = 9.8,
                     cmu: float = 0.09):
    """Per-unit-area no-slip wall conductance g with tau_w = g * U_t.

    Low-Re (viscous) branch: g = nu / d (the half-cell link). Log-law
    branch (the k-based nutkWallFunction form): with u* = Cmu^{1/4}
    sqrt(k) and y* = u* d / nu, g = u* kappa / ln(E y*), the log clamped
    at 1 so that g_log vanishes with u* below the crossover. The branches
    combine as the 4-norm (g_vis^4 + g_log^4)^{1/4}, a Spalding-profile
    approximation. Independent of |U_t|: the momentum wall link stays
    implicit and linear. `d` is a Python number or a tensor."""
    ustar = cmu**0.25 * torch.sqrt(torch.clamp(k_wall, min=0.0))
    ystar = torch.clamp(ustar * d / nu, min=1e-10)
    g_log = ustar * kappa / torch.clamp(
        torch.log(torch.clamp(e_rough * ystar, min=1e-10)), min=1.0)
    g_vis = nu / d if not isinstance(d, torch.Tensor) else rdiv(nu, d)
    return (g_vis**4 + g_log**4) ** 0.25


def wall_unit_normal(case: Case):
    """Unit embedded-wall normal (n_x, n_y) per cell from the wall-area
    vector (case.wall_ax/ay); zero where the cell has no wall piece. Its
    sign follows A_w (into the body); every user is sign-invariant."""
    ax, ay = case.wall_ax, case.wall_ay
    amag = torch.hypot(ax, ay)
    ok = amag > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, amag, 1.0), 0.0)
    return ax * inv, ay * inv


def wall_normal_release(case: Case, a_wall: torch.Tensor,
                        u: torch.Tensor, v: torch.Tensor):
    """Deferred correction that restricts the embedded-wall no-slip link
    to the tangential velocity (PisoConfig.wall_link='tangential'): the
    source pair + a_wall (U.n) n, added to (b_u, b_v), so that at
    convergence the wall exerts only -a_wall (U.t) t on the fluid (the
    viscous traction of a no-slip wall has no normal component;
    no-penetration comes from the closed wall-face apertures)."""
    nx, ny = wall_unit_normal(case)
    un = u * nx + v * ny
    c = a_wall * un
    return c * nx * case.fluid, c * ny * case.fluid


def wall_shear2_source(case: Case, gpx: torch.Tensor, gpy: torch.Tensor):
    """Second-order wall-shear deferred correction (a source pair).

    At a stationary no-slip wall the tangential momentum equation reduces
    to nu d2u_t/dn2 = dp/ds, so the quadratic near-wall profile gives
    tau_w = nu U_t / d_w - (d_w / 2) dp/ds. The implicit matrix keeps the
    link nu L_w / d_w; this returns the explicit remainder
    + (L_w d_w / 2)(t . grad p) t for (b_u, b_v), and fv.forces subtracts
    the same term from the body force."""
    nx, ny = wall_unit_normal(case)
    tx, ty = -ny, nx                       # unit tangent (sign-invariant)
    dpds = tx * gpx + ty * gpy
    c = 0.5 * case.wall_len * case.wall_dist * dpds
    return c * tx * case.fluid, c * ty * case.fluid


def momentum_coeffs(case: Case, phi_x: torch.Tensor, phi_y: torch.Tensor,
                    u_old: torch.Tensor, v_old: torch.Tensor,
                    dt: torch.Tensor, *, convection_blend: float = 0.0,
                    nu_t: torch.Tensor | None = None,
                    convection: str = "blend",
                    k_turb: torch.Tensor | None = None,
                    ddt: str = "euler",
                    u_nm1: torch.Tensor | None = None,
                    v_nm1: torch.Tensor | None = None,
                    dt_prev: torch.Tensor | None = None,
                    wall_grad_p=None,
                    wall_link: str = "full") -> MomentumCoeffs:
    """UEqn coefficients: an upwind implicit matrix, no-slip walls
    (half-cell domain walls, embedded-wall link nu L_w / d_w on the
    obstacle), fixed-velocity inlet. `dt` is one per case: () or (B,).

    nu_t: optional (ny, nx) eddy viscosity: nu_eff = nu + nu_t in every
    conductance (face-interpolated), with the transpose-gradient term
    div(nu_eff (grad U)^T) in the source. None: the laminar path (scalar
    conductances).
    k_turb: optional turbulent kinetic energy: the no-slip wall links take
    the log-law wall-function conductance `wall_conductance` (the
    nutkWallFunction role); the wall_grad_p and wall_link options are off
    under it (the log law models the whole traction).

    convection: 'limitedLinear' adds the limitedLinearV-1 deferred
    correction to the explicit source; 'blend' adds an unlimited central
    correction scaled by `convection_blend` (0, the default, is pure
    upwind); 'upwind' adds none.

    ddt: 'euler', or 'backward', the variable-step BDF2 from u_nm1, v_nm1
    (u^{n-1}, the Flow.u_prev fields) and dt_prev (the previous step
    size). With r = dt/dt_prev the implicit coefficient c1 = (1+2r)/(1+r)
    enters a_P and the source carries (1+r) u^n - r^2/(1+r) u^{n-1}; on
    the bootstrap step (u^{n-1} == u^n) the two cancel to Euler's.

    wall_grad_p: optional (gpx, gpy) cell-centred pressure gradient; on a
    cut-cell case it adds the second-order wall-shear correction
    `wall_shear2_source` to (b_u, b_v) (PisoConfig.wall_order=2).
    wall_link: 'full' keeps the isotropic embedded-wall link;
    'tangential' adds `wall_normal_release` on a cut-cell case, so the
    link acts on the tangential velocity only."""
    if convection not in ("limitedLinear", "blend", "upwind"):
        raise ValueError(f"unknown convection scheme {convection!r}")
    if ddt not in ("euler", "backward"):
        raise ValueError(f"unknown ddt scheme {ddt!r}")
    if wall_link not in ("full", "tangential"):
        raise ValueError(f"unknown wall link {wall_link!r}")
    dt = per_case(dt)
    nu = case.nu
    # scalars on a uniform grid, (1, nx) / (ny, 1) tensors on a stretched
    m = grid_metrics(case.grid, case.device)
    dx, dy = m.dxc, m.dyc
    vol = dx * dy
    if nu_t is None:
        # conductances: face area / centre-to-centre distance
        d_e = nu * m.dyc / m.hx_e
        d_w = nu * m.dyc / m.hx_w
        d_n = nu * m.dxc / m.hy_n
        d_s = nu * m.dxc / m.hy_s
        d_cx = nu * dy / dx
        d_cy = nu * dx / dy
    else:
        nu_eff = nu + nu_t
        d_e = (m.wx_e * nu_eff + (1 - m.wx_e) * nb_e(nu_eff)) \
            * m.dyc / m.hx_e
        d_w = (m.wx_w * nu_eff + (1 - m.wx_w) * nb_w(nu_eff)) \
            * m.dyc / m.hx_w
        d_n = (m.wy_n * nu_eff + (1 - m.wy_n) * nb_n(nu_eff)) \
            * m.dxc / m.hy_n
        d_s = (m.wy_s * nu_eff + (1 - m.wy_s) * nb_s(nu_eff)) \
            * m.dxc / m.hy_s
        d_cx = nu_eff * dy / dx   # half-cell wall/inlet conductances
        d_cy = nu_eff * dx / dy

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
    if k_turb is not None:
        # turbulent wall functions: g = tau_w / U_t from the log law
        g_dom = wall_conductance(nu, k_turb, 0.5 * dy)
        g_obst = wall_conductance(nu, k_turb, case.wall_dist)
        wall_contrib = g_dom * dx * (dom_n + dom_s)
        a_wall = g_obst * case.wall_len
    else:
        wall_contrib = 2.0 * d_cy * (dom_n + dom_s)
        nu_w = nu if nu_t is None else nu_eff
        a_wall = nu_w * case.wall_len / case.wall_dist

    # inlet (fixed U): diffusion at half distance + upwinded inflow
    a_in = case.inlet_w * (2.0 * d_cx + maximum(f_w, 0.0))

    volc = case.alpha * vol
    div_f = f_e - f_w + f_n - f_s
    if ddt == "backward":
        r = dt / maximum(per_case(dt_prev), 1e-30)
        c1 = (1.0 + 2.0 * r) / (1.0 + r)
        ddt_u = (volc / dt) * ((1.0 + r) * u_old
                               - (r * r / (1.0 + r)) * u_nm1)
        ddt_v = (volc / dt) * ((1.0 + r) * v_old
                               - (r * r / (1.0 + r)) * v_nm1)
    else:
        c1 = 1.0
        ddt_u = (volc / dt) * u_old
        ddt_v = (volc / dt) * v_old
    a_p = (a_e + a_w + a_n + a_s + wall_contrib + a_wall + a_in + div_f
           + c1 * volc / dt) * case.fluid + (1.0 - case.fluid)
    b_u = (ddt_u + a_in * case.inlet_u[..., :, None]) * case.fluid
    b_v = ddt_v * case.fluid
    if convection == "limitedLinear":
        cu, cv = _limited_linear_corrections(case, f_e, f_w, f_n, f_s,
                                             u_old, v_old)
        b_u = b_u + cu * case.fluid
        b_v = b_v + cv * case.fluid
    elif convection == "blend" and convection_blend > 0.0:
        b_u = b_u + _deferred_central_correction(
            case, f_e, f_w, f_n, f_s, u_old, convection_blend) * case.fluid
        b_v = b_v + _deferred_central_correction(
            case, f_e, f_w, f_n, f_s, v_old, convection_blend) * case.fluid
    if nu_t is not None:
        s_u, s_v = _transpose_diffusion_source(case, nu_t, u_old, v_old)
        b_u = b_u + s_u * vol * case.fluid
        b_v = b_v + s_v * vol * case.fluid
    if wall_grad_p is not None and k_turb is None and case.cut:
        # cut-cell cases only: the stair force report carries no closure
        # corrections, so a blank grid keeps the first-order link
        ws_u, ws_v = wall_shear2_source(case, wall_grad_p[0], wall_grad_p[1])
        b_u = b_u + ws_u
        b_v = b_v + ws_v
    if wall_link == "tangential" and k_turb is None and case.cut:
        # deferred on u_old like the other corrections
        r_u, r_v = wall_normal_release(case, a_wall, u_old, v_old)
        b_u = b_u + r_u
        b_v = b_v + r_v
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
                    sweeps: int = 4, smoother: str = "plain", mesh=None):
    """Solve a_P U - sum a_nb U_nb = b + src by `sweeps` Jacobi sweeps.

    `src_*` carries the -grad(p)*V term. smoother='kernel' runs all sweeps
    in one call of ops.momentum.momentum_multisweep (the hand-written
    kernel on a CUDA tensor, its plain version on a CPU tensor), one call
    for every case of a (B, ny, nx) fleet. `mesh` (a parallel.mesh.Mesh)
    runs the kernel per block of the mesh on halo-extended blocks instead
    (ops.sharded.momentum_multisweep_sharded) where
    `sharded_available_for` takes the grid; a mesh it refuses runs the
    single kernel, since the fields are whole on one device (the JAX
    package runs its XLA loop there). 'plain' runs the sweep loop, as
    does, as in the JAX package, a kernel smoother beyond the kernel's
    MAX_SWEEPS. `jacobi_momentum.sweep_loops` counts the calls that ran
    the loop."""
    if smoother not in ("kernel", "plain"):
        raise ValueError(f"unknown momentum smoother {smoother!r}")
    inv_ap = 1.0 / coef.a_p
    if smoother == "kernel" and sweeps <= MAX_SWEEPS:
        ops = (coef.a_e, coef.a_w, coef.a_n, coef.a_s, inv_ap * case.fluid,
               coef.b_u + src_u, coef.b_v + src_v, u0, v0)
        if mesh is not None and sharded_available_for(
                tuple(u0.shape), mesh, dtype=u0.dtype, kernel="momentum"):
            return momentum_multisweep_sharded(mesh, *ops, sweeps=sweeps)
        return momentum_multisweep(*ops, sweeps=sweeps)
    jacobi_momentum.sweep_loops += 1
    u, v = u0, v0
    for _ in range(sweeps):
        hu, hv = h_operator(coef, u, v)
        u, v = ((hu + src_u) * inv_ap * case.fluid,
                (hv + src_v) * inv_ap * case.fluid)
    return u, v


jacobi_momentum.sweep_loops = 0
