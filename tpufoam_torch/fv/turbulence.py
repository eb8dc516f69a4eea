"""k-omega SST eddy-viscosity turbulence model (Menter 2003).

`sst_step` advances (k, omega) one timestep after the PISO step (the
reference loop's `turbulence->correct()`) and refreshes nu_t, which the
next momentum predictor takes as nu_eff = nu + nu_t. Both transport
equations are assembled with the momentum equation's stencils (upwind
convection, central diffusion with face-averaged diffusivity, implicit
Patankar-linearized sinks) and relaxed with a fixed number of Jacobi
sweeps, a Python loop of whole-field operations. Walls: the analytic
viscous-sublayer floor omega >= 6 nu / (beta1 d^2) from the SDF, or with
`wall_fn` the high-Re wall functions. One case, (ny, nx) fields, on a
uniform grid.

The expression order follows the JAX package's wherever it decides the
rounding; a Python number divided by a tensor is divided as JAX divides
it (`operators.rdiv`).
"""

from __future__ import annotations

import dataclasses

import torch

from .case import Case, domain_row_masks
from .momentum import wall_conductance
from .operators import nb_e, nb_n, nb_s, nb_w, rdiv

# Menter (2003) constants
A1 = 0.31
BETA_STAR = 0.09
KAPPA = 0.41               # von Karman (wall functions)
CMU25 = BETA_STAR ** 0.25  # u* = Cmu^{1/4} sqrt(k)
SIGMA_K1, SIGMA_W1, BETA1, GAMMA1 = 0.85, 0.5, 0.075, 5.0 / 9.0
SIGMA_K2, SIGMA_W2, BETA2, GAMMA2 = 1.0, 0.856, 0.0828, 0.44

K_FLOOR = 1e-12
W_FLOOR = 1e-8


@dataclasses.dataclass
class TurbState:
    k: torch.Tensor        # (ny, nx) turbulent kinetic energy [m^2/s^2]
    omega: torch.Tensor    # (ny, nx) specific dissipation rate [1/s]
    nu_t: torch.Tensor     # (ny, nx) eddy viscosity [m^2/s]
    k_in: torch.Tensor     # () inlet k
    w_in: torch.Tensor     # () inlet omega


def init_turbulence(case: Case, intensity: float = 0.05,
                    length_frac: float = 0.1) -> TurbState:
    """Freestream/inlet turbulence from intensity I and mixing length
    l = length_frac * channel height: k = 1.5 (I U_ref)^2,
    omega = sqrt(k) / (Cmu^0.25 l). A stretched grid raises ValueError:
    the transport discretization takes scalar spacings."""
    if case.grid.stretched:
        raise ValueError("k-omega SST is implemented for uniform grids; "
                         "stretched grids run laminar (2D-1/2/3 class)")
    u_ref = torch.clamp(torch.max(case.inlet_u), min=1e-6)
    height = case.grid.ny * case.grid.dy
    k_in = 1.5 * (intensity * u_ref) ** 2
    w_in = torch.sqrt(k_in) / (BETA_STAR ** 0.25 * length_frac * height)
    shape = case.grid.shape
    k = torch.full(shape, float(k_in), dtype=torch.float32,
                   device=case.device) * case.fluid
    w = (torch.full(shape, float(w_in), dtype=torch.float32,
                    device=case.device) * case.fluid + (1 - case.fluid))
    nu_t = (k / torch.clamp(w, min=W_FLOOR)) * case.fluid
    return TurbState(k=k, omega=w, nu_t=nu_t, k_in=k_in.float(),
                     w_in=w_in.float())


def _masked_grad(case: Case, f: torch.Tensor):
    """Cell-centred gradient: central where both neighbours are fluid,
    one-sided at openings, zero in solids."""
    dx, dy = case.grid.dx, case.grid.dy
    cx = torch.clamp(case.open_e + case.open_w, min=1.0)
    cy = torch.clamp(case.open_n + case.open_s, min=1.0)
    dfdx = (case.open_e * (nb_e(f) - f) + case.open_w * (f - nb_w(f))) \
        / (cx * dx)
    dfdy = (case.open_n * (nb_n(f) - f) + case.open_s * (f - nb_s(f))) \
        / (cy * dy)
    return dfdx * case.fluid, dfdy * case.fluid


def _transport_solve(case: Case, phi_x, phi_y, gamma, dt, old, su, sp,
                     inlet_val, wall_dirichlet_zero: bool, sweeps: int):
    """Implicit FV advance of one scalar:
        ddt(q) + div(phi, q) - laplacian(gamma, q) == su - sp*q
    su, sp per unit volume, sp >= 0 (Patankar); `sweeps` Jacobi sweeps."""
    grid = case.grid
    dx, dy = grid.dx, grid.dy
    vol = dx * dy

    d_e = 0.5 * (gamma + nb_e(gamma)) * dy / dx
    d_w = 0.5 * (gamma + nb_w(gamma)) * dy / dx
    d_n = 0.5 * (gamma + nb_n(gamma)) * dx / dy
    d_s = 0.5 * (gamma + nb_s(gamma)) * dx / dy

    f_e = phi_x[:, 1:]
    f_w = phi_x[:, :-1]
    f_n = phi_y[1:, :]
    f_s = phi_y[:-1, :]

    # apertures scale diffusion; convective fluxes already carry them
    a_e = case.open_e * d_e + torch.where(case.open_e > 0,
                                          torch.clamp(-f_e, min=0.0), 0.0)
    a_w = case.open_w * d_w + torch.where(case.open_w > 0,
                                          torch.clamp(f_w, min=0.0), 0.0)
    a_n = case.open_n * d_n + torch.where(case.open_n > 0,
                                          torch.clamp(-f_n, min=0.0), 0.0)
    a_s = case.open_s * d_s + torch.where(case.open_s > 0,
                                          torch.clamp(f_s, min=0.0), 0.0)

    # domain-row walls (half-cell) + embedded-wall link (fv.cutcell)
    dom_n, dom_s = domain_row_masks(case)
    wall = (dom_n + dom_s) * 2.0 * gamma * dx / dy \
        + gamma * case.wall_len / case.wall_dist
    wall_contrib = wall if wall_dirichlet_zero else 0.0

    a_in = case.inlet_w * (2.0 * gamma * dy / dx + torch.clamp(f_w, min=0.0))

    volc = case.alpha * vol
    div_f = f_e - f_w + f_n - f_s
    a_p = (a_e + a_w + a_n + a_s + wall_contrib + a_in + div_f
           + volc / dt + sp * volc) * case.fluid + (1.0 - case.fluid)
    b = ((volc / dt) * old + su * volc + a_in * inlet_val) * case.fluid

    inv_ap = 1.0 / a_p
    q = old * case.fluid
    for _ in range(sweeps):
        h = (a_e * nb_e(q) + a_w * nb_w(q) + a_n * nb_n(q) + a_s * nb_s(q)
             + b)
        q = h * inv_ap * case.fluid
    return q


def wall_cell_masks(case: Case):
    """(wall mask, wall distance) for wall-adjacent cells: domain N/S rows
    at the half-cell distance + embedded-wall cells at their cut-cell
    centroid distance (fv.cutcell)."""
    dom_n, dom_s = domain_row_masks(case)
    dom = torch.maximum(dom_n, dom_s)
    obst = (case.wall_len > 1e-12).to(case.fluid.dtype)
    mask = torch.maximum(dom, obst)
    d = torch.where(obst > 0, case.wall_dist, 0.5 * case.grid.dy)
    return mask, d


def sst_step(case: Case, turb: TurbState, u, v, phi_x, phi_y, dt,
             sweeps: int = 4, wall_fn: bool = False) -> TurbState:
    """One `turbulence->correct()`: advance k and omega with the corrected
    velocity and fluxes, refresh nu_t.

    wall_fn=True: the high-Re wall functions for coarse uniform near-wall
    grids (OpenFOAM's kqRWallFunction / omegaWallFunction /
    nutkWallFunction): k zero-gradient at walls with its wall-cell
    production from the log-law shear, omega imposed as
    sqrt(omega_vis^2 + omega_log^2) in wall cells (the momentum wall
    links take the log-law conductance when the step passes k to
    momentum_coeffs). False: the low-Re viscous-sublayer treatment."""
    nu = case.nu
    k = torch.clamp(turb.k, min=K_FLOOR) * case.fluid
    w = torch.clamp(turb.omega, min=W_FLOOR)

    dudx, dudy = _masked_grad(case, u)
    dvdx, dvdy = _masked_grad(case, v)
    s2 = 2.0 * (dudx ** 2 + dvdy ** 2) + (dudy + dvdx) ** 2
    s = torch.sqrt(s2)

    d = torch.clamp(case.sdf, min=0.25 * min(case.grid.dx, case.grid.dy))

    dkdx, dkdy = _masked_grad(case, k)
    dwdx, dwdy = _masked_grad(case, w)
    cross = rdiv(2.0 * SIGMA_W2, w) * (dkdx * dwdx + dkdy * dwdy)
    cd_kw = torch.clamp(cross, min=1e-10)

    sqrt_k = torch.sqrt(k)
    arg1 = torch.minimum(
        torch.maximum(sqrt_k / (BETA_STAR * w * d),
                      rdiv(500.0 * nu, d ** 2 * w)),
        4.0 * SIGMA_W2 * k / (cd_kw * d ** 2))
    f1 = torch.tanh(arg1 ** 4)
    arg2 = torch.maximum(2.0 * sqrt_k / (BETA_STAR * w * d),
                         rdiv(500.0 * nu, d ** 2 * w))
    f2 = torch.tanh(arg2 ** 2)

    nu_t = A1 * k / torch.maximum(A1 * w, s * f2) * case.fluid

    def blend(c1, c2):
        return f1 * c1 + (1.0 - f1) * c2

    sigma_k = blend(SIGMA_K1, SIGMA_K2)
    sigma_w = blend(SIGMA_W1, SIGMA_W2)
    beta = blend(BETA1, BETA2)
    gamma_c = blend(GAMMA1, GAMMA2)

    # production, limited to 10 beta* k omega (Menter's limiter)
    pk = torch.minimum(nu_t * s2, 10.0 * BETA_STAR * k * w)

    if wall_fn:
        # wall-cell production from the log-law shear: G = tau_w u* /
        # (kappa d), tau_w = g |U_t|
        wmask, wd = wall_cell_masks(case)
        g = wall_conductance(nu, k, wd)
        umag = torch.sqrt(u * u + v * v)
        ustar = CMU25 * sqrt_k
        g_wall = g * umag * ustar / torch.clamp(KAPPA * wd, min=1e-12)
        pk = torch.where(wmask > 0, g_wall, pk)

    k_new = _transport_solve(
        case, phi_x, phi_y, nu + sigma_k * nu_t, dt, k,
        su=pk, sp=BETA_STAR * w,
        inlet_val=turb.k_in, wall_dirichlet_zero=not wall_fn, sweeps=sweeps)

    # cross-diffusion: the positive part an explicit source, the negative
    # part in the implicit sink (Patankar), keeping Menter's signed
    # (1 - f1) cross term
    cross_w = (1.0 - f1) * cross
    pw = gamma_c * s2 + torch.clamp(cross_w, min=0.0)
    sp_cross = torch.clamp(-cross_w, min=0.0) / torch.clamp(w, min=W_FLOOR)
    w_new = _transport_solve(
        case, phi_x, phi_y, nu + sigma_w * nu_t, dt, w,
        su=pw, sp=beta * w + sp_cross,
        inlet_val=turb.w_in, wall_dirichlet_zero=False, sweeps=sweeps)

    if wall_fn:
        # omegaWallFunction: the viscous and log asymptotes blended,
        # imposed in wall-adjacent cells
        k_pos = torch.clamp(k_new, min=K_FLOOR)
        w_vis = rdiv(6.0 * nu, BETA1 * wd ** 2)
        w_log = torch.sqrt(k_pos) / (CMU25 * KAPPA
                                     * torch.clamp(wd, min=1e-12))
        w_imposed = torch.sqrt(w_vis**2 + w_log**2)
        w_new = torch.where(wmask > 0, w_imposed, w_new)
    else:
        # viscous-sublayer floor omega >= 6 nu / (beta1 d^2), binding only
        # in a band of max(dx, dy) widths near walls
        w_wall = rdiv(6.0 * nu, BETA1 * d ** 2)
        band = 3.0 * max(case.grid.dx, case.grid.dy)
        w_new = torch.maximum(w_new, w_wall * (case.sdf < band))
    w_new = torch.clamp(w_new, min=W_FLOOR) * case.fluid + (1 - case.fluid)
    k_new = torch.clamp(k_new, min=K_FLOOR) * case.fluid

    nu_t_new = A1 * k_new / torch.maximum(A1 * w_new, s * f2) * case.fluid
    return TurbState(k=k_new, omega=w_new, nu_t=nu_t_new,
                     k_in=turb.k_in, w_in=turb.w_in)
