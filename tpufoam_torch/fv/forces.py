"""Obstacle force and force-coefficient diagnostics.

The force on the obstacle is assembled from its wall terms, in kinematic
units (per density) and per unit depth. Cut-cell cases take the discrete
momentum-consistent embedded-wall terms; blanked cases sample the stair
faces. One case: (ny, nx) fields. The cut-cell report takes the step's
wall treatment as the momentum equation does: the eddy viscosity and
the wall functions of a turbulent step, or the laminar wall options
(second-order shear, tangential link).
"""

from __future__ import annotations

import dataclasses

import torch

from .case import Case
from .momentum import wall_conductance, wall_shear2_source, wall_unit_normal
from .operators import nb_e, nb_n, nb_s, nb_w
from .pressure import pressure_gradient


@dataclasses.dataclass
class ForceReport:
    f_pressure: torch.Tensor  # (2,) [Fx, Fy]
    f_viscous: torch.Tensor   # (2,)
    cd: torch.Tensor          # drag coefficient
    cl: torch.Tensor          # lift coefficient

    @property
    def total(self):
        return self.f_pressure + self.f_viscous


def _obstacle_walls(case: Case):
    """Wall-face masks excluding the domain top/bottom boundaries."""
    interior_n = torch.ones_like(case.fluid)
    interior_n[-1, :] = 0.0
    interior_s = torch.ones_like(case.fluid)
    interior_s[0, :] = 0.0
    return (case.wall_e, case.wall_w,
            case.wall_n * interior_n, case.wall_s * interior_s)


def _second_order_wall(f: torch.Tensor, nb_in, fluid: torch.Tensor,
                       mode: str):
    """Wall-face value ('face': 1.5 f1 - 0.5 f2) or one-sided quadratic
    wall gradient in units of the cell spacing ('grad': (9 f1 - f2) / 3)
    from the two interior cells along the inward shift `nb_in`; the
    first-order form where the second cell is solid or outside."""
    f2 = nb_in(f)
    ok2 = nb_in(fluid)
    if mode == "face":
        return torch.where(ok2 > 0, 1.5 * f - 0.5 * f2, f)
    return torch.where(ok2 > 0, (9.0 * f - f2) / 3.0, 2.0 * f)


def _report(f_pres: torch.Tensor, f_visc: torch.Tensor, u_ref: float,
            d_ref: float) -> ForceReport:
    q = 0.5 * u_ref**2 * d_ref
    total = f_pres + f_visc
    return ForceReport(f_pressure=f_pres, f_viscous=f_visc,
                       cd=total[0] / q, cl=total[1] / q)


def _obstacle_force_cut(case: Case, u: torch.Tensor, v: torch.Tensor,
                        p: torch.Tensor, u_ref: float = 1.0,
                        d_ref: float = 1.0, nu_t=None, k_turb=None,
                        wall_order: int = 1,
                        wall_link: str = "full") -> ForceReport:
    """Cut-cell force, the discrete momentum-consistent wall terms:
        F_p  = sum_cells p_P A_w    (the pressure gradient's wall closure)
        F_nu = sum_cells a_wall U_P (the no-slip link of fv.momentum:
                                     nu L_w / d_w laminar, nu_eff L_w / d_w
                                     with an eddy viscosity, g L_w with
                                     the wall functions of k_turb)
    i.e. the momentum the discretized equations transfer to the body. The
    step's laminar wall options change that transfer, and the report
    follows: wall_link='tangential' takes off the released normal part
    a_wall (U.n) n, wall_order=2 the second-order shear correction that
    the fluid gained (neither under wall functions)."""
    fpx = torch.sum(p * case.wall_ax)
    fpy = torch.sum(p * case.wall_ay)
    if k_turb is not None:
        a_wall = wall_conductance(case.nu, k_turb,
                                  case.wall_dist) * case.wall_len
    elif nu_t is not None:
        a_wall = (case.nu + nu_t) * case.wall_len / case.wall_dist
    else:
        a_wall = case.nu * case.wall_len / case.wall_dist
    fvx = torch.sum(a_wall * u)
    fvy = torch.sum(a_wall * v)
    if wall_link == "tangential" and k_turb is None:
        nxh, nyh = wall_unit_normal(case)
        un = (u * nxh + v * nyh) * case.fluid
        fvx = fvx - torch.sum(a_wall * un * nxh)
        fvy = fvy - torch.sum(a_wall * un * nyh)
    if wall_order == 2 and k_turb is None:
        ws_u, ws_v = wall_shear2_source(case, *pressure_gradient(case, p))
        fvx = fvx - torch.sum(ws_u)
        fvy = fvy - torch.sum(ws_v)
    return _report(torch.stack([fpx, fpy]), torch.stack([fvx, fvy]), u_ref,
                   d_ref)


def _obstacle_force_stair(case: Case, u: torch.Tensor, v: torch.Tensor,
                          p: torch.Tensor, u_ref: float = 1.0,
                          d_ref: float = 1.0) -> ForceReport:
    """Blank-mode stair-face force: pressure extrapolated to each wall face,
    wall shear from the one-sided quadratic tangential gradient."""
    grid = case.grid
    dx, dy, nu = grid.dx, grid.dy, case.nu
    w_e, w_w, w_n, w_s = _obstacle_walls(case)
    fl = case.fluid

    # +p along the fluid->solid direction; the inward neighbour of a cell
    # whose east face is a wall lies to the west
    p_e = _second_order_wall(p, nb_w, fl, "face")
    p_w = _second_order_wall(p, nb_e, fl, "face")
    p_n = _second_order_wall(p, nb_s, fl, "face")
    p_s = _second_order_wall(p, nb_n, fl, "face")
    fpx = torch.sum(p_e * w_e * dy) - torch.sum(p_w * w_w * dy)
    fpy = torch.sum(p_n * w_n * dx) - torch.sum(p_s * w_s * dx)

    # x-normal walls shear v, y-normal walls shear u
    gv_e = _second_order_wall(v, nb_w, fl, "grad") / dx
    gv_w = _second_order_wall(v, nb_e, fl, "grad") / dx
    fvy = nu * (torch.sum(gv_e * w_e * dy) + torch.sum(gv_w * w_w * dy))
    gu_n = _second_order_wall(u, nb_s, fl, "grad") / dy
    gu_s = _second_order_wall(u, nb_n, fl, "grad") / dy
    fvx = nu * (torch.sum(gu_n * w_n * dx) + torch.sum(gu_s * w_s * dx))
    return _report(torch.stack([fpx, fpy]), torch.stack([fvx, fvy]), u_ref,
                   d_ref)


def obstacle_force(case: Case, u: torch.Tensor, v: torch.Tensor,
                   p: torch.Tensor, u_ref: float = 1.0,
                   d_ref: float = 1.0, *, nu_t=None, k_turb=None,
                   wall_order: int = 1,
                   wall_link: str = "full") -> ForceReport:
    """Pressure + viscous force on the obstacle and its coefficients
    (reference velocity u_ref, length d_ref): the cut-cell terms when
    case.cut, else the stair-face sampling. Pass the step's wall
    treatment, so that a cut-cell report stays the momentum the step
    transferred: for a turbulent step its `nu_t`, and `k_turb` when its
    wall functions are on; for a laminar one PisoConfig.wall_order and
    wall_link. The stair path is laminar and takes none of them."""
    if wall_order not in (1, 2):
        raise ValueError(f"unknown wall order {wall_order!r}")
    if wall_link not in ("full", "tangential"):
        raise ValueError(f"unknown wall link {wall_link!r}")
    if case.cut:
        return _obstacle_force_cut(case, u, v, p, u_ref=u_ref, d_ref=d_ref,
                                   nu_t=nu_t, k_turb=k_turb,
                                   wall_order=wall_order,
                                   wall_link=wall_link)
    return _obstacle_force_stair(case, u, v, p, u_ref=u_ref, d_ref=d_ref)
