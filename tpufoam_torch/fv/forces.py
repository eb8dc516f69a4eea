"""Obstacle force and force-coefficient diagnostics, laminar.

The force on the obstacle is assembled from its wall terms, in kinematic
units (per density) and per unit depth. Cut-cell cases take the discrete
momentum-consistent embedded-wall terms; blanked cases sample the stair
faces. One case: (ny, nx) fields.
"""

from __future__ import annotations

import dataclasses

import torch

from .case import Case
from .operators import nb_e, nb_n, nb_s, nb_w


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
                        d_ref: float = 1.0) -> ForceReport:
    """Cut-cell force, the discrete momentum-consistent wall terms:
        F_p  = sum_cells p_P A_w    (the pressure gradient's wall closure)
        F_nu = sum_cells a_wall U_P (the no-slip link nu L_w / d_w of
                                     fv.momentum)
    i.e. the momentum the discretized equations transfer to the body."""
    fpx = torch.sum(p * case.wall_ax)
    fpy = torch.sum(p * case.wall_ay)
    a_wall = case.nu * case.wall_len / case.wall_dist
    fvx = torch.sum(a_wall * u)
    fvy = torch.sum(a_wall * v)
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
                   d_ref: float = 1.0, *, wall_order: int = 1,
                   wall_link: str = "full") -> ForceReport:
    """Pressure + viscous force on the obstacle and its coefficients
    (reference velocity u_ref, length d_ref): the cut-cell terms when
    case.cut, else the stair-face sampling. Laminar only; wall_order=2 and
    wall_link='tangential' (their momentum terms) are not ported."""
    if wall_order != 1 or wall_link != "full":
        raise NotImplementedError(
            f"obstacle_force(wall_order={wall_order}, "
            f"wall_link={wall_link!r}) is not ported: only the first-order "
            "full wall link")
    if case.cut:
        return _obstacle_force_cut(case, u, v, p, u_ref=u_ref, d_ref=d_ref)
    return _obstacle_force_stair(case, u, v, p, u_ref=u_ref, d_ref=d_ref)
