"""Feature definitions of the surrogate families.

  deltaU_deltaP : [dUx/Um, dUy/Um, SDF] -> dp/Um^2   (per-block zero-mean)
  poisson       : [arcsinh-smoothed Poisson source, dUx/Um, dUy/Um, SDF]
                  -> dp/Um^2; source (Ux,x^2 + 2 Ux,y Uy,x + Uy,y^2)
                  * L^2/Um^2 in grid-index derivatives
  M_u           : [Ux/Um, Uy/Um, SDF] -> p/Um^2
  M_fU          : [f_U/Um^2, SDF] -> p/Um^2 with
                  f_U = Ux,x^2 + Uy,y^2 + 2 Ux,y Uy,x (physical derivatives)
  U_gradP       : [Ux/Um, Uy/Um, SDF] -> [dp/dx Lx/Um^2, dp/dy Ly/Um^2]

with Um the instantaneous max |U|. The input functions map ([B,] ny, nx)
fields to ([B,] ny, nx, C), with one Um per case (the poisson and M_fU
features take one case: their derivatives and the arcsinh band are
whole-field); the target functions (the training data's, and the
evaluation's) likewise. The dataset's max-abs scaling lives in the
artifact bundle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..fv.case import Case, per_case


def u_max_norm(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """max |U| per case: () for (ny, nx) fields, (B,) for (B, ny, nx)."""
    return torch.clamp(torch.amax(torch.sqrt(u * u + v * v), dim=(-2, -1)),
                       min=1e-12)


def masked_gradient(case: Case, f: torch.Tensor):
    """(d/dy, d/dx) by np.gradient's rule (index spacing 1, central inside,
    one-sided first order at the edges), zeroed on solid cells and on
    their direct fluid neighbours."""
    gy, gx = torch.gradient(f, dim=(-2, -1))
    near_wall = (case.wall_e + case.wall_w + case.wall_n + case.wall_s) > 0
    keep = case.fluid * (1.0 - near_wall.to(case.fluid.dtype))
    return gy * keep, gx * keep


def smart_arcsinh(field: torch.Tensor, k: float) -> torch.Tensor:
    """Outlier-taming transform: map [mean - k std, mean + k std] (the
    population std) affinely to [-1, 1], push outliers beyond, then
    arcsinh. The outlier branches divide by |bound|, so the map stays
    monotonic when the whole band lies on one side of zero."""
    mean = torch.mean(field)
    std = torch.std(field, correction=0)
    lb = mean - k * std
    ub = mean + k * std

    def _safe_abs(b):
        a = torch.abs(b)
        return torch.where(a < 1e-30, 1.0, a)

    scaled = torch.where(
        field < lb, -1.0 + (field - lb) / _safe_abs(lb),
        torch.where(field > ub, 1.0 + (field - ub) / _safe_abs(ub),
                    2.0 * (field - lb) / torch.clamp(ub - lb, min=1e-30)
                    - 1.0))
    return torch.arcsinh(scaled)


def poisson_source(case: Case, u: torch.Tensor, v: torch.Tensor,
                   u_max: torch.Tensor, length_scale: float,
                   k_smooth: float = 2.0) -> torch.Tensor:
    """(Ux,x^2 + 2 Ux,y Uy,x + Uy,y^2) * L^2/U^2 in grid-index
    derivatives, arcsinh-smoothed."""
    du_dy, du_dx = masked_gradient(case, u)
    dv_dy, dv_dx = masked_gradient(case, v)
    term = (du_dx * du_dx + 2.0 * du_dy * dv_dx + dv_dy * dv_dy)
    term = term * (length_scale**2) / (u_max**2)
    return smart_arcsinh(term, k_smooth)


def f_u_term(case: Case, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f(U) = Ux,x^2 + Uy,y^2 + 2 Ux,y Uy,x in physical derivatives."""
    du_dy, du_dx = masked_gradient(case, u)
    dv_dy, dv_dx = masked_gradient(case, v)
    du_dx = du_dx / case.grid.dx
    dv_dx = dv_dx / case.grid.dx
    du_dy = du_dy / case.grid.dy
    dv_dy = dv_dy / case.grid.dy
    return du_dx * du_dx + dv_dy * dv_dy + 2.0 * du_dy * dv_dx


@dataclasses.dataclass(frozen=True)
class FamilyConfig:
    name: str
    n_in: int
    n_out: int
    target_zero_mean: bool        # subtract per-block masked mean of target
    predicts_delta: bool          # p_new = p_prev + prediction
    build_inputs: Callable        # (case, fields) -> (ny, nx, n_in)
    build_targets: Callable       # (case, fields) -> (ny, nx, n_out)
    # the fields of the step that build_inputs reads beside the case's:
    # all a predictor hands it, and what a CUDA graph of it copies in
    reads: tuple


def _in_deltas(case, fields):
    du = fields["u"] - fields["u_prev"]
    dv = fields["v"] - fields["v_prev"]
    um = per_case(u_max_norm(fields["u"], fields["v"]))
    return torch.stack([du / um, dv / um, case.sdf], dim=-1)


def _out_deltas(case, fields):
    dp = fields["p"] - fields["p_prev"]
    um = per_case(u_max_norm(fields["u"], fields["v"]))
    return (dp / um**2)[..., None]


def _in_poisson(case, fields):
    du = fields["u"] - fields["u_prev"]
    dv = fields["v"] - fields["v_prev"]
    um = u_max_norm(fields["u"], fields["v"])
    src = poisson_source(case, fields["u"], fields["v"], um,
                         fields.get("length_scale", 1.0),
                         fields.get("k_smooth", 2.0))
    return torch.stack([src, du / um, dv / um, case.sdf], dim=-1)


def _in_mu(case, fields):
    um = per_case(u_max_norm(fields["u"], fields["v"]))
    return torch.stack([fields["u"] / um, fields["v"] / um, case.sdf],
                       dim=-1)


def _out_p(case, fields):
    um = per_case(u_max_norm(fields["u"], fields["v"]))
    return (fields["p"] / um**2)[..., None]


def _in_mfu(case, fields):
    um = u_max_norm(fields["u"], fields["v"])
    f_u = f_u_term(case, fields["u"], fields["v"]) / um**2
    return torch.stack([f_u, case.sdf], dim=-1)


def _out_gradp(case, fields):
    """[dp/dx Lx/Um^2, dp/dy Ly/Um^2] by np.gradient's rule in physical
    spacing, zero on solid cells."""
    um = per_case(u_max_norm(fields["u"], fields["v"]))
    gy, gx = torch.gradient(fields["p"], dim=(-2, -1))
    gx = gx / case.grid.dx * case.fluid
    gy = gy / case.grid.dy * case.fluid
    lx = case.grid.nx * case.grid.dx
    ly = case.grid.ny * case.grid.dy
    return torch.stack([gx * lx / um**2, gy * ly / um**2], dim=-1)


FAMILIES = {
    "deltaU_deltaP": FamilyConfig("deltaU_deltaP", 3, 1, True, True,
                                  _in_deltas, _out_deltas,
                                  ("u", "v", "u_prev", "v_prev")),
    # a predictor's poisson inputs take the default length scale and
    # smoothing: the two are per-simulation parameters of training data
    "poisson": FamilyConfig("poisson", 4, 1, True, True, _in_poisson,
                            _out_deltas, ("u", "v", "u_prev", "v_prev")),
    "M_u": FamilyConfig("M_u", 3, 1, True, False, _in_mu, _out_p,
                        ("u", "v")),
    "M_fU": FamilyConfig("M_fU", 2, 1, True, False, _in_mfu, _out_p,
                         ("u", "v")),
    "U_gradP": FamilyConfig("U_gradP", 3, 2, False, False, _in_mu,
                            _out_gradp, ("u", "v")),
}
