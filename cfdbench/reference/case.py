"""Device-resident case state: static masks + dynamic flow fields.

`Case` is everything fixed for a given geometry: fluid/solid blanking,
per-direction face apertures and wall masks, the SDF feature grid and the
inlet profile. `Flow` is the state the PISO engine advances.

A fleet of same-shape cases (piso.batched.stack_cases / stack_flows)
holds the same dataclasses with a leading case axis on every tensor:
fields (B, ny, nx), `inlet_u` (B, ny), `Flow.dt` and `Flow.t` (B,).

Boundary model (channel with obstacle):
  west  = inlet  (fixed parabolic U, zero-grad p)
  east  = outlet (zero-grad U, fixed p = 0)
  north/south + obstacle = no-slip walls, zero-grad p
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geometry import ChannelCase
from .grid import Grid2D, make_grid
from .sdf import sdf_min_distance


@dataclasses.dataclass
class Case:
    grid: Grid2D
    nu: float
    fluid: torch.Tensor       # (ny, nx) 1.0 fluid / 0.0 solid
    sdf: torch.Tensor         # (ny, nx) wall distance, 0 in solids
    inlet_u: torch.Tensor     # (ny,) inlet x-velocity profile
    # per-direction face apertures (fraction of the face open to the
    # neighbour; 0 at domain edges), see fv.cutcell
    open_e: torch.Tensor
    open_w: torch.Tensor
    open_n: torch.Tensor
    open_s: torch.Tensor
    # boundary-face masks per cell (stair-step faces toward non-fluid cells)
    wall_e: torch.Tensor
    wall_w: torch.Tensor
    wall_n: torch.Tensor
    wall_s: torch.Tensor
    inlet_w: torch.Tensor     # 1 on fluid cells whose west face is the inlet
    outlet_e: torch.Tensor    # 1 on fluid cells whose east face is the outlet
    alpha: torch.Tensor       # fluid volume fraction
    wall_ax: torch.Tensor     # embedded-wall area vector (into the solid)
    wall_ay: torch.Tensor
    wall_len: torch.Tensor    # embedded-wall wetted length
    wall_dist: torch.Tensor   # centroid->wall distance (1.0 where no wall)
    cut: bool = False

    @property
    def device(self) -> torch.device:
        return self.fluid.device


class GridMetrics:
    """FV metric terms of a uniform grid, each a Python float (so the step
    keeps the scalar arithmetic): cell spacings, centre-to-centre
    distances toward each neighbour, and the face interpolation weight
    (0.5) of the cell at its own face."""

    __slots__ = ("dxc", "dyc", "hx_e", "hx_w", "hy_n", "hy_s",
                 "wx_e", "wx_w", "wy_n", "wy_s")

    def __init__(self, grid: Grid2D):
        self.dxc, self.dyc = grid.dx, grid.dy
        self.hx_e = self.hx_w = grid.dx
        self.hy_n = self.hy_s = grid.dy
        self.wx_e = self.wx_w = self.wy_n = self.wy_s = 0.5


def grid_metrics(grid: Grid2D) -> GridMetrics:
    """The metric terms of `grid` (see GridMetrics)."""
    return GridMetrics(grid)


def domain_row_masks(case: Case):
    """(dom_n, dom_s): fluid cells in the top/bottom domain wall rows."""
    dom_n = torch.zeros_like(case.fluid)
    dom_n[..., -1, :] = 1.0
    dom_s = torch.zeros_like(case.fluid)
    dom_s[..., 0, :] = 1.0
    return dom_n * case.fluid, dom_s * case.fluid


def per_case(s):
    """A per-case scalar tensor, shape () or (B,), shaped to broadcast
    against ([B,] ny, nx) fields; a Python number as it is."""
    if not isinstance(s, torch.Tensor):
        return s
    return s.reshape(s.shape + (1, 1))


@dataclasses.dataclass
class Flow:
    u: torch.Tensor       # (ny, nx)
    v: torch.Tensor       # (ny, nx)
    p: torch.Tensor       # (ny, nx) kinematic pressure [m^2/s^2]
    phi_x: torch.Tensor   # (ny, nx+1) volumetric face fluxes [m^2/s]
    phi_y: torch.Tensor   # (ny+1, nx)
    dt: torch.Tensor      # () current time step
    t: torch.Tensor       # () current time
    # previous-step fields: the delta-featured surrogate families consume
    # dU = U - U_prev, dp = p - p_prev
    u_prev: torch.Tensor
    v_prev: torch.Tensor
    p_prev: torch.Tensor


def build_channel_case(geom: ChannelCase, delta: float,
                       device, n_boundary: int = 720,
                       alpha_cut: float = 0.05) -> Case:
    """Discretize a ChannelCase onto the uniform grid of spacing `delta`
    (one-time setup; the masks are host numpy, the SDF runs on `device`).
    The obstacle is resolved with sub-cell face apertures and volume
    fractions (`cutcell`).
    """
    from .cutcell import cut_masks

    device = torch.device(device)
    grid = make_grid(0.0, geom.length, 0.0, geom.height, delta)
    # float64 centres, cast to float32 for the SDF as the JAX package casts
    pts = grid.cell_centers_flat()

    top_b = geom.boundary_points_top(4 * n_boundary)
    inside = geom.shape.inside(pts).reshape(grid.shape)
    obst_b = geom.shape.boundary_points(n_boundary)

    cg = cut_masks(grid, geom.shape, inside, alpha_cut=alpha_cut)
    fluid_np = cg["fluid"].astype(np.float32)

    # SDF: min distance to (obstacle U walls), zeroed outside the domain
    pts32 = pts.astype(np.float32)
    in_box = ((pts32[:, 0] <= top_b[:, 0].max())
              & (pts32[:, 0] >= top_b[:, 0].min())
              & (pts32[:, 1] <= top_b[:, 1].max())
              & (pts32[:, 1] >= top_b[:, 1].min()))
    domain = in_box & ~inside.reshape(-1)

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    # chunks of 16384 rows keep the (rows x boundary points) float64
    # temporaries of the wall set under 400 MB
    q = on_dev(pts32)
    d_obst = sdf_min_distance(q, on_dev(obst_b), chunk=16384)
    d_top = sdf_min_distance(q, on_dev(top_b), chunk=16384)
    sdf = (torch.minimum(d_obst, d_top) * on_dev(domain)).reshape(grid.shape)
    sdf = sdf * on_dev(fluid_np)

    y = grid.y0 + (np.arange(grid.ny) + 0.5) * grid.dy
    inlet_u = geom.inlet_profile(y).astype(np.float32)

    _validate_connectivity(fluid_np)
    return _assemble_masks(grid, fluid_np, sdf, inlet_u, geom.nu, cg,
                           cut=True, device=device)


def _validate_connectivity(fluid: np.ndarray) -> None:
    """Reject ill-posed cases where the obstacle seals the channel: a fixed
    inflow with no path to the outlet has no solution."""
    from scipy import ndimage
    labels, _ = ndimage.label(fluid > 0)
    inlet_labels = set(np.unique(labels[:, 0])) - {0}
    outlet_labels = set(np.unique(labels[:, -1])) - {0}
    if not (inlet_labels & outlet_labels):
        raise ValueError(
            "ill-posed case: no fluid path connects the inlet to the outlet "
            "(obstacle seals the channel)")


def _assemble_masks(grid: Grid2D, fluid: np.ndarray, sdf: torch.Tensor,
                    inlet_u: np.ndarray, nu: float, cg: dict,
                    cut: bool, device) -> Case:
    f = fluid

    nbf_e = np.zeros_like(f); nbf_e[:, :-1] = f[:, 1:]
    nbf_w = np.zeros_like(f); nbf_w[:, 1:] = f[:, :-1]
    nbf_n = np.zeros_like(f); nbf_n[:-1, :] = f[1:, :]
    nbf_s = np.zeros_like(f); nbf_s[1:, :] = f[:-1, :]

    interior_e = np.ones_like(f); interior_e[:, -1] = 0
    interior_w = np.ones_like(f); interior_w[:, 0] = 0
    interior_n = np.ones_like(f); interior_n[-1, :] = 0
    interior_s = np.ones_like(f); interior_s[0, :] = 0

    # fractional face apertures from fv.cutcell ({0,1} in blank mode)
    thx = cg["thx"].astype(np.float32)
    thy = cg["thy"].astype(np.float32)
    open_e = thx[:, 1:] * interior_e
    open_w = thx[:, :-1] * interior_w
    open_n = thy[1:, :] * interior_n
    open_s = thy[:-1, :] * interior_s

    # walls: obstacle faces (interior face to a solid cell) + domain N/S walls
    wall_e = f * interior_e * (1 - nbf_e)
    wall_w = f * interior_w * (1 - nbf_w)
    wall_n = np.minimum(f * ((interior_n * (1 - nbf_n)) + (1 - interior_n)),
                        1.0)
    wall_s = np.minimum(f * ((interior_s * (1 - nbf_s)) + (1 - interior_s)),
                        1.0)

    inlet_w = np.zeros_like(f); inlet_w[:, 0] = f[:, 0]
    outlet_e = np.zeros_like(f); outlet_e[:, -1] = f[:, -1]

    def j(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    return Case(
        grid=grid, nu=float(nu), cut=cut,
        fluid=j(f), sdf=sdf.to(device=device, dtype=torch.float32),
        inlet_u=j(inlet_u),
        open_e=j(open_e), open_w=j(open_w), open_n=j(open_n), open_s=j(open_s),
        wall_e=j(wall_e), wall_w=j(wall_w), wall_n=j(wall_n), wall_s=j(wall_s),
        inlet_w=j(inlet_w), outlet_e=j(outlet_e),
        alpha=j(cg["alpha"]), wall_ax=j(cg["wall_ax"]),
        wall_ay=j(cg["wall_ay"]), wall_len=j(cg["wall_len"]),
        wall_dist=j(cg["wall_dist"]),
    )


def initial_flow(case: Case, dt0: float = 1e-3) -> Flow:
    """Inlet profile swept through the domain, zero pressure, fluxes
    consistent with U."""
    grid = case.grid
    u = case.inlet_u[:, None].expand(grid.shape) * case.fluid
    v = torch.zeros(grid.shape, dtype=torch.float32, device=case.device)
    p = torch.zeros_like(v)
    phi_x, phi_y = fluxes_from_velocity(case, u, v)
    scalar = dict(dtype=torch.float32, device=case.device)
    return Flow(u=u, v=v, p=p, phi_x=phi_x, phi_y=phi_y,
                dt=torch.tensor(dt0, **scalar), t=torch.tensor(0.0, **scalar),
                u_prev=u, v_prev=v, p_prev=p)


def fluxes_from_velocity(case: Case, u: torch.Tensor, v: torch.Tensor):
    """Linear face interpolation of U dotted with face areas (fvc::flux).

    x-face j (of nx+1) sits between cells j-1 and j; its openness is
    open_w[..., j]. Inlet face = fixed profile, outlet face = zero-grad
    (upwind cell value), wall/solid faces = 0.
    """
    grid = case.grid
    dy, dx = grid.dy, grid.dx
    face_val_x = 0.5 * (u[..., :-1] + u[..., 1:])      # faces j=1..nx-1
    face_val_y = 0.5 * (v[..., :-1, :] + v[..., 1:, :])  # faces i=1..ny-1
    dy_col = dy * torch.ones((grid.ny, 1), dtype=u.dtype, device=u.device)

    phi_x = torch.cat([
        case.inlet_u[..., :, None] * case.fluid[..., :1] * dy_col,
        face_val_x * case.open_w[..., 1:] * dy,
        u[..., -1:] * case.fluid[..., -1:] * dy_col,
    ], dim=-1)

    zrow = torch.zeros(u.shape[:-2] + (1, grid.nx), dtype=u.dtype,
                       device=u.device)
    phi_y = torch.cat([
        zrow,
        face_val_y * case.open_s[..., 1:, :] * dx,
        zrow,
    ], dim=-2)
    return phi_x, phi_y
