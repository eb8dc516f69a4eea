"""Cut-cell (embedded-boundary) geometry: face apertures + volume fractions.

Host numpy, one-time setup; a copy of the JAX package's cut-cell module,
for uniform and stretched grids (per-axis spacings and edges there). The
body is represented by sub-cell geometry:

  alpha   (ny, nx)    fluid volume fraction of each cell
  theta_x (ny, nx+1)  open-area fraction of each x-normal face
  theta_y (ny+1, nx)  open-area fraction of each y-normal face
  wall_a  (ny, nx, 2) embedded-wall area vector per cell (outward, into the
                      solid) from the aperture deficits:
                      A_wall = -((th_e - th_w) dy, (th_n - th_s) dx)
  wall_len (ny, nx)   embedded-wall wetted length (the friction area)
  wall_dist           fluid-centroid -> discrete-wall distance, clipped to
                      [0.05 h, h/2] (h the local cell size on a stretched
                      grid)

In the binary limit (apertures in {0,1} from a centre-inside test) every
formula reduces to the blanked-cell scheme. Cells with alpha < alpha_cut
are blanked (their faces close).
"""

from __future__ import annotations

import numpy as np


def _fraction_outside(shape, pts: np.ndarray) -> np.ndarray:
    """Mean not-inside over the sample axis. pts: (..., k, 2)."""
    flat = pts.reshape(-1, 2)
    ins = shape.inside(flat).reshape(pts.shape[:-1])
    return 1.0 - ins.mean(axis=-1)


def cut_masks(grid, shape, inside_centers: np.ndarray,
              mode: str = "cutcell", alpha_cut: float = 0.05,
              n_sub: int = 24, n_boundary: int = 8192):
    """Compute cut-cell geometry for `shape` on `grid`.

    inside_centers: (ny, nx) bool, centre-inside test (the blank mask).
    mode: 'cutcell' (fractional) or 'blank' (binary, centre-inside).
    Returns dict of numpy arrays (see module docstring).
    """
    ny, nx = grid.shape
    stretched = grid.stretched
    if stretched:
        # per-axis spacing and edge arrays; the uniform branch keeps the
        # scalar arithmetic
        xs_c, ys_c = grid.spacing_arrays()
        xe_c, ye_c = grid.x_edges(), grid.y_edges()
        DX, DY = xs_c[None, :], ys_c[:, None]       # (1,nx), (ny,1)
        h = float(min(xs_c.min(), ys_c.min()))
        h_pad = 2.0 * float(max(xs_c.max(), ys_c.max()))
        cx = 0.5 * (xe_c[:-1] + xe_c[1:])
        cy = 0.5 * (ye_c[:-1] + ye_c[1:])
    else:
        DX, DY = grid.dx, grid.dy
        h = min(grid.dx, grid.dy)
        h_pad = 2.0 * h
        cx = grid.x0 + (np.arange(nx) + 0.5) * grid.dx
        cy = grid.y0 + (np.arange(ny) + 0.5) * grid.dy
    dx, dy = grid.dx, grid.dy

    thx = np.ones((ny, nx + 1), dtype=np.float64)
    thy = np.ones((ny + 1, nx), dtype=np.float64)
    alpha = 1.0 - inside_centers.astype(np.float64)
    CX, CY = np.meshgrid(cx, cy)
    cent_x, cent_y = CX.copy(), CY.copy()

    if shape is not None and mode == "cutcell":
        bp = shape.boundary_points(256)
        pad = h_pad
        xlo, xhi = bp[:, 0].min() - pad, bp[:, 0].max() + pad
        ylo, yhi = bp[:, 1].min() - pad, bp[:, 1].max() + pad
        j_sel = np.where((cx > xlo) & (cx < xhi))[0]
        i_sel = np.where((cy > ylo) & (cy < yhi))[0]
        if len(j_sel) and len(i_sel):
            j0, j1 = j_sel[0], j_sel[-1] + 1
            i0, i1 = i_sel[0], i_sel[-1] + 1
            off = (np.arange(n_sub) + 0.5) / n_sub

            # cell volume fractions + fluid-part centroids (midpoint grid)
            if stretched:
                xs = (xe_c[j_sel][None, :, None]
                      + off[None, None, :] * xs_c[j_sel][None, :, None])
                ys = (ye_c[i_sel][:, None, None]
                      + off[None, None, :] * ys_c[i_sel][:, None, None])
            else:
                xs = grid.x0 + (j_sel[None, :, None] + off[None, None, :]) * dx
                ys = grid.y0 + (i_sel[:, None, None] + off[None, None, :]) * dy
            # (ni, nj, k, k, 2): broadcast x along one sample axis, y other
            px = np.broadcast_to(xs[:, :, None, :],
                                 (i1 - i0, j1 - j0, n_sub, n_sub))
            py = np.broadcast_to(ys[:, :, :, None],
                                 (i1 - i0, j1 - j0, n_sub, n_sub))
            pts = np.stack([px, py], axis=-1).reshape(i1 - i0, j1 - j0, -1, 2)
            ins = shape.inside(pts.reshape(-1, 2)).reshape(pts.shape[:-1])
            a_blk = 1.0 - ins.mean(axis=-1)
            alpha[i0:i1, j0:j1] = a_blk
            # fluid-part centroid (defaults to centre where alpha == 0)
            w = (~ins).astype(np.float64)
            wsum = np.maximum(w.sum(axis=-1), 1e-12)
            cent_x[i0:i1, j0:j1] = np.where(
                a_blk > 0, (pts[..., 0] * w).sum(axis=-1) / wsum,
                CX[i0:i1, j0:j1])
            cent_y[i0:i1, j0:j1] = np.where(
                a_blk > 0, (pts[..., 1] * w).sum(axis=-1) / wsum,
                CY[i0:i1, j0:j1])

            # x-face apertures: faces j0..j1 (inclusive), rows i0..i1
            if stretched:
                fx = xe_c[j0:j1 + 1]
                fy = (ye_c[i0:i1][:, None]
                      + off[None, :] * ys_c[i0:i1][:, None])
            else:
                fx = grid.x0 + np.arange(j0, j1 + 1) * dx
                fy = grid.y0 + (np.arange(i0, i1)[:, None]
                                + off[None, :]) * dy
            pfx = np.broadcast_to(fx[None, :, None],
                                  (i1 - i0, j1 - j0 + 1, n_sub))
            pfy = np.broadcast_to(fy[:, None, :],
                                  (i1 - i0, j1 - j0 + 1, n_sub))
            thx[i0:i1, j0:j1 + 1] = _fraction_outside(
                shape, np.stack([pfx, pfy], axis=-1))

            # y-face apertures: faces i0..i1 (inclusive), cols j0..j1
            if stretched:
                gy = ye_c[i0:i1 + 1]
                gx = (xe_c[j0:j1][None, :, None]
                      + off[None, None, :] * xs_c[j0:j1][None, :, None])
            else:
                gy = grid.y0 + np.arange(i0, i1 + 1) * dy
                gx = grid.x0 + (np.arange(j0, j1)[None, :, None]
                                + off[None, None, :]) * dx
            pgy = np.broadcast_to(gy[:, None, None],
                                  (i1 - i0 + 1, j1 - j0, n_sub))
            pgx = np.broadcast_to(gx, (i1 - i0 + 1, j1 - j0, n_sub))
            thy[i0:i1 + 1, j0:j1] = _fraction_outside(
                shape, np.stack([pgx, pgy], axis=-1))
    elif shape is not None:
        # binary mode: face closed iff either adjacent cell centre is inside
        f = alpha
        thx[:, 1:-1] = f[:, :-1] * f[:, 1:]
        thx[:, 0] = f[:, 0]
        thx[:, -1] = f[:, -1]
        thy[1:-1, :] = f[:-1, :] * f[1:, :]
        thy[0, :] = f[0, :]
        thy[-1, :] = f[-1, :]

    # --- small-cell blanking + face closure ---------------------------------
    if mode == "cutcell":
        fluid = (alpha >= alpha_cut).astype(np.float64)
    else:
        fluid = (alpha > 0.5).astype(np.float64)
    alpha = alpha * fluid            # blanked slivers return to the solid
    alpha = np.where(fluid > 0, np.maximum(alpha, alpha_cut), 0.0)
    thx[:, 1:-1] *= fluid[:, :-1] * fluid[:, 1:]
    thx[:, 0] *= fluid[:, 0]
    thx[:, -1] *= fluid[:, -1]
    thy[1:-1, :] *= fluid[:-1, :] * fluid[1:, :]
    thy[0, :] *= fluid[0, :]
    thy[-1, :] *= fluid[-1, :]

    # --- embedded-wall area vectors (domain edges do NOT count as walls) ----
    tx = thx.copy()
    tx[:, 0] = fluid[:, 0]
    tx[:, -1] = fluid[:, -1]
    ty = thy.copy()
    ty[0, :] = fluid[0, :]
    ty[-1, :] = fluid[-1, :]
    wall_ax = -(tx[:, 1:] - tx[:, :-1]) * DY * fluid
    wall_ay = -(ty[1:, :] - ty[:-1, :]) * DX * fluid
    wall_len = _wetted_length(tx, ty, fluid, DX, DY, mode)

    # --- wall distance + nearest boundary point (force probe anchors) -------
    wall_dist = np.ones((ny, nx), dtype=np.float64)
    sel = wall_len > 1e-12 * h
    if shape is not None and sel.any():
        if mode == "cutcell":
            from scipy.spatial import cKDTree
            bpts = shape.boundary_points(n_boundary)
            tree = cKDTree(bpts)
            cen = np.stack([cent_x[sel], cent_y[sel]], axis=-1)
            d, _ = tree.query(cen)
            # clip bounds follow the LOCAL cell size on stretched grids
            h_cell = (np.minimum(np.broadcast_to(DX, (ny, nx)),
                                 np.broadcast_to(DY, (ny, nx)))[sel]
                      if stretched else h)
            wall_dist[sel] = np.clip(d, 0.05 * h_cell, 0.5 * h_cell)
        else:
            # blank mode: the discrete wall IS the closed face, half a
            # cell away ALONG ITS OWN AXIS (a centre can graze the true
            # boundary arbitrarily closely). The momentum link is
            # nu*wall_len/wall_dist, so the effective distance is the one
            # that reproduces the exact per-face half-cell conductance
            # sum (dE+dW)dy/(dx/2) + (dN+dS)dx/(dy/2); on isotropic grids
            # this is exactly h/2, on anisotropic grids it keeps x-normal
            # faces at dx/2 and y-normal faces at dy/2 instead of
            # min(dx,dy)/2 for both.
            d_e = (1.0 - tx[:, 1:]) * fluid
            d_w = (1.0 - tx[:, :-1]) * fluid
            d_n = (1.0 - ty[1:, :]) * fluid
            d_s = (1.0 - ty[:-1, :]) * fluid
            cond = ((d_e + d_w) * DY / (0.5 * DX)
                    + (d_n + d_s) * DX / (0.5 * DY))
            wall_dist[sel] = wall_len[sel] / cond[sel]

    return dict(alpha=alpha, fluid=fluid, thx=thx, thy=thy,
                wall_ax=wall_ax, wall_ay=wall_ay, wall_len=wall_len,
                wall_dist=wall_dist)


def _wetted_length(tx: np.ndarray, ty: np.ndarray, fluid: np.ndarray,
                   dx, dy, mode: str) -> np.ndarray:
    """Per-cell embedded-wall WETTED length for the no-slip friction link.

    The net area vector |A_w| (= hypot of the aperture-deficit sums) is
    the correct pressure-closure area but UNDERCOUNTS friction area
    whenever a cell has wall on more than one side: opposing wall faces
    cancel entirely (a one-cell slot would become free-slip) and stair
    corners shrink to the diagonal. So:

    - blank/binary mode: the per-face sum (dE + dW) dy + (dN + dS) dx —
      every closed stair face is a wall face at the half-cell distance,
      which IS the round-2 blanked scheme this mode claims parity with
      (the vector norm was a silent round-3 regression for multi-face
      stair cells: -29% corner friction, -100% slots);
    - cutcell mode: |A_w| = hypot of the NET per-direction deficits.
      This is exact for a single straight facet, INCLUDING the common
      near-tangent cell where one facet crosses both opposite faces
      (their same-side closed fractions then largely cancel in the net —
      a per-face or min-overlap sum would double-count that facet).
      The one case it undercounts — a genuinely two-sided thin feature
      inside one cell — is sub-grid by definition; alpha_cut blanking
      removes most such slivers, and shapes thinner than a cell need a
      finer grid regardless.
    """
    d_e = (1.0 - tx[:, 1:]) * fluid
    d_w = (1.0 - tx[:, :-1]) * fluid
    d_n = (1.0 - ty[1:, :]) * fluid
    d_s = (1.0 - ty[:-1, :]) * fluid
    if mode != "cutcell":
        return (d_e + d_w) * dy + (d_n + d_s) * dx
    return np.hypot((d_e - d_w) * dy, (d_n - d_s) * dx)


def binary_masks_from_fluid(grid, fluid: np.ndarray) -> dict:
    """Blank-mode cut-geometry from an arbitrary 0/1 fluid mask (no
    analytic shape available — e.g. domains resampled from the
    reference's unstructured datasets, eval/evaluation.py). Faces close
    between fluid and non-fluid cells; stair wall areas at the half-cell
    distance; no nearest-boundary-point data (per-face half-cell
    wall distances)."""
    ny, nx = fluid.shape
    f = fluid.astype(np.float64)
    dx, dy = grid.dx, grid.dy
    h = min(dx, dy)

    thx = np.ones((ny, nx + 1))
    thy = np.ones((ny + 1, nx))
    thx[:, 1:-1] = f[:, :-1] * f[:, 1:]
    thx[:, 0] = f[:, 0]
    thx[:, -1] = f[:, -1]
    thy[1:-1, :] = f[:-1, :] * f[1:, :]
    thy[0, :] = f[0, :]
    thy[-1, :] = f[-1, :]

    tx = thx.copy(); tx[:, 0] = f[:, 0]; tx[:, -1] = f[:, -1]
    ty = thy.copy(); ty[0, :] = f[0, :]; ty[-1, :] = f[-1, :]
    wall_ax = -(tx[:, 1:] - tx[:, :-1]) * dy * f
    wall_ay = -(ty[1:, :] - ty[:-1, :]) * dx * f
    wall_len = _wetted_length(tx, ty, f, dx, dy, "blank")
    # per-face half-cell link distance (== h/2 isotropic; axis-correct on
    # anisotropic grids — same form as the blank branch in cut_masks)
    d_e = (1.0 - tx[:, 1:]) * f
    d_w = (1.0 - tx[:, :-1]) * f
    d_n = (1.0 - ty[1:, :]) * f
    d_s = (1.0 - ty[:-1, :]) * f
    cond = ((d_e + d_w) * dy / (0.5 * dx) + (d_n + d_s) * dx / (0.5 * dy))
    sel = wall_len > 1e-12 * h
    wall_dist = np.ones_like(f)
    wall_dist[sel] = wall_len[sel] / cond[sel]

    return dict(alpha=f, fluid=f, thx=thx, thy=thy,
                wall_ax=wall_ax, wall_ay=wall_ay, wall_len=wall_len,
                wall_dist=wall_dist)
