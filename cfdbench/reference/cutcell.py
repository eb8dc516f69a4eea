"""Cut-cell (embedded-boundary) geometry: face apertures + volume fractions.

Host numpy, one-time setup; a copy of the JAX package's cut-cell module
on a uniform grid. The body is represented by sub-cell geometry:

  alpha   (ny, nx)    fluid volume fraction of each cell
  theta_x (ny, nx+1)  open-area fraction of each x-normal face
  theta_y (ny+1, nx)  open-area fraction of each y-normal face
  wall_a  (ny, nx, 2) embedded-wall area vector per cell (outward, into the
                      solid) from the aperture deficits:
                      A_wall = -((th_e - th_w) dy, (th_n - th_s) dx)
  wall_len (ny, nx)   embedded-wall wetted length (the friction area)
  wall_dist           fluid-centroid -> discrete-wall distance, clipped to
                      [0.05 h, h/2]

Cells with alpha < alpha_cut are blanked (their faces close).
"""

from __future__ import annotations

import numpy as np


def _fraction_outside(shape, pts: np.ndarray) -> np.ndarray:
    """Mean not-inside over the sample axis. pts: (..., k, 2)."""
    flat = pts.reshape(-1, 2)
    ins = shape.inside(flat).reshape(pts.shape[:-1])
    return 1.0 - ins.mean(axis=-1)


def cut_masks(grid, shape, inside_centers: np.ndarray,
              alpha_cut: float = 0.05, n_sub: int = 24,
              n_boundary: int = 8192):
    """Compute cut-cell geometry for `shape` on the uniform `grid`.

    inside_centers: (ny, nx) bool, centre-inside test.
    Returns dict of numpy arrays (see module docstring).
    """
    ny, nx = grid.shape
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
        fx = grid.x0 + np.arange(j0, j1 + 1) * dx
        fy = grid.y0 + (np.arange(i0, i1)[:, None] + off[None, :]) * dy
        pfx = np.broadcast_to(fx[None, :, None],
                              (i1 - i0, j1 - j0 + 1, n_sub))
        pfy = np.broadcast_to(fy[:, None, :],
                              (i1 - i0, j1 - j0 + 1, n_sub))
        thx[i0:i1, j0:j1 + 1] = _fraction_outside(
            shape, np.stack([pfx, pfy], axis=-1))

        # y-face apertures: faces i0..i1 (inclusive), cols j0..j1
        gy = grid.y0 + np.arange(i0, i1 + 1) * dy
        gx = grid.x0 + (np.arange(j0, j1)[None, :, None]
                        + off[None, None, :]) * dx
        pgy = np.broadcast_to(gy[:, None, None],
                              (i1 - i0 + 1, j1 - j0, n_sub))
        pgx = np.broadcast_to(gx, (i1 - i0 + 1, j1 - j0, n_sub))
        thy[i0:i1 + 1, j0:j1] = _fraction_outside(
            shape, np.stack([pgx, pgy], axis=-1))

    # --- small-cell blanking + face closure ---------------------------------
    fluid = (alpha >= alpha_cut).astype(np.float64)
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
    wall_len = _wetted_length(tx, ty, fluid, DX, DY)

    # --- wall distance + nearest boundary point (force probe anchors) -------
    wall_dist = np.ones((ny, nx), dtype=np.float64)
    sel = wall_len > 1e-12 * h
    if sel.any():
        from scipy.spatial import cKDTree
        bpts = shape.boundary_points(n_boundary)
        tree = cKDTree(bpts)
        cen = np.stack([cent_x[sel], cent_y[sel]], axis=-1)
        d, _ = tree.query(cen)
        wall_dist[sel] = np.clip(d, 0.05 * h, 0.5 * h)

    return dict(alpha=alpha, fluid=fluid, thx=thx, thy=thy,
                wall_ax=wall_ax, wall_ay=wall_ay, wall_len=wall_len,
                wall_dist=wall_dist)


def _wetted_length(tx: np.ndarray, ty: np.ndarray, fluid: np.ndarray,
                   dx, dy) -> np.ndarray:
    """Per-cell embedded-wall wetted length for the no-slip friction link:
    |A_w| = hypot of the net per-direction aperture deficits, exact for a
    single straight facet, including the near-tangent cell where one
    facet crosses both opposite faces."""
    d_e = (1.0 - tx[:, 1:]) * fluid
    d_w = (1.0 - tx[:, :-1]) * fluid
    d_n = (1.0 - ty[1:, :]) * fluid
    d_s = (1.0 - ty[:-1, :]) * fluid
    return np.hypot((d_e - d_w) * dy, (d_n - d_s) * dx)
