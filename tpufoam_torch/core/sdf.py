"""Wall-distance feature, computed on the device.

The min distance from every query point to a boundary point set, as a
chunked ``|x|^2 + |p|^2 - 2 x.p`` expression, so the full
(n_query x n_boundary) distance matrix is never held at once.

The expression cancels, so its last bits depend on how each sum is
rounded, and the surrogate's near-wall guard (``sdf < 0.05``) compares
cells that sit 0.05 from a wall with it. It is rounded as XLA rounds the
JAX package's expression on the CPU: the two-term sums ``x.x`` and
``x.p`` as fused multiply-adds, the rest in float32, the square root
correctly rounded. Every step is an elementwise operation, so the result
is the same bit for bit on the CPU and on the card.

`domain_and_sdf` is the reference's `domain_dist` for points that come
without an analytic shape (the cells of an unstructured mesh): the
domain mask from the walls' bounding box and the obstacle's convex hull,
and the SDF zeroed outside it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import DEFAULT_DEVICE


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 operands with one rounding: the product is
    exact in float64, the sum is rounded to float64 and then to float32
    (which differs from a fused multiply-add only where float64's rounding
    lands on a float32 tie)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def sdf_min_distance(query: torch.Tensor, boundary: torch.Tensor,
                     chunk: int = 65536) -> torch.Tensor:
    """Min Euclidean distance from each query point to the boundary set.

    query: (n, 2), boundary: (b, 2), both on one device -> (n,) float32.
    """
    query = query.to(torch.float32)
    boundary = boundary.to(torch.float32)
    bx, by = boundary[None, :, 0], boundary[None, :, 1]
    by64 = by.double()
    b_sq = _fma(by, by, bx * bx)
    out = torch.empty(query.shape[0], dtype=torch.float32,
                      device=query.device)
    for s in range(0, query.shape[0], chunk):
        qx, qy = query[s:s + chunk, 0:1], query[s:s + chunk, 1:2]
        # 2 x.p as fma(2 qy, py, 2 qx px): scaling by 2 is exact, and the
        # float64 product of two float32 numbers is exact
        xp2 = ((2.0 * qx) * bx).double().addcmul_(2.0 * qy.double(), by64)
        d2 = (_fma(qy, qy, qx * qx) + b_sq).sub_(xp2.to(torch.float32))
        d2_min = torch.clamp(d2.min(dim=1).values, min=0.0)
        out[s:s + chunk] = torch.sqrt(d2_min.double()).to(torch.float32)
    return out


def inside_convex_hull(points: np.ndarray,
                       boundary: np.ndarray) -> np.ndarray:
    """(n,) bool: each point strictly inside the convex hull of
    `boundary`'s points, in float64 on the host.

    The hull's vertices come from scipy's ConvexHull, counter-clockwise;
    a point is inside when it lies strictly left of every hull edge (a
    positive cross product). A point on an edge or a vertex is outside.
    This is the membership the JAX package takes from matplotlib's
    ``Path.contains_points`` on the same vertices; the two agree wherever
    a point is off the hull's edges."""
    from scipy.spatial import ConvexHull

    boundary = np.asarray(boundary)
    v = np.asarray(boundary[ConvexHull(boundary).vertices], dtype=np.float64)
    p = np.asarray(points, dtype=np.float64)
    inside = np.zeros(len(p), dtype=bool)
    # only points inside the hull's bounding box can be inside the hull
    box = np.flatnonzero((p[:, 0] > v[:, 0].min()) & (p[:, 0] < v[:, 0].max())
                         & (p[:, 1] > v[:, 1].min())
                         & (p[:, 1] < v[:, 1].max()))
    px, py = p[box, 0], p[box, 1]
    keep = np.ones(len(box), dtype=bool)
    for (x0, y0), (x1, y1) in zip(v, np.roll(v, -1, axis=0)):
        keep &= (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0) > 0
    inside[box] = keep
    return inside


def domain_and_sdf(grid_pts: np.ndarray, top_boundary: np.ndarray,
                   obst_boundary: np.ndarray,
                   obst_inside: np.ndarray | None = None,
                   subsample: int = 1, device=DEFAULT_DEVICE
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Domain mask and SDF of points (the reference's `domain_dist`), on
    `device`: (n,) bool and (n,) float32.

    - the domain: inside the bounding box of `top_boundary` (the float32
      points against the boundary's own extremes) and not inside the
      obstacle. Obstacle membership is `inside_convex_hull` of
      `obst_boundary`, unless the caller passes the exact `obst_inside`
      bool array (analytic, possibly concave, shapes).
    - the SDF: the min distance to the obstacle's and the walls' points
      (`sdf_min_distance`), zeroed outside the domain.
    - `subsample`: the boundary decimation stride (the reference's 2;
      1, exact, by default)."""
    grid_pts = np.asarray(grid_pts, dtype=np.float32)
    top_boundary = np.asarray(top_boundary)
    top = np.asarray(top_boundary, dtype=np.float32)[::subsample]
    obst = np.asarray(obst_boundary, dtype=np.float32)[::subsample]

    max_x, max_y = top_boundary[:, 0].max(), top_boundary[:, 1].max()
    min_x, min_y = top_boundary[:, 0].min(), top_boundary[:, 1].min()
    in_box = ((grid_pts[:, 0] <= max_x) & (grid_pts[:, 0] >= min_x)
              & (grid_pts[:, 1] <= max_y) & (grid_pts[:, 1] >= min_y))
    if obst_inside is None:
        obst_inside = inside_convex_hull(grid_pts, obst_boundary)
    device = torch.device(device)
    domain = torch.as_tensor(in_box & ~np.asarray(obst_inside),
                             device=device)

    # chunks of 16384 rows keep the (rows x boundary points) float64
    # temporaries under 400 MB for a few thousand boundary points
    q = torch.as_tensor(grid_pts, device=device)
    d_obst = sdf_min_distance(q, torch.as_tensor(obst, device=device),
                              chunk=16384)
    d_top = sdf_min_distance(q, torch.as_tensor(top, device=device),
                             chunk=16384)
    return domain, torch.minimum(d_obst, d_top) * domain
