"""Pressure reconstruction from predicted gradients: the U_gradP family's
evaluation engine.

The reference integrates (dp/dx, dp/dy) by cumulative sums along grid
lines, resetting the running sum across obstacle cells, splits the domain
into 4 quadrants around the obstacle so that each is integrated away from
a corner in its own direction, and mean-matches the quadrants at their
seams. A quadrant integral is two masked cumulative sums

    p(i, j) = Sy[i, j0] - Sy[i0, j0] + Sx[i, j] - Sx[i, j0]

with Sx, Sy the along-axis cumulative sums of the solid-masked gradient
components (masked to zero across solids, the reference's reset), the
four quadrants flipped into one orientation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fv.case import Case


def _integrate_corner(gx: torch.Tensor, gy: torch.Tensor, mask: torch.Tensor,
                      dx: float, dy: float) -> torch.Tensor:
    """Integrate from the (0, 0) corner: along column 0 with gy, then along
    rows with gx. Solid cells contribute zero increments."""
    sx = torch.cumsum(gx * mask, dim=1) * dx
    sy = torch.cumsum(gy * mask, dim=0) * dy
    return sy[:, 0:1] - sy[0:1, 0:1] + sx - sx[:, 0:1]


def _masked_mean(x, m):
    cnt = m.sum()
    return torch.where(cnt > 0, (x * m).sum() / torch.clamp(cnt, min=1.0),
                       0.0)


def integrate_gradp(case: Case, gx: torch.Tensor, gy: torch.Tensor,
                    center: tuple[int, int] | None = None) -> torch.Tensor:
    """(dp/dx, dp/dy) on the grid -> p, anchored to 0 at the outlet column.

    `center` is the (i, j) split point; by default the obstacle's
    centroid, found on the host from the case's mask (mid-domain without
    an obstacle)."""
    grid = case.grid
    fluid = case.fluid
    if center is None:
        solid = 1.0 - fluid.cpu().numpy()
        if solid.sum() > 0:
            ci = int(round((solid.sum(axis=1) * np.arange(grid.ny)).sum()
                           / solid.sum()))
            cj = int(round((solid.sum(axis=0) * np.arange(grid.nx)).sum()
                           / solid.sum()))
            center = (ci, cj)
        else:
            center = (grid.ny // 2, grid.nx // 2)
    ci, cj = center

    def quadrant(sl_i, sl_j, flip_i, flip_j):
        g_x, g_y, m = gx[sl_i, sl_j], gy[sl_i, sl_j], fluid[sl_i, sl_j]
        if flip_i:
            g_x, g_y, m = g_x.flip(0), -g_y.flip(0), m.flip(0)
        if flip_j:
            g_x, g_y, m = -g_x.flip(1), g_y.flip(1), m.flip(1)
        p = _integrate_corner(g_x, g_y, m, grid.dx, grid.dy)
        if flip_i:
            p = p.flip(0)
        if flip_j:
            p = p.flip(1)
        return p, fluid[sl_i, sl_j]

    # upper-right: from its right edge (the outlet side) leftward
    ur, m_ur = quadrant(slice(ci, None), slice(cj, None), False, True)
    # upper-left: from its left edge rightward; its seam matched to ur's
    ul, m_ul = quadrant(slice(ci, None), slice(0, cj), False, False)
    ul = ul - (_masked_mean(ul[:, -1], m_ul[:, -1])
               - _masked_mean(ur[:, 0], m_ur[:, 0]))
    # lower-right / lower-left, mirrored in i
    lr, m_lr = quadrant(slice(0, ci), slice(cj, None), True, True)
    ll, m_ll = quadrant(slice(0, ci), slice(0, cj), True, False)
    ll = ll - (_masked_mean(ll[:, -1], m_ll[:, -1])
               - _masked_mean(lr[:, 0], m_lr[:, 0]))
    # the seam between the upper and lower halves
    top_row = torch.cat([ul[0], ur[0]])
    bot_row = torch.cat([ll[-1], lr[-1]])
    m_top = torch.cat([m_ul[0], m_ur[0]])
    m_bot = torch.cat([m_ll[-1], m_lr[-1]])
    vseam = _masked_mean(bot_row, m_bot) - _masked_mean(top_row, m_top)

    result = torch.zeros(grid.shape, dtype=gx.dtype, device=gx.device)
    result[ci:, cj:] = ur
    result[ci:, :cj] = ul
    result[:ci, cj:] = lr - vseam
    result[:ci, :cj] = ll - vseam

    # outlet anchor: p = 0 on the rightmost column (fixed-p BC)
    anchor = _masked_mean(result[:, -1], fluid[:, -1])
    return (result - anchor) * fluid
