"""Structured 2D grids: uniform, or graded (stretched tensor-product).

Fields are (ny, nx) arrays, row index i = y, column index j = x. A grid is
uniform by default; per-axis spacing tuples (`xs`, `ys`) make it a graded
grid that packs cells around walls and obstacles (`graded_spacing`,
`make_graded_grid`). All of it is host numpy in float64, as in the JAX
package, but for `scatter_to_grid` and `gather_from_grid`, which move
per-point values into and out of a field on its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """A tensor-product grid of nx x ny cells from (x0, y0).

    Uniform when xs and ys are None: cells of dx x dy everywhere.
    Stretched when per-axis spacing tuples are given (xs: the nx cell
    widths, ys: the ny cell heights); `dx`/`dy` are then the minimum
    spacing of each axis (make_graded_grid sets them), the conservative
    value for every scalar guard (the diffusion-number warning, the
    near-wall bands).
    """

    nx: int
    ny: int
    dx: float
    dy: float
    x0: float = 0.0
    y0: float = 0.0
    xs: tuple | None = None   # per-column cell widths (nx,), None = uniform
    ys: tuple | None = None   # per-row cell heights (ny,), None = uniform

    @property
    def stretched(self) -> bool:
        return self.xs is not None or self.ys is not None

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    @property
    def x_max(self) -> float:
        if self.xs is not None:
            return self.x0 + float(np.sum(self.xs))
        return self.x0 + self.nx * self.dx

    @property
    def y_max(self) -> float:
        if self.ys is not None:
            return self.y0 + float(np.sum(self.ys))
        return self.y0 + self.ny * self.dy

    def spacing_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(xs, ys) per-cell spacings of shapes (nx,), (ny,), float64."""
        xs = (np.asarray(self.xs) if self.xs is not None
              else np.full(self.nx, self.dx))
        ys = (np.asarray(self.ys) if self.ys is not None
              else np.full(self.ny, self.dy))
        return xs, ys

    def x_edges(self) -> np.ndarray:
        """(nx+1,) cell-edge x coordinates."""
        if self.xs is None:
            return self.x0 + np.arange(self.nx + 1) * self.dx
        return self.x0 + np.concatenate([np.zeros(1),
                                         np.cumsum(np.asarray(self.xs))])

    def y_edges(self) -> np.ndarray:
        """(ny+1,) cell-edge y coordinates."""
        if self.ys is None:
            return self.y0 + np.arange(self.ny + 1) * self.dy
        return self.y0 + np.concatenate([np.zeros(1),
                                         np.cumsum(np.asarray(self.ys))])

    def cell_centers(self) -> tuple[np.ndarray, np.ndarray]:
        """(X, Y) cell-centre coordinate arrays, each (ny, nx), float64."""
        if not self.stretched:
            x = self.x0 + (np.arange(self.nx) + 0.5) * self.dx
            y = self.y0 + (np.arange(self.ny) + 0.5) * self.dy
            return np.meshgrid(x, y)
        xe, ye = self.x_edges(), self.y_edges()
        return np.meshgrid(0.5 * (xe[:-1] + xe[1:]),
                           0.5 * (ye[:-1] + ye[1:]))

    def cell_centers_flat(self) -> np.ndarray:
        """(n_cells, 2) array of cell-centre coordinates (x, y)."""
        X, Y = self.cell_centers()
        return np.stack([X.ravel(), Y.ravel()], axis=-1)

    def point_to_index(self, pts: np.ndarray) -> np.ndarray:
        """Nearest cell (i, j) indices for points (n, 2) given as (x, y);
        on a stretched grid the containing cell, clipped at the domain's
        edges."""
        if not self.stretched:
            j = np.clip(np.round((pts[:, 0] - self.x0) / self.dx - 0.5),
                        0, self.nx - 1)
            i = np.clip(np.round((pts[:, 1] - self.y0) / self.dy - 0.5),
                        0, self.ny - 1)
            return np.stack([i, j], axis=-1).astype(np.int32)
        j = np.clip(np.searchsorted(self.x_edges(), pts[:, 0]) - 1,
                    0, self.nx - 1)
        i = np.clip(np.searchsorted(self.y_edges(), pts[:, 1]) - 1,
                    0, self.ny - 1)
        return np.stack([i, j], axis=-1).astype(np.int32)


def make_grid(x_min: float, x_max: float, y_min: float, y_max: float,
              delta: float) -> Grid2D:
    """Uniform grid with spacing `delta` and n = round(extent / delta)
    cells per direction."""
    nx = int(round((x_max - x_min) / delta))
    ny = int(round((y_max - y_min) / delta))
    return Grid2D(nx=nx, ny=ny, dx=delta, dy=delta, x0=x_min, y0=y_min)


def graded_spacing(length: float, h_coarse: float,
                   bands: list, ratio: float = 1.12,
                   n_sample: int = 200_001) -> np.ndarray:
    """1D graded cell spacings (float64) that sum exactly to `length`.

    bands: [(lo, hi, h_fine), ...] intervals of the axis (from 0) resolved
    at spacing h_fine. Between bands the target spacing grows linearly
    with the distance from the band at slope (ratio - 1), geometric
    cell-to-cell growth at `ratio`, and caps at h_coarse.

    The stretch coordinate xi(x) = int dx / h(x) is integrated on
    `n_sample` points; N = round(xi_total) cells take their edges at the
    equal-xi points by inverse interpolation."""
    if h_coarse <= 0 or length <= 0:
        raise ValueError("length and h_coarse must be positive")
    x = np.linspace(0.0, length, n_sample)
    h = np.full_like(x, float(h_coarse))
    for lo, hi, h_fine in bands:
        if h_fine <= 0:
            raise ValueError("band h_fine must be positive")
        dist = np.maximum(np.maximum(lo - x, x - hi), 0.0)
        h = np.minimum(h, h_fine + (ratio - 1.0) * dist)
    xi = np.concatenate([[0.0], np.cumsum(
        0.5 * (1.0 / h[1:] + 1.0 / h[:-1]) * np.diff(x))])
    n = max(int(round(xi[-1])), 1)
    edges = np.interp(np.linspace(0.0, xi[-1], n + 1), xi, x)
    edges[0], edges[-1] = 0.0, length
    return np.diff(edges)


def make_graded_grid(x_min: float, x_max: float, y_min: float, y_max: float,
                     xs: np.ndarray, ys: np.ndarray) -> Grid2D:
    """A stretched tensor-product grid from per-axis spacings (e.g. from
    `graded_spacing`); dx/dy carry the minimum spacing of each axis."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if not np.isclose(xs.sum(), x_max - x_min, rtol=1e-9, atol=1e-12):
        raise ValueError(f"xs sum {xs.sum()} != domain length {x_max - x_min}")
    if not np.isclose(ys.sum(), y_max - y_min, rtol=1e-9, atol=1e-12):
        raise ValueError(f"ys sum {ys.sum()} != domain height {y_max - y_min}")
    return Grid2D(nx=len(xs), ny=len(ys),
                  dx=float(xs.min()), dy=float(ys.min()),
                  x0=x_min, y0=y_min,
                  xs=tuple(float(v) for v in xs),
                  ys=tuple(float(v) for v in ys))


def _index(indices, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.as_tensor(indices, device=device).long()
    return idx[:, 0], idx[:, 1]


def scatter_to_grid(grid: Grid2D, indices, values: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Scatter per-point values into a (ny, nx) field at (i, j) `indices`
    ((n, 2) array or tensor), on the values' device; cells no index
    names hold `fill`."""
    out = torch.full(grid.shape, fill, dtype=values.dtype,
                     device=values.device)
    out[_index(indices, values.device)] = values
    return out


def gather_from_grid(field: torch.Tensor, indices) -> torch.Tensor:
    """Per-point values of a (ny, nx) field at (i, j) `indices`."""
    return field[_index(indices, field.device)]
