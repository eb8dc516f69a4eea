"""The uniform structured 2D grid.

Fields are (ny, nx) arrays, row index i = y, column index j = x. All of
it is host numpy in float64, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """A grid of nx x ny cells of dx x dy from (x0, y0)."""

    nx: int
    ny: int
    dx: float
    dy: float
    x0: float = 0.0
    y0: float = 0.0

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    def cell_centers(self) -> tuple[np.ndarray, np.ndarray]:
        """(X, Y) cell-centre coordinate arrays, each (ny, nx), float64."""
        x = self.x0 + (np.arange(self.nx) + 0.5) * self.dx
        y = self.y0 + (np.arange(self.ny) + 0.5) * self.dy
        return np.meshgrid(x, y)

    def cell_centers_flat(self) -> np.ndarray:
        """(n_cells, 2) array of cell-centre coordinates (x, y)."""
        X, Y = self.cell_centers()
        return np.stack([X.ravel(), Y.ravel()], axis=-1)


def make_grid(x_min: float, x_max: float, y_min: float, y_max: float,
              delta: float) -> Grid2D:
    """Uniform grid with spacing `delta` and n = round(extent / delta)
    cells per direction."""
    nx = int(round((x_max - x_min) / delta))
    ny = int(round((y_max - y_min) / delta))
    return Grid2D(nx=nx, ny=ny, dx=delta, dy=delta, x0=x_min, y0=y_min)
