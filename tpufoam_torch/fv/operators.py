"""Structured-grid shift/stencil primitives.

Fields are (ny, nx), i = y index, j = x index. The neighbour shifts pad
with zeros: a neighbour beyond the domain reads as 0 (they are not rolls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nb_e(f: torch.Tensor) -> torch.Tensor:
    """East-neighbour values (j+1); zero beyond the domain."""
    return F.pad(f[:, 1:], (0, 1))


def nb_w(f: torch.Tensor) -> torch.Tensor:
    """West-neighbour values (j-1); zero beyond the domain."""
    return F.pad(f[:, :-1], (1, 0))


def nb_n(f: torch.Tensor) -> torch.Tensor:
    """North-neighbour values (i+1); zero beyond the domain."""
    return F.pad(f[1:, :], (0, 0, 0, 1))


def nb_s(f: torch.Tensor) -> torch.Tensor:
    """South-neighbour values (i-1); zero beyond the domain."""
    return F.pad(f[:-1, :], (0, 0, 1, 0))


def divergence(phi_x: torch.Tensor, phi_y: torch.Tensor) -> torch.Tensor:
    """Net outflux per cell from face fluxes (not divided by volume).

    phi_x: (ny, nx+1) fluxes through x-normal faces (positive = +x),
    phi_y: (ny+1, nx) fluxes through y-normal faces (positive = +y).
    """
    return (phi_x[:, 1:] - phi_x[:, :-1]) + (phi_y[1:, :] - phi_y[:-1, :])
