"""Structured-grid shift/stencil primitives.

Fields are (ny, nx), i = y index, j = x index, or (B, ny, nx) with a
leading case axis (the batched fleet, piso.batched): every function here
indexes with `...` and acts per case. The neighbour shifts pad with zeros:
a neighbour beyond the domain reads as 0 (they are not rolls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rdiv(c, t: torch.Tensor) -> torch.Tensor:
    """c / t elementwise for a Python number c, rounded once (a true
    division, as JAX divides a weakly typed number by an array; PyTorch's
    `number / tensor` multiplies by the reciprocal instead)."""
    return torch.div(torch.full_like(t, c), t)


def _bound(c, t: torch.Tensor) -> torch.Tensor:
    # a 0-dim CPU tensor in t's dtype: a scalar operand on any device
    return torch.tensor(c, dtype=t.dtype)


def maximum(t: torch.Tensor, c) -> torch.Tensor:
    """jnp.maximum(t, c) for a Python number c. The value is
    torch.clamp(t, min=c)'s; the gradient is JAX's: where t equals c it
    is split evenly between the two (torch.clamp passes all of it to t)."""
    return torch.maximum(t, _bound(c, t))


def minimum(t: torch.Tensor, c) -> torch.Tensor:
    """jnp.minimum(t, c) for a Python number c (see `maximum`)."""
    return torch.minimum(t, _bound(c, t))


def clip(t: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip(t, lo, hi): maximum with lo, then minimum with hi, so
    that a value at a bound takes JAX's gradient (see `maximum`)."""
    return minimum(maximum(t, lo), hi)


def nb_e(f: torch.Tensor) -> torch.Tensor:
    """East-neighbour values (j+1); zero beyond the domain."""
    return F.pad(f[..., 1:], (0, 1))


def nb_w(f: torch.Tensor) -> torch.Tensor:
    """West-neighbour values (j-1); zero beyond the domain."""
    return F.pad(f[..., :-1], (1, 0))


def nb_n(f: torch.Tensor) -> torch.Tensor:
    """North-neighbour values (i+1); zero beyond the domain."""
    return F.pad(f[..., 1:, :], (0, 0, 0, 1))


def nb_s(f: torch.Tensor) -> torch.Tensor:
    """South-neighbour values (i-1); zero beyond the domain."""
    return F.pad(f[..., :-1, :], (0, 0, 1, 0))


def divergence(phi_x: torch.Tensor, phi_y: torch.Tensor) -> torch.Tensor:
    """Net outflux per cell from face fluxes (not divided by volume).

    phi_x: ([B,] ny, nx+1) fluxes through x-normal faces (positive = +x),
    phi_y: ([B,] ny+1, nx) fluxes through y-normal faces (positive = +y).
    """
    return ((phi_x[..., 1:] - phi_x[..., :-1])
            + (phi_y[..., 1:, :] - phi_y[..., :-1, :]))
