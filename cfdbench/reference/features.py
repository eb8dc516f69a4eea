"""The surrogate family's features:

  deltaU_deltaP : [dUx/Um, dUy/Um, SDF] -> dp/Um^2   (per-block zero-mean)

with Um the instantaneous max |U|. The input function maps (ny, nx)
fields to (ny, nx, 3). The dataset's max-abs scaling lives in the
artifact bundle. Other families raise KeyError in `FAMILIES`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .case import per_case


def u_max_norm(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """max |U| per case: () for (ny, nx) fields, (B,) for (B, ny, nx)."""
    return torch.clamp(torch.amax(torch.sqrt(u * u + v * v), dim=(-2, -1)),
                       min=1e-12)


@dataclasses.dataclass(frozen=True)
class FamilyConfig:
    name: str
    n_in: int
    n_out: int
    target_zero_mean: bool        # subtract per-block masked mean of target
    predicts_delta: bool          # p_new = p_prev + prediction
    build_inputs: Callable        # (case, fields) -> (ny, nx, n_in)


def _in_deltas(case, fields):
    du = fields["u"] - fields["u_prev"]
    dv = fields["v"] - fields["v_prev"]
    um = per_case(u_max_norm(fields["u"], fields["v"]))
    return torch.stack([du / um, dv / um, case.sdf], dim=-1)


FAMILIES = {
    "deltaU_deltaP": FamilyConfig("deltaU_deltaP", 3, 1, True, True,
                                  _in_deltas),
}
