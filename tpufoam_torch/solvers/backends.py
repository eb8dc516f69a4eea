"""Pressure backends: `(case, coef, rhs, p_prev, aux) -> p`.

Only the main path's backend is ported so far: `MGBackend`, a fixed number
of geometric-multigrid V-cycles (optionally bf16 residual-correction).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch


@dataclasses.dataclass(frozen=True)
class MGBackend:
    """Fixed V-cycle geometric multigrid, O(n) per solve.

    pre+post is clamped to >= 3: V(1,1) with damped Jacobi is not a
    contraction on this operator as a standalone solver."""
    cycles: int = 4
    pre: int = 2
    post: int = 2
    precision: str = "f32"   # "bf16": f32 residual, bf16 correction
    max_levels: int = 12     # hierarchy depth cap
    coarse_iters: int = 40   # Jacobi sweeps on the coarsest level
    rtol: float = 0.0        # > 0: `cycles` becomes the maximum and the
                             # loop exits once the relative residual
                             # clears rtol (mg_solve)

    def __call__(self, case, coef, rhs, p_prev, aux):
        from .multigrid import mg_solve
        dtype = torch.bfloat16 if self.precision == "bf16" else None
        pre, post = self.pre, self.post
        if pre < 1 or post < 1 or pre + post < 3:
            warnings.warn(
                f"MGBackend(pre={self.pre}, post={self.post}) is not a "
                "contraction standalone; clamping to V(2,2).", stacklevel=2)
            pre, post = 2, 2
        if dtype is not None and 0.0 < self.rtol < 0.15:
            warnings.warn(
                f"MGBackend(precision='bf16', rtol={self.rtol:g}) is below "
                "the ~0.10 bf16 correction-form residual noise floor; every "
                "step will run the full cycle cap. Use rtol >= 0.15 with "
                "bf16, or precision='f32'.", stacklevel=2)
        return mg_solve(coef, rhs, p_prev, cycles=self.cycles,
                        pre=pre, post=post, dtype=dtype,
                        max_levels=self.max_levels,
                        coarse_iters=self.coarse_iters,
                        rtol=self.rtol) * case.fluid
