"""The pressure backend of the benchmark's configurations: `(case, coef,
rhs, p_prev, aux) -> p`.

  MGBackend   a fixed number of geometric-multigrid V-cycles.

The program's multigrid takes `smoother`: "plain", "kernel" (the
multisweep kernel) or "kernel-fused" (the fused down- and up-leg
kernels). Each runs the same damped-Jacobi sweeps, so the reference
takes the setting and runs them plainly (`multigrid`).
"""

from __future__ import annotations

import dataclasses

import torch

from .multigrid import mg_solve


@dataclasses.dataclass(frozen=True)
class MGBackend:
    """Fixed V-cycle geometric multigrid, O(n) per solve.

    pre+post is clamped to >= 3: V(1,1) with damped Jacobi is not a
    contraction on this operator as a standalone solver."""
    cycles: int = 4
    pre: int = 2
    post: int = 2
    precision: str = "f32"   # "bf16": f32 residual, bf16 correction
    smoother: str = "plain"  # the same sweeps on every route (above)
    max_levels: int = 12     # hierarchy depth cap
    coarse_iters: int = 40   # Jacobi sweeps on the coarsest level
    rtol: float = 0.0        # the fixed cycle count only (0)

    def __post_init__(self):
        if self.rtol != 0.0:
            raise ValueError("the reference runs a fixed cycle count: "
                             "rtol 0")

    def __call__(self, case, coef, rhs, p_prev, aux):
        dtype = torch.bfloat16 if self.precision == "bf16" else None
        pre, post = self.pre, self.post
        if pre < 1 or post < 1 or pre + post < 3:
            pre, post = 2, 2
        return mg_solve(coef, rhs, p_prev, cycles=self.cycles, pre=pre,
                        post=post, dtype=dtype, max_levels=self.max_levels,
                        coarse_iters=self.coarse_iters) * case.fluid
