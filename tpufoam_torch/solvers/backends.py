"""Pressure backends behind one interface: `(case, coef, rhs, p_prev, aux)
-> p`, where `aux` carries the extra fields a surrogate needs (u, v, ...).

  CGBackend        Jacobi-preconditioned CG to tolerance.
  MGBackend        a fixed number of geometric-multigrid V-cycles.
  MGCGBackend      V-cycle-preconditioned CG to tolerance.
  AutoBackend      the fixed bf16 polish, escalated to a capped MGCG
                   where its residual stays high.
  SurrogateBackend the surrogate's prediction alone.
  HybridBackend    surrogate prediction, then a capped PCG polish.

The multigrid backends take `smoother`, named after the JAX package's
values: "plain" (JAX "xla", the default), "kernel" (JAX "pallas": the
multisweep kernel) and "kernel-fused" (JAX "pallas-fused": the fused
down- and up-leg kernels); see `multigrid`.

Every backend also takes a fleet's (B, ny, nx) operands (piso.batched),
where the JAX package vmaps it: each case is solved as if alone (per-case
norms, exits and escalation). MGBackend and MGCGBackend take the kernel
smoothers on a fleet too: one launch of a kernel a level for the whole
stack, each case on the route it would take alone (multigrid._smooth).
AutoBackend, HybridBackend and SurrogateBackend take no smoother, as in
the JAX package: their multigrid smooths with the plain smoother.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Protocol

import torch

from ..fv.case import Case
from ..fv.pressure import PressureCoeffs, pressure_matvec
from .cg import _norm, pcg_fixed_iters, pcg_pressure
from .multigrid import mg_solve, mgcg_pressure


class PressureBackend(Protocol):
    def __call__(self, case: Case, coef: PressureCoeffs, rhs: torch.Tensor,
                 p_prev: torch.Tensor, aux: dict) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class CGBackend:
    rtol: float = 1e-6
    maxiter: int = 1000

    def __call__(self, case, coef, rhs, p_prev, aux):
        return pcg_pressure(coef, rhs, x0=p_prev, rtol=self.rtol,
                            maxiter=self.maxiter).x * case.fluid


@dataclasses.dataclass(frozen=True)
class MGBackend:
    """Fixed V-cycle geometric multigrid, O(n) per solve.

    pre+post is clamped to >= 3: V(1,1) with damped Jacobi is not a
    contraction on this operator as a standalone solver. `smoother` is
    "plain" (JAX "xla"), "kernel" (JAX "pallas") or "kernel-fused" (JAX
    "pallas-fused")."""
    cycles: int = 4
    pre: int = 2
    post: int = 2
    precision: str = "f32"   # "bf16": f32 residual, bf16 correction
    smoother: str = "plain"  # multigrid.SMOOTHERS
    max_levels: int = 12     # hierarchy depth cap
    coarse_iters: int = 40   # Jacobi sweeps on the coarsest level
    rtol: float = 0.0        # > 0: `cycles` becomes the maximum and the
                             # loop exits once the relative residual
                             # clears rtol (mg_solve)

    def solve_kwargs(self) -> dict:
        """mg_solve's keyword arguments (with the warnings below); the
        decomposed solve (solvers.decomposed) takes the same."""
        dtype = torch.bfloat16 if self.precision == "bf16" else None
        pre, post = self.pre, self.post
        if pre < 1 or post < 1 or pre + post < 3:
            warnings.warn(
                f"MGBackend(pre={self.pre}, post={self.post}) is not a "
                "contraction standalone; clamping to V(2,2).", stacklevel=3)
            pre, post = 2, 2
        if dtype is not None and 0.0 < self.rtol < 0.15:
            warnings.warn(
                f"MGBackend(precision='bf16', rtol={self.rtol:g}) is below "
                "the ~0.10 bf16 correction-form residual noise floor; every "
                "step will run the full cycle cap. Use rtol >= 0.15 with "
                "bf16, or precision='f32'.", stacklevel=3)
        return dict(cycles=self.cycles, pre=pre, post=post, dtype=dtype,
                    smoother=self.smoother, max_levels=self.max_levels,
                    coarse_iters=self.coarse_iters, rtol=self.rtol)

    def __call__(self, case, coef, rhs, p_prev, aux):
        return mg_solve(coef, rhs, p_prev,
                        **self.solve_kwargs()) * case.fluid


@dataclasses.dataclass(frozen=True)
class MGCGBackend:
    """V-cycle-preconditioned CG to tolerance. `smoother` is "plain" (JAX
    "xla"), "kernel" (JAX "pallas") or "kernel-fused" (JAX
    "pallas-fused"). precision="bf16" runs the preconditioner in bf16,
    which can stall plain CG at rtol 1e-6. cycle_type="w" takes a W cycle,
    whose pre/post default to 2 (1 for "v"); keep pre == post."""
    rtol: float = 1e-6
    maxiter: int = 60
    smoother: str = "plain"
    precision: str = "f32"
    cycle_type: str = "v"
    pre: int | None = None
    post: int | None = None

    def solve_kwargs(self) -> dict:
        """mgcg_pressure's keyword arguments; the decomposed solve
        (solvers.decomposed) takes the same."""
        dtype = torch.bfloat16 if self.precision == "bf16" else None
        default = 2 if self.cycle_type == "w" else 1
        pre = default if self.pre is None else self.pre
        post = default if self.post is None else self.post
        if pre != post:
            raise ValueError(
                f"MGCGBackend resolved to an asymmetric V({pre},{post}) "
                f"preconditioner (pre={self.pre}, post={self.post}, "
                f"cycle default {default}); plain CG requires pre == post "
                f"— set both explicitly")
        return dict(rtol=self.rtol, maxiter=self.maxiter, dtype=dtype,
                    pre=pre, post=post, smoother=self.smoother,
                    cycle_type=self.cycle_type)

    def __call__(self, case, coef, rhs, p_prev, aux):
        return mgcg_pressure(coef, rhs, x0=p_prev,
                             **self.solve_kwargs()).x * case.fluid


@dataclasses.dataclass(frozen=True)
class AutoBackend:
    """The fixed `cycles`-cycle polish, escalated per solve to MGCG at
    `rtol` and `maxiter`, warm-started from the polished result, when the
    polish leaves a relative residual above `tau` or a non-finite one.

    JAX's lax.cond becomes one host read of the per-case verdicts. On a
    fleet, as under JAX's vmap (where the cond runs both branches and
    selects per case), the escalation runs on the whole stack when any
    case needs it, each case's MGCG exiting on its own residual, and a
    case that needs none keeps the polished result exactly."""
    cycles: int = 2
    tau: float = 0.05
    rtol: float = 1e-3
    maxiter: int = 6
    precision: str = "bf16"          # fast-path polish precision
    escalate_precision: str = "f32"  # preconditioner dtype inside MGCG

    def needs_escalation(self, case, coef, rhs, p1) -> torch.Tensor:
        """Per case, () or (B,) bool: the polish's relative residual is
        above `tau` or not finite (NaN compares False)."""
        r = _norm((rhs - pressure_matvec(coef, p1)) * case.fluid)
        b = _norm(rhs * case.fluid)
        return ~(r <= self.tau * b)

    def __call__(self, case, coef, rhs, p_prev, aux):
        dtype = torch.bfloat16 if self.precision == "bf16" else None
        p1 = mg_solve(coef, rhs, p_prev, cycles=self.cycles,
                      dtype=dtype) * case.fluid
        need = self.needs_escalation(case, coef, rhs, p1)
        if not bool(need.any()):
            return p1
        edtype = torch.bfloat16 if self.escalate_precision == "bf16" \
            else None
        p_esc = mgcg_pressure(coef, rhs, x0=p1, rtol=self.rtol,
                              maxiter=self.maxiter,
                              dtype=edtype).x * case.fluid
        return torch.where(need[..., None, None], p_esc, p1)


@dataclasses.dataclass(frozen=True)
class SurrogateBackend:
    """The surrogate's pressure alone: p = predict(case, p_prev, aux). A
    fleet's stacked case goes to `predict` whole (a Predictor predicts it
    case by case)."""
    predict: Callable

    def __call__(self, case, coef, rhs, p_prev, aux):
        return self.predict(case, p_prev, aux) * case.fluid


@dataclasses.dataclass(frozen=True)
class HybridBackend:
    """Surrogate initial guess, then `polish_iters` PCG iterations (per
    case on a fleet)."""
    predict: Callable
    polish_iters: int = 6

    def __call__(self, case, coef, rhs, p_prev, aux):
        p_guess = self.predict(case, p_prev, aux) * case.fluid
        return pcg_fixed_iters(coef, rhs, p_guess,
                               iters=self.polish_iters).x * case.fluid
