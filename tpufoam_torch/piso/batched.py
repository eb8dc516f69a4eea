"""Batched multi-geometry rollouts: a fleet of cases stepped in lockstep.

The JAX package gets the fleet from `jax.vmap` of the single-case step.
Here the step itself takes a leading case axis: a stack of same-shape
cases (different obstacles, hence masks and apertures; the same grid,
viscosity and boundary model, which the JAX package holds as static
metadata) becomes (B, ny, nx) fields, and one call of `piso_step`
advances every case. Each case evolves as if alone: per-case dt, per-case
solver exits and safeguard, and one launch of the momentum kernel and one
surrogate prediction for the whole fleet per lockstep.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fv.case import Case, Flow
from ..solvers.backends import MGCGBackend
from .engine import PisoConfig, _bind_sm, piso_step


def _stack(items: list) -> dict:
    """Every tensor field of same-typed dataclasses, stacked on a new
    leading axis."""
    return {f.name: torch.stack([getattr(x, f.name) for x in items])
            for f in dataclasses.fields(items[0])
            if isinstance(getattr(items[0], f.name), torch.Tensor)}


def stack_cases(cases: list[Case]) -> Case:
    """Stack same-shape cases into one batched Case. The grid, `nu` and
    the boundary model (`cut`) are one per fleet; differing ones raise,
    as the JAX package's tree map refuses differing static metadata."""
    c0 = cases[0]
    for c in cases[1:]:
        if c.grid.shape != c0.grid.shape:
            raise ValueError("all cases in a batch must share the grid shape")
        if c.grid != c0.grid or c.nu != c0.nu or c.cut != c0.cut:
            raise ValueError("all cases in a batch must share the grid, nu "
                             "and the boundary model (cut)")
    return Case(grid=c0.grid, nu=c0.nu, cut=c0.cut, **_stack(cases))


def stack_flows(flows: list[Flow]) -> Flow:
    """Stack flows into one batched Flow: fields (B, ...), dt and t (B,)."""
    return Flow(**_stack(flows))


def run_piso_batched(cases: Case, flows: Flow, n_steps: int,
                     cfg: PisoConfig = PisoConfig(),
                     backend=MGCGBackend(rtol=1e-5)) -> Flow:
    """Advance every case n_steps in lockstep. The JAX package scans a
    vmapped step; PyTorch has no scan, so this is the same loop as
    `run_piso_batched_eager` without a surrogate, and it keeps autograd
    on: a loss of the fleet differentiates on the card as `run_piso`'s
    does (the plain momentum smoother, a fixed-cycle MGBackend with the
    plain smoother: one stencil_matvec_grad launch for the whole stack
    per taped matvec), each case's gradient that case's alone."""
    for _ in range(n_steps):
        flows = piso_step(cases, flows, cfg=cfg, backend=backend)
    return flows


def run_piso_batched_eager(cases: Case, flows: Flow, n_steps: int,
                           cfg: PisoConfig = PisoConfig(),
                           backend=MGCGBackend(rtol=1e-5),
                           sm_predict=None) -> Flow:
    """Forward-only fleet rollout with an optional surrogate warm start:
    the loop of `run_piso_batched` under `torch.no_grad()`, with the
    predictor bound to the stacked case once (one stitch operator per
    case)."""
    if sm_predict is not None:
        sm_predict = _bind_sm(sm_predict, cases)
    with torch.no_grad():
        for _ in range(n_steps):
            flows = piso_step(cases, flows, cfg=cfg, backend=backend,
                              sm_predict=sm_predict)
    return flows
