"""The PISO timestep engine.

One step: Courant-limited adaptive dt, the optional surrogate pressure
prediction before the momentum predictor (Algorithm 2 of the DLPoissonFoam
coupling), the implicit momentum predictor (UEqn), and nCorrectors PISO
pressure corrections (pEqn). PyTorch runs it eagerly; the only host
synchronisation per step is the residual safeguard's gate.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fv.case import Case, Flow
from ..fv.momentum import h_operator, jacobi_momentum, momentum_coeffs
from ..fv.operators import divergence
from ..fv.pressure import (correct_fluxes, face_fluxes_hbya, pressure_coeffs,
                           pressure_gradient, pressure_matvec, pressure_rhs)
from ..solvers.backends import MGBackend


@dataclasses.dataclass(frozen=True)
class PisoConfig:
    """The step's knobs: nCorrectors 2, maxCo 0.5, limitedLinearV
    convection and Euler ddt (fixed in fv.momentum)."""
    n_correctors: int = 2
    momentum_sweeps: int = 8          # <= 8 for the kernel
    max_co: float = 0.5
    max_dt: float = 0.05
    momentum_smoother: str = "kernel"  # 'kernel': ops.momentum (CUDA
                                       # kernel on the card, its plain
                                       # version on the CPU); 'plain': the
                                       # sweep loop of fv.momentum
    sm_safeguard: float = 0.5         # residual gate on the first SM-warm-
                                      # started corrector solve: above it
                                      # (or NaN) the solve restarts from the
                                      # previous-step pressure; 0 disables
    sm_safeguard_extra: int = 3       # max rescue solves per step


def courant_number(case: Case, flow: Flow) -> torch.Tensor:
    """max Courant number from face fluxes (CourantNo.H semantics)."""
    grid = case.grid
    sum_phi = (torch.abs(flow.phi_x[:, 1:]) + torch.abs(flow.phi_x[:, :-1])
               + torch.abs(flow.phi_y[1:, :]) + torch.abs(flow.phi_y[:-1, :]))
    # cut cells: floor alpha at 0.5 so sliver cells don't collapse dt
    alpha_co = torch.clamp(case.alpha, min=0.5)
    vol = grid.dx * grid.dy
    return 0.5 * torch.max(sum_phi * case.fluid / alpha_co) / vol * flow.dt


def continuity_error(case: Case, flow: Flow) -> torch.Tensor:
    """Mean |div phi| over fluid cells — the step's health diagnostic."""
    div = divergence(flow.phi_x, flow.phi_y) * case.fluid
    return torch.sum(torch.abs(div)) / torch.clamp(torch.sum(case.fluid),
                                                   min=1.0)


def _next_dt(case: Case, flow: Flow, cfg: PisoConfig) -> torch.Tensor:
    """setDeltaT.H: damped growth toward maxCo, hard caps."""
    co = courant_number(case, flow) / torch.clamp(flow.dt, min=1e-12)
    dt_co = cfg.max_co / torch.clamp(co, min=1e-12)
    new_dt = torch.clamp(torch.minimum(dt_co, 1.2 * flow.dt), max=cfg.max_dt)
    return new_dt.to(flow.dt.dtype)


def _gate_sm_prediction(p_sm: torch.Tensor, p_prev: torch.Tensor,
                        fluid: torch.Tensor) -> torch.Tensor:
    """Reject a non-finite surrogate prediction wholesale (fall back to the
    incoming pressure), on the device."""
    return torch.where(torch.isfinite(p_sm).all(), p_sm, p_prev) * fluid


def _rescue_if_unconverged(case: Case, pcoef, rhs, p_cand, p_fallback,
                           backend, aux, cfg: PisoConfig) -> torch.Tensor:
    """Residual safeguard for the SM-warm-started capped solve. If the
    first corrector's solution leaves a relative residual above the gate
    (or NaN), restart from the previous-step pressure: apply the backend
    once, then up to sm_safeguard_extra - 1 more times until the gate
    clears (a do-while). Healthy steps pay one matvec, two norms and one
    host read."""
    def rnorm(p):
        return torch.linalg.norm((rhs - pressure_matvec(pcoef, p))
                                 * case.fluid)

    gate = cfg.sm_safeguard * (torch.linalg.norm(rhs * case.fluid) + 1e-30)
    if bool(rnorm(p_cand) <= gate):      # NaN compares unconverged
        return p_cand
    pc = backend(case, pcoef, rhs, p_fallback * case.fluid, aux)
    i = 1
    while i < cfg.sm_safeguard_extra and not bool(rnorm(pc) <= gate):
        pc = backend(case, pcoef, rhs, pc, aux)
        i += 1
    return pc


def piso_step(case: Case, flow: Flow, cfg: PisoConfig = PisoConfig(),
              backend=MGBackend(), sm_predict=None) -> Flow:
    """Advance one PISO timestep (the JAX package's `_piso_step_impl`;
    PyTorch runs it eagerly, so no jit wrapper sits around it).

    `backend(case, coef, rhs, p_prev, aux) -> p` solves the pressure
    equation each corrector. `sm_predict(case, p_prev, aux) -> p`
    optionally replaces the initial pressure with a surrogate prediction:
    it warm-starts the step, it does not replace the corrector solve."""
    grid = case.grid
    volc = case.alpha * (grid.dx * grid.dy)   # cut-cell fluid volumes
    dt = _next_dt(case, flow, cfg)

    u, v, p = flow.u, flow.v, flow.p
    phi_x, phi_y = flow.phi_x, flow.phi_y

    def _aux():
        return dict(u=u, v=v, p=p, dt=dt, u_prev=flow.u_prev,
                    v_prev=flow.v_prev, p_prev=flow.p_prev)

    # --- surrogate pressure prediction (Algorithm 2: before UEqn) ---
    if sm_predict is not None:
        p_sm = sm_predict(case, p, _aux())
        p = (_gate_sm_prediction(p_sm, p, case.fluid)
             if cfg.sm_safeguard > 0.0 else p_sm * case.fluid)

    # --- momentum predictor: solve(UEqn == -grad p) ---
    gpx, gpy = pressure_gradient(case, p)
    coef = momentum_coeffs(case, phi_x, phi_y, u, v, dt)
    u, v = jacobi_momentum(coef, case, u, v, -gpx * volc, -gpy * volc,
                           sweeps=cfg.momentum_sweeps,
                           smoother=cfg.momentum_smoother)

    # --- PISO corrector loop (pEqn, nCorrectors times) ---
    for i_corr in range(cfg.n_correctors):
        rau = volc * case.fluid / coef.a_p   # rAU = 1/A() = V/a_P  [s]
        hu, hv = h_operator(coef, u, v)
        hbya_u = hu * case.fluid / coef.a_p  # HbyA = H()/A() = h/a_P
        hbya_v = hv * case.fluid / coef.a_p
        phi_hx, phi_hy = face_fluxes_hbya(case, hbya_u, hbya_v)

        pcoef = pressure_coeffs(case, rau)
        rhs = pressure_rhs(case, phi_hx, phi_hy)
        p = backend(case, pcoef, rhs, p, _aux())
        if sm_predict is not None and cfg.sm_safeguard > 0.0 \
                and i_corr == 0:
            # the SM init only enters the first corrector
            p = _rescue_if_unconverged(case, pcoef, rhs, p, flow.p,
                                       backend, _aux(), cfg)

        phi_x, phi_y = correct_fluxes(case, pcoef, p, phi_hx, phi_hy)
        gpx, gpy = pressure_gradient(case, p)
        u = (hbya_u - rau * gpx) * case.fluid
        v = (hbya_v - rau * gpy) * case.fluid

    return Flow(u=u, v=v, p=p, phi_x=phi_x, phi_y=phi_y,
                dt=dt, t=flow.t + dt,
                u_prev=flow.u, v_prev=flow.v, p_prev=flow.p)


def _bind_sm(sm_predict, case: Case):
    """Resolve a predictor's per-case stitch operator once, before the
    rollout (surrogate.pipeline.Predictor.bind)."""
    bind = getattr(sm_predict, "bind", None)
    return sm_predict if bind is None else bind(case)


def run_piso_eager(case: Case, flow: Flow, n_steps: int,
                   cfg: PisoConfig = PisoConfig(), backend=MGBackend(),
                   sm_predict=None) -> Flow:
    """Forward rollout of n_steps PISO steps."""
    if sm_predict is not None:
        sm_predict = _bind_sm(sm_predict, case)
    with torch.no_grad():
        for _ in range(n_steps):
            flow = piso_step(case, flow, cfg=cfg, backend=backend,
                             sm_predict=sm_predict)
    return flow
