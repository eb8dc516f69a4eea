"""The PISO timestep engine.

One step: Courant-limited adaptive dt, the surrogate pressure prediction
before the momentum predictor (Algorithm 2 of the DLPoissonFoam coupling)
or between it and the correctors (Algorithm 1), the implicit momentum
predictor (UEqn), and nCorrectors PISO pressure corrections (pEqn), on a
uniform grid. The step takes one case (the reference checks a fleet case
by case); a leading case axis on every field, with `dt`, `t` of shape
(B,), is taken too.
"""

from __future__ import annotations

import dataclasses

import torch

from .case import Case, Flow, per_case
from .momentum import h_operator, jacobi_momentum, momentum_coeffs
from .operators import maximum, minimum
from .pressure import (_norm, correct_fluxes, face_fluxes_hbya,
                       pressure_coeffs, pressure_gradient, pressure_matvec,
                       pressure_rhs)


@dataclasses.dataclass(frozen=True)
class PisoConfig:
    """The step's knobs that a configuration states, with the JAX
    package's defaults: nCorrectors 2, maxCo 0.5, limitedLinearV
    convection, Euler ddt, Algorithm 2. The program's other options
    (turbulence, ddtCorr, wall corrections, inlet ramps, t_stop, a
    mesh) are not here: a configuration that names one fails to build."""
    n_correctors: int = 2
    momentum_sweeps: int = 8          # the kernel takes <= 8; more run
                                      # the sweep loop
    max_co: float = 0.5
    max_dt: float = 0.05
    adjust_dt: bool = True            # False: keep the incoming dt
    sm_before_predictor: bool = True  # True: Algorithm 2; False:
                                      # Algorithm 1 (the prediction from
                                      # the predicted U* and the old p)
    convection: str = "limitedLinear"  # the only scheme here
    ddt: str = "euler"                # the only scheme here
    momentum_smoother: str = "plain"  # 'plain': the sweep loop; 'kernel':
                                      # the multisweep (its plain form)
    sm_safeguard: float = 0.5         # residual gate on the first SM-warm-
                                      # started corrector solve: above it
                                      # (or NaN) the solve restarts from the
                                      # previous-step pressure; 0 disables
    sm_safeguard_extra: int = 3       # max rescue solves per step
    sm_trust: float = 0.0             # > 0: reject a prediction with
                                      # ||(p_sm - p_prev) fluid|| >
                                      # sm_trust ||p_prev fluid|| (fall
                                      # back to p_prev) before the
                                      # momentum predictor; an all-zero
                                      # p_prev passes; 0 disables

    def __post_init__(self):
        if self.convection != "limitedLinear" or self.ddt != "euler":
            raise ValueError("the reference implements limitedLinear "
                             "convection and Euler ddt only")


def _courant_field(case: Case, phi_x: torch.Tensor,
                   phi_y: torch.Tensor) -> torch.Tensor:
    """Each cell's summed |face fluxes| over its fluid fraction (the cell
    volume `_courant_of_peak` divides by): the field whose max the
    Courant number scales."""
    sum_phi = (torch.abs(phi_x[..., 1:]) + torch.abs(phi_x[..., :-1])
               + torch.abs(phi_y[..., 1:, :]) + torch.abs(phi_y[..., :-1, :]))
    # cut cells: floor alpha at 0.5 so sliver cells don't collapse dt
    alpha_co = torch.clamp(case.alpha, min=0.5)
    return sum_phi * case.fluid / alpha_co


def _courant_of_peak(grid, peak: torch.Tensor, dt: torch.Tensor):
    """The Courant number from the max of `_courant_field`."""
    return 0.5 * peak / (grid.dx * grid.dy) * dt


def courant_number(case: Case, flow: Flow) -> torch.Tensor:
    """max Courant number from face fluxes (CourantNo.H semantics), per
    case: () or (B,)."""
    return _courant_of_peak(case.grid, torch.amax(_courant_field(
        case, flow.phi_x, flow.phi_y), dim=(-2, -1)), flow.dt)


def _next_dt(case: Case, flow: Flow, cfg: PisoConfig) -> torch.Tensor:
    """setDeltaT.H: damped growth toward maxCo, hard caps."""
    return _dt_from_courant(courant_number(case, flow), flow.dt, cfg)


def _dt_from_courant(co, dt, cfg: PisoConfig) -> torch.Tensor:
    """_next_dt from the Courant number `co` of the step of size `dt`."""
    co = co / maximum(dt, 1e-12)
    dt_co = cfg.max_co / maximum(co, 1e-12)
    new_dt = minimum(torch.minimum(dt_co, 1.2 * dt), cfg.max_dt)
    return new_dt.to(dt.dtype)


def _gate_sm_prediction(p_sm: torch.Tensor, p_prev: torch.Tensor,
                        fluid: torch.Tensor,
                        trust: float = 0.0) -> torch.Tensor:
    """Reject a non-finite surrogate prediction wholesale, or with
    `trust` > 0 one that moves the pressure by more than `trust` times its
    norm (fall back to the incoming pressure), per case, on the device.
    An all-zero incoming pressure (the cold start) carries no scale, so
    the trust test passes it."""
    ok = torch.isfinite(p_sm).flatten(-2).all(dim=-1)
    if trust > 0.0:
        dn = _norm((p_sm - p_prev) * fluid)
        pn = _norm(p_prev * fluid)
        ok = ok & ((dn <= trust * pn) | (pn == 0.0))   # NaN dn: rejected
    return torch.where(per_case(ok), p_sm, p_prev) * fluid


def _rescue_if_unconverged(case: Case, pcoef, rhs, p_cand, p_fallback,
                           backend, aux, cfg: PisoConfig) -> torch.Tensor:
    """Residual safeguard for the SM-warm-started capped solve. If the
    first corrector's solution leaves a relative residual above the gate
    (or NaN), restart from the previous-step pressure: apply the backend
    once, then up to sm_safeguard_extra - 1 more times until the gate
    clears (a do-while). Healthy steps pay one matvec, two norms and one
    host read.

    Per case for a fleet: the rescue runs when any case is bad, and only
    the bad cases take its result; a case whose rescue has cleared the
    gate is frozen while the others go on (the JAX package's vmapped
    lax.cond and lax.while_loop give each case the same result)."""
    def ok(p):                           # NaN compares unconverged
        return _norm((rhs - pressure_matvec(pcoef, p)) * case.fluid) <= gate

    gate = cfg.sm_safeguard * (_norm(rhs * case.fluid) + 1e-30)
    bad = ~ok(p_cand)
    if not bool(bad.any()):
        return p_cand
    _rescue_if_unconverged.solves += 1
    pc = backend(case, pcoef, rhs, p_fallback * case.fluid, aux)
    for _ in range(cfg.sm_safeguard_extra - 1):
        todo = bad & ~ok(pc)
        if not bool(todo.any()):
            break
        _rescue_if_unconverged.solves += 1
        pc = torch.where(per_case(todo), backend(case, pcoef, rhs, pc, aux),
                         pc)
    return torch.where(per_case(bad), pc, p_cand)


# the safeguard's rescue solves (its decisions), counted
_rescue_if_unconverged.solves = 0


def piso_step(case: Case, flow: Flow, cfg: PisoConfig, backend,
              sm_predict=None) -> Flow:
    """Advance one PISO timestep (the JAX package's `_piso_step_impl`).

    `backend(case, coef, rhs, p_prev, aux) -> p` solves the pressure
    equation each corrector. `sm_predict(case, p_prev, aux) -> p`
    optionally replaces the initial pressure with a surrogate prediction:
    it warm-starts the step, it does not replace the corrector solve. It
    runs before the momentum predictor (Algorithm 2), or with
    cfg.sm_before_predictor False after it (Algorithm 1); `aux` holds u,
    v and p as they stand when it is called."""
    grid = case.grid
    volc = case.alpha * (grid.dx * grid.dy)   # cut-cell fluid volumes
    dt = _next_dt(case, flow, cfg) if cfg.adjust_dt else flow.dt

    u, v, p = flow.u, flow.v, flow.p
    phi_x, phi_y = flow.phi_x, flow.phi_y

    # reads u, v and p when it is called: Algorithm 1's prediction sees
    # the predicted U* and the old p
    def _aux():
        return dict(u=u, v=v, p=p, dt=dt, u_prev=flow.u_prev,
                    v_prev=flow.v_prev, p_prev=flow.p_prev)

    def _predict(p_in):
        p_sm = sm_predict(case, p_in, _aux())
        return (_gate_sm_prediction(p_sm, p_in, case.fluid,
                                    trust=cfg.sm_trust)
                if cfg.sm_safeguard > 0.0 or cfg.sm_trust > 0.0
                else p_sm * case.fluid)

    # --- surrogate pressure prediction (Algorithm 2: before UEqn) ---
    if sm_predict is not None and cfg.sm_before_predictor:
        p = _predict(p)

    # --- momentum predictor: solve(UEqn == -grad p) ---
    gpx, gpy = pressure_gradient(case, p)
    coef = momentum_coeffs(case, phi_x, phi_y, u, v, dt)
    u, v = jacobi_momentum(coef, case, u, v, -gpx * volc, -gpy * volc,
                           sweeps=cfg.momentum_sweeps,
                           smoother=cfg.momentum_smoother)

    # --- surrogate pressure prediction (Algorithm 1: after UEqn) ---
    if sm_predict is not None and not cfg.sm_before_predictor:
        p = _predict(p)

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


