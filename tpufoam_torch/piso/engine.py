"""The PISO timestep engine.

One step: Courant-limited adaptive dt, the optional surrogate pressure
prediction before the momentum predictor (Algorithm 2 of the DLPoissonFoam
coupling), the implicit momentum predictor (UEqn), and nCorrectors PISO
pressure corrections (pEqn). PyTorch runs it eagerly; the only host
synchronisation per step is the residual safeguard's gate.

The step takes one case, or a stacked fleet of cases (piso.batched) with
a leading case axis on every field and `dt`, `t` of shape (B,). Each case
then evolves as if alone, with the semantics of the JAX package's
`jax.vmap` of the step: per-case dt, per-case gates, and a rescue that
acts only on the cases that need it.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from ..fv.case import Case, Flow, per_case
from ..fv.momentum import h_operator, jacobi_momentum, momentum_coeffs
from ..fv.operators import divergence
from ..fv.pressure import (correct_fluxes, face_fluxes_hbya, pressure_coeffs,
                           pressure_gradient, pressure_matvec, pressure_rhs)
from ..solvers.backends import CGBackend
from ..solvers.cg import _norm


@dataclasses.dataclass(frozen=True)
class PisoConfig:
    """The step's knobs, with the JAX package's defaults: nCorrectors 2,
    maxCo 0.5, limitedLinearV convection, Euler ddt. Its options
    ddt_corr, wall_order, wall_link, sm_before_predictor (Algorithm 1),
    turb_wall_fn and shard_mesh are not ported and have no field."""
    n_correctors: int = 2
    momentum_sweeps: int = 8          # the kernel takes <= 8; more run
                                      # the sweep loop
    max_co: float = 0.5
    max_dt: float = 0.05
    adjust_dt: bool = True            # False: keep the incoming dt
    convection: str = "limitedLinear"  # | 'blend' | 'upwind'
                                       # (fv.momentum.momentum_coeffs)
    convection_blend: float = 0.0     # gamma for convection='blend'
    ddt: str = "euler"                # | 'backward' (variable-step BDF2
                                      # from u_prev, v_prev and the
                                      # previous step size)
    inlet_scale_fn: object = None     # optional callable t -> scale of
                                      # case.inlet_u at the new time level
                                      # (the 2D-3 ramp eval.benchmark.
                                      # ramp_2d3), evaluated in the step
    t_stop: float = 0.0               # > 0: cap dt so the run lands on
                                      # t_stop; steps at or past it take a
                                      # 1e-6 floor dt
    momentum_smoother: str = "plain"  # 'plain' (JAX 'xla'): the sweep
                                      # loop of fv.momentum; 'kernel' (JAX
                                      # 'pallas'): ops.momentum (the CUDA
                                      # kernel on the card, its plain
                                      # version on the CPU)
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


def courant_number(case: Case, flow: Flow) -> torch.Tensor:
    """max Courant number from face fluxes (CourantNo.H semantics), per
    case: () or (B,)."""
    grid = case.grid
    sum_phi = (torch.abs(flow.phi_x[..., 1:])
               + torch.abs(flow.phi_x[..., :-1])
               + torch.abs(flow.phi_y[..., 1:, :])
               + torch.abs(flow.phi_y[..., :-1, :]))
    # cut cells: floor alpha at 0.5 so sliver cells don't collapse dt
    alpha_co = torch.clamp(case.alpha, min=0.5)
    vol = grid.dx * grid.dy
    return 0.5 * torch.amax(sum_phi * case.fluid / alpha_co,
                            dim=(-2, -1)) / vol * flow.dt


def continuity_error(case: Case, flow: Flow) -> torch.Tensor:
    """Mean |div phi| over fluid cells — the step's health diagnostic, per
    case: () or (B,)."""
    div = divergence(flow.phi_x, flow.phi_y) * case.fluid
    return torch.sum(torch.abs(div), dim=(-2, -1)) / torch.clamp(
        torch.sum(case.fluid, dim=(-2, -1)), min=1.0)


def _next_dt(case: Case, flow: Flow, cfg: PisoConfig) -> torch.Tensor:
    """setDeltaT.H: damped growth toward maxCo, hard caps."""
    co = courant_number(case, flow) / torch.clamp(flow.dt, min=1e-12)
    dt_co = cfg.max_co / torch.clamp(co, min=1e-12)
    new_dt = torch.clamp(torch.minimum(dt_co, 1.2 * flow.dt), max=cfg.max_dt)
    return new_dt.to(flow.dt.dtype)


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
    pc = backend(case, pcoef, rhs, p_fallback * case.fluid, aux)
    for _ in range(cfg.sm_safeguard_extra - 1):
        todo = bad & ~ok(pc)
        if not bool(todo.any()):
            break
        pc = torch.where(per_case(todo), backend(case, pcoef, rhs, pc, aux),
                         pc)
    return torch.where(per_case(bad), pc, p_cand)


def piso_step(case: Case, flow: Flow, cfg: PisoConfig = PisoConfig(),
              backend=CGBackend(), sm_predict=None) -> Flow:
    """Advance one PISO timestep (the JAX package's `_piso_step_impl`;
    PyTorch runs it eagerly, so no jit wrapper sits around it). For a
    stacked fleet it advances every case in lockstep, with one momentum
    launch and one prediction for all of them.

    `backend(case, coef, rhs, p_prev, aux) -> p` solves the pressure
    equation each corrector. `sm_predict(case, p_prev, aux) -> p`
    optionally replaces the initial pressure with a surrogate prediction:
    it warm-starts the step, it does not replace the corrector solve."""
    grid = case.grid
    volc = case.alpha * (grid.dx * grid.dy)   # cut-cell fluid volumes
    dt = _next_dt(case, flow, cfg) if cfg.adjust_dt else flow.dt
    if cfg.t_stop and cfg.t_stop > 0:
        # land exactly on t_stop, whether or not dt adapts
        dt = torch.minimum(dt, torch.clamp(cfg.t_stop - flow.t, min=1e-6)
                           ).to(flow.dt.dtype)
    if cfg.inlet_scale_fn is not None:
        # the inlet at the new time level, so the implicit momentum solve
        # sees dU_in/dt
        scale = cfg.inlet_scale_fn(flow.t + dt)
        case = dataclasses.replace(
            case, inlet_u=case.inlet_u * scale.unsqueeze(-1))

    u, v, p = flow.u, flow.v, flow.p
    phi_x, phi_y = flow.phi_x, flow.phi_y

    def _aux():
        return dict(u=u, v=v, p=p, dt=dt, u_prev=flow.u_prev,
                    v_prev=flow.v_prev, p_prev=flow.p_prev)

    # --- surrogate pressure prediction (Algorithm 2: before UEqn) ---
    if sm_predict is not None:
        p_sm = sm_predict(case, p, _aux())
        p = (_gate_sm_prediction(p_sm, p, case.fluid, trust=cfg.sm_trust)
             if cfg.sm_safeguard > 0.0 or cfg.sm_trust > 0.0
             else p_sm * case.fluid)

    # --- momentum predictor: solve(UEqn == -grad p) ---
    gpx, gpy = pressure_gradient(case, p)
    coef = momentum_coeffs(case, phi_x, phi_y, u, v, dt,
                           convection_blend=cfg.convection_blend,
                           convection=cfg.convection, ddt=cfg.ddt,
                           u_nm1=flow.u_prev, v_nm1=flow.v_prev,
                           dt_prev=flow.dt)
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


def _warn_stiff_max_dt(case: Case, cfg: PisoConfig, limit: float = 4.0):
    """Warn when cfg.max_dt allows a momentum diffusion number
    nu*dt/(dx*dy) above `limit`: the fixed-sweep momentum solve
    under-converges there, and slow-flow phases (start-up, ramp feet) can
    ring instead of decaying. It warns on the worst dt the config allows,
    not on the dt the run will see."""
    dx2 = float(case.grid.dx) * float(case.grid.dy)
    d_num = float(case.nu) * float(cfg.max_dt) / dx2
    if d_num > limit:
        warnings.warn(
            f"max_dt={cfg.max_dt:g} allows a momentum diffusion number "
            f"nu*dt/(dx*dy) = {d_num:.1f} > {limit:g}; the fixed-sweep "
            f"momentum solve under-converges there and slow-flow phases "
            f"(startup, ramp feet) can ring instead of decaying. Lower "
            f"max_dt to <= {limit * dx2 / float(case.nu):.2e} "
            f"(or raise momentum sweeps) if dt reaches the cap.",
            stacklevel=3)


def run_piso_eager(case: Case, flow: Flow, n_steps: int,
                   cfg: PisoConfig = PisoConfig(), backend=CGBackend(),
                   sm_predict=None) -> Flow:
    """Forward rollout of n_steps PISO steps."""
    if n_steps <= 0:
        return flow
    _warn_stiff_max_dt(case, cfg)
    if sm_predict is not None:
        sm_predict = _bind_sm(sm_predict, case)
    with torch.no_grad():
        for _ in range(n_steps):
            flow = piso_step(case, flow, cfg=cfg, backend=backend,
                             sm_predict=sm_predict)
    return flow


# The JAX package's rollout in `chunk`-step jitted programs. PyTorch has
# no such programs and runs every step eagerly: the same steps.
run_piso_chunked = run_piso_eager
