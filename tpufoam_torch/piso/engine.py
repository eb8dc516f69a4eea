"""The PISO timestep engine.

One step: Courant-limited adaptive dt, the optional surrogate pressure
prediction before the momentum predictor (Algorithm 2 of the DLPoissonFoam
coupling) or between it and the correctors (Algorithm 1), the implicit
momentum predictor (UEqn), and nCorrectors PISO pressure corrections
(pEqn). PyTorch runs it eagerly; the only host synchronisation per step is
the residual safeguard's gate. The grid is uniform or stretched. The
turbulent step (`piso_step_sst`) adds the k-omega SST model: the PISO step
with nu_eff = nu + nu_t (and the log-law wall links with
cfg.turb_wall_fn), then `turbulence->correct()` on the corrected
velocity.

The step takes one case, or a stacked fleet of cases (piso.batched) with
a leading case axis on every field and `dt`, `t` of shape (B,). Each case
then evolves as if alone, with the semantics of the JAX package's
`jax.vmap` of the step: per-case dt, per-case gates, and a rescue that
acts only on the cases that need it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch

from ..fv.case import (Case, Flow, fluxes_from_velocity, grid_metrics,
                       per_case)
from ..fv.momentum import h_operator, jacobi_momentum, momentum_coeffs
from ..fv.operators import divergence, maximum, minimum
from ..fv.pressure import (correct_fluxes, face_fluxes_hbya, pressure_coeffs,
                           pressure_gradient, pressure_matvec, pressure_rhs)
from ..solvers.backends import CGBackend
from ..solvers.cg import _norm


@dataclasses.dataclass(frozen=True)
class PisoConfig:
    """The step's knobs, with the JAX package's defaults and field order:
    nCorrectors 2, maxCo 0.5, limitedLinearV convection, Euler ddt,
    Algorithm 2. Every option of the JAX package's step is here."""
    n_correctors: int = 2
    momentum_sweeps: int = 8          # the kernel takes <= 8; more run
                                      # the sweep loop
    max_co: float = 0.5
    max_dt: float = 0.05
    adjust_dt: bool = True            # False: keep the incoming dt
    sm_before_predictor: bool = True  # True: Algorithm 2 (the prediction
                                      # before the momentum predictor);
                                      # False: Algorithm 1 (after it, from
                                      # the predicted U* and the old p)
    convection: str = "limitedLinear"  # | 'blend' | 'upwind'
                                       # (fv.momentum.momentum_coeffs)
    convection_blend: float = 0.0     # gamma for convection='blend'
    ddt: str = "euler"                # | 'backward' (variable-step BDF2
                                      # from u_prev, v_prev and the
                                      # previous step size)
    momentum_smoother: str = "plain"  # 'plain' (JAX 'xla'): the sweep
                                      # loop of fv.momentum; 'kernel' (JAX
                                      # 'pallas'): ops.momentum (the CUDA
                                      # kernel on the card, its plain
                                      # version on the CPU)
    turb_wall_fn: bool = False        # high-Re wall functions for the SST
                                      # model and log-law momentum wall
                                      # links (fv.turbulence.sst_step
                                      # wall_fn; for uniform grids whose
                                      # first cell sits in the log layer);
                                      # laminar steps ignore it
    inlet_scale_fn: object = None     # optional callable t -> scale of
                                      # case.inlet_u at the new time level
                                      # (the 2D-3 ramp eval.benchmark.
                                      # ramp_2d3), evaluated in the step
    ddt_corr: bool = False            # fvc::ddtCorr: each corrector's
                                      # phiHbyA takes back the old face
                                      # flux phi^n in place of the
                                      # interpolated u^n (interior faces,
                                      # OpenFOAM's coupling limiter); under
                                      # 'backward' scaled by the BDF2
                                      # implicit coefficient, without the
                                      # phi^{n-1} term
    t_stop: float = 0.0               # > 0: cap dt so the run lands on
                                      # t_stop; steps at or past it take a
                                      # 1e-6 floor dt
    wall_order: int = 1               # 2: the second-order embedded-wall
                                      # shear correction (fv.momentum.
                                      # wall_shear2_source), with its term
                                      # in fv.forces; cut-cell cases only
    wall_link: str = "full"           # 'tangential': the embedded no-slip
                                      # link on the tangential velocity
                                      # only (fv.momentum.
                                      # wall_normal_release), with its term
                                      # in fv.forces; cut-cell cases only
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
    shard_mesh: object = None         # parallel.mesh.Mesh (hashable): the
                                      # momentum kernel then runs per block
                                      # of the mesh on halo-extended blocks
                                      # of the whole fields (ops.sharded;
                                      # the decomposed step of parallel.
                                      # mesh keeps its fields per block and
                                      # needs none)


def _courant_field(case: Case, phi_x: torch.Tensor,
                   phi_y: torch.Tensor) -> torch.Tensor:
    """Each cell's summed |face fluxes| over its fluid volume (over
    alpha alone on a uniform grid, whose volume `_courant_of_peak`
    divides by): the field whose max the Courant number scales."""
    grid = case.grid
    sum_phi = (torch.abs(phi_x[..., 1:]) + torch.abs(phi_x[..., :-1])
               + torch.abs(phi_y[..., 1:, :]) + torch.abs(phi_y[..., :-1, :]))
    # cut cells: floor alpha at 0.5 so sliver cells don't collapse dt
    alpha_co = torch.clamp(case.alpha, min=0.5)
    if grid.stretched:
        m = grid_metrics(grid, case.device)
        return sum_phi * case.fluid / (alpha_co * (m.dxc * m.dyc))
    return sum_phi * case.fluid / alpha_co


def _courant_of_peak(grid, peak: torch.Tensor, dt: torch.Tensor):
    """The Courant number from the max of `_courant_field`."""
    if grid.stretched:
        return 0.5 * peak * dt
    return 0.5 * peak / (grid.dx * grid.dy) * dt


def courant_number(case: Case, flow: Flow) -> torch.Tensor:
    """max Courant number from face fluxes (CourantNo.H semantics), per
    case: () or (B,)."""
    return _courant_of_peak(case.grid, torch.amax(_courant_field(
        case, flow.phi_x, flow.phi_y), dim=(-2, -1)), flow.dt)


def continuity_error(case: Case, flow: Flow) -> torch.Tensor:
    """Mean |div phi| over fluid cells — the step's health diagnostic, per
    case: () or (B,)."""
    div = divergence(flow.phi_x, flow.phi_y) * case.fluid
    return torch.sum(torch.abs(div), dim=(-2, -1)) / torch.clamp(
        torch.sum(case.fluid, dim=(-2, -1)), min=1.0)


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


def piso_step(case: Case, flow: Flow, cfg: PisoConfig = PisoConfig(),
              backend=CGBackend(), sm_predict=None, nu_t=None,
              k_turb=None) -> Flow:
    """Advance one PISO timestep (the JAX package's `_piso_step_impl`;
    PyTorch runs it eagerly, so no jit wrapper sits around it). For a
    stacked fleet it advances every case in lockstep, with one momentum
    launch and one prediction for all of them.

    `backend(case, coef, rhs, p_prev, aux) -> p` solves the pressure
    equation each corrector. `sm_predict(case, p_prev, aux) -> p`
    optionally replaces the initial pressure with a surrogate prediction:
    it warm-starts the step, it does not replace the corrector solve. It
    runs before the momentum predictor (Algorithm 2), or with
    cfg.sm_before_predictor False after it (Algorithm 1); `aux` holds u,
    v and p as they stand when it is called. `nu_t` adds an eddy
    viscosity to the momentum predictor (fv.turbulence supplies it);
    `k_turb` switches its wall links to the log-law wall functions when
    cfg.turb_wall_fn is set."""
    grid = case.grid
    if grid.stretched:
        m = grid_metrics(grid, case.device)
        vol = m.dxc * m.dyc                   # (ny, nx) cell volumes
    else:
        vol = grid.dx * grid.dy
    volc = case.alpha * vol                   # cut-cell fluid volumes
    dt = _next_dt(case, flow, cfg) if cfg.adjust_dt else flow.dt
    if cfg.t_stop and cfg.t_stop > 0:
        # land exactly on t_stop, whether or not dt adapts
        dt = torch.minimum(dt, maximum(cfg.t_stop - flow.t, 1e-6)
                           ).to(flow.dt.dtype)
    if cfg.inlet_scale_fn is not None:
        # the inlet at the new time level, so the implicit momentum solve
        # sees dU_in/dt
        scale = cfg.inlet_scale_fn(flow.t + dt)
        case = dataclasses.replace(
            case, inlet_u=case.inlet_u * scale.unsqueeze(-1))

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
    coef = momentum_coeffs(case, phi_x, phi_y, u, v, dt,
                           convection_blend=cfg.convection_blend, nu_t=nu_t,
                           convection=cfg.convection,
                           k_turb=k_turb if cfg.turb_wall_fn else None,
                           ddt=cfg.ddt,
                           u_nm1=flow.u_prev, v_nm1=flow.v_prev,
                           dt_prev=flow.dt,
                           wall_grad_p=(gpx, gpy) if cfg.wall_order == 2
                           else None,
                           wall_link=cfg.wall_link)
    u, v = jacobi_momentum(coef, case, u, v, -gpx * volc, -gpy * volc,
                           sweeps=cfg.momentum_sweeps,
                           smoother=cfg.momentum_smoother,
                           mesh=cfg.shard_mesh)

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
        if cfg.ddt_corr:
            phi_hx, phi_hy = _ddt_corr(case, flow, cfg, dt, rau, phi_hx,
                                       phi_hy)

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


def _ddt_corr(case: Case, flow: Flow, cfg: PisoConfig, dt, rau, phi_hx,
              phi_hy):
    """fvc::ddtCorr(U, phi) on phiHbyA, out of place: the ddt source of the
    b-vector enters phiHbyA as interp(u^n); the correction puts the old
    face flux phi^n in its place, scaled by rAU_f * (the implicit ddt
    coefficient) / dt and OpenFOAM's coupling limiter
    (EulerDdtScheme::fvcDdtPhiCorr). Under ddt='backward' the implicit
    coefficient is the BDF2 one, and the phi^{n-1} term of
    backwardDdtScheme::fvcDdtPhiCorr is left out (the flow carries no
    old-old fluxes). Interior faces only: the domain's boundary fluxes
    are constrained."""
    dt = per_case(dt)
    if cfg.ddt == "backward":
        rr = dt / maximum(per_case(flow.dt), 1e-30)
        cddt = (1.0 + 2.0 * rr) / (1.0 + rr)
    else:
        cddt = 1.0
    phi_ux, phi_uy = fluxes_from_velocity(case, flow.u, flow.v)
    old_x, old_y = flow.phi_x[..., 1:-1], flow.phi_y[..., 1:-1, :]
    dpx = old_x - phi_ux[..., 1:-1]
    dpy = old_y - phi_uy[..., 1:-1, :]
    lim_x = 1.0 - minimum(torch.abs(dpx) / (torch.abs(old_x) + 1e-30), 1.0)
    lim_y = 1.0 - minimum(torch.abs(dpy) / (torch.abs(old_y) + 1e-30), 1.0)
    rau_fx = 0.5 * (rau[..., :-1] + rau[..., 1:])
    rau_fy = 0.5 * (rau[..., :-1, :] + rau[..., 1:, :])
    phi_hx = torch.cat([phi_hx[..., :1],
                        phi_hx[..., 1:-1] + cddt * lim_x * rau_fx / dt * dpx,
                        phi_hx[..., -1:]], dim=-1)
    phi_hy = torch.cat([phi_hy[..., :1, :],
                        phi_hy[..., 1:-1, :]
                        + cddt * lim_y * rau_fy / dt * dpy,
                        phi_hy[..., -1:, :]], dim=-2)
    return phi_hx, phi_hy


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


def piso_step_sst(case: Case, flow: Flow, turb,
                  cfg: PisoConfig = PisoConfig(), backend=CGBackend(),
                  sm_predict=None):
    """One turbulent timestep: PISO with nu_eff = nu + nu_t (the log-law
    wall links with cfg.turb_wall_fn), then `turbulence->correct()`
    (fv.turbulence.sst_step) on the corrected velocity, fluxes and dt.
    The predictor sees the laminar aux, as in the JAX package. Returns
    (Flow, TurbState)."""
    from ..fv.turbulence import sst_step
    flow2 = piso_step(case, flow, cfg=cfg, backend=backend,
                      sm_predict=sm_predict, nu_t=turb.nu_t,
                      k_turb=turb.k if cfg.turb_wall_fn else None)
    turb2 = sst_step(case, turb, flow2.u, flow2.v, flow2.phi_x, flow2.phi_y,
                     flow2.dt, wall_fn=cfg.turb_wall_fn)
    return flow2, turb2


def _rollout(case: Case, flow: Flow, chunks, cfg: PisoConfig, backend,
             sm_predict, grad: bool = False, turb=None):
    """Eager PISO steps in `chunks` (step counts), the predictor bound
    once; under torch.no_grad() unless `grad`. With `turb` the steps are
    `piso_step_sst`'s and the result is (Flow, TurbState)."""
    if sm_predict is not None:
        sm_predict = _bind_sm(sm_predict, case)
    with contextlib.nullcontext() if grad else torch.no_grad():
        for steps in chunks:
            for _ in range(steps):
                if turb is None:
                    flow = piso_step(case, flow, cfg=cfg, backend=backend,
                                     sm_predict=sm_predict)
                else:
                    flow, turb = piso_step_sst(case, flow, turb, cfg=cfg,
                                               backend=backend,
                                               sm_predict=sm_predict)
    return flow if turb is None else (flow, turb)


def run_piso(case: Case, flow: Flow, n_steps: int,
             cfg: PisoConfig = PisoConfig(), backend=CGBackend(),
             sm_predict=None) -> Flow:
    """Rollout of n_steps PISO steps with autograd on: the form to
    differentiate through (torch.autograd.grad of a loss of the result).
    The JAX package scans a jitted step; PyTorch has no scan, so this is
    the loop of run_piso_eager without torch.no_grad() and equals it bit
    for bit. On the card it differentiates what JAX differentiates: the
    plain momentum smoother (JAX's "xla") and a fixed-cycle MGBackend
    (f32 or the bf16 correction form) with the plain pressure smoother,
    every pressure matvec a launch of the stencil_matvec kernel and its
    backward a launch of stencil_matvec_grad. The momentum kernel and the
    multisweep kernels (JAX's Pallas kernels, which have no reverse mode)
    raise on a tensor that requires grad, naming the kernel; nothing
    switches to a plain version quietly. A surrogate warm start has no
    reference gradient: JAX's reverse mode refuses its safeguard's
    while_loop."""
    _warn_stiff_max_dt(case, cfg)
    return _rollout(case, flow, (n_steps,), cfg, backend, sm_predict,
                    grad=True)


def run_piso_eager(case: Case, flow: Flow, n_steps: int,
                   cfg: PisoConfig = PisoConfig(), backend=CGBackend(),
                   sm_predict=None) -> Flow:
    """Forward rollout of n_steps PISO steps."""
    if n_steps <= 0:
        return flow
    _warn_stiff_max_dt(case, cfg)
    return _rollout(case, flow, (n_steps,), cfg, backend, sm_predict)


def run_piso_chunked(case: Case, flow: Flow, n_steps: int,
                     cfg: PisoConfig = PisoConfig(), backend=CGBackend(),
                     sm_predict=None, chunk: int = 4) -> Flow:
    """The JAX package's rollout in chunks of k = max(1, min(chunk,
    n_steps)) steps, the remainder after them. JAX jits each chunk into
    one program; PyTorch has no such programs and runs every step
    eagerly, so `chunk` changes no result: this equals run_piso_eager bit
    for bit."""
    if n_steps <= 0:
        return flow
    _warn_stiff_max_dt(case, cfg)
    k = max(1, min(chunk, n_steps))
    n_chunks, rem = divmod(n_steps, k)
    return _rollout(case, flow, (k,) * n_chunks + (rem,), cfg, backend,
                    sm_predict)


def run_piso_sst(case: Case, flow: Flow, turb, n_steps: int,
                 cfg: PisoConfig = PisoConfig(), backend=CGBackend(),
                 sm_predict=None):
    """Turbulent n-step rollout with autograd on (see run_piso); equals
    run_piso_sst_eager bit for bit. Returns (Flow, TurbState)."""
    _warn_stiff_max_dt(case, cfg)
    return _rollout(case, flow, (n_steps,), cfg, backend, sm_predict,
                    grad=True, turb=turb)


def run_piso_sst_eager(case: Case, flow: Flow, turb, n_steps: int,
                       cfg: PisoConfig = PisoConfig(), backend=CGBackend(),
                       sm_predict=None):
    """Forward turbulent rollout of n_steps `piso_step_sst` steps.
    Returns (Flow, TurbState)."""
    if n_steps <= 0:
        return flow, turb
    _warn_stiff_max_dt(case, cfg)
    return _rollout(case, flow, (n_steps,), cfg, backend, sm_predict,
                    turb=turb)
