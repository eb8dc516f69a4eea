"""The PISO and SST steps on fields resident per block of a mesh: the
domain-decomposed step of parallel.mesh.make_sharded_piso_step and
make_sharded_sst_step.

The case, flow and SST state are those of parallel.mesh.shard_case,
shard_flow and shard_turbulence: every tensor a parallel.blocks
.BlockField, each block on its mesh device (the case's blocks with a
stored halo). Each stage of `engine.piso_step` runs per block, on the
block's window of a halo as deep as the stage's reach (an exchange of
the inputs' edge strips, the case's window a view), with the port's own
functions on a block case (the window's masks, walls and inlet, its
grid's local dims and, graded, its slice of the spacings), and keeps the
block's own cells and faces:
  _next_dt                 phi, 1 cell: the Courant number's max over
                           the blocks' own cells (a max is exact)
  pressure_gradient +      p, u, v, phi (and nu_t, k): 2 cells
    momentum_coeffs
  jacobi_momentum          its `momentum_sweeps` cells: the momentum
                           kernel (ops.momentum) once per block
  h_operator, HbyA,        u, v, the UEqn (and ddtCorr's old fields):
    face_fluxes_hbya,      2 cells
    ddtCorr, pressure_
    coeffs, pressure_rhs
  the pressure solve       solvers.decomposed (per-block kernels)
  correct_fluxes,          p: 1 cell
    pressure_gradient, U
  sst_step                 u, v, phi, k, omega, nu_t: its sweeps + 2
The arithmetic of every kept cell is the whole step's, so with a
fixed-cycle multigrid the step equals `piso_step` bit for bit. The
safeguard's norms are summed per block, then over the blocks in mesh
order (parallel.blocks.norm): its decisions are the whole step's but
where a norm sits within rounding of its gate.

The surrogate's one whole-field stage. `sm_predict` reads whole fields
(its 128-blocks overlap the mesh's blocks and its least-squares stitch
couples them all), so for the call the step gathers the case and the
fields the predictor reads (u, v, p, the previous step's u, v, p) to the
mesh's lead device, predicts there, and splits the prediction back to
the blocks; the gathered fields are dropped when the call returns. This
is the reference's own layout: its MPI variant gathers to rank 0 and
scatters the predicted pressure back. In a world of processes every
process gathers and predicts alike and keeps its own blocks. A
predictor with a stitch operator is bound once per sharded case, from
its first gathered case.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from ..fv.case import Case, Flow, grid_metrics
from ..fv.momentum import (MomentumCoeffs, h_operator, jacobi_momentum,
                           momentum_coeffs)
from ..fv.operators import maximum
from ..fv.pressure import (PressureCoeffs, correct_fluxes,
                           face_fluxes_hbya, pressure_coeffs,
                           pressure_gradient, pressure_rhs)
from ..fv.turbulence import TurbState, sst_step
from ..parallel.blocks import (BlockField, block_all, block_max, block_sum,
                               bmap, norm, split, stage, value,
                               whole_field_stage, window_grid)
from ..solvers import decomposed as dsolve
from . import engine
from .engine import PisoConfig, _ddt_corr, _dt_from_courant

# the halo of each stage (see the module docstring)
_H_MOMENTUM_COEFFS = 2
_H_CORRECTOR = 2
_H_CORRECT = 1
_SST_SWEEPS = 4


def _fields(dc) -> tuple:
    """A dataclass's fields in order, not copied (dataclasses.astuple
    deep-copies them)."""
    return tuple(getattr(dc, f.name) for f in dataclasses.fields(dc))


def _case_fields(case: Case) -> list[str]:
    return [f.name for f in dataclasses.fields(case)
            if isinstance(getattr(case, f.name), BlockField)]


def run(case: Case, h: int, fn, inputs, outputs):
    """fn(block case, *windows) on every block's windows of halo h (see
    parallel.blocks.stage); `outputs` by kind: "cell", "x" (phi_x), "y"
    (phi_y) or None (a scalar)."""
    mesh = case.fluid.mesh
    names = _case_fields(case)
    ny, nx = case.grid.shape
    kinds = {"cell": ((ny, nx), (0, 0)), "x": ((ny, nx + 1), (0, 1)),
             "y": ((ny + 1, nx), (1, 0)), None: None}

    def per_block(k, *w):
        wc = Case(grid=window_grid(case.grid, mesh, k, h), nu=case.nu,
                  cut=case.cut, **dict(zip(names, w)))
        return fn(wc, *w[len(names):])

    return stage(mesh, h, per_block, [getattr(case, n) for n in names]
                 + list(inputs), [kinds[o] for o in outputs])


def _volc(wc: Case):
    """case.alpha * the cell volumes, as piso_step forms it."""
    if wc.grid.stretched:
        m = grid_metrics(wc.grid, wc.device)
        return wc.alpha * (m.dxc * m.dyc)
    return wc.alpha * (wc.grid.dx * wc.grid.dy)


def courant_number(case: Case, flow: Flow) -> BlockField:
    """engine.courant_number over the blocks: each block's Courant field
    on its window (every cell of which has its faces), kept on its own
    cells, its max, the max over the blocks (parallel.blocks.block_max),
    scaled as the whole step scales it. A max is exact, so the value is
    the whole step's; where autograd records, `_split_ties` gives it its
    gradient, the whole step's."""
    mesh = case.fluid.mesh
    field, = run(case, 1, lambda wc, px, py: (engine._courant_field(
        wc, px, py),), [flow.phi_x, flow.phi_y], ["cell"])
    fields = dict(field.local())
    peak = block_max(mesh, {k: torch.amax(t.detach())
                            for k, t in fields.items()})
    if torch.is_grad_enabled():
        peak = _split_ties(mesh, fields, peak)
    return bmap(lambda m, dt: engine._courant_of_peak(case.grid, m, dt),
                peak, flow.dt)


def _split_ties(mesh, fields: dict, peak: BlockField) -> BlockField:
    """`peak`, the max of the blocks' `fields` (no gradient of its own),
    with a gradient split evenly over every cell of the domain that
    equals it, as the whole step's amax and jnp.max split it (block_max
    would split it over the tied blocks, then over each block's tied
    cells). The tied cells' sum over the blocks, over their count,
    carries the gradient; the value added is its difference from itself,
    0, so the value is `peak`'s bit for bit."""
    sums = {}
    for k, t in fields.items():
        tied = (t == peak.blocks[k]).to(t.dtype)
        sums[k] = torch.stack([(t * tied).sum(), tied.sum()])
    total = block_sum(mesh, sums)

    def split(m, s):
        mean = s[0] / s[1].detach()
        return m + torch.where(torch.isfinite(m), mean - mean.detach(),
                               0.0)
    return bmap(split, peak, total)


def continuity_error(case: Case, flow: Flow) -> BlockField:
    """engine.continuity_error over the blocks (sums per block, then over
    the blocks in mesh order)."""
    mesh = case.fluid.mesh
    div, = run(case, 1, lambda wc, px, py: (
        (px[..., 1:] - px[..., :-1]) + (py[..., 1:, :] - py[..., :-1, :]),),
        [flow.phi_x, flow.phi_y], ["cell"])
    num = block_sum(mesh, {k: torch.sum(torch.abs(d * case.fluid.interior(
        k))) for k, d in div.local()})
    den = block_sum(mesh, {k: torch.sum(case.fluid.interior(k))
                           for k in mesh.local_blocks})
    return bmap(lambda a, b: a / torch.clamp(b, min=1.0), num, den)


def _whole_case(case: Case) -> Case:
    return dataclasses.replace(case, **{
        n: getattr(case, n).gather() for n in _case_fields(case)})


class SurrogateStage:
    """The predictor's whole-field stage (see the module docstring)."""

    def __init__(self, sm_predict):
        self.sm_predict = sm_predict
        self.bound = None         # (the sharded case's fluid, bound fn)

    def __call__(self, case: Case, p_in: BlockField, aux: dict):
        mesh = case.fluid.mesh
        with whole_field_stage("surrogate"):
            whole = _whole_case(case)
            if self.bound is None or self.bound[0] is not case.fluid:
                bind = getattr(self.sm_predict, "bind", None)
                self.bound = (case.fluid, self.sm_predict if bind is None
                              else bind(whole))
            fields = {n: a.gather() if isinstance(a, BlockField) else a
                      for n, a in aux.items()}
            p_sm = self.bound[1](whole, fields["p"], fields)
            return split(mesh, p_sm)


def _gate(p_sm: BlockField, p_in: BlockField, fluid: BlockField,
          trust: float) -> BlockField:
    """engine._gate_sm_prediction on the blocks."""
    mesh = fluid.mesh
    ok = block_all(mesh, {k: torch.isfinite(t).all()
                          for k, t in p_sm.local()})
    if trust > 0.0:
        dn = norm(bmap(lambda a, b, f: (a - b) * f, p_sm, p_in, fluid))
        pn = norm(bmap(torch.mul, p_in, fluid))
        ok = bmap(lambda o, d, n: o & ((d <= trust * n) | (n == 0.0)),
                  ok, dn, pn)
    return bmap(lambda o, a, b, f: torch.where(o, a, b) * f,
                ok, p_sm, p_in, fluid)


def _rescue(case: Case, op, rhs: BlockField, p_cand: BlockField,
            p_fallback: BlockField, backend, cfg: PisoConfig) -> BlockField:
    """engine._rescue_if_unconverged on the blocks (counted there)."""
    def masked(p):
        return bmap(torch.mul, p, case.fluid)

    def ok(p):
        r = norm(masked(dsolve.residual(op, rhs, p)))
        return value(bmap(lambda a, g: a <= g, r, gate))

    gate = bmap(lambda n: cfg.sm_safeguard * (n + 1e-30), norm(masked(rhs)))
    if ok(p_cand):
        return p_cand
    rescue = engine._rescue_if_unconverged
    rescue.solves += 1
    pc = dsolve.solve(backend, case, op, rhs, masked(p_fallback))
    for _ in range(cfg.sm_safeguard_extra - 1):
        if ok(pc):
            break
        rescue.solves += 1
        pc = dsolve.solve(backend, case, op, rhs, pc)
    return pc


def piso_step(case: Case, flow: Flow, cfg: PisoConfig = PisoConfig(),
              backend=None, sm_predict=None, nu_t=None,
              k_turb=None) -> Flow:
    """engine.piso_step on the blocks (see the module docstring).
    `sm_predict` is the predictor, or a `SurrogateStage` of it."""
    if backend is None:
        raise ValueError("the decomposed step needs a backend")
    if sm_predict is not None and not isinstance(sm_predict, SurrogateStage):
        sm_predict = SurrogateStage(sm_predict)
    mesh = case.fluid.mesh
    if cfg.adjust_dt:
        dt = bmap(lambda c, d: _dt_from_courant(c, d, cfg),
                  courant_number(case, flow), flow.dt)
    else:
        dt = flow.dt
    if cfg.t_stop and cfg.t_stop > 0:
        dt = bmap(lambda d, t: torch.minimum(d, maximum(
            cfg.t_stop - t, 1e-6)).to(d.dtype), dt, flow.t)
    if cfg.inlet_scale_fn is not None:
        scale = bmap(lambda t, d: cfg.inlet_scale_fn(t + d), flow.t, dt)
        inlet = case.inlet_u
        case = dataclasses.replace(case, inlet_u=BlockField(
            mesh, inlet.shape, [None if b is None else
                                b * scale.blocks[k].unsqueeze(-1)
                                for k, b in enumerate(inlet.blocks)],
            halo=inlet.halo))

    u, v, p = flow.u, flow.v, flow.p
    phi_x, phi_y = flow.phi_x, flow.phi_y

    def _predict(p_in):
        aux = dict(u=u, v=v, p=p, dt=dt, u_prev=flow.u_prev,
                   v_prev=flow.v_prev, p_prev=flow.p_prev)
        p_sm = sm_predict(case, p_in, aux)
        if cfg.sm_safeguard > 0.0 or cfg.sm_trust > 0.0:
            return _gate(p_sm, p_in, case.fluid, cfg.sm_trust)
        return bmap(torch.mul, p_sm, case.fluid)

    if sm_predict is not None and cfg.sm_before_predictor:
        p = _predict(p)

    # --- momentum predictor ---
    def coeffs(wc, p_, px, py, u_, v_, dt_, up, vp, dtp, nut, kt):
        gpx, gpy = pressure_gradient(wc, p_)
        coef = momentum_coeffs(
            wc, px, py, u_, v_, dt_, convection_blend=cfg.convection_blend,
            nu_t=nut, convection=cfg.convection,
            k_turb=kt if cfg.turb_wall_fn else None, ddt=cfg.ddt,
            u_nm1=up, v_nm1=vp, dt_prev=dtp,
            wall_grad_p=(gpx, gpy) if cfg.wall_order == 2 else None,
            wall_link=cfg.wall_link)
        volc = _volc(wc)
        return (*_fields(coef), -gpx * volc, -gpy * volc)

    coef_src = run(case, _H_MOMENTUM_COEFFS, coeffs,
                   [p, phi_x, phi_y, u, v, dt, flow.u_prev, flow.v_prev,
                    flow.dt, nu_t, k_turb], ["cell"] * 9)
    coef = MomentumCoeffs(*coef_src[:7])

    def momentum(wc, *w):
        return jacobi_momentum(MomentumCoeffs(*w[:7]), wc, w[9], w[10],
                               w[7], w[8], sweeps=cfg.momentum_sweeps,
                               smoother=cfg.momentum_smoother)

    u, v = run(case, cfg.momentum_sweeps, momentum, [*coef_src, u, v],
               ["cell", "cell"])

    if sm_predict is not None and not cfg.sm_before_predictor:
        p = _predict(p)

    # --- PISO correctors ---
    old = (flow.u, flow.v, flow.phi_x, flow.phi_y, flow.dt)
    for i_corr in range(cfg.n_correctors):
        def front(wc, *w):
            c = MomentumCoeffs(*w[:7])
            u_, v_, dt_ = w[7:10]
            volc = _volc(wc)
            rau = volc * wc.fluid / c.a_p
            hu, hv = h_operator(c, u_, v_)
            hbya_u = hu * wc.fluid / c.a_p
            hbya_v = hv * wc.fluid / c.a_p
            phx, phy = face_fluxes_hbya(wc, hbya_u, hbya_v)
            if cfg.ddt_corr:
                fu, fv, fpx, fpy, fdt = w[10:]
                phx, phy = _ddt_corr(wc, types.SimpleNamespace(
                    u=fu, v=fv, phi_x=fpx, phi_y=fpy, dt=fdt), cfg, dt_,
                    rau, phx, phy)
            pc = pressure_coeffs(wc, rau)
            rhs = pressure_rhs(wc, phx, phy)
            return (rau, hbya_u, hbya_v, phx, phy,
                    *_fields(pc), rhs)

        outs = run(case, _H_CORRECTOR, front,
                   [*_fields(coef), u, v, dt,
                    *(old if cfg.ddt_corr else ())],
                   ["cell"] * 3 + ["x", "y"] + ["cell"] * 7)
        rau, hbya_u, hbya_v, phi_hx, phi_hy = outs[:5]
        op = dsolve.BlockOperator(PressureCoeffs(*outs[5:11]))
        rhs = outs[11]
        p = dsolve.solve(backend, case, op, rhs, p)
        if sm_predict is not None and cfg.sm_safeguard > 0.0 \
                and i_corr == 0:
            p = _rescue(case, op, rhs, p, flow.p, backend, cfg)

        def back(wc, *w):
            pc = PressureCoeffs(*w[:6])
            p_, phx, phy, hu, hv, rau_ = w[6:]
            px, py = correct_fluxes(wc, pc, p_, phx, phy)
            gpx, gpy = pressure_gradient(wc, p_)
            return (px, py, (hu - rau_ * gpx) * wc.fluid,
                    (hv - rau_ * gpy) * wc.fluid)

        phi_x, phi_y, u, v = run(
            case, _H_CORRECT, back,
            [*_fields(op.coef), p, phi_hx, phi_hy, hbya_u,
             hbya_v, rau], ["x", "y", "cell", "cell"])

    return Flow(u=u, v=v, p=p, phi_x=phi_x, phi_y=phi_y, dt=dt,
                t=bmap(torch.add, flow.t, dt), u_prev=flow.u,
                v_prev=flow.v, p_prev=flow.p)


def piso_step_sst(case: Case, flow: Flow, turb: TurbState,
                  cfg: PisoConfig = PisoConfig(), backend=None,
                  sm_predict=None):
    """engine.piso_step_sst on the blocks: the decomposed PISO step with
    nu_t (and k for the wall functions), then sst_step per block on a
    window of its sweeps + 2 cells. Returns (Flow, TurbState)."""
    flow2 = piso_step(case, flow, cfg=cfg, backend=backend,
                      sm_predict=sm_predict, nu_t=turb.nu_t,
                      k_turb=turb.k if cfg.turb_wall_fn else None)

    def sst(wc, k, w, nut, k_in, w_in, u, v, px, py, dt):
        t = sst_step(wc, TurbState(k=k, omega=w, nu_t=nut, k_in=k_in,
                                   w_in=w_in), u, v, px, py, dt,
                     sweeps=_SST_SWEEPS, wall_fn=cfg.turb_wall_fn)
        return t.k, t.omega, t.nu_t

    k, w, nut = run(case, _SST_SWEEPS + 2, sst,
                    [turb.k, turb.omega, turb.nu_t, turb.k_in, turb.w_in,
                     flow2.u, flow2.v, flow2.phi_x, flow2.phi_y, flow2.dt],
                    ["cell"] * 3)
    return flow2, TurbState(k=k, omega=w, nu_t=nut, k_in=turb.k_in,
                            w_in=turb.w_in)
