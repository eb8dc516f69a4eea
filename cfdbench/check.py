"""What decides `correct`: the health gates of every case-step of the
window, and the plain reference's step from the program's own state.

The hybrid step's bf16 polish turns a one-ulp difference of its input
into percents of the velocity, within one step (a different rounding of
a bf16 correction, or of the residual safeguard's decision). So no
reference can follow the program's rollout, nor even its step as a
whole. The reference therefore follows the program stage by stage,
from the program's own state and calls. The benchmark records, in the
last step of the window and in the first step of the warm-up, every
call the program makes of the predictor and of the pressure backend it
hands it. For every case of the window's last step, and for one case of
each class (drawn from the seed) of the first, the reference then
  - predicts from each recorded prediction's inputs (`pred_gap`),
  - solves each recorded pressure system (`solve_gap`),
  - replays the step from the program's state before it, taking the
    program's prediction and solutions in place of its own, and compares
    each pressure system it assembles (`rhs_gap`: momentum predictor, H
    operator, face fluxes, pressure coefficients and right-hand side)
    and the velocity after the step (`u_gap`: flux and velocity
    correction; `dt_gap`: the dt control; the pressure after it is the
    last solve's, which `solve_gap` holds).
The start is checked by itself: the case build (`case_gap`) and the
first step, replayed from the reference's own initial flow. The reference
is the package that the configuration names (`spec.reference`; by default
the frozen `cfdbench/reference`), built with the configuration's options
as the program is. Nothing here imports the program.
"""

from __future__ import annotations

import os
import sys

import torch

from . import spec

FLOW_FIELDS = ("u", "v", "p", "phi_x", "phi_y", "dt", "t", "u_prev",
               "v_prev", "p_prev")
CASE_FIELDS = ("fluid", "sdf", "inlet_u", "open_e", "open_w", "open_n",
               "open_s", "wall_e", "wall_w", "wall_n", "wall_s", "inlet_w",
               "outlet_e", "alpha", "wall_ax", "wall_ay", "wall_len",
               "wall_dist")
COEF_FIELDS = ("c_e", "c_w", "c_n", "c_s", "c_out", "diag")
AUX_FIELDS = ("u", "v", "p", "dt", "u_prev", "v_prev", "p_prev")
LIMITED = ("case_gap", "pred_gap", "solve_gap", "rhs_gap", "u_gap",
           "dt_gap")


class Gates:
    """The configuration's guarantees, per case, on the device and with no
    host synchronisation: finite fields, the step's Courant number (its
    dt on its incoming fluxes) at most maxCo, and time advanced. The
    continuity error is read beside them, and bounds nothing: two bf16
    V-cycles leave what they leave, the reference alike."""

    def __init__(self, fluid, alpha, dx: float, dy: float):
        self.fluid = fluid
        self.inv_alpha = fluid / torch.clamp(alpha, min=0.5)
        self.n_fluid = torch.clamp(fluid.sum((-2, -1)), min=1.0)
        self.area = dx * dy

    def __call__(self, fin, fout) -> torch.Tensor:
        finite = (torch.isfinite(fout.u).flatten(-2).all(-1)
                  & torch.isfinite(fout.v).flatten(-2).all(-1)
                  & torch.isfinite(fout.p).flatten(-2).all(-1))
        div = (fout.phi_x[..., 1:] - fout.phi_x[..., :-1]
               + fout.phi_y[..., 1:, :] - fout.phi_y[..., :-1, :])
        cont = (div.abs() * self.fluid).sum((-2, -1)) / self.n_fluid
        sphi = (fin.phi_x[..., 1:].abs() + fin.phi_x[..., :-1].abs()
                + fin.phi_y[..., 1:, :].abs() + fin.phi_y[..., :-1, :].abs())
        co = 0.5 * torch.amax(sphi * self.inv_alpha, dim=(-2, -1)) \
            / self.area * fout.dt
        return torch.stack([finite.float(), cont, co,
                            (fout.t > fin.t).float()])


def gate_failures(rows: torch.Tensor, config: dict) -> tuple[int, dict]:
    """(case-steps that broke a gate, the worst reading of each gate
    beside its limit) from the stacked (steps, 4, cases) readings."""
    co_max = config["guarantees"]["max_co"] + 1e-3
    r = rows.double().cpu()
    finite, co, adv = r[:, 0], r[:, 2], r[:, 3]
    bad = (finite < 1) | ~(co <= co_max) | (adv < 1)
    worst = {
        "nonfinite_case_steps": [int((finite < 1).sum()), 0],
        "courant_max": [float(co.max()), co_max],
        "stalled_case_steps": [int((adv < 1).sum()), 0],
    }
    print(f"cfdbench: continuity error, the widest of the window "
          f"{float(r[:, 1].max()):.4g}", file=sys.stderr, flush=True)
    return int(bad.sum()), worst


class Recorder:
    """Wraps the backend and the predictor handed to the step, and keeps
    (references to) each call's operands and result."""

    def __init__(self, backend, predict):
        # the wrappers hold the lists, not the recorder: no reference
        # cycle, so the recorded tensors go with the recorder and not at
        # the collector's next pass (which would move the peak memory)
        solves, preds = [], []
        self.solves, self.preds = solves, preds

        def solve(case, coef, rhs, p_prev, aux):
            out = backend(case, coef, rhs, p_prev, aux)
            solves.append(({f: getattr(coef, f) for f in COEF_FIELDS},
                           rhs, p_prev, out))
            return out

        def pred(case, p_in, aux):
            out = predict(case, p_in, aux)
            preds.append((p_in, {f: aux[f] for f in AUX_FIELDS}, out))
            return out

        self.backend, self.predict = solve, pred

    def member(self, k, device) -> dict:
        """Copies, on `device`, of the calls as case k saw them (k None: a
        single case)."""
        def take(t):
            return (t if k is None else t[k]).to(device, copy=True)

        return {"solves": [({f: take(t) for f, t in c.items()}, take(r),
                            take(x), take(o))
                           for c, r, x, o in self.solves],
                "preds": [(take(p), {f: take(t) for f, t in a.items()},
                           take(o)) for p, a, o in self.preds]}


def _lowp(x):
    """Stored in bfloat16: a float32 tensor (or each in a dict) rounded."""
    if isinstance(x, dict):
        return {k: _lowp(v) for k, v in x.items()}
    return x.to(torch.bfloat16).to(x.dtype) if x.dtype == torch.float32 \
        else x


def _inf(t):                          # NaN reads as the widest gap
    return torch.nan_to_num(t.abs().double(), nan=float("inf"))


def _max_gap(out, ref) -> float:
    """The widest gap over the reference's range."""
    rng = float(ref.max() - ref.min())
    return float(_inf(out - ref).max()) / max(rng, 1e-30)


def _l2_gap(out, ref) -> float:
    return float(_inf(out - ref).square().sum().sqrt()) / max(
        float(ref.double().square().sum().sqrt()), 1e-30)


def _continuity(phi_x, phi_y, fluid) -> float:
    div = (phi_x[..., 1:] - phi_x[..., :-1] + phi_y[..., 1:, :]
           - phi_y[..., :-1, :])
    return float((div.abs() * fluid).sum() / fluid.sum())


class _Reference:
    """The reference's case, step, predictor and backend for one case,
    from the configuration's reference package `ref`
    (`spec.reference`)."""

    def __init__(self, config: dict, ref, shape: str, size: float,
                 device, bundle, control: bool):
        backends, rcase, engine, geometry, pipeline = (
            ref.backends, ref.case, ref.engine, ref.geometry, ref.pipeline)
        self.engine, self.rcase, self.pressure = engine, rcase, ref.pressure
        g = config["grid"]
        geom = geometry.channel_case_geometry(
            shape, length=g["length"], height=g["height"],
            obstacle_size=size, cx=spec.obstacle_x(config, size),
            nu=config["nu"], **spec.geometry_options(config))
        self.case = rcase.build_channel_case(
            geom, delta=g["height"] / g["ny"], device=device)
        self.cfg = engine.PisoConfig(**config["piso"])
        self.backend = spec.backend(backends, config["backend"])
        opts = spec.surrogate_options(config)
        self.predict = pipeline.make_predictor(bundle, **opts).bind(
            self.case)
        self.dt0 = config["dt0"]
        if control:
            # the control: the reference with its state, its prediction
            # and its pressure solutions stored in bfloat16, and its PCA
            # products on bfloat16 operands
            low = pipeline.make_predictor(
                bundle, **{**opts, "precision": "bf16"}).bind(self.case)
            solve = self.backend
            self.low_predict = lambda c, p, a: _lowp(low(c, p, a))
            self.low_backend = lambda c, k, r, x, a: _lowp(solve(c, k, r,
                                                                 x, a))

    def initial(self) -> dict:
        f0 = self.rcase.initial_flow(self.case, dt0=self.dt0)
        return {f: getattr(f0, f) for f in FLOW_FIELDS}

    def step(self, fields: dict, backend, predict):
        return self.engine.piso_step(self.case, self.rcase.Flow(**fields),
                                     cfg=self.cfg, backend=backend,
                                     sm_predict=predict)

    def control_step(self, before: dict):
        """The control in the program's place: (its recorded calls, its
        state after the step)."""
        rec = Recorder(self.low_backend, self.low_predict)
        out = self.step(_lowp(before), rec.backend, rec.predict)
        return (rec.member(None, before["u"].device),
                _lowp({f: getattr(out, f) for f in FLOW_FIELDS}))

    def replay(self, before: dict, after: dict, calls: dict) -> dict:
        """The stage gaps of one step of the program (its state before and
        after, its recorded calls) against the reference."""
        case, engine = self.case, self.engine
        gaps = {"pred_gap": 0.0, "solve_gap": 0.0, "rhs_gap": 0.0}
        for p_in, aux, out in calls["preds"]:
            gaps["pred_gap"] = max(gaps["pred_gap"], _max_gap(
                out, self.predict(case, p_in, aux)))
        for coef, rhs, x0, out in calls["solves"]:
            ref = self.backend(case, self.pressure.PressureCoeffs(**coef),
                               rhs, x0, {})
            gaps["solve_gap"] = max(gaps["solve_gap"], _max_gap(out, ref))

        # the step again, the program's prediction and solutions in place
        # of the reference's: the first corrector's solve is the program's
        # first call, its rescues the next, each later corrector's solve
        # one of the last; a call the program did not make is solved here
        progs = calls["solves"]
        n_rescue = len(progs) - self.cfg.n_correctors
        state = {"rescue": False, "r": 0, "c": 0}

        def solve(c, coef, rhs, p_prev, aux):
            if state["rescue"]:
                j = 1 + state["r"] if state["r"] < n_rescue else None
                state["r"] += 1
            else:
                j = 0 if state["c"] == 0 else n_rescue + state["c"]
                state["c"] += 1
            if j is None or not 0 <= j < len(progs):
                return self.backend(c, coef, rhs, p_prev, aux)
            pcoef, prhs = progs[j][0], progs[j][1]
            gaps["rhs_gap"] = max(
                gaps["rhs_gap"], _l2_gap(prhs, rhs),
                *(_l2_gap(pcoef[f], getattr(coef, f)) for f in COEF_FIELDS))
            return progs[j][3]

        preds = iter(calls["preds"])

        def predict(c, p_in, aux):
            p = next(preds, None)
            return self.predict(c, p_in, aux) if p is None else p[2]

        rescue = engine._rescue_if_unconverged

        def in_rescue(*a, **k):
            state["rescue"] = True
            try:
                return rescue(*a, **k)
            finally:
                state["rescue"] = False

        in_rescue.solves = 0
        engine._rescue_if_unconverged = in_rescue
        try:
            ref = self.step(before, solve, predict)
        finally:
            engine._rescue_if_unconverged = rescue
        gaps["u_gap"] = max(_max_gap(after["u"], ref.u),
                            _max_gap(after["v"], ref.v))
        gaps["dt_gap"] = float(_inf(after["dt"] - ref.dt).max()) / float(
            ref.dt)
        gaps["continuity"] = _continuity(after["phi_x"], after["phi_y"],
                                         case.fluid)
        gaps["continuity_ref"] = _continuity(ref.phi_x, ref.phi_y,
                                             case.fluid)
        return gaps


def reference_gaps(config: dict, members: list, prog_case, pairs: list,
                   device, control: bool = False) -> dict:
    """The widest of each gap over the checked cases: `case_gap` of the
    case fields (`prog_case(k)`: the program's fields of case k), and the
    stage gaps (`_Reference.replay`) of each pair (label, the cases it
    checks, before(k): the program's state before the step, or None for
    the reference's own initial flow, after(k): its state after, calls(k):
    its recorded calls). With `control`, the reference stored in bfloat16
    takes the program's place, and the program's states after and calls
    are not read. Every reference module is the configuration's reference
    package's (`spec.reference`)."""
    ref_pkg = spec.reference(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = ref_pkg.pipeline.SurrogateBundle.load(
        os.path.join(spec.ROOT, config["surrogate"]["bundle"]),
        device=device)
    spec.check_family(bundle.family, config["surrogate"])
    worst = {"case_gap": 0.0}
    checked = sorted({k for _, ks, *_ in pairs for k in ks})
    with torch.no_grad():
        for i in checked:
            shape, size = members[i]
            ref = _Reference(config, ref_pkg, shape, size, device,
                             bundle, control)
            fields = prog_case(i)
            for f in CASE_FIELDS:
                r = getattr(ref.case, f)
                worst["case_gap"] = max(worst["case_gap"], _max_gap(
                    _lowp(r) if control else fields[f], r))
            del fields
            for label, ks, before, after, calls in pairs:
                if i not in ks:
                    continue
                fin = before(i) if before else ref.initial()
                if control:
                    calls_i, after_i = ref.control_step(fin)
                else:
                    calls_i, after_i = calls(i), after(i)
                gaps = ref.replay(fin, after_i, calls_i)
                del fin, calls_i, after_i
                print(f"cfdbench: check {label} case {i} ({shape} "
                      f"{size:.4f}) "
                      + " ".join(f"{k} {v:.4g}" for k, v in gaps.items()),
                      file=sys.stderr, flush=True)
                for k, v in gaps.items():
                    worst[k] = max(worst.get(k, 0.0), v)
            del ref
    return worst
