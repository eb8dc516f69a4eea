"""The Schaefer & Turek (1996) laminar cylinder-in-channel benchmarks
("Benchmark computations of laminar flow around a cylinder"): the case,
the force series of a run, its restart files and its summaries.

    2D-1 (steady, Re=20):   cd in [5.57, 5.59], cl in [0.0104, 0.0110]
    2D-2 (unsteady, Re=100): cd_max in [3.22, 3.24], cl_max in [0.99, 1.01],
                             St in [0.295, 0.305]
    2D-3 (ramped, Re 0 -> 100 -> 0): cd_max in [2.93, 2.97],
                             cl_max in [0.47, 0.49], dP(t=8) in
                             [-0.115, -0.105]

Geometry: cylinder D=0.1 centred at (0.2, 0.2) in a 2.2 x 0.41 channel,
parabolic inlet 6 u_mean (y/H)(1 - y/H), nu = 1e-3, resolved with cut
cells on the uniform grid. The graded grids of the JAX package
(`grading=`) are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from .. import DEFAULT_DEVICE

# Published intervals, Schaefer & Turek (1996), Tables 2, 4 and 5. 2D-3
# ramps the inlet as sin(pi t / 8) over t in [0, 8]; its coefficients use
# the peak mean velocity U = 1, and dP is p(0.15, 0.2) - p(0.25, 0.2) at
# the final time t = 8.
PUBLISHED = {
    "2D-1": dict(u_mean=0.2, re=20,
                 cd=(5.57, 5.59), cl=(0.0104, 0.0110)),
    "2D-2": dict(u_mean=1.0, re=100,
                 cd_max=(3.22, 3.24), cl_max=(0.99, 1.01),
                 strouhal=(0.295, 0.305)),
    "2D-3": dict(u_mean=1.0, re=100,
                 cd_max=(2.93, 2.97), cl_max=(0.47, 0.49),
                 dp_final=(-0.115, -0.105)),
}

D_CYL = 0.1
CHANNEL = dict(length=2.2, height=0.41, cx=0.2, cy=0.2, nu=1e-3)


def ramp_2d3(t: torch.Tensor) -> torch.Tensor:
    """The 2D-3 inlet ramp sin(pi t / 8), flat past t = 8. Set as
    PisoConfig.inlet_scale_fn, it scales the inlet at each step's new time
    level, so the momentum balance sees dU_in/dt (the deceleration
    pressure gradient of dP(t=8))."""
    return torch.sin(math.pi * torch.clamp(t, 0.0, 8.0) / 8.0)


def schafer_turek_case(bench: str, delta: float, alpha_cut: float = 0.05,
                       cy: float | None = None, grading: dict | None = None,
                       device=DEFAULT_DEVICE):
    """The benchmark Case on a uniform grid of spacing `delta`; returns
    (case, u_mean). alpha_cut is the cut-cell sliver threshold; cy moves
    the cylinder centre (0.205 is the symmetric control)."""
    from ..core.geometry import channel_case_geometry
    from ..fv.case import build_channel_case

    if grading:
        raise NotImplementedError("graded grids are not ported")
    u_mean = PUBLISHED[bench]["u_mean"]
    geom = channel_case_geometry(
        "cylinder", length=CHANNEL["length"], height=CHANNEL["height"],
        obstacle_size=D_CYL, cx=CHANNEL["cx"],
        cy=CHANNEL["cy"] if cy is None else cy, u_mean=u_mean,
        nu=CHANNEL["nu"])
    return build_channel_case(geom, delta=delta, alpha_cut=alpha_cut,
                              device=device), u_mean


@dataclasses.dataclass
class ForceSeries:
    t: np.ndarray
    cd: np.ndarray
    cl: np.ndarray
    n_steps: int = 0    # solver steps taken (samples are not uniformly
                        # spaced once the single-step t_stop tail engages)


def save_run_state(path: str, flow, series: ForceSeries, *,
                   meta: dict | None = None) -> None:
    """Write a force-series run (solver state and the series so far) for a
    restart, in the JAX package's format. `meta` (a flat json-able dict:
    bench, delta, ddt, backend, ...) is stored as a fingerprint that
    `load_run_state` verifies."""
    from ..fv.case import save_flow

    extra = dict(series_t=np.asarray(series.t),
                 series_cd=np.asarray(series.cd),
                 series_cl=np.asarray(series.cl),
                 series_steps=np.asarray(series.n_steps))
    if meta is not None:
        extra["run_meta"] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
    save_flow(path, flow, extra=extra)


def load_run_state(path: str, expect_meta: dict | None = None,
                   defaults: dict | None = None, device=DEFAULT_DEVICE):
    """(flow on `device`, ForceSeries) saved by save_run_state. With
    `expect_meta`, a stored fingerprint that differs raises ValueError
    naming the keys. A key absent from the stored fingerprint predates its
    flag, so the stored run used the flag's default: with `defaults`
    (key -> default) it matches only when the requested value is that
    default; without, it matches. A file with no fingerprint raises when
    expect_meta is given."""
    from ..fv.case import load_flow

    d = np.load(path)
    if expect_meta is not None:
        if "run_meta" not in d.files:
            raise ValueError(
                f"run state {path} carries no configuration fingerprint "
                f"(pre-fingerprint format); delete the state file or load "
                f"it with expect_meta=None if you are certain it matches")
        stored = json.loads(bytes(d["run_meta"]).decode())
        bad = {}
        for k, v in expect_meta.items():
            if k in stored:
                if stored[k] != v:
                    bad[k] = (stored[k], v)
            elif defaults is not None and k in defaults and defaults[k] != v:
                bad[k] = (f"<absent: stored run used the default "
                          f"{defaults[k]!r}>", v)
        if bad:
            raise ValueError(
                f"run state {path} was written under a different "
                f"configuration: {{stored vs requested}} = {bad}; "
                f"delete the state file (or fix the flags) to proceed")
    return load_flow(d, device=device), ForceSeries(
        t=d["series_t"], cd=d["series_cd"], cl=d["series_cl"],
        n_steps=int(d["series_steps"]))


def merge_series(a: ForceSeries, b: ForceSeries) -> ForceSeries:
    return ForceSeries(t=np.concatenate([a.t, b.t]),
                       cd=np.concatenate([a.cd, b.cd]),
                       cl=np.concatenate([a.cl, b.cl]),
                       n_steps=a.n_steps + b.n_steps)


def run_force_series(case, flow, t_end: float, u_ref: float,
                     cfg=None, backend=None, sample_steps: int = 10,
                     d_ref: float = D_CYL, progress=None,
                     inlet_scale=None, sm_predict=None, on_sample=None):
    """Advance to t_end in runs of `sample_steps` eager steps (the JAX
    package's jitted chunks), recording Cd and Cl after each (the
    forceCoeffs function object's role). Returns (final flow,
    ForceSeries).

    `inlet_scale` (a callable t -> scale, e.g. `ramp_2d3`) makes the inlet
    time-dependent inside the step, and the run lands exactly on t_end:
    near it the runs shrink to single steps, so the capped landing step is
    the last one taken. `sm_predict` runs the hybrid step (surrogate warm
    start + capped polish). `on_sample(flow, make_series)` is called after
    every sample, with a zero-argument callable that builds the segment's
    series (the checkpoint hook: save_run_state). A resumed run passes the
    loaded flow back in and merges the returned segment with
    merge_series."""
    from ..fv.forces import obstacle_force
    from ..piso.engine import PisoConfig, run_piso_eager
    from ..solvers.backends import MGCGBackend

    cfg = cfg or PisoConfig(max_co=0.4, max_dt=5e-3)
    backend = backend or MGCGBackend(rtol=1e-6)
    if inlet_scale is not None:
        cfg = dataclasses.replace(cfg, inlet_scale_fn=inlet_scale,
                                  t_stop=float(t_end))

    ts, cds, cls_ = [], [], []
    steps = 0
    # flow.t is float32: compare with the float32 rendering of t_end, or a
    # t_end it cannot represent (0.01) forces one floor-dt step past it
    t_end32 = float(np.float32(t_end))
    while float(flow.t) < t_end32:
        n = sample_steps
        # single-step tail: the worst n-step advance under the 1.2x growth
        # cap is 6 (1.2^n - 1) dt, with a 1.25 margin
        worst_advance = 6.0 * (1.2 ** sample_steps - 1.0) * float(flow.dt)
        if cfg.t_stop and (t_end - float(flow.t) < 1.25 * worst_advance):
            n = 1
        flow = run_piso_eager(case, flow, n, cfg=cfg, backend=backend,
                              sm_predict=sm_predict)
        steps += n
        rep = obstacle_force(case, flow.u, flow.v, flow.p, u_ref=u_ref,
                             d_ref=d_ref)
        ts.append(float(flow.t))
        cds.append(float(rep.cd))
        cls_.append(float(rep.cl))
        if progress is not None:
            progress(steps, ts[-1], cds[-1], cls_[-1])
        if on_sample is not None:
            n_now = steps
            on_sample(flow, lambda: ForceSeries(
                t=np.asarray(ts), cd=np.asarray(cds),
                cl=np.asarray(cls_), n_steps=n_now))
    return flow, ForceSeries(t=np.asarray(ts), cd=np.asarray(cds),
                             cl=np.asarray(cls_), n_steps=steps)


def strouhal_from_cl(ts, cls, d: float = D_CYL, u: float = 1.0) -> float:
    """Shedding frequency from the mean-crossing intervals of the settled
    Cl signal."""
    ts = np.asarray(ts)
    cls = np.asarray(cls)
    mid = cls - cls.mean()
    ups = np.where((mid[:-1] < 0) & (mid[1:] >= 0))[0]
    if len(ups) < 3:
        return float("nan")
    tc = ts[ups] + (ts[ups + 1] - ts[ups]) * (-mid[ups]) / (mid[ups + 1]
                                                            - mid[ups])
    period = float(np.median(np.diff(tc)))
    return d / (u * period)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def pressure_probe(case, p, x: float, y: float, k: int = 4) -> float:
    """Pressure at a physical point by inverse-distance weighting of the k
    nearest fluid cell centres (the benchmark's front and rear probes sit
    on the wall). Host-side diagnostic."""
    g = case.grid
    p = _host(p)
    fluid = _host(case.fluid) > 0
    i0 = int((y - g.y0) / g.dy)
    j0 = int((x - g.x0) / g.dx)
    xcen = g.x0 + (np.arange(g.nx) + 0.5) * g.dx
    ycen = g.y0 + (np.arange(g.ny) + 0.5) * g.dy
    w = 6  # search window (cells) around the probe
    i_lo, i_hi = max(i0 - w, 0), min(i0 + w + 1, g.ny)
    j_lo, j_hi = max(j0 - w, 0), min(j0 + w + 1, g.nx)
    ii, jj = np.mgrid[i_lo:i_hi, j_lo:j_hi]
    sel = fluid[i_lo:i_hi, j_lo:j_hi]
    if not sel.any():
        return float("nan")
    yc = ycen[ii[sel]]
    xc = xcen[jj[sel]]
    d = np.hypot(xc - x, yc - y)
    order = np.argsort(d)[:k]
    wts = 1.0 / np.maximum(d[order], 1e-12)
    return float((p[i_lo:i_hi, j_lo:j_hi][sel][order] * wts).sum()
                 / wts.sum())


def summarize_2d3(series: ForceSeries, case, flow,
                  t_skip: float = 0.5) -> dict:
    """cd_max and cl_max over the ramped run past the start-up, and the
    front-rear pressure difference at the final time."""
    sel = series.t > t_skip
    i_cd = int(np.argmax(series.cd[sel]))
    i_cl = int(np.argmax(series.cl[sel]))
    cy = CHANNEL["cy"]
    r = 0.5 * D_CYL
    dp = (pressure_probe(case, flow.p, CHANNEL["cx"] - r, cy)
          - pressure_probe(case, flow.p, CHANNEL["cx"] + r, cy))
    return dict(
        cd_max=float(series.cd[sel][i_cd]),
        t_cd_max=float(series.t[sel][i_cd]),
        cl_max=float(series.cl[sel][i_cl]),
        t_cl_max=float(series.t[sel][i_cl]),
        dp_final=dp,
    )


def summarize_2d2(series: ForceSeries, settle_t: float) -> dict:
    """cd_max, cl_max and the Strouhal number of the settled signal."""
    sel = series.t > settle_t
    return dict(
        cd_max=float(series.cd[sel].max()),
        cd_mean=float(series.cd[sel].mean()),
        cl_max=float(series.cl[sel].max()),
        cl_amp=float(0.5 * (series.cl[sel].max() - series.cl[sel].min())),
        strouhal=strouhal_from_cl(series.t[sel], series.cl[sel]),
    )
