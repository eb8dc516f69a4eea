"""Where the fleet's lockstep and the single-case steps agree, on one card.

    python -m tpufoam_torch.tools.fleet_probe [--steps 14]

The four cases of scripts/bench_fleet_ab.py at 512 x 2048 on the hybrid
path (MGBackend(cycles=2, precision="bf16"), sm_ref512 with the lstsq
stitch, the momentum kernel), from the impulsive start. Prints JSON lines:

  courant  dt and the Courant number after each of `--steps` steps, for
           each case alone and for the fleet in lockstep;
  parity   after 3 locksteps, per case, max |a - b| / max |b| of u, v and
           p for: one lockstep against each case's single step
           ("fleet_vs_single"); a single step against itself
           ("single_twice"); a single step against the same step from
           p * (1 + 2^-23) ("single_vs_1ulp_p", the path's sensitivity to
           one float32 ulp), with the bf16 and with the f32 multigrid.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from .profile_step import FLEET, ROOT


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=14)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fleet_probe: no CUDA device")

    from ..core.geometry import channel_case_geometry
    from ..fv.case import build_channel_case, fleet_member, initial_flow
    from ..piso.batched import run_piso_batched_eager, stack_cases, stack_flows
    from ..piso.engine import PisoConfig, courant_number, piso_step
    from ..solvers.backends import MGBackend
    from ..surrogate.pipeline import SurrogateBundle, make_predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    ny, nx = 512, 2048
    delta = 2.0 / ny
    cases = [build_channel_case(channel_case_geometry(
        shape, length=nx * delta, height=2.0, obstacle_size=size, nu=8e-3),
        delta=delta) for shape, size in FLEET]
    pred = make_predictor(SurrogateBundle.load(
        os.path.join(ROOT, "artifacts", "sm_ref512")), stitch="lstsq")
    cfg = PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                     momentum_smoother="kernel")
    bf16, f32 = MGBackend(cycles=2, precision="bf16"), MGBackend(cycles=2)
    case_b = stack_cases(cases)

    def rel(a, b):
        return {n: float((getattr(a, n) - getattr(b, n)).abs().max()
                         / getattr(b, n).abs().max().clamp(min=1e-30))
                for n in ("u", "v", "p")}

    with torch.no_grad():
        for (shape, _), case in zip(FLEET, cases):
            flow, bound, row = initial_flow(case, 5e-4), pred.bind(case), []
            for _ in range(args.steps):
                flow = piso_step(case, flow, cfg, bf16, bound)
                row.append([float(flow.dt),
                            float(courant_number(case, flow))])
            print(json.dumps({"courant": shape, "dt_co": row}), flush=True)
        flow_b = stack_flows([initial_flow(c, 5e-4) for c in cases])
        bound_b = pred.bind(case_b)
        rows = []
        for _ in range(args.steps):
            flow_b = piso_step(case_b, flow_b, cfg, bf16, bound_b)
            rows.append([flow_b.dt.tolist(),
                         courant_number(case_b, flow_b).tolist()])
        print(json.dumps({"courant": "fleet", "dt_co": rows}), flush=True)

        flow_b = run_piso_batched_eager(
            case_b, stack_flows([initial_flow(c, 5e-4) for c in cases]), 3,
            cfg=cfg, backend=bf16, sm_predict=pred)
        for mg, backend in (("bf16", bf16), ("f32", f32)):
            got = piso_step(case_b, flow_b, cfg, backend, bound_b)
            for k, case in enumerate(cases):
                flow, bound = fleet_member(flow_b, k), pred.bind(case)
                one = piso_step(case, flow, cfg, backend, bound)
                again = piso_step(case, flow, cfg, backend, bound)
                nudged = piso_step(case, dataclasses.replace(
                    flow, p=flow.p * (1 + 2.0 ** -23)), cfg, backend, bound)
                print(json.dumps({
                    "parity": mg, "case": FLEET[k][0],
                    "fleet_vs_single": rel(fleet_member(got, k), one),
                    "single_twice": rel(again, one),
                    "single_vs_1ulp_p": rel(nudged, one)}), flush=True)


if __name__ == "__main__":
    main()
