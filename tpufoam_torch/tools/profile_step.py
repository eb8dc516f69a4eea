"""Profile a PISO path at 512 x 2048, or the Schaefer-Turek path, on one
CUDA card.

    python -m tpufoam_torch.tools.profile_step [--backend mg|mgcg]
        [--smoother plain|kernel|kernel-fused] [--fleet N] [--st]
        [--mesh DYxDX] [--steps 3] [--out DIR]

`--backend mg` (the default) is the hybrid path: MGBackend(cycles=2,
precision="bf16", smoother=...) with the sm_ref512 surrogate warm start
(lstsq stitch), two warm-up steps from the impulsive start. `--backend
mgcg` is the pure solver: MGCGBackend(rtol=1e-6, maxiter=60,
smoother=...) with no surrogate, one warm-up step. Both take the momentum
kernel. `--fleet N` steps the first N cases of the fleet of
scripts/bench_fleet_ab.py (cylinder 0.5, rectangle 0.4, triangle 0.45,
ellipse 0.6) in lockstep through `run_piso_batched_eager` instead of the
cylinder alone; a "step" is then one lockstep of all N cases. `--st`
profiles the Schaefer-Turek 2D-2 hybrid run of
artifacts/validation/st_2d2_hybrid_d62_auto.json instead: 256 x 1375,
BDF2, AutoBackend(cycles=2, tau=0.05), sm_st128 (lstsq stitch),
sm_trust 1.0, maxCo 0.4, two warm-up steps from initial_flow(dt0=2e-4);
`--backend` and `--smoother` do not apply. `--mesh DYxDX` profiles
the single-case path a second time in the same call, through the
domain-decomposed parallel.mesh.make_sharded_piso_step on a DY x DX mesh
of the one card (every field resident per block, the kernels launched
per block), from the same state (its pressure solves: the correctors'
and the safeguard's rescues). Then
`--steps` steps are traced with torch.profiler. Prints one JSON line: wall ms per step (host clock around
synchronised steps), device busy ms per step (the sum of kernel times),
the device's idle share, the kernel launches, pressure solves (two
correctors, plus the residual safeguard's rescue solves) and multigrid
cycles per step, the launches per step of each hand-written kernel, and
the kernels that take the most device time. Writes the full key_averages
table to DIR/profile_step_<backend>_<smoother>[_fleetN].txt
(DIR/profile_step_st.txt with --st; _meshDYxDX.txt for the sharded
step's profile, which prints a second line).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# scripts/bench_fleet_ab.py's four geometries (shape, obstacle size)
FLEET = (("cylinder", 0.5), ("rectangle", 0.4), ("triangle", 0.45),
         ("ellipse", 0.6))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["mg", "mgcg"], default="mg")
    ap.add_argument("--smoother", default="plain",
                    choices=["plain", "kernel", "kernel-fused"])
    ap.add_argument("--fleet", type=int, default=0,
                    help="step this many fleet cases in lockstep")
    ap.add_argument("--st", action="store_true",
                    help="profile the Schaefer-Turek 2D-2 hybrid step")
    ap.add_argument("--mesh", default=None,
                    help="also profile the sharded step on a DYxDX mesh")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    if args.mesh and (args.fleet or args.st):
        ap.error("--mesh profiles the single-case 512 x 2048 path")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from ..core.geometry import channel_case_geometry
    from ..eval.benchmark import schafer_turek_case
    from ..fv.case import build_channel_case, initial_flow
    from ..fv import momentum as fv_momentum
    from ..ops import momentum, sharded, stencil
    from ..parallel.mesh import device_mesh, make_sharded_piso_step
    from ..piso.batched import (run_piso_batched_eager, stack_cases,
                                stack_flows)
    from ..parallel.mesh import shard_case, shard_flow
    from ..piso import engine
    from ..piso.engine import PisoConfig, run_piso_eager
    from ..solvers import multigrid
    from ..solvers.backends import AutoBackend, MGBackend, MGCGBackend
    from ..surrogate.pipeline import SurrogateBundle, make_predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    ny, nx = 512, 2048
    delta = 2.0 / ny
    geoms = FLEET[:args.fleet] if args.fleet else FLEET[:1]
    if args.st:
        cases = [schafer_turek_case("2D-2", delta=0.0016)[0]]
    else:
        cases = [build_channel_case(channel_case_geometry(
            shape, length=nx * delta, height=2.0, obstacle_size=size,
            nu=8e-3), delta=delta) for shape, size in geoms]
    flow0 = [initial_flow(c, dt0=2e-4 if args.st else 5e-4) for c in cases]
    if args.fleet:
        case, flow0, run = stack_cases(cases), stack_flows(flow0), \
            run_piso_batched_eager
    else:
        case, flow0, run = cases[0], flow0[0], run_piso_eager
    cfg = PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                     momentum_smoother="kernel")
    if args.st:
        cfg = PisoConfig(max_co=0.4, max_dt=5e-3, ddt="backward",
                         momentum_smoother="kernel", sm_safeguard=0.5,
                         sm_safeguard_extra=3, sm_trust=1.0)
        pred = make_predictor(SurrogateBundle.load(
            os.path.join(ROOT, "artifacts", "sm_st128")), stitch="lstsq")
        solver, warm = AutoBackend(cycles=2, tau=0.05), 2
    elif args.backend == "mg":
        pred = make_predictor(SurrogateBundle.load(
            os.path.join(ROOT, "artifacts", "sm_ref512")), stitch="lstsq")
        solver, warm = MGBackend(cycles=2, precision="bf16",
                                 smoother=args.smoother), 2
    else:
        pred, warm = None, 1
        solver = MGCGBackend(rtol=1e-6, maxiter=60, smoother=args.smoother)
    solves = [0]
    kernels_fn = {"momentum_multisweep": momentum.momentum_multisweep,
                  "stencil_matvec": stencil.stencil_matvec,
                  "jacobi_sweep": stencil.jacobi_sweep,
                  "jacobi_multisweep": stencil.jacobi_multisweep,
                  "smooth_residual": stencil.smooth_residual,
                  "corr_smooth": stencil.corr_smooth,
                  "momentum_multisweep_sharded":
                  sharded.momentum_multisweep_sharded}

    def backend(*a):
        solves[0] += 1
        return solver(*a)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    os.makedirs(args.out, exist_ok=True)
    name = "profile_step_st" if args.st else \
        f"profile_step_{args.backend}_{args.smoother}" \
        + (f"_fleet{args.fleet}" if args.fleet else "")

    def profiled(run, flow, label, mesh=None):
        """Trace `args.steps` steps of `run` from `flow`; print a line."""
        solves[0] = 0
        engine._rescue_if_unconverged.solves = 0
        multigrid.v_cycle.cycles = 0
        fv_momentum.jacobi_momentum.sweep_loops = 0
        for fn in kernels_fn.values():
            fn.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            flow = run(case, flow, args.steps, cfg=cfg, backend=backend,
                       sm_predict=pred)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t) * 1e3 / args.steps
        if mesh is not None:
            solves[0] = cfg.n_correctors * args.steps \
                + engine._rescue_if_unconverged.solves
        avgs = prof.key_averages()
        kernels = [e for e in avgs
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        with open(os.path.join(args.out, f"{label}.txt"), "w") as f:
            f.write(f"{card}\n")
            f.write(avgs.table(sort_by="self_device_time_total",
                               row_limit=60))
        busy_ms = dev_us / 1e3 / args.steps
        print(json.dumps({
            "card": card, "path": "st" if args.st else args.backend,
            "backend": type(solver).__name__, "smoother": args.smoother,
            "fleet": args.fleet, "mesh": mesh, "steps": args.steps,
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms if dev_us
            else "not measured",
            "device_idle_share": 1.0 - busy_ms / wall_ms if dev_us
            else "not measured",
            "kernel_launches_per_step": launches / args.steps,
            "pressure_solves_per_step": solves[0] / args.steps,
            "v_cycles_per_step": multigrid.v_cycle.cycles / args.steps,
            "momentum_sweep_loops_per_step":
            fv_momentum.jacobi_momentum.sweep_loops / args.steps,
            "hand_written_launches_per_step": {
                k: fn.launches / args.steps for k, fn in kernels_fn.items()},
            "top_kernels": [{"name": e.key[:80],
                             "count": e.count / args.steps,
                             "ms_per_step": e.self_device_time_total / 1e3
                             / args.steps} for e in top],
        }), flush=True)
        return flow

    flow = run(case, flow0, warm, cfg=cfg, backend=backend, sm_predict=pred)
    torch.cuda.synchronize()
    start = flow
    profiled(run, start, name)
    if args.mesh:
        dy, dx = (int(k) for k in args.mesh.split("x"))
        mesh = device_mesh(dy * dx, shape=(dy, dx),
                           devices=[case.device] * (dy * dx))
        step = make_sharded_piso_step(mesh, cfg, solver, sm_predict=pred)
        case_sh = shard_case(mesh, case)

        def run_sharded(case_, flow_, n, **_):
            with torch.no_grad():
                for _ in range(n):
                    flow_ = step(case_sh, flow_)
            return flow_

        profiled(run_sharded, shard_flow(mesh, start),
                 f"{name}_mesh{dy}x{dx}", [dy, dx])

if __name__ == "__main__":
    main()
