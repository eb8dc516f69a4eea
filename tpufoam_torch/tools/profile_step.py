"""Profile the hybrid PISO main path on one CUDA card.

    python -m tpufoam_torch.tools.profile_step [--steps 3] [--out DIR]

Builds the 512 x 2048 cylinder channel with the sm_ref512 surrogate, takes
two warm-up steps, then traces `--steps` steps with torch.profiler. Prints
one JSON line: wall ms per step (host clock around synchronised steps),
device busy ms per step (the sum of kernel times), the device's idle share,
the kernel launches and pressure solves per step (two correctors, plus the
residual safeguard's rescue solves), and the kernels that take the most
device time. Writes the full key_averages table to DIR/profile_step.txt.
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from ..core.geometry import channel_case_geometry
    from ..fv.case import build_channel_case, initial_flow
    from ..piso.engine import PisoConfig, run_piso_eager
    from ..solvers.backends import MGBackend
    from ..surrogate.pipeline import SurrogateBundle, make_predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    ny, nx = 512, 2048
    delta = 2.0 / ny
    geom = channel_case_geometry("cylinder", length=nx * delta, height=2.0,
                                 obstacle_size=0.5, nu=8e-3)
    case = build_channel_case(geom, delta=delta)
    pred = make_predictor(SurrogateBundle.load(
        os.path.join(ROOT, "artifacts", "sm_ref512")))
    cfg = PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3)
    mg = MGBackend(cycles=2, precision="bf16")
    solves = [0]

    def backend(*a):
        solves[0] += 1
        return mg(*a)

    flow = run_piso_eager(case, initial_flow(case, dt0=5e-4), 2, cfg=cfg,
                          backend=backend, sm_predict=pred)
    torch.cuda.synchronize()
    solves[0] = 0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        flow = run_piso_eager(case, flow, args.steps, cfg=cfg,
                              backend=backend, sm_predict=pred)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3 / args.steps

    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_step.txt"), "w") as f:
        f.write(f"{card}\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
    busy_ms = dev_us / 1e3 / args.steps
    print(json.dumps({
        "card": card, "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms if dev_us else "not measured",
        "device_idle_share": 1.0 - busy_ms / wall_ms if dev_us
        else "not measured",
        "kernel_launches_per_step": launches / args.steps,
        "pressure_solves_per_step": solves[0] / args.steps,
        "top_kernels": [{"name": e.key[:80], "count": e.count / args.steps,
                         "ms_per_step": e.self_device_time_total / 1e3
                         / args.steps} for e in top],
    }), flush=True)


if __name__ == "__main__":
    main()
