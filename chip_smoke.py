#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  build   compile every CUDA kernel of the path (one nvcc call each)
  kernel  each kernel against its plain version at the main path's shape,
          on random structured operands; its time from CUDA events
  case    the 512 x 2048 cylinder channel and the sm_ref512 surrogate
  kernel-real  the kernel against its plain version on the operands of
          the case's first step
  step    the hybrid PISO main path (run_piso_eager, MG bf16 backend,
          sm_ref512 warm start) for a few steps, with every launch counter
          set to 0 just before and read just after
  parity  one step with the plain momentum smoother against one with the
          kernel, from the same state

It imports torch, numpy and tpufoam_torch only. It exits non-zero without
a result line when there is no CUDA device or any check fails; otherwise
the line before the last is the card's name and power limit and the last
line is the result object.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()

NY, NX = 512, 2048            # the main path's grid (bench.py)
SWEEPS = 8
N_WARM, N_STEPS = 2, 10
MEM_RATE = 3.35e12            # H100 SXM HBM3, bytes/s (published peak)
F32_RATE = 67e12              # H100 SXM f32 outside the tensor cores
KERNEL_REL_TOL = 1e-5
# Step parity, max |kernel - plain| / max |plain| per field. The two steps
# differ only in the momentum smoother, whose outputs agree to ~1e-7
# relative. The pressure equation's right-hand side is a divergence, a
# small difference of large fluxes, so that ~1e-7 grows to ~1e-4 in p even
# with f32 multigrid. With the path's bf16 multigrid it moves bf16
# roundings of the correction (2^-8 = 3.9e-3 relative each), so the bound
# there is a dozen bf16 ulps.
PARITY_TOL = {"bf16": {"u": 5e-2, "v": 5e-2, "p": 5e-2},
              "f32": {"u": 1e-4, "v": 1e-4, "p": 1e-3}}


def say(phase, **kv):
    kv = {"phase": phase, "t_s": round(time.time() - T0, 3), **kv}
    print(json.dumps(kv), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, n, torch):
    """Mean ms per call of fn over n calls, from CUDA events, warmed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def compare(out, ref):
    """(max abs err, max abs err / max |ref|) over a tuple of tensors."""
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return err, err / max(scale, 1e-30)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.fv.momentum import momentum_coeffs
    from tpufoam_torch.fv.pressure import pressure_gradient
    from tpufoam_torch.ops import build
    from tpufoam_torch.ops.momentum import (momentum_multisweep,
                                            momentum_multisweep_plain)
    from tpufoam_torch.piso.engine import (PisoConfig, continuity_error,
                                           courant_number, piso_step,
                                           run_piso_eager)
    from tpufoam_torch.solvers.backends import MGBackend
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)

    # float32 matrix products in full float32 (the PCA and stitch matvecs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say("start", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    # ---- build ----------------------------------------------------------
    t = time.time()
    _, log = build.build("momentum_multisweep")
    say("build", kernel="momentum_multisweep", seconds=round(time.time() - t, 3),
        ptxas=[ln for ln in log.splitlines() if "registers" in ln
               or "smem" in ln or "spill" in ln])

    # ---- kernel vs plain, random structured operands ---------------------
    rng = np.random.default_rng(0)

    def field(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (NY, NX)).astype(
            np.float32), device=dev)

    a_e, a_w, a_n, a_s = (field(0.0, 1.0) for _ in range(4))
    a_e[:, -1] = 0.0      # zero conductances on the domain edges
    a_w[:, 0] = 0.0
    a_n[-1, :] = 0.0
    a_s[0, :] = 0.0
    fluid = torch.as_tensor((rng.uniform(size=(NY, NX)) > 0.02).astype(
        np.float32), device=dev)
    ap_inv = fluid / (a_e + a_w + a_n + a_s + field(0.5, 2.0))
    ops_rand = (a_e, a_w, a_n, a_s, ap_inv, field(-1, 1), field(-1, 1),
                field(-1, 1) * fluid, field(-1, 1) * fluid)
    out = momentum_multisweep(*ops_rand, sweeps=SWEEPS)
    torch.cuda.synchronize()
    ref = momentum_multisweep_plain(*ops_rand, sweeps=SWEEPS)
    err_rand, rel_rand = compare(out, ref)
    check(rel_rand <= KERNEL_REL_TOL,
          f"kernel vs plain (random): rel err {rel_rand:.3e}")
    ms = time_ms(lambda: momentum_multisweep(*ops_rand, sweeps=SWEEPS), 200,
                 torch)
    plain_ms = time_ms(lambda: momentum_multisweep_plain(*ops_rand,
                                                         sweeps=SWEEPS),
                       20, torch)
    n_cells = NY * NX
    bytes_moved = (9 + 2) * n_cells * 4
    flops = SWEEPS * 2 * 9 * n_cells
    bound_ms = max(bytes_moved / MEM_RATE, flops / F32_RATE) * 1e3
    bound_by = "bytes" if bytes_moved / MEM_RATE >= flops / F32_RATE \
        else "operations"
    say("kernel", max_abs_err=err_rand, rel_err=rel_rand, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / ms)

    # ---- the main path's case and surrogate -----------------------------
    delta = 2.0 / NY
    geom = channel_case_geometry("cylinder", length=NX * delta, height=2.0,
                                 obstacle_size=0.5, nu=8e-3)
    t = time.time()
    case = build_channel_case(geom, delta=delta, device=dev)
    torch.cuda.synchronize()
    t_case = time.time() - t
    bundle = SurrogateBundle.load(os.path.join(ROOT, "artifacts",
                                               "sm_ref512"), device=dev)
    predictor = make_predictor(bundle, stitch="lstsq")
    flow0 = initial_flow(case, dt0=5e-4)
    say("case", ny=NY, nx=NX, seconds=round(t_case, 3),
        fluid_cells=int(case.fluid.sum()))

    # ---- kernel vs plain on the first step's operands --------------------
    cfg = PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3)
    backend = MGBackend(cycles=2, precision="bf16")
    p = flow0.p
    gpx, gpy = pressure_gradient(case, p)
    volc = case.alpha * (case.grid.dx * case.grid.dy)
    coef = momentum_coeffs(case, flow0.phi_x, flow0.phi_y, flow0.u, flow0.v,
                           flow0.dt)
    ops_real = (coef.a_e, coef.a_w, coef.a_n, coef.a_s,
                case.fluid / coef.a_p, coef.b_u - gpx * volc,
                coef.b_v - gpy * volc, flow0.u, flow0.v)
    out = momentum_multisweep(*ops_real, sweeps=SWEEPS)
    torch.cuda.synchronize()
    ref = momentum_multisweep_plain(*ops_real, sweeps=SWEEPS)
    err_real, rel_real = compare(out, ref)
    check(rel_real <= KERNEL_REL_TOL,
          f"kernel vs plain (first step): rel err {rel_real:.3e}")
    ms_real = time_ms(lambda: momentum_multisweep(*ops_real, sweeps=SWEEPS),
                      200, torch)
    plain_ms_real = time_ms(
        lambda: momentum_multisweep_plain(*ops_real, sweeps=SWEEPS), 20, torch)
    say("kernel-real", max_abs_err=err_real, rel_err=rel_real, ms=ms_real,
        plain_ms=plain_ms_real, bound_ms=bound_ms,
        share_of_bound=bound_ms / ms_real)

    # ---- the main path ---------------------------------------------------
    with torch.no_grad():
        flow = run_piso_eager(case, flow0, N_WARM, cfg=cfg, backend=backend,
                              sm_predict=predictor)
        torch.cuda.synchronize()
        momentum_multisweep.launches = 0
        predictor.calls = 0
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t = time.time()
        ev0.record()
        flow = run_piso_eager(case, flow, N_STEPS, cfg=cfg, backend=backend,
                              sm_predict=predictor)
        ev1.record()
        torch.cuda.synchronize()
        host_s = time.time() - t
        launches = momentum_multisweep.launches
        sm_calls = predictor.calls
    step_ms = ev0.elapsed_time(ev1) / N_STEPS
    finite = all(bool(torch.isfinite(getattr(flow, f)).all())
                 for f in ("u", "v", "p", "phi_x", "phi_y"))
    cont = float(continuity_error(case, flow))
    co = float(courant_number(case, flow))
    say("step", steps=N_STEPS, ms_per_step=step_ms,
        host_ms_per_step=host_s * 1e3 / N_STEPS, continuity_error=cont,
        courant=co, t_sim=float(flow.t), dt=float(flow.dt),
        kernel_launches=launches, sm_predict_calls=sm_calls,
        finite=finite)
    check(finite, "non-finite field after the main path")
    check(cont < 1e-4, f"continuity error {cont:.3e} >= 1e-4")
    check(co <= 0.5 + 1e-3, f"Courant number {co:.4f} > 0.501")
    check(launches == N_STEPS,
          f"momentum kernel launched {launches} times in {N_STEPS} steps")
    check(sm_calls == N_STEPS,
          f"surrogate predicted {sm_calls} times in {N_STEPS} steps")

    # ---- one step, plain smoother vs kernel, from the same state ---------
    # with the path's bf16 multigrid, and with f32 multigrid, which keeps
    # the two steps' difference at the kernel's own rounding
    plain_cfg = dataclasses.replace(cfg, momentum_smoother="plain")
    bound_sm = predictor.bind(case)
    for label, be in (("bf16", backend), ("f32", MGBackend(cycles=2))):
        with torch.no_grad():
            f_plain = piso_step(case, flow, plain_cfg, be, bound_sm)
            f_kern = piso_step(case, flow, cfg, be, bound_sm)
            torch.cuda.synchronize()
        diffs = {name: compare((getattr(f_kern, name),),
                               (getattr(f_plain, name),))[1]
                 for name in ("u", "v", "p")}
        say("parity", mg=label, rel_diff=diffs, tol=PARITY_TOL[label])
        for name, d in diffs.items():
            check(d <= PARITY_TOL[label][name],
                  f"step parity ({label} MG) {name}: rel diff {d:.3e}")

    kernels = [{
        "name": "momentum_multisweep",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/momentum_multisweep.cu",
        "replaces": "tpufoam/ops/stencil.py:352",
        "launches": launches,
        "max_abs_err": max(err_rand, err_real),
        "ms": ms_real,
        "plain_ms": plain_ms_real,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    say("done")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
