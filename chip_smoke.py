#!/usr/bin/env python3
"""Drive the PyTorch port's solver paths on one NVIDIA card and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:
  build   compile every CUDA source (one nvcc call each, all at once) and
          print ptxas' registers, shared memory and spills
  kernel  the momentum kernel against its plain version at the main
          path's shape, on random structured operands; its time from CUDA
          events
  case    the 512 x 2048 cylinder channel and the sm_ref512 surrogate
  kernel-real  the momentum kernel on the operands of the case's first step
  kernel-pressure  each pressure-stencil kernel (jacobi_multisweep,
          smooth_residual, corr_smooth) in float32 and bfloat16 against its
          plain version at the six kernel levels of the multigrid
          hierarchy, on the case's first-corrector operator, and on random
          operands at 512 x 2048 with the most sweeps it takes; its time at
          the finest level
  step    the hybrid PISO main path (run_piso_eager, MG bf16 backend with
          the plain smoother, sm_ref512 warm start) for a few steps
  step-fused  the same path with MGBackend(smoother="kernel-fused")
  step-mgcg   the pure solver, MGCGBackend(rtol=1e-6, maxiter=60,
          smoother="kernel"), from the impulsive start
  parity  one step with the plain momentum smoother against one with the
          kernel, from the same state
  parity-pressure  one step with each kernel smoother against one with
          the plain smoother, from the same state
  kernel-fleet  the momentum kernel's batched launch on (4, 512, 2048)
          random structured operands, against its plain version and
          against four single-case launches (bit for bit); its time
  fleet-case  the four cases of scripts/bench_fleet_ab.py (cylinder,
          rectangle, triangle, ellipse at 512 x 2048), stacked
  step-fleet  the fleet path (run_piso_batched_eager, MG bf16, sm_ref512,
          the momentum kernel) for a few locksteps, and the same four
          cases stepped one after another through run_piso_eager
  parity-fleet  one lockstep against four single-case steps from the
          same state
  step-fleet-mgcg  run_piso_batched with its default MGCGBackend(rtol=
          1e-5) on four 256 x 1024 cases: per-case CG iterations
Each step phase sets every launch counter to 0 just before its timed
steps and holds the counts to the steps, predictions and multigrid cycles
it ran.

It imports torch, numpy and tpufoam_torch only. It exits non-zero without
a result line when there is no CUDA device or any check fails; otherwise
the line before the last is the card's name and power limit and the last
line is the result object.
"""

import concurrent.futures
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
N_MGCG = 3                    # pure-solver steps from the impulsive start
# the fleet of scripts/bench_fleet_ab.py: (shape, obstacle size) at
# 512 x 2048, delta 2/512, nu 8e-3; its locksteps; the MGCG fleet's grid.
# In the impulsive start the damped dt control (setDeltaT) leaves the
# post-step Courant number alternating about maxCo, above it after odd
# steps (cylinder alone: 0.5915, 0.4318, 0.5544, ..., 0.5104 after step
# 7, 0.4862 after step 8, tools/fleet_probe.py; the fleet's cases the
# same): the Courant gate holds
# after an even number of steps, as the single-case phases' 2 + 10 does,
# so the fleet takes 3 + 5.
FLEET = (("cylinder", 0.5), ("rectangle", 0.4), ("triangle", 0.45),
         ("ellipse", 0.6))
N_FLEET_WARM, N_FLEET_STEPS = 3, 5
MGCG_FLEET_NY, N_MGCG_FLEET = 256, 2
# A lockstep against the four single-case steps from the same state. The
# momentum kernel's batched launch equals the single launches bit for
# bit, the predictor predicts a fleet case by case, and every other
# operation acts per cell or per case, so the two should agree bit for
# bit: the hybrid's bf16 multigrid turns a one-ulp difference into
# percents (tools/fleet_probe.py). Bounded at the bf16 parity of two
# single-case smoothers (the kernel and the plain one: below 1e-2 on the
# card); dt comes from the same incoming state, a maximum and scalar
# arithmetic: 1e-6.
FLEET_PARITY_TOL = {"u": 1e-2, "v": 1e-2, "p": 1e-2, "dt": 1e-6}
KERNEL_LEVELS = 6             # levels 512x2048 .. 16x64; 8x32 is plain
MEM_RATE = 3.35e12            # H100 SXM HBM3, bytes/s (published peak)
F32_RATE = 67e12              # H100 SXM f32 outside the tensor cores
KERNEL_REL_TOL = 1e-5
# Pressure-stencil kernels against their plain versions, max |err| /
# max |plain|. Both round at the same places (csrc/pressure_stencil.cu),
# so they should agree bit for bit; the bounds allow a few float32
# roundings, and one bf16 ulp (2^-8) of the largest value.
STENCIL_TOL = {"f32": 1e-5, "bf16": 2.0 ** -8}
# Step parity, max |kernel - plain| / max |plain| per field. The two steps
# differ only in the momentum smoother, whose outputs agree to ~1e-7
# relative. The pressure equation's right-hand side is a divergence, a
# small difference of large fluxes, so that ~1e-7 grows to ~1e-4 in p even
# with f32 multigrid. With the path's bf16 multigrid it moves bf16
# roundings of the correction (2^-8 = 3.9e-3 relative each), so the bound
# there is a dozen bf16 ulps.
PARITY_TOL = {"bf16": {"u": 5e-2, "v": 5e-2, "p": 5e-2},
              "f32": {"u": 1e-4, "v": 1e-4, "p": 1e-3}}
# Smoother parity: a kernel smoother computes x + omega (b - A x) / diag
# where the plain one multiplies by 1/diag, so the two multigrid solves
# round differently. In f32 that is PARITY_TOL["f32"]. The bf16 correction
# form leaves a relative residual near its 0.1 noise floor after two
# cycles, and two roundings of it may land anywhere inside that floor:
# 1e-1. MGCG stops both solves at a relative residual of 1e-6: u and v
# agree to PARITY_TOL["f32"], while p is fixed only to that residual times
# the operator's condition, which grows 4x per doubling of the grid
# (tests/test_torch_piso.py measures 2.5e-3 at 64 x 256 between two
# frameworks): 5e-2.
SMOOTHER_PARITY_TOL = {"bf16": {"u": 1e-1, "v": 1e-1, "p": 1e-1},
                       "f32": PARITY_TOL["f32"],
                       "mgcg": {"u": 1e-4, "v": 1e-4, "p": 5e-2}}
# pressure kernels: (operands read, outputs written, operations per cell
# and sweep, operations per cell once) and the TPU kernel each replaces
STENCIL = {
    "jacobi_multisweep": (7, 1, 13, 0, "tpufoam/ops/stencil.py:302"),
    "smooth_residual": (7, 2, 13, 10, "tpufoam/ops/stencil.py:578"),
    "corr_smooth": (8, 1, 13, 1, "tpufoam/ops/stencil.py:672"),
}
# the dtype of each kernel's path (MGCG's f32 V(1,1) for the multisweep,
# the hybrid's bf16 V(2,2) for the fused legs), and the sweeps per launch
# in each dtype: the multisweep runs 2 in the bf16 hybrid (path 3)
PATH_DTYPE = {"jacobi_multisweep": "f32", "smooth_residual": "bf16",
              "corr_smooth": "bf16"}
PATH_SWEEPS = {"jacobi_multisweep": {"f32": 1, "bf16": 2},
               "smooth_residual": {"f32": 2, "bf16": 2},
               "corr_smooth": {"f32": 2, "bf16": 2}}


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
    err = max(float((o.float() - r.float()).abs().max())
              for o, r in zip(out, ref))
    scale = max(float(r.float().abs().max()) for r in ref)
    return err, err / max(scale, 1e-30)


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time on the card."""
    t_mem, t_ops = n_bytes / MEM_RATE, n_ops / F32_RATE
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops \
        else "operations"


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
    from tpufoam_torch.fv.pressure import PressureCoeffs, pressure_gradient
    from tpufoam_torch.ops import build
    from tpufoam_torch.ops import stencil as st
    from tpufoam_torch.ops.momentum import (momentum_multisweep,
                                            momentum_multisweep_plain)
    from tpufoam_torch.piso.engine import (PisoConfig, continuity_error,
                                           courant_number, piso_step,
                                           run_piso_eager)
    from tpufoam_torch.solvers import multigrid as mg
    from tpufoam_torch.solvers.backends import MGBackend, MGCGBackend
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
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    counters = {"momentum_multisweep": momentum_multisweep,
                "jacobi_multisweep": st.jacobi_multisweep,
                "smooth_residual": st.smooth_residual,
                "corr_smooth": st.corr_smooth}

    def reset_counts(predictor=None):
        for fn in counters.values():
            fn.launches = 0
        mg.v_cycle.cycles = 0
        if predictor is not None:
            predictor.calls = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    # ---- build ----------------------------------------------------------
    t = time.time()
    sources = ("momentum_multisweep", "pressure_stencil")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(lambda n: build.build(n)[1],
                                          sources)))
    say("build", kernels=list(sources), seconds=round(time.time() - t, 3),
        ptxas={name: [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "smem" in ln
                      or "spill" in ln or "Compiling entry" in ln]
               for name, log in logs.items()})

    # ---- momentum kernel vs plain, random structured operands ------------
    rng = np.random.default_rng(0)

    def field(lo, hi, shape=(NY, NX)):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(
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
    bound_ms, bound_by = bound((9 + 2) * n_cells * 4,
                               SWEEPS * 2 * 9 * n_cells)
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

    # ---- momentum kernel vs plain on the first step's operands -----------
    cfg = PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                     momentum_smoother="kernel")
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

    # ---- pressure-stencil kernels vs plain -------------------------------
    # the first corrector's pressure system of the main path's first step
    first = []

    def capture(case_, pcoef_, rhs_, p_prev_, aux_):
        if not first:
            first.append((pcoef_, rhs_))
        return backend(case_, pcoef_, rhs_, p_prev_, aux_)

    with torch.no_grad():
        piso_step(case, flow0, cfg, capture, predictor.bind(case))
    pcoef, rhs = first[0]
    levels = mg.build_hierarchy(pcoef)
    check(len(levels) == KERNEL_LEVELS + 1,
          f"hierarchy has {len(levels)} levels, not {KERNEL_LEVELS + 1}")
    rhs_levels = [rhs]
    for _ in range(KERNEL_LEVELS - 1):
        rhs_levels.append(mg.restrict(rhs_levels[-1]))
    fine = list(zip(levels[:-1], rhs_levels))

    def stencil_call(name, coef_, x, b, corr, iters, plain=False):
        fn = getattr(st, f"{name}_plain" if plain else name)
        if name == "corr_smooth":
            out_ = fn(coef_, x, corr, b, iters)
        else:
            out_ = fn(coef_, x, b, iters)
        return out_ if isinstance(out_, tuple) else (out_,)

    def cast(coef_, dt):
        return PressureCoeffs(*(getattr(coef_, f.name).to(dt)
                                for f in dataclasses.fields(coef_)))

    def level_operands(coef_, b, dt):
        """A level's real operator and right-hand side in `dt`, x from one
        Jacobi step of them, and a correction field."""
        x = b / coef_.diag
        return (cast(coef_, dt), x.to(dt), b.to(dt),
                (0.1 * torch.roll(x, 1, 1)).to(dt))

    def random_operands(dt):
        """Conductances in [0, 1), nonzero on the domain's edges too, diag
        above their sum; x, b and a correction."""
        c = [field(0.0, 1.0) for _ in range(4)]
        diag = c[0] + c[1] + c[2] + c[3] + field(0.1, 1.0)
        return (cast(PressureCoeffs(*c, torch.zeros_like(diag), diag), dt),
                field(-1, 1).to(dt), field(-1, 1).to(dt),
                field(-0.1, 0.1).to(dt))

    def held(name, prec, ops, iters, where):
        """The kernel against its plain version; (max abs err, rel err)."""
        got = stencil_call(name, *ops, iters)
        torch.cuda.synchronize()
        err, rel = compare(got, stencil_call(name, *ops, iters, True))
        check(rel <= STENCIL_TOL[prec],
              f"{name} {prec} {where}, iters {iters}: rel err {rel:.3e}")
        return err, rel

    stencil_rows = {}
    for name, (n_in, n_out, ops_sweep, ops_once, _) in STENCIL.items():
        row = {"max_abs_err": 0.0}
        for prec, dt in dtypes.items():
            iters = PATH_SWEEPS[name][prec]
            per_level = []
            for coef_l, b_l in fine:
                ops = level_operands(coef_l, b_l, dt)
                err, rel = held(name, prec, ops, iters,
                                f"level {tuple(b_l.shape)}")
                per_level.append({"shape": list(b_l.shape),
                                  "max_abs_err": err, "rel_err": rel})
                row["max_abs_err"] = max(row["max_abs_err"], err)
            # random operands at the finest shape, the most sweeps taken
            top = st._halo_for(dt) - (name == "smooth_residual")
            err_r, rel_r = held(name, prec, random_operands(dt), top,
                                "random")
            row["max_abs_err"] = max(row["max_abs_err"], err_r)
            # time at the finest level, with this dtype's sweeps
            ops = level_operands(*fine[0], dt)
            k_ms = time_ms(lambda: stencil_call(name, *ops, iters), 200,
                           torch)
            p_ms = time_ms(lambda: stencil_call(name, *ops, iters, True),
                           20, torch)
            size = torch.tensor([], dtype=dt).element_size()
            b_ms, b_by = bound((n_in + n_out) * n_cells * size,
                               (ops_sweep * iters + ops_once) * n_cells)
            say("kernel-pressure", kernel=name, dtype=prec, iters=iters,
                levels=per_level, random={"iters": top, "max_abs_err": err_r,
                                          "rel_err": rel_r},
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / k_ms)
            if prec == PATH_DTYPE[name]:
                row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by)
        stencil_rows[name] = row

    # ---- the main path ---------------------------------------------------
    def drive(label, flow, n, be, sm, warm=0):
        """`warm` steps, then `n` steps with the counters set to 0 just
        before and read just after; checks the step's health."""
        with torch.no_grad():
            if warm:
                flow = run_piso_eager(case, flow, warm, cfg=cfg, backend=be,
                                      sm_predict=sm)
            torch.cuda.synchronize()
            reset_counts(predictor)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t = time.time()
            ev0.record()
            flow = run_piso_eager(case, flow, n, cfg=cfg, backend=be,
                                  sm_predict=sm)
            ev1.record()
            torch.cuda.synchronize()
            host_s = time.time() - t
            launched, cycles = counts(), mg.v_cycle.cycles
            sm_calls = predictor.calls
        finite = all(bool(torch.isfinite(getattr(flow, f)).all())
                     for f in ("u", "v", "p", "phi_x", "phi_y"))
        cont = float(continuity_error(case, flow))
        co = float(courant_number(case, flow))
        stats = dict(steps=n, ms_per_step=ev0.elapsed_time(ev1) / n,
                     host_ms_per_step=host_s * 1e3 / n,
                     continuity_error=cont, courant=co, t_sim=float(flow.t),
                     dt=float(flow.dt), kernel_launches=launched,
                     v_cycles=cycles, sm_predict_calls=sm_calls,
                     finite=finite)
        check(finite, f"{label}: non-finite field")
        check(cont < 1e-4, f"{label}: continuity error {cont:.3e} >= 1e-4")
        check(co <= 0.5 + 1e-3, f"{label}: Courant number {co:.4f} > 0.501")
        check(launched["momentum_multisweep"] == n,
              f"{label}: momentum kernel launched "
              f"{launched['momentum_multisweep']} times in {n} steps")
        check(sm_calls == (n if sm is not None else 0),
              f"{label}: surrogate predicted {sm_calls} times in {n} steps")
        return flow, stats

    flow, stats = drive("step", flow0, N_STEPS, backend, predictor,
                        warm=N_WARM)
    say("step", **stats)
    launches = stats["kernel_launches"]["momentum_multisweep"]
    check(stats["kernel_launches"]["jacobi_multisweep"]
          + stats["kernel_launches"]["smooth_residual"]
          + stats["kernel_launches"]["corr_smooth"] == 0,
          "the plain smoother launched a pressure kernel")

    # ---- path 1: the fused V-cycle legs in bf16 --------------------------
    fused_be = MGBackend(cycles=2, precision="bf16", smoother="kernel-fused")
    flow_f, stats = drive("step-fused", flow0, N_STEPS, fused_be, predictor,
                          warm=N_WARM)
    say("step-fused", **stats)
    k = stats["kernel_launches"]
    legs = KERNEL_LEVELS * stats["v_cycles"]
    check(stats["v_cycles"] > 0 and k["smooth_residual"] == legs
          and k["corr_smooth"] == legs and k["jacobi_multisweep"] == 0,
          f"step-fused: launches {k} for {stats['v_cycles']} V-cycles")
    fused_launches = k

    # ---- path 2: MGCG with the multisweep kernel in f32 ------------------
    mgcg_be = MGCGBackend(rtol=1e-6, maxiter=60, smoother="kernel")
    cg_iters = []

    def mgcg_counted(*args):
        c0 = mg.v_cycle.cycles
        p_ = mgcg_be(*args)
        cg_iters.append(mg.v_cycle.cycles - c0 - 1)  # one cycle per iter + 1
        return p_

    _, stats = drive("step-mgcg", flow0, N_MGCG, mgcg_counted, None)
    say("step-mgcg", cg_iters_per_solve=cg_iters, **stats)
    k = stats["kernel_launches"]
    check(stats["v_cycles"] > 0
          and k["jacobi_multisweep"] == 2 * KERNEL_LEVELS * stats["v_cycles"]
          and k["smooth_residual"] + k["corr_smooth"] == 0,
          f"step-mgcg: launches {k} for {stats['v_cycles']} V-cycles")
    mgcg_launches = k

    # ---- one step, plain momentum smoother vs kernel, same state ---------
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

    # ---- one step, each kernel smoother vs the plain one, same state -----
    parity_cases = [
        ("kernel-fused", "bf16", lambda s: MGBackend(
            cycles=2, precision="bf16", smoother=s), bound_sm),
        ("kernel-fused", "f32", lambda s: MGBackend(cycles=2, smoother=s),
         bound_sm),
        ("kernel", "bf16", lambda s: MGBackend(
            cycles=2, precision="bf16", smoother=s), bound_sm),
        ("kernel", "mgcg", lambda s: MGCGBackend(
            rtol=1e-6, maxiter=60, smoother=s), None),
    ]
    for smoother, label, make, sm in parity_cases:
        with torch.no_grad():
            f_plain = piso_step(case, flow_f, cfg, make("plain"), sm)
            torch.cuda.synchronize()
            reset_counts()
            f_kern = piso_step(case, flow_f, cfg, make(smoother), sm)
            torch.cuda.synchronize()
        k, cycles = counts(), mg.v_cycle.cycles
        legs = KERNEL_LEVELS * cycles
        fused = legs if smoother == "kernel-fused" else 0
        expect = {"jacobi_multisweep": 2 * legs - 2 * fused,
                  "smooth_residual": fused, "corr_smooth": fused}
        check(cycles > 0 and all(k[n] == v for n, v in expect.items()),
              f"parity-pressure {smoother} {label}: launches {k} for "
              f"{cycles} cycles")
        diffs = {name: compare((getattr(f_kern, name),),
                               (getattr(f_plain, name),))[1]
                 for name in ("u", "v", "p")}
        tol = SMOOTHER_PARITY_TOL[label]
        say("parity-pressure", smoother=smoother, mg=label, v_cycles=cycles,
            kernel_launches=k, rel_diff=diffs, tol=tol)
        for name, d in diffs.items():
            check(d <= tol[name], f"smoother parity ({smoother}, {label}) "
                  f"{name}: rel diff {d:.3e}")

    # ---- the fleet: the momentum kernel's batched launch ----------------
    n_fleet = len(FLEET)
    per_case_ops = []
    for _ in range(n_fleet):
        a_e, a_w, a_n, a_s = (field(0.0, 1.0) for _ in range(4))
        a_e[:, -1] = 0.0
        a_w[:, 0] = 0.0
        a_n[-1, :] = 0.0
        a_s[0, :] = 0.0
        fl = torch.as_tensor((rng.uniform(size=(NY, NX)) > 0.02).astype(
            np.float32), device=dev)
        per_case_ops.append((a_e, a_w, a_n, a_s,
                             fl / (a_e + a_w + a_n + a_s + field(0.5, 2.0)),
                             field(-1, 1), field(-1, 1), field(-1, 1) * fl,
                             field(-1, 1) * fl))
    ops_fleet = [torch.stack(x) for x in zip(*per_case_ops)]
    out = momentum_multisweep(*ops_fleet, sweeps=SWEEPS)
    torch.cuda.synchronize()
    err_fleet, rel_fleet = compare(
        out, momentum_multisweep_plain(*ops_fleet, sweeps=SWEEPS))
    check(rel_fleet <= KERNEL_REL_TOL,
          f"batched kernel vs plain: rel err {rel_fleet:.3e}")
    single_diff = 0.0
    for k, ops_k in enumerate(per_case_ops):
        one = momentum_multisweep(*ops_k, sweeps=SWEEPS)
        single_diff = max(single_diff, max(
            float((o[k] - r).abs().max()) for o, r in zip(out, one)))
    check(single_diff == 0.0, "batched launch vs single launches: max "
          f"|diff| {single_diff:.3e}, not 0")
    ms_fleet = time_ms(lambda: momentum_multisweep(*ops_fleet,
                                                   sweeps=SWEEPS), 200, torch)
    plain_ms_fleet = time_ms(lambda: momentum_multisweep_plain(
        *ops_fleet, sweeps=SWEEPS), 10, torch)
    bound_ms_fleet, bound_by_fleet = bound((9 + 2) * n_fleet * n_cells * 4,
                                           SWEEPS * 2 * 9 * n_fleet * n_cells)
    say("kernel-fleet", shape=list(ops_fleet[0].shape), sweeps=SWEEPS,
        max_abs_err=err_fleet, rel_err=rel_fleet,
        max_abs_diff_vs_single_launches=single_diff, ms=ms_fleet,
        plain_ms=plain_ms_fleet, bound_ms=bound_ms_fleet,
        bound_by=bound_by_fleet, share_of_bound=bound_ms_fleet / ms_fleet)
    del ops_fleet, per_case_ops, out

    # ---- the fleet's cases ----------------------------------------------
    from tpufoam_torch.fv.case import fleet_member
    from tpufoam_torch.piso.batched import (run_piso_batched,
                                            run_piso_batched_eager,
                                            stack_cases, stack_flows)
    from tpufoam_torch.solvers import backends as backends_mod

    def fleet_cases(ny):
        d = 2.0 / ny
        return [build_channel_case(channel_case_geometry(
            shape, length=4 * ny * d, height=2.0, obstacle_size=size,
            nu=8e-3), delta=d, device=dev) for shape, size in FLEET]

    def fleet_health(case_b_, flow_b_):
        """(all fields finite, per-case continuity, per-case Courant)."""
        finite = all(bool(torch.isfinite(getattr(flow_b_, name)).all())
                     for name in ("u", "v", "p", "phi_x", "phi_y", "dt"))
        return (finite, continuity_error(case_b_, flow_b_).tolist(),
                courant_number(case_b_, flow_b_).tolist())

    def check_fleet_health(label, finite, cont_, co_=()):
        check(finite, f"{label}: non-finite field")
        for k, c_ in enumerate(cont_):
            check(c_ < 1e-4, f"{label} case {k}: continuity {c_:.3e}")
        for k, o_ in enumerate(co_):
            check(o_ <= 0.5 + 1e-3, f"{label} case {k}: Courant {o_:.4f}")

    t = time.time()
    fcases = fleet_cases(NY)
    case_b = stack_cases(fcases)
    flow_b0 = stack_flows([initial_flow(c, dt0=5e-4) for c in fcases])
    torch.cuda.synchronize()
    say("fleet-case", cases=[f"{s} {z}" for s, z in FLEET],
        shape=list(case_b.fluid.shape), seconds=round(time.time() - t, 3),
        fluid_cells=case_b.fluid.sum(dim=(-2, -1)).tolist())

    # ---- the fleet path: lockstep, and the same cases one after another --
    with torch.no_grad():
        flow_b = run_piso_batched_eager(case_b, flow_b0, N_FLEET_WARM,
                                        cfg=cfg, backend=backend,
                                        sm_predict=predictor)
        torch.cuda.synchronize()
        flow_warm = flow_b
        reset_counts(predictor)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t = time.time()
        ev0.record()
        flow_b = run_piso_batched_eager(case_b, flow_b, N_FLEET_STEPS,
                                        cfg=cfg, backend=backend,
                                        sm_predict=predictor)
        ev1.record()
        torch.cuda.synchronize()
        fleet_host_s = time.time() - t
        fleet_launches, fleet_cycles = counts(), mg.v_cycle.cycles
        fleet_calls = predictor.calls
        fleet_ms = ev0.elapsed_time(ev1) / N_FLEET_STEPS
        # the A/B of scripts/bench_fleet_ab.py: the same four cases from
        # the same state, one after another through the single-case path
        seq = [fleet_member(flow_warm, k) for k in range(n_fleet)]
        bound_seq = [predictor.bind(c) for c in fcases]
        torch.cuda.synchronize()
        reset_counts(predictor)
        t = time.time()
        ev0.record()
        for k, c in enumerate(fcases):
            seq[k] = run_piso_eager(c, seq[k], N_FLEET_STEPS, cfg=cfg,
                                    backend=backend, sm_predict=bound_seq[k])
        ev1.record()
        torch.cuda.synchronize()
        seq_host_s = time.time() - t
        seq_ms = ev0.elapsed_time(ev1) / N_FLEET_STEPS
        seq_launches = counts()["momentum_multisweep"]
    finite, cont, co = fleet_health(case_b, flow_b)
    _, _, co_seq = fleet_health(case_b, stack_flows(seq))
    say("step-fleet", cases=n_fleet, locksteps=N_FLEET_STEPS,
        ms_per_lockstep=fleet_ms,
        host_ms_per_lockstep=fleet_host_s * 1e3 / N_FLEET_STEPS,
        sequential_ms_per_4case_step=seq_ms,
        sequential_host_ms_per_4case_step=seq_host_s * 1e3 / N_FLEET_STEPS,
        continuity_error=cont, courant=co, dt=flow_b.dt.tolist(),
        t_sim=flow_b.t.tolist(), kernel_launches=fleet_launches,
        v_cycles=fleet_cycles, sm_predict_calls=fleet_calls,
        sequential_momentum_launches=seq_launches,
        sequential_courant=co_seq, finite=finite)
    check_fleet_health("step-fleet", finite, cont, co)
    check(fleet_launches["momentum_multisweep"] == N_FLEET_STEPS,
          f"step-fleet: momentum kernel launched "
          f"{fleet_launches['momentum_multisweep']} times in "
          f"{N_FLEET_STEPS} locksteps")
    check(fleet_calls == N_FLEET_STEPS,
          f"step-fleet: surrogate predicted {fleet_calls} times in "
          f"{N_FLEET_STEPS} locksteps")
    check(seq_launches == n_fleet * N_FLEET_STEPS,
          f"step-fleet sequential: {seq_launches} momentum launches")
    fleet_step_launches = fleet_launches["momentum_multisweep"]

    # ---- one lockstep against four single-case steps, same state --------
    with torch.no_grad():
        got = piso_step(case_b, flow_warm, cfg, backend,
                        predictor.bind(case_b))
        singles = [piso_step(c, fleet_member(flow_warm, k), cfg, backend,
                             bound_seq[k]) for k, c in enumerate(fcases)]
        torch.cuda.synchronize()
    diffs = []
    for k, single in enumerate(singles):
        d = {name: compare((getattr(got, name)[k],),
                           (getattr(single, name),))[1]
             for name in ("u", "v", "p", "dt")}
        diffs.append(d)
    say("parity-fleet", rel_diff=diffs, tol=FLEET_PARITY_TOL)
    for k, d in enumerate(diffs):
        for name, v in d.items():
            check(v <= FLEET_PARITY_TOL[name],
                  f"fleet parity case {k} {name}: rel diff {v:.3e}")
    del flow_b, flow_warm, seq, singles, got, case_b

    # ---- the MGCG fleet: per-case masked CG on the card ------------------
    mcases = fleet_cases(MGCG_FLEET_NY)
    mcase_b = stack_cases(mcases)
    mflow = stack_flows([initial_flow(c, dt0=5e-4) for c in mcases])
    cg_fleet_iters = []
    mgcg_impl = backends_mod.mgcg_pressure

    def recorded(*args, **kw):
        res = mgcg_impl(*args, **kw)
        cg_fleet_iters.append(res.iters.tolist())
        return res

    backends_mod.mgcg_pressure = recorded
    try:
        torch.cuda.synchronize()
        reset_counts()
        t = time.time()
        with torch.no_grad():
            mflow = run_piso_batched(mcase_b, mflow, N_MGCG_FLEET,
                                     cfg=cfg)
        torch.cuda.synchronize()
        mgcg_s = time.time() - t
    finally:
        backends_mod.mgcg_pressure = mgcg_impl
    k_mgcg = counts()
    finite_m, cont_m, co_m = fleet_health(mcase_b, mflow)
    say("step-fleet-mgcg", cases=n_fleet,
        shape=list(mcase_b.fluid.shape), steps=N_MGCG_FLEET,
        host_ms_per_lockstep=mgcg_s * 1e3 / N_MGCG_FLEET,
        cg_iters_per_solve=cg_fleet_iters, continuity_error=cont_m,
        courant=co_m, kernel_launches=k_mgcg, finite=finite_m)
    check_fleet_health("step-fleet-mgcg", finite_m, cont_m)
    check(len(cg_fleet_iters) == 2 * N_MGCG_FLEET
          and k_mgcg["momentum_multisweep"] == N_MGCG_FLEET,
          f"step-fleet-mgcg: {len(cg_fleet_iters)} solves, launches "
          f"{k_mgcg}")

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
    path_launches = {"jacobi_multisweep": mgcg_launches,
                     "smooth_residual": fused_launches,
                     "corr_smooth": fused_launches}
    for name, row in stencil_rows.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpufoam_torch/ops/csrc/pressure_stencil.cu",
            "replaces": STENCIL[name][4],
            "launches": path_launches[name][name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    kernels.append({
        "name": "momentum_multisweep (batched launch)",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/momentum_multisweep.cu",
        "replaces": "tpufoam/ops/stencil.py:479",
        "launches": fleet_step_launches,
        "max_abs_err": err_fleet,
        "ms": ms_fleet,
        "plain_ms": plain_ms_fleet,
        "bound_ms": bound_ms_fleet,
        "bound_by": bound_by_fleet,
        "library_ms": None,
    })
    say("done", total_s=round(time.time() - T0, 3))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
