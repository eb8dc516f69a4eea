#!/usr/bin/env python3
"""Drive the PyTorch port's solver paths on one NVIDIA card and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:
  build   compile every CUDA source (one nvcc call each, all at once) and
          print ptxas' registers, shared memory and spills
  kernel  the momentum kernel against its plain version at the main
          path's shape, on random structured operands; its time, and its
          device time at 1, 2, 4 and 8 sweeps
  case    the 512 x 2048 cylinder channel and the sm_ref512 surrogate
  kernel-real  the momentum kernel on the operands of the case's first step
  kernel-pressure  each pressure-stencil kernel (jacobi_multisweep,
          smooth_residual, corr_smooth) in float32 and bfloat16 against its
          plain version at the six kernel levels of the multigrid
          hierarchy, on the case's first-corrector operator, and on random
          operands at 512 x 2048 with the most sweeps it takes; its time at
          the finest level
  case-st  the Schaefer-Turek 2D-2 case of artifacts/validation/
          st_2d2_hybrid_d62_auto.json (256 x 1375) and the sm_st128
          surrogate; its SDF on the card against the CPU's (bit for bit)
  kernel-matvec  the stencil_matvec kernel against its plain version at
          every level of both multigrid hierarchies (512 x 2048 .. 8 x 32
          and 256 x 1375 .. 8 x 43, each on its case's first-corrector
          operator) and on random operands of odd shapes, in float32 and
          bfloat16, one case and a (4, ny, nx) stack, and from operands
          one element off 16 bytes (the cell variant): bit for bit;
          its time at both finest levels, beside the library's sparse
          product (CSR) of the same operator (in bfloat16 too, or the
          reason there is none), and its device time and bound at every
          level of the main path's hierarchy (and without the flush, as
          the path finds a level just written); after the step phase, a
          second line joins those with the launches per step of each
          level on the main path, by variant (the finest level vector,
          the coarser ones cell)
  kernel-sweep  the jacobi_sweep kernel (one sweep a launch) against its
          plain version and against the jacobi_multisweep kernel, iters 1,
          2 and 8, float32 and bfloat16, at the same levels: bit for bit;
          its time per sweep
  kernel-sharded  the sharded kernels (ops.sharded) on meshes 2x2, 4x1,
          1x4 and 4x2 of the one card at 512 x 2048: the momentum kernel
          per block on the random and first-step operands, the
          jacobi_multisweep kernel per block in float32 and bfloat16,
          iters 1, 2 and the halo, on the finest level's operator and on
          random operands; each bit for bit against the single-device
          kernel, and against its sharded plain version (the momentum
          kernel within its rel tolerance: it contracts multiply-adds);
          their times on the 2x2 mesh, the kernels' own device time and
          the launches of a call
  step    the hybrid PISO main path (run_piso_eager, MG bf16 backend with
          the plain smoother, sm_ref512 warm start) for a few steps
  step-sharded  the same path through parallel.mesh.make_sharded_piso_step
          on a 2 x 2 mesh of the one card: the momentum kernel per block
          (one launch a step), no single-device launch, no sweep loop
  parity-sharded  one sharded step against one piso_step from the same
          state, with the plain and with the kernel pressure smoother
          (which the sharded step passes through): bit for bit
  step-fused  the same path with MGBackend(smoother="kernel-fused")
  step-mgcg   the pure solver, MGCGBackend(rtol=1e-6, maxiter=60,
          smoother="kernel"), from the impulsive start
  parity  one step with the plain momentum smoother against one with the
          kernel, from the same state
  parity-pressure  one step with each kernel smoother against one with
          the plain smoother, from the same state
  step-st the Schaefer-Turek hybrid path (BDF2, AutoBackend, sm_st128,
          sm_trust 1.0, the momentum kernel) for 2 + 10 steps, with the
          drag and lift after each
  st-series  run_force_series to t = 0.01, and again to 0.005, saved,
          loaded and continued to 0.01: the two equal bit for bit; and the
          2D-3 ramp from rest, landing on t_end
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
  step-fleet-sharded  the same four cases through
          parallel.mesh.make_sharded_fleet_step on a mesh of four blocks of
          the one card (one case each), 3 + 5 locksteps: bit for bit
          against step-fleet's lockstep
  step-fleet-mgcg  run_piso_batched with its default MGCGBackend(rtol=
          1e-5) on four 256 x 1024 cases: per-case CG iterations
A kernel's time is its device time from torch.profiler with the L2
cache flushed before each call (ms, plain_ms: the plain version's kernels
summed) beside the per-call span on the
stream from CUDA events (call_ms, plain_call_ms), which holds the host's
cost of each call. Step times are CUDA events around the steps.
Each step phase sets every launch counter to 0 just before its timed
steps and holds the counts to the steps, predictions and multigrid cycles
it ran. On the card every pressure matvec of every path is a launch of
the stencil_matvec kernel.

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
# the Schaefer-Turek 2D-2 hybrid run of artifacts/validation/
# st_2d2_hybrid_d62_auto.json (scripts/validate_schafer_turek.py): D/delta
# 62.5, 256 x 1375; its PisoConfig and AutoBackend(cycles=2, tau=0.05).
# Its maxCo is 0.4; the Courant gate holds after an even number of steps
# from the impulsive start (see FLEET below), so 2 + 10.
ST_DELTA = 0.0016
ST_CFG = dict(max_co=0.4, max_dt=5e-3, ddt="backward",
              momentum_smoother="kernel", sm_safeguard=0.5,
              sm_safeguard_extra=3, sm_trust=1.0)
ST_DT0 = 2e-4
N_ST_WARM, N_ST_STEPS = 2, 10
ST_T_END, ST_T_SPLIT, ST_SAMPLE = 0.01, 0.005, 10
ST_RAMP_T_END = 0.004
# odd shapes of random operands for the single-pass kernels
ODD_SHAPES = ((37, 70), (1, 70), (43, 8), (255, 1377))
SWEEP_ITERS = (1, 2, 8)
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
# the sharded kernels' meshes, all of one card; the first is the sharded
# step's (device_mesh(4) of one card) and the timed one
SHARD_MESHES = ((2, 2), (4, 1), (1, 4), (4, 2))
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


def time_ms(fn, n, torch, flush):
    """(device ms, call ms) per call of fn over n calls, warmed. Device ms
    is the sum of the times of the kernels fn launches, from
    torch.profiler, with `flush` run before each call so that fn finds
    the 50 MB L2 cache cold, as the bound assumes (the flush's kernel,
    the only bitwise-not, is left out of the sum by its name; taking its
    name from a separate profile of the flush once let its ~0.07 ms into
    the sum). Call ms is the span on the stream
    from CUDA events, without flushes, which also holds the host's cost of
    issuing each call; for a kernel of a few microseconds that cost is
    most of it."""
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

    times = cold_kernels(fn, n, torch, flush)
    dev_us = sum(t for t, _ in times.values())
    check(dev_us > 0, "torch.profiler recorded no device time")
    return dev_us / 1e3 / n, a.elapsed_time(b) / n


def cold_kernels(fn, n, torch, flush):
    """{kernel name: (device us, launches)} over n calls of fn, each after
    `flush`, from torch.profiler; the flush's kernel (the only
    bitwise-not) left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "bitwise_not" not in e.key}


def timings(kernel_fn, plain_fn, n_kernel, n_plain, torch, flush):
    """The kernel's and its plain version's times (see time_ms)."""
    ms, call_ms = time_ms(kernel_fn, n_kernel, torch, flush)
    plain_ms, plain_call_ms = time_ms(plain_fn, n_plain, torch, flush)
    return dict(ms=ms, plain_ms=plain_ms, call_ms=call_ms,
                plain_call_ms=plain_call_ms)


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
    from tpufoam_torch.eval import benchmark as bench
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.fv.forces import obstacle_force
    from tpufoam_torch.fv import momentum as fvm
    from tpufoam_torch.fv.momentum import momentum_coeffs
    from tpufoam_torch.fv.pressure import PressureCoeffs, pressure_gradient
    from tpufoam_torch.ops import build
    from tpufoam_torch.ops import sharded as sh
    from tpufoam_torch.ops import stencil as st
    from tpufoam_torch.ops.momentum import (momentum_multisweep,
                                            momentum_multisweep_plain)
    from tpufoam_torch.parallel.mesh import (device_mesh,
                                             make_sharded_fleet_step,
                                             make_sharded_piso_step,
                                             shard_case, shard_flow,
                                             shard_fleet, unshard_fleet)
    from tpufoam_torch.piso import engine
    from tpufoam_torch.piso.engine import (PisoConfig, continuity_error,
                                           courant_number, piso_step,
                                           run_piso_eager)
    from tpufoam_torch.solvers import backends as backends_mod
    from tpufoam_torch.solvers import multigrid as mg
    from tpufoam_torch.solvers.backends import (AutoBackend, MGBackend,
                                                MGCGBackend)
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)
    from tpufoam_torch.tools.kernel_bounds import sharded_bound

    # float32 matrix products in full float32 (the PCA and stitch matvecs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # writing 96 MiB evicts the card's 50 MB L2 cache before each timed call
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev).bitwise_not_
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say("start", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    counters = {"momentum_multisweep": momentum_multisweep,
                "stencil_matvec": st.stencil_matvec,
                "jacobi_sweep": st.jacobi_sweep,
                "jacobi_multisweep": st.jacobi_multisweep,
                "smooth_residual": st.smooth_residual,
                "corr_smooth": st.corr_smooth,
                "momentum_multisweep_sharded": sh.momentum_multisweep_sharded,
                "jacobi_multisweep_sharded": sh.jacobi_multisweep_sharded}

    def reset_counts(predictor=None):
        for fn in counters.values():
            fn.launches = 0
        st.stencil_matvec.by_shape.clear()
        st.jacobi_sweep.by_shape.clear()
        mg.v_cycle.cycles = 0
        fvm.jacobi_momentum.sweep_loops = 0
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
    t_rand = timings(
        lambda: momentum_multisweep(*ops_rand, sweeps=SWEEPS),
        lambda: momentum_multisweep_plain(*ops_rand, sweeps=SWEEPS), 200, 20,
        torch, flush)
    n_cells = NY * NX
    bound_ms, bound_by = bound((9 + 2) * n_cells * 4,
                               SWEEPS * 2 * 9 * n_cells)
    # device time against the sweeps: the bytes are the same at every
    # count, so the slope is what a sweep costs
    by_sweeps = {}
    for k in (1, 2, 4, 8):
        ms_k = time_ms(lambda: momentum_multisweep(*ops_rand, sweeps=k), 100,
                       torch, flush)[0]
        by_sweeps[k] = dict(ms=ms_k, bound_ms=bound(
            (9 + 2) * n_cells * 4, k * 2 * 9 * n_cells)[0])
    say("kernel", max_abs_err=err_rand, rel_err=rel_rand, **t_rand,
        bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / t_rand["ms"], by_sweeps=by_sweeps)

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
                           flow0.dt, convection=cfg.convection)
    ops_real = (coef.a_e, coef.a_w, coef.a_n, coef.a_s,
                case.fluid / coef.a_p, coef.b_u - gpx * volc,
                coef.b_v - gpy * volc, flow0.u, flow0.v)
    out = momentum_multisweep(*ops_real, sweeps=SWEEPS)
    torch.cuda.synchronize()
    ref = momentum_multisweep_plain(*ops_real, sweeps=SWEEPS)
    err_real, rel_real = compare(out, ref)
    check(rel_real <= KERNEL_REL_TOL,
          f"kernel vs plain (first step): rel err {rel_real:.3e}")
    t_real = timings(
        lambda: momentum_multisweep(*ops_real, sweeps=SWEEPS),
        lambda: momentum_multisweep_plain(*ops_real, sweeps=SWEEPS), 200, 20,
        torch, flush)
    say("kernel-real", max_abs_err=err_real, rel_err=rel_real, **t_real,
        bound_ms=bound_ms, share_of_bound=bound_ms / t_real["ms"])

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
            t_k = timings(lambda: stencil_call(name, *ops, iters),
                          lambda: stencil_call(name, *ops, iters, True), 200,
                          20, torch, flush)
            size = torch.tensor([], dtype=dt).element_size()
            b_ms, b_by = bound((n_in + n_out) * n_cells * size,
                               (ops_sweep * iters + ops_once) * n_cells)
            say("kernel-pressure", kernel=name, dtype=prec, iters=iters,
                levels=per_level, random={"iters": top, "max_abs_err": err_r,
                                          "rel_err": rel_r},
                **t_k, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / t_k["ms"])
            if prec == PATH_DTYPE[name]:
                row.update(ms=t_k["ms"], plain_ms=t_k["plain_ms"],
                           bound_ms=b_ms, bound_by=b_by)
        stencil_rows[name] = row

    # ---- the Schaefer-Turek case and its first pressure system -----------
    t = time.time()
    case_st, u_mean = bench.schafer_turek_case("2D-2", delta=ST_DELTA,
                                               device=dev)
    torch.cuda.synchronize()
    t_case_st = time.time() - t
    # the surrogate's near-wall guard compares the SDF with 0.05 on rows
    # that sit 0.05 from a wall, so the card's SDF must be the CPU's (which
    # the CPU tests hold to the JAX package's) bit for bit
    t = time.time()
    sdf_cpu = bench.schafer_turek_case("2D-2", delta=ST_DELTA,
                                       device="cpu")[0].sdf
    t_sdf_cpu = time.time() - t
    sdf_equal = torch.equal(case_st.sdf.cpu(), sdf_cpu)
    check(sdf_equal, "case-st: the card's SDF differs from the CPU's")
    bundle_st = SurrogateBundle.load(os.path.join(ROOT, "artifacts",
                                                  "sm_st128"), device=dev)
    predictor_st = make_predictor(bundle_st, stitch="lstsq")
    cfg_st = PisoConfig(**ST_CFG)
    auto_be = AutoBackend(cycles=2, tau=0.05)
    flow_st0 = initial_flow(case_st, dt0=ST_DT0)
    first_st = []

    def capture_st(case_, pcoef_, rhs_, p_prev_, aux_):
        if not first_st:
            first_st.append((pcoef_, rhs_))
        return auto_be(case_, pcoef_, rhs_, p_prev_, aux_)

    with torch.no_grad():
        piso_step(case_st, flow_st0, cfg_st, capture_st,
                  predictor_st.bind(case_st))
    say("case-st", shape=list(case_st.grid.shape), u_mean=u_mean,
        seconds=round(t_case_st, 3), cpu_case_seconds=round(t_sdf_cpu, 3),
        sdf_equal_cpu=sdf_equal, fluid_cells=int(case_st.fluid.sum()))

    def hierarchy(pcoef_, rhs_):
        """Every level of the multigrid hierarchy of a pressure system,
        the coarsest too, with the right-hand side restricted to it."""
        levels_ = mg.build_hierarchy(pcoef_)
        rhs_l = [rhs_]
        for _ in levels_[1:]:
            rhs_l.append(mg.restrict(rhs_l[-1]))
        return list(zip(levels_, rhs_l))

    all_levels = {"512x2048": hierarchy(pcoef, rhs),
                  "256x1375": hierarchy(*first_st[0])}
    check([tuple(b.shape) for _, b in all_levels["256x1375"]]
          == [(256, 1375), (128, 688), (64, 344), (32, 172), (16, 86),
              (8, 43)], "the Schaefer-Turek hierarchy is not 256 x 1375 "
          ".. 8 x 43")

    def stacked(coef_, x_, k=4):
        """A (k, ny, nx) fleet of the operands: the coefficients scaled
        and x shifted per case."""
        return (PressureCoeffs(*(torch.stack([
            getattr(coef_, f.name) * (1.0 + 0.25 * j) for j in range(k)])
            for f in dataclasses.fields(coef_))),
                torch.stack([torch.roll(x_, j, -1) * (1 - 2 * (j % 2))
                             for j in range(k)]))

    def random_edge_operands(shape, dt):
        """Random conductances that are zero out of the domain, as on a
        real case; diag above their sum; x and b."""
        c = [field(0.0, 1.0, shape) for _ in range(4)]
        c[0][:, -1] = 0.0
        c[1][:, 0] = 0.0
        c[2][-1, :] = 0.0
        c[3][0, :] = 0.0
        diag = c[0] + c[1] + c[2] + c[3] + field(0.1, 1.0, shape)
        return (cast(PressureCoeffs(*c, torch.zeros_like(diag), diag), dt),
                field(-1, 1, shape).to(dt), field(-1, 1, shape).to(dt))

    def exact(label, got, ref):
        err = compare(got, ref)[0]
        check(err == 0.0, f"{label}: max |diff| {err:.3e}, not 0")
        return err

    # ---- B.2: stencil_matvec against its plain version, bit for bit -------
    def offset_by_one(t):
        """A contiguous copy of t (or of each field of a PressureCoeffs)
        that starts one element into a fresh buffer."""
        if isinstance(t, PressureCoeffs):
            return PressureCoeffs(*(offset_by_one(getattr(t, f.name))
                                    for f in dataclasses.fields(t)))
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out_ = buf[1:].view(t.shape)
        out_.copy_(t)
        return out_

    matvec = {"max_abs_err": 0.0, "checked": 0}
    for prec, dt in dtypes.items():
        for grid_name, lv in all_levels.items():
            for coef_l, b_l in lv:
                c_, x_, _, _ = level_operands(coef_l, b_l, dt)
                where = f"stencil_matvec {prec} {tuple(b_l.shape)}"
                got = st.stencil_matvec(c_, x_)
                torch.cuda.synchronize()
                matvec["max_abs_err"] = max(matvec["max_abs_err"], exact(
                    where, (got,), (st.stencil_matvec_plain(c_, x_),)))
                cb, xb = stacked(c_, x_)
                got = st.stencil_matvec(cb, xb)
                torch.cuda.synchronize()
                exact(where + " x4", (got,),
                      (st.stencil_matvec_plain(cb, xb),))
                matvec["checked"] += 2
        for shape in ODD_SHAPES:
            c_, x_, _ = random_edge_operands(shape, dt)
            got = st.stencil_matvec(c_, x_)
            torch.cuda.synchronize()
            matvec["max_abs_err"] = max(matvec["max_abs_err"], exact(
                f"stencil_matvec {prec} random {shape}", (got,),
                (st.stencil_matvec_plain(c_, x_),)))
            matvec["checked"] += 1
        # the finest level from operands one element off 16 bytes: the
        # cell variant takes them
        c_, x_, _, _ = level_operands(*fine[0], dt)
        c_off, x_off = offset_by_one(c_), offset_by_one(x_)
        key = ("cell", prec, tuple(x_.shape))
        n_cell = st.stencil_matvec.by_shape[key]
        got = st.stencil_matvec(c_off, x_off)
        torch.cuda.synchronize()
        check(st.stencil_matvec.by_shape[key] == n_cell + 1,
              "stencil_matvec: an operand off 16 bytes took the vector "
              "variant")
        matvec["max_abs_err"] = max(matvec["max_abs_err"], exact(
            f"stencil_matvec {prec} offset operands", (got,),
            (st.stencil_matvec_plain(c_, x_),)))
        matvec["checked"] += 1

    def csr_operator(coef_):
        """A as a (ny nx)^2 CSR matrix: the library's sparse product is
        the yardstick of the matvec (it rounds in its own order)."""
        ny_, nx_ = coef_.diag.shape
        idx = torch.arange(ny_ * nx_, device=dev).reshape(ny_, nx_)
        parts = [(idx, idx, coef_.diag),
                 (idx[:, :-1], idx[:, 1:], -coef_.c_e[:, :-1]),
                 (idx[:, 1:], idx[:, :-1], -coef_.c_w[:, 1:]),
                 (idx[:-1], idx[1:], -coef_.c_n[:-1]),
                 (idx[1:], idx[:-1], -coef_.c_s[1:])]
        rows, cols, vals = (torch.cat([p[k].reshape(-1) for p in parts])
                            for k in range(3))
        return torch.sparse_coo_tensor(
            torch.stack([rows, cols]), vals,
            (ny_ * nx_,) * 2).coalesce().to_sparse_csr()

    matvec_times = {}
    for grid_name, lv in all_levels.items():
        for prec, dt in dtypes.items():
            c_, x_, _, _ = level_operands(*lv[0], dt)
            size = torch.tensor([], dtype=dt).element_size()
            cells = x_.numel()
            b_ms, b_by = bound(7 * cells * size, 9 * cells)
            t_m = timings(lambda: st.stencil_matvec(c_, x_),
                          lambda: st.stencil_matvec_plain(c_, x_), 200, 50,
                          torch, flush)
            try:
                a_csr, x_col = csr_operator(c_), x_.reshape(-1, 1)
                y_lib = (a_csr @ x_col).reshape(x_.shape)
            except RuntimeError as exc:    # no such product in this dtype
                lib = dict(library_ms=None, library_error=str(exc)[:200])
            else:
                # in float32 it must compute the same function; in
                # bfloat16 it rounds once where the matvec rounds after
                # every operation, so its distance is only recorded
                lib_rel = compare((y_lib,),
                                  (st.stencil_matvec_plain(c_, x_),))[1]
                check(prec != "f32" or lib_rel <= KERNEL_REL_TOL,
                      f"sparse product vs matvec: rel err {lib_rel:.3e}")
                lib = dict(library_ms=time_ms(lambda: a_csr @ x_col, 200,
                                              torch, flush)[0],
                           library_rel_err=lib_rel)
            matvec_times[f"{grid_name} {prec}"] = dict(
                **t_m, **lib, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / t_m["ms"])
    # the rate this timing allows: one copy that reads and writes as many
    # bytes as the f32 matvec at 512 x 2048 moves (the flush leaves the L2
    # full of dirty lines, whose write-back the copy pays too)
    src = torch.empty(7 * n_cells // 2, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), 100, torch, flush)[0]
    del src, dst
    # device time and bound at every level of the main path's hierarchy
    matvec_levels = {}
    for prec, dt in dtypes.items():
        size = torch.tensor([], dtype=dt).element_size()
        for coef_l, b_l in all_levels["512x2048"]:
            c_, x_, _, _ = level_operands(coef_l, b_l, dt)
            ms_l = time_ms(lambda: st.stencil_matvec(c_, x_), 100, torch,
                           flush)[0]
            # on the path a level's operands were just written: warm in L2
            warm_l = time_ms(lambda: st.stencil_matvec(c_, x_), 100, torch,
                             lambda: None)[0]
            b_ms = bound(7 * x_.numel() * size, 9 * x_.numel())[0]
            matvec_levels[prec, tuple(b_l.shape)] = dict(
                ms=ms_l, warm_ms=warm_l, bound_ms=b_ms,
                share_of_bound=b_ms / ms_l)
    say("kernel-matvec", checked=matvec["checked"],
        max_abs_err=matvec["max_abs_err"], times=matvec_times,
        copy_7x512x2048_f32_ms=copy_ms,
        main_path_levels=[{"dtype": p_, "shape": list(sh_), **v_}
                          for (p_, sh_), v_ in matvec_levels.items()])

    # ---- B.6: jacobi_sweep against its plain version and the multisweep ---
    sweep_err = 0.0
    sweep_checked = 0
    for prec, dt in dtypes.items():
        for grid_name, lv in all_levels.items():
            for coef_l, b_l in lv:
                c_, x_, b_, _ = level_operands(coef_l, b_l, dt)
                for iters in SWEEP_ITERS:
                    where = (f"jacobi_sweep {prec} {tuple(b_l.shape)} "
                             f"iters {iters}")
                    got = st.jacobi_sweep(c_, x_, b_, iters)
                    multi = st.jacobi_multisweep(c_, x_, b_, iters)
                    torch.cuda.synchronize()
                    sweep_err = max(sweep_err, exact(
                        where, (got,),
                        (st.jacobi_sweep_plain(c_, x_, b_, iters),)))
                    exact(where + " vs jacobi_multisweep", (got,), (multi,))
                    sweep_checked += 2
    sweep_times = {}
    for grid_name, lv in all_levels.items():
        for prec, dt in dtypes.items():
            c_, x_, b_, _ = level_operands(*lv[0], dt)
            size = torch.tensor([], dtype=dt).element_size()
            cells = x_.numel()
            b_ms, b_by = bound(8 * cells * size, 13 * cells)
            t_s = timings(lambda: st.jacobi_sweep(c_, x_, b_, 1),
                          lambda: st.jacobi_sweep_plain(c_, x_, b_, 1), 200,
                          50, torch, flush)
            sweep_times[f"{grid_name} {prec}"] = dict(
                **t_s, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / t_s["ms"])
    say("kernel-sweep", checked=sweep_checked, iters=list(SWEEP_ITERS),
        max_abs_err=sweep_err, times_per_sweep=sweep_times)

    # ---- B.7: the sharded kernels on meshes of the one card --------------
    def card_mesh(shape):
        return device_mesh(shape[0] * shape[1], shape=shape,
                           devices=[dev] * (shape[0] * shape[1]))

    def own_share(times, kernel, n):
        """The kernel's own device ms, the rest (the split, exchange,
        stack and crop) and the launches, per call of a cold profile."""
        own = sum(t for k, (t, _) in times.items() if kernel in k)
        check(own > 0, f"no device time of {kernel} in the profile")
        total = sum(t for t, _ in times.values())
        return dict(kernel_ms=own / 1e3 / n,
                    assembly_ms=(total - own) / 1e3 / n,
                    launches_per_call=sum(c for _, c in times.values()) / n)

    jac_ops = {prec: (("level 512x2048", level_operands(*fine[0], dt)),
                      ("random", random_operands(dt)))
               for prec, dt in dtypes.items()}
    msh = {"max_abs_err": 0.0, "max_rel_err": 0.0, "checked": 0}
    jsh = {"max_abs_err": 0.0, "checked": 0}
    for shape in SHARD_MESHES:
        mesh = card_mesh(shape)
        for label, ops in (("random", ops_rand), ("first step", ops_real)):
            where = f"momentum_multisweep_sharded {shape} {label}"
            n0 = sh.momentum_multisweep_sharded.launches
            got = sh.momentum_multisweep_sharded(mesh, *ops, sweeps=SWEEPS)
            torch.cuda.synchronize()
            check(sh.momentum_multisweep_sharded.launches == n0 + 1,
                  f"{where}: not one launch for the card")
            exact(where + " vs the single kernel", got,
                  momentum_multisweep(*ops, sweeps=SWEEPS))
            plain = sh.momentum_multisweep_sharded_plain(mesh, *ops,
                                                         sweeps=SWEEPS)
            exact(where + ": plain vs the global plain", plain,
                  momentum_multisweep_plain(*ops, sweeps=SWEEPS))
            err, rel = compare(got, plain)
            check(rel <= KERNEL_REL_TOL,
                  f"{where} vs plain: rel err {rel:.3e}")
            msh["max_abs_err"] = max(msh["max_abs_err"], err)
            msh["max_rel_err"] = max(msh["max_rel_err"], rel)
            msh["checked"] += 1
        for prec, dt in dtypes.items():
            for label, (c_, x_, b_, _) in jac_ops[prec]:
                for iters in (1, 2, st._halo_for(dt)):
                    where = (f"jacobi_multisweep_sharded {shape} {prec} "
                             f"{label} iters {iters}")
                    n0 = sh.jacobi_multisweep_sharded.launches
                    got = sh.jacobi_multisweep_sharded(mesh, c_, x_, b_,
                                                       iters)
                    torch.cuda.synchronize()
                    check(sh.jacobi_multisweep_sharded.launches
                          == n0 + mesh.size,
                          f"{where}: not one launch per block")
                    exact(where + " vs the single kernel", (got,),
                          (st.jacobi_multisweep(c_, x_, b_, iters),))
                    plain = sh.jacobi_multisweep_sharded_plain(
                        mesh, c_, x_, b_, iters)
                    jsh["max_abs_err"] = max(jsh["max_abs_err"], exact(
                        where + " vs plain", (got,), (plain,)))
                    exact(where + ": plain vs the global plain", (plain,),
                          (st.jacobi_multisweep_plain(c_, x_, b_, iters),))
                    jsh["checked"] += 1
    # times on the 2 x 2 mesh: the momentum kernel on the first step's
    # operands, the pressure kernel in float32 with one sweep (MGCG's
    # V(1,1)), each beside its single-device kernel's row
    mesh22 = card_mesh(SHARD_MESHES[0])
    c_, x_, b_, _ = jac_ops["f32"][0][1]

    def msh_call():
        return sh.momentum_multisweep_sharded(mesh22, *ops_real,
                                              sweeps=SWEEPS)

    def jsh_call():
        return sh.jacobi_multisweep_sharded(mesh22, c_, x_, b_, 1)

    t_msh = timings(msh_call, lambda: sh.momentum_multisweep_sharded_plain(
        mesh22, *ops_real, sweeps=SWEEPS), 200, 20, torch, flush)
    t_jsh = timings(jsh_call, lambda: sh.jacobi_multisweep_sharded_plain(
        mesh22, c_, x_, b_, 1), 200, 20, torch, flush)
    b_msh = sharded_bound("momentum_multisweep", (NY, NX),
                          SHARD_MESHES[0], "f32")
    b_jsh = sharded_bound("jacobi_multisweep", (NY, NX), SHARD_MESHES[0],
                          "f32", sweeps=1)
    split_msh = own_share(cold_kernels(msh_call, 50, torch, flush),
                          "momentum_multisweep_kernel", 50)
    split_jsh = own_share(cold_kernels(jsh_call, 50, torch, flush),
                          "pressure_stencil_kernel", 50)
    say("kernel-sharded", meshes=[list(m) for m in SHARD_MESHES],
        momentum={**msh, **t_msh, **split_msh,
                  "bound_ms": b_msh["bound_us"] / 1e3,
                  "bound_by": b_msh["bound_by"], "block": b_msh["block"],
                  "haloed_bound_ms": b_msh["haloed_bound_us"] / 1e3,
                  "share_of_bound": b_msh["bound_us"] / 1e3 / t_msh["ms"]},
        jacobi={**jsh, **t_jsh, **split_jsh, "dtype": "f32", "iters": 1,
                "bound_ms": b_jsh["bound_us"] / 1e3,
                "bound_by": b_jsh["bound_by"], "block": b_jsh["block"],
                "haloed_bound_ms": b_jsh["haloed_bound_us"] / 1e3,
                "share_of_bound": b_jsh["bound_us"] / 1e3 / t_jsh["ms"]})

    # ---- the main path ---------------------------------------------------
    def drive(label, flow, n, be, sm, warm=0, run=None,
              momentum="momentum_multisweep"):
        """`warm` steps, then `n` steps with the counters set to 0 just
        before and read just after; checks the step's health and that the
        `momentum` kernel launched once a step. `run(flow, k)` takes k
        steps (run_piso_eager by default)."""
        if run is None:
            def run(flow_, k):
                return run_piso_eager(case, flow_, k, cfg=cfg, backend=be,
                                      sm_predict=sm)
        with torch.no_grad():
            if warm:
                flow = run(flow, warm)
            torch.cuda.synchronize()
            reset_counts(predictor)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t = time.time()
            ev0.record()
            flow = run(flow, n)
            ev1.record()
            torch.cuda.synchronize()
            host_s = time.time() - t
            launched, cycles = counts(), mg.v_cycle.cycles
            loops = fvm.jacobi_momentum.sweep_loops
            sm_calls = predictor.calls
        finite = all(bool(torch.isfinite(getattr(flow, f)).all())
                     for f in ("u", "v", "p", "phi_x", "phi_y"))
        cont = float(continuity_error(case, flow))
        co = float(courant_number(case, flow))
        stats = dict(steps=n, ms_per_step=ev0.elapsed_time(ev1) / n,
                     host_ms_per_step=host_s * 1e3 / n,
                     continuity_error=cont, courant=co, t_sim=float(flow.t),
                     dt=float(flow.dt), kernel_launches=launched,
                     momentum_sweep_loops=loops, v_cycles=cycles,
                     sm_predict_calls=sm_calls, finite=finite)
        check(finite, f"{label}: non-finite field")
        check(cont < 1e-4, f"{label}: continuity error {cont:.3e} >= 1e-4")
        check(co <= 0.5 + 1e-3, f"{label}: Courant number {co:.4f} > 0.501")
        check(launched[momentum] == n and loops == 0,
              f"{label}: {momentum} launched {launched[momentum]} times "
              f"and the sweep loop ran {loops} times in {n} steps")
        check(sm_calls == (n if sm is not None else 0),
              f"{label}: surrogate predicted {sm_calls} times in {n} steps")
        return flow, stats

    flow, stats = drive("step", flow0, N_STEPS, backend, predictor,
                        warm=N_WARM)
    by_level = dict(st.stencil_matvec.by_shape)
    say("step", **stats)
    # the main path's matvecs by level: each at a level of the 512 x 2048
    # hierarchy, in the variant its aligned operands take (vector at the
    # finest level, cell below)
    check(all((p_, sh_) in matvec_levels
              and v_ == st.pass_geometry(sh_, dtypes[p_]).variant
              for v_, p_, sh_ in by_level)
          and sum(by_level.values())
          == stats["kernel_launches"]["stencil_matvec"],
          f"step: stencil_matvec launches by variant and level {by_level}")
    path_levels = []
    for (_v, p_, sh_), n_ in sorted(by_level.items(),
                                   key=lambda kv: (kv[0][1], -kv[0][2][0])):
        lv = matvec_levels[p_, sh_]
        path_levels.append({"dtype": p_, "shape": list(sh_), "variant": _v,
                            "launches_per_step": n_ / N_STEPS, **lv,
                            "ms_per_step": n_ / N_STEPS * lv["ms"],
                            "warm_ms_per_step": n_ / N_STEPS * lv["warm_ms"],
                            "bound_ms_per_step":
                                n_ / N_STEPS * lv["bound_ms"]})
    say("kernel-matvec", part="main path", steps=N_STEPS,
        launches_per_step=sum(by_level.values()) / N_STEPS,
        levels=path_levels,
        ms_per_step=sum(r["ms_per_step"] for r in path_levels),
        warm_ms_per_step=sum(r["warm_ms_per_step"] for r in path_levels),
        bound_ms_per_step=sum(r["bound_ms_per_step"] for r in path_levels))
    launches = stats["kernel_launches"]["momentum_multisweep"]
    step_launches = stats["kernel_launches"]
    check(stats["kernel_launches"]["jacobi_multisweep"]
          + stats["kernel_launches"]["smooth_residual"]
          + stats["kernel_launches"]["corr_smooth"] == 0,
          "the plain smoother launched a pressure kernel")

    # ---- the main path through the sharded step, 2 x 2 blocks of the card -
    mesh_step = device_mesh(4, devices=[dev] * 4)
    case_sh = shard_case(mesh_step, case)
    step_sh = make_sharded_piso_step(mesh_step, cfg, backend,
                                     sm_predict=predictor.bind(case))

    def run_sharded(flow_, k):
        for _ in range(k):
            flow_ = step_sh(case_sh, flow_)
        return flow_

    _, stats_sh = drive("step-sharded", shard_flow(mesh_step, flow0),
                        N_STEPS, backend, predictor, warm=N_WARM,
                        run=run_sharded,
                        momentum="momentum_multisweep_sharded")
    k = stats_sh["kernel_launches"]
    say("step-sharded", mesh=mesh_step.shape,
        step_ms_per_step=stats["ms_per_step"], **stats_sh)
    check(k["momentum_multisweep"] == 0,
          f"step-sharded: {k['momentum_multisweep']} single-device "
          "momentum launches")
    sharded_step_launches = k

    # ---- one sharded step against one piso_step, same state -------------
    with torch.no_grad():
        f_single = piso_step(case, flow, cfg, backend, predictor.bind(case))
        f_sh = step_sh(case_sh, flow)
        torch.cuda.synchronize()
    diffs = {name: compare((getattr(f_sh, name),),
                           (getattr(f_single, name),))[0]
             for name in ("u", "v", "p", "phi_x", "phi_y", "dt")}
    # the backend passes through the sharded step: with the multigrid's
    # kernel smoother the pressure kernel runs on the lead device
    kern_be = MGBackend(cycles=2, precision="bf16", smoother="kernel")
    step_shk = make_sharded_piso_step(mesh_step, cfg, kern_be,
                                      sm_predict=predictor.bind(case))
    with torch.no_grad():
        f_single_k = piso_step(case, flow, cfg, kern_be, predictor.bind(case))
        reset_counts()
        f_sh_k = step_shk(case_sh, flow)
        torch.cuda.synchronize()
        k_shk = counts()
    diffs_k = {name: compare((getattr(f_sh_k, name),),
                             (getattr(f_single_k, name),))[0]
               for name in ("u", "v", "p", "phi_x", "phi_y", "dt")}
    say("parity-sharded", max_abs_diff=diffs,
        kernel_smoother_max_abs_diff=diffs_k,
        kernel_smoother_launches=k_shk)
    for name, d in [*diffs.items(), *diffs_k.items()]:
        check(d == 0.0, f"sharded step parity {name}: max |diff| {d:.3e}")
    check(k_shk["jacobi_multisweep"] > 0
          and k_shk["momentum_multisweep_sharded"] == 1,
          f"sharded step with the kernel smoother launched {k_shk}")
    del f_single, f_sh, f_single_k, f_sh_k

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

    # ---- the Schaefer-Turek hybrid path ---------------------------------
    # AutoBackend escalates to MGCG through backends.mgcg_pressure, and the
    # trust gate is engine._gate_sm_prediction: both are counted here, the
    # gate's verdicts kept on the device until the timed steps are done
    mgcg_impl, gate_impl = backends_mod.mgcg_pressure, \
        engine._gate_sm_prediction
    escalations, rejected = [0], []

    def mgcg_counted(*args, **kw):
        escalations[0] += 1
        return mgcg_impl(*args, **kw)

    def gate_counted(p_sm, p_prev, fluid, trust=0.0):
        out_ = gate_impl(p_sm, p_prev, fluid, trust)
        rejected.append((out_ != p_sm * fluid).any())
        return out_

    def st_health(label, flow_, co_max):
        finite_ = all(bool(torch.isfinite(getattr(flow_, f)).all())
                      for f in ("u", "v", "p", "phi_x", "phi_y"))
        cont_ = float(continuity_error(case_st, flow_))
        co_ = float(courant_number(case_st, flow_))
        check(finite_, f"{label}: non-finite field")
        check(cont_ < 1e-4, f"{label}: continuity error {cont_:.3e}")
        if co_max is not None:
            check(co_ <= co_max + 1e-3, f"{label}: Courant number {co_:.4f}")
        return cont_, co_

    backends_mod.mgcg_pressure = mgcg_counted
    engine._gate_sm_prediction = gate_counted
    try:
        with torch.no_grad():
            flow_st = run_piso_eager(case_st, flow_st0, N_ST_WARM,
                                     cfg=cfg_st, backend=auto_be,
                                     sm_predict=predictor_st)
            bound_st = predictor_st.bind(case_st)
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(N_ST_STEPS)]
            forces = []
            torch.cuda.synchronize()
            reset_counts(predictor_st)
            escalations[0] = 0
            rejected.clear()
            t = time.time()
            for e0, e1 in ev:
                e0.record()
                flow_st = run_piso_eager(case_st, flow_st, 1, cfg=cfg_st,
                                         backend=auto_be,
                                         sm_predict=bound_st)
                e1.record()
                rep = obstacle_force(case_st, flow_st.u, flow_st.v,
                                     flow_st.p, u_ref=u_mean,
                                     d_ref=bench.D_CYL)
                forces.append((rep.cd, rep.cl))
            torch.cuda.synchronize()
            st_host_s = time.time() - t
            st_launches, st_cycles = counts(), mg.v_cycle.cycles
            st_calls = predictor_st.calls
            st_escalations = escalations[0]
            st_rejections = int(sum(bool(r) for r in rejected))
    finally:
        backends_mod.mgcg_pressure = mgcg_impl
        engine._gate_sm_prediction = gate_impl
    cd_cl = [[float(cd), float(cl)] for cd, cl in forces]
    cont_st, co_st = st_health("step-st", flow_st, ST_CFG["max_co"])
    st_ms = sum(e0.elapsed_time(e1) for e0, e1 in ev) / N_ST_STEPS
    say("step-st", shape=list(case_st.grid.shape), steps=N_ST_STEPS,
        ms_per_step=st_ms, host_ms_per_step=st_host_s * 1e3 / N_ST_STEPS,
        continuity_error=cont_st, courant=co_st, t_sim=float(flow_st.t),
        dt=float(flow_st.dt), kernel_launches=st_launches,
        stencil_matvec_launches_per_step=st_launches["stencil_matvec"]
        / N_ST_STEPS, v_cycles=st_cycles, sm_predict_calls=st_calls,
        auto_escalations=st_escalations, sm_trust_rejections=st_rejections,
        cd_cl=cd_cl)
    check(st_launches["momentum_multisweep"] == N_ST_STEPS,
          f"step-st: momentum kernel launched "
          f"{st_launches['momentum_multisweep']} times in {N_ST_STEPS} steps")
    check(st_calls == N_ST_STEPS,
          f"step-st: surrogate predicted {st_calls} times in {N_ST_STEPS}")
    check(st_launches["stencil_matvec"] > 0,
          "step-st: the pressure matvec never launched its kernel")
    check(all(np.isfinite(cd_cl).ravel()), f"step-st: cd, cl {cd_cl}")
    st_matvec_launches = st_launches["stencil_matvec"]

    # ---- the force series: uninterrupted, and saved / loaded / resumed ---
    def series(flow_, t_end, **kw):
        with torch.no_grad():
            return bench.run_force_series(
                case_st, flow_, t_end, u_mean, cfg=cfg_st, backend=auto_be,
                sample_steps=ST_SAMPLE, sm_predict=predictor_st, **kw)

    t = time.time()
    flow_a, ser_a = series(flow_st0, ST_T_END)
    flow_b, ser_b1 = series(flow_st0, ST_T_SPLIT)
    meta = dict(bench="2D-2", delta=ST_DELTA, backend="hybrid",
                hybrid_solver="auto", **ST_CFG)
    state = os.path.join(ROOT, "chiprun_out", "st_series_state.npz")
    os.makedirs(os.path.dirname(state), exist_ok=True)
    bench.save_run_state(state, flow_b, ser_b1, meta=meta)
    flow_b, ser_b1 = bench.load_run_state(state, expect_meta=meta,
                                          device=dev)
    os.remove(state)
    flow_b, ser_b2 = series(flow_b, ST_T_END)
    ser_b = bench.merge_series(ser_b1, ser_b2)
    torch.cuda.synchronize()
    series_s = time.time() - t
    same_series = all(np.array_equal(getattr(ser_a, k), getattr(ser_b, k))
                      for k in ("t", "cd", "cl")) \
        and ser_a.n_steps == ser_b.n_steps
    field_diff = {f: float((getattr(flow_a, f) - getattr(flow_b, f)
                            ).abs().max())
                  for f in ("u", "v", "p", "phi_x", "phi_y", "dt", "t",
                            "u_prev", "v_prev", "p_prev")}
    cont_a, co_a = st_health("st-series", flow_a, None)
    # the 2D-3 ramp from rest lands on float32(t_end)
    flow_r, ser_r = bench.run_force_series(
        case_st, initial_flow(dataclasses.replace(
            case_st, inlet_u=case_st.inlet_u * 0.0), dt0=ST_DT0),
        ST_RAMP_T_END, u_mean, cfg=cfg_st, backend=auto_be,
        sample_steps=ST_SAMPLE, sm_predict=predictor_st,
        inlet_scale=bench.ramp_2d3)
    ramp_t = float(flow_r.t)
    st_health("st-series ramp", flow_r, None)
    say("st-series", steps=ser_a.n_steps, samples=len(ser_a.t),
        t_sim=float(flow_a.t), seconds=round(series_s, 3),
        resumed_steps=[ser_b1.n_steps, ser_b2.n_steps],
        resumed_equal=same_series, final_field_max_abs_diff=field_diff,
        continuity_error=cont_a, courant=co_a,
        cd=ser_a.cd.tolist(), cl=ser_a.cl.tolist(),
        ramp={"t_end": ST_RAMP_T_END, "t": ramp_t, "steps": ser_r.n_steps,
              "cd": ser_r.cd.tolist(), "cl": ser_r.cl.tolist()})
    check(same_series, "st-series: the resumed series differs from the "
          "uninterrupted one")
    check(all(d == 0.0 for d in field_diff.values()),
          f"st-series: resumed final fields differ: {field_diff}")
    check(ramp_t == float(np.float32(ST_RAMP_T_END)),
          f"st-series: the 2D-3 ramp ended at t = {ramp_t!r}, not "
          f"float32({ST_RAMP_T_END})")
    check(all(np.isfinite(ser_a.cd)) and all(np.isfinite(ser_a.cl))
          and all(np.isfinite(ser_r.cd)), "st-series: non-finite cd or cl")
    del flow_a, flow_b, flow_r

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
    t_fleet = timings(
        lambda: momentum_multisweep(*ops_fleet, sweeps=SWEEPS),
        lambda: momentum_multisweep_plain(*ops_fleet, sweeps=SWEEPS), 200,
        10, torch, flush)
    bound_ms_fleet, bound_by_fleet = bound((9 + 2) * n_fleet * n_cells * 4,
                                           SWEEPS * 2 * 9 * n_fleet * n_cells)
    say("kernel-fleet", shape=list(ops_fleet[0].shape), sweeps=SWEEPS,
        max_abs_err=err_fleet, rel_err=rel_fleet,
        max_abs_diff_vs_single_launches=single_diff, **t_fleet,
        bound_ms=bound_ms_fleet, bound_by=bound_by_fleet,
        share_of_bound=bound_ms_fleet / t_fleet["ms"])
    del ops_fleet, per_case_ops, out

    # ---- the fleet's cases ----------------------------------------------
    from tpufoam_torch.fv.case import fleet_member
    from tpufoam_torch.piso.batched import (run_piso_batched,
                                            run_piso_batched_eager,
                                            stack_cases, stack_flows)

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
    del flow_warm, seq, singles, got

    # ---- the fleet over a mesh of four blocks of the card, one case each -
    mesh_fleet = device_mesh(n_fleet, devices=[dev] * n_fleet)
    fleet_step = make_sharded_fleet_step(mesh_fleet, cfg, backend,
                                         sm_predict=predictor)
    parts_c = shard_fleet(mesh_fleet, case_b)
    with torch.no_grad():
        parts_f = shard_fleet(mesh_fleet, flow_b0)
        for _ in range(N_FLEET_WARM):
            parts_f = fleet_step(parts_c, parts_f)
        torch.cuda.synchronize()
        reset_counts(predictor)
        t = time.time()
        ev0.record()
        for _ in range(N_FLEET_STEPS):
            parts_f = fleet_step(parts_c, parts_f)
        ev1.record()
        torch.cuda.synchronize()
        fsh_host_s = time.time() - t
        fsh_launches, fsh_calls = counts(), predictor.calls
        fsh_loops = fvm.jacobi_momentum.sweep_loops
    fsh_ms = ev0.elapsed_time(ev1) / N_FLEET_STEPS
    flow_fsh = unshard_fleet(mesh_fleet, parts_f)
    finite, cont, co = fleet_health(case_b, flow_fsh)
    fsh_diff = {name: float((getattr(flow_fsh, name) - getattr(flow_b, name)
                             ).abs().max())
                for name in ("u", "v", "p", "phi_x", "phi_y", "dt", "t")}
    say("step-fleet-sharded", mesh=mesh_fleet.shape,
        cases_per_block=n_fleet // mesh_fleet.size,
        locksteps=N_FLEET_STEPS, ms_per_lockstep=fsh_ms,
        host_ms_per_lockstep=fsh_host_s * 1e3 / N_FLEET_STEPS,
        step_fleet_ms_per_lockstep=fleet_ms,
        step_fleet_sequential_ms_per_4case_step=seq_ms,
        continuity_error=cont, courant=co, kernel_launches=fsh_launches,
        momentum_sweep_loops=fsh_loops, sm_predict_calls=fsh_calls,
        max_abs_diff_vs_step_fleet=fsh_diff, finite=finite)
    check_fleet_health("step-fleet-sharded", finite, cont, co)
    check(fsh_launches["momentum_multisweep"] == n_fleet * N_FLEET_STEPS
          and fsh_loops == 0,
          f"step-fleet-sharded: {fsh_launches['momentum_multisweep']} "
          f"momentum launches, {fsh_loops} sweep loops")
    check(fsh_calls == n_fleet * N_FLEET_STEPS,
          f"step-fleet-sharded: surrogate predicted {fsh_calls} times")
    for name, d in fsh_diff.items():
        check(d == 0.0, f"step-fleet-sharded vs step-fleet {name}: max "
              f"|diff| {d:.3e}")
    del flow_b, case_b, parts_c, parts_f, flow_fsh

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
        "ms": t_real["ms"],
        "plain_ms": t_real["plain_ms"],
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
        "name": "stencil_matvec",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/pressure_stencil.cu",
        "replaces": "tpufoam/ops/stencil.py:221",
        "launches": st_matvec_launches,
        "max_abs_err": matvec["max_abs_err"],
        # the finest level of its path in f32 (residuals, probes and the
        # escalated MGCG; the bf16 polish's times are in kernel-matvec)
        "ms": matvec_times["256x1375 f32"]["ms"],
        "plain_ms": matvec_times["256x1375 f32"]["plain_ms"],
        "bound_ms": matvec_times["256x1375 f32"]["bound_ms"],
        "bound_by": matvec_times["256x1375 f32"]["bound_by"],
        "library_ms": matvec_times["256x1375 f32"]["library_ms"],
    })
    # no path of either package calls jacobi_sweep: its count over every
    # driven path, each path's counts set to 0 just before its steps
    paths = (step_launches, sharded_step_launches, fused_launches,
             mgcg_launches, st_launches, fleet_launches, fsh_launches,
             k_mgcg)
    sweep_launches = sum(k_["jacobi_sweep"] for k_ in paths)
    check(sweep_launches == 0,
          f"a path launched jacobi_sweep {sweep_launches} times")
    kernels.append({
        "name": "jacobi_sweep",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/pressure_stencil.cu",
        "replaces": "tpufoam/ops/stencil.py:245",
        "launches": sweep_launches,
        "max_abs_err": sweep_err,
        "ms": sweep_times["512x2048 f32"]["ms"],
        "plain_ms": sweep_times["512x2048 f32"]["plain_ms"],
        "bound_ms": sweep_times["512x2048 f32"]["bound_ms"],
        "bound_by": sweep_times["512x2048 f32"]["bound_by"],
        "library_ms": None,
    })
    # no path of either package runs the sharded pressure kernel (the
    # sharded step's pressure solve runs whole on the lead device): its
    # count over every driven path, as jacobi_sweep's
    jsh_launches = sum(k_["jacobi_multisweep_sharded"] for k_ in paths)
    check(jsh_launches == 0,
          f"a path launched jacobi_multisweep_sharded {jsh_launches} times")
    kernels.append({
        "name": "momentum_multisweep (batched launch)",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/momentum_multisweep.cu",
        "replaces": "tpufoam/ops/stencil.py:479",
        "launches": fleet_step_launches,
        "max_abs_err": err_fleet,
        "ms": t_fleet["ms"],
        "plain_ms": t_fleet["plain_ms"],
        "bound_ms": bound_ms_fleet,
        "bound_by": bound_by_fleet,
        "library_ms": None,
    })
    kernels.append({
        "name": "momentum_multisweep_sharded",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/momentum_multisweep.cu",
        "replaces": "tpufoam/ops/stencil.py:850",
        "launches": sharded_step_launches["momentum_multisweep_sharded"],
        "max_abs_err": msh["max_abs_err"],
        "ms": t_msh["ms"],
        "plain_ms": t_msh["plain_ms"],
        "bound_ms": b_msh["bound_us"] / 1e3,
        "bound_by": b_msh["bound_by"],
        "haloed_bound_ms": b_msh["haloed_bound_us"] / 1e3,
        "library_ms": None,
    })
    kernels.append({
        "name": "jacobi_multisweep_sharded",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/pressure_stencil.cu",
        "replaces": "tpufoam/ops/stencil.py:886",
        "launches": jsh_launches,
        "max_abs_err": jsh["max_abs_err"],
        "ms": t_jsh["ms"],
        "plain_ms": t_jsh["plain_ms"],
        "bound_ms": b_jsh["bound_us"] / 1e3,
        "bound_by": b_jsh["bound_by"],
        "haloed_bound_ms": b_jsh["haloed_bound_us"] / 1e3,
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
