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
          plain version, bit for bit, at the six kernel levels of the
          multigrid hierarchy, on the case's first-corrector operator
          (the path's sweeps, 1, 2 and the most it takes), and on random
          operands at 512 x 2048 with the most sweeps it takes, each
          launch counted under the variant ops.stencil.multisweep_geometry
          names; its time at the finest level; and at each level, in the
          path's dtype and sweeps, the variant each takes and its device
          time beside the region kernel's (the first port's, forced, and
          held to the plain version too). After case-st, a second part
          holds all three at every level of both hierarchies, iters 1, 2
          and the most each takes, on the level's operator, on random
          operands, on random operands with a solid disc and from operands
          one element off 16 bytes, bit for bit
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
  kernel-matvec-grad  the matvec's backward kernel (stencil_matvec_grad,
          csrc/stencil_grad.cu) against stencil_matvec_grad_plain, bit
          for bit, with all six gradients and with dx alone, at every
          level of both hierarchies, on a (4, ny, nx) stack of each and
          on the odd shapes, float32 and bfloat16, and on every window
          grad-sharded tapes (each block of the 2 x 2 mesh at every block
          level of 512 x 2048, haloes 1, 2 and 3: odd and haloed widths)
          and on (1, ny, nx) stacks (grad-fleet-sharded's); its device
          time and bound at both finest levels beside its plain
          version's and, for dx, the library's sparse product with the
          transposed operator
  kernel-sweep  the jacobi_sweep kernel (one sweep a launch) against its
          plain version and against the jacobi_multisweep kernel, iters 1,
          2 and 8, float32 and bfloat16, at the same levels: bit for bit;
          its time per sweep
  kernel-sharded  the sharded kernels (ops.sharded) on meshes 2x2, 4x1,
          1x4 and 4x2 of the one card at 512 x 2048, each call one window
          launch (all the card's blocks, halos read in place, interiors
          written into the global output), counted by route: the
          momentum kernel on the random and first-step operands, the
          jacobi_multisweep kernel in float32 and bfloat16, iters 1, 2
          and the halo, on the finest level's operator, on random
          operands and on random operands with a solid disc of zero diag
          (which the sharded functions fill with 1); each bit for bit
          against the single-device kernel (not on the disc: the single
          kernel divides 0 by 0 there) and against its sharded plain
          version (the momentum kernel within its rel tolerance: it
          contracts multiply-adds); the window form's cell variant at
          128 x 512 and the exchange route (blocks of 1030 columns, one
          launch a block) on the 2x2 mesh, held the same way; the window
          instantiations' ptxas registers and spills (0 required); their
          times on the 2x2 mesh (momentum, 8 sweeps; jacobi f32 1 sweep,
          bf16 2 sweeps and the halo), the kernels' own device time, the
          rest (assembly) and the launches of a call
  step    the hybrid PISO main path (run_piso_eager, MG bf16 backend with
          the plain smoother, sm_ref512 warm start) for a few steps
  grad-step  reverse mode through bench.py's main path in the
          configuration JAX differentiates (the plain momentum smoother,
          MGBackend(cycles=2, precision="bf16"), no surrogate): 2 steps
          of run_piso under autograd, the gradient of the downstream
          kinetic energy w.r.t. the inlet profile: finite, centre row
          positive, each taped matvec's backward one launch of
          stencil_matvec_grad, bit for bit equal to the same run with a
          Function of the plain forward and backward in the matvec's
          place; a central difference on a small case within GRAD_TOL;
          forward and backward ms, device memory
  step-sharded  the same path through the domain-decomposed step
          (parallel.mesh.make_sharded_piso_step) on a 2 x 2 mesh of the
          one card, 2 + 4 steps: every field resident per block, each
          stage on haloed windows, the momentum kernel once per block a
          step (4 launches), every matvec and smoother launch on a
          block's window (none on a whole level), the coarsest level
          gathered; its ms/step, launches per step by kernel and route
          and device memory (torch.cuda.max_memory_allocated, and the
          peak less what was allocated before the steps) beside the
          whole step's (step), the case's bytes whole and per block;
          then one step under a TorchDispatchMode: no op output of a
          whole-field shape but in the surrogate's gather and the
          agglomerated levels
  grad-sharded  grad-step's configuration and steps through the
          decomposed step on step-sharded's 2 x 2 mesh, the gradient
          w.r.t. the whole inlet profile (split into blocks on the tape):
          its loss grad-step's bit for bit, finite, centre row positive,
          the forward launching only stencil_matvec and the backward only
          stencil_matvec_grad, one launch for each taped matvec, every
          backward window shape one kernel-matvec-grad checked; bit for
          bit equal to the same run with the plain Function in the
          matvec's place; within GRAD_SHARDED_TOL of grad-step's gradient;
          the kernel pressure smoothers refuse a gradient, naming the
          kernel; forward and backward ms, the backward's launches by
          window shape, device memory beside grad-step's
  parity-sharded  one decomposed step against one piso_step from the
          same state, with the plain, the kernel and the kernel-fused
          pressure smoothers (each launched per block): bit for bit
  step-fused  the same path with MGBackend(smoother="kernel-fused"); its
          launches per step of smooth_residual and corr_smooth by variant
          and level, each level once a V-cycle in the variant the geometry
          names
  step-mgcg   the pure solver, MGCGBackend(rtol=1e-6, maxiter=60,
          smoother="kernel"), from the impulsive start; its launches per
          step of jacobi_multisweep by variant and level
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
  grad-fleet  run_piso_batched on those four cases, one lockstep of
          grad-step's configuration under autograd, the loss summed over
          the cases: each case's gradient equal to it stepped alone, bit
          for bit; one backward launch for each taped batched matvec
  grad-fleet-sharded  the same through make_sharded_fleet_step over a
          mesh of 4 of the card (one case a block): each case's gradient
          equal to grad-fleet's, bit for bit; one backward launch for each
          taped matvec; ms and memory beside grad-fleet's
  kernel-fleet-pressure  jacobi_multisweep, smooth_residual and
          corr_smooth on the (4, ny, nx) stack, one launch for the four
          cases, at every level of the main path's hierarchy (512 x 2048
          .. 8 x 32), float32 and bfloat16, iters 1, 2 and the most each
          takes, on the four cases' first-corrector operators and on
          random operands: each launch counted under the variant of a
          case's plane, bit for bit against its plain version and against
          four single-case launches; their device time at 4 x 512 x 2048
          (the paths' dtype and sweeps) beside the four single launches
          and tools/kernel_bounds.py's bound of four planes
  step-fleet  the fleet path (run_piso_batched_eager, MG bf16, sm_ref512,
          the momentum kernel) for a few locksteps, and the same four
          cases stepped one after another through run_piso_eager
  parity-fleet  one lockstep against four single-case steps from the
          same state
  step-fleet-kernel-fused, step-fleet-kernel  the four cases of
          step-fleet with MGBackend(cycles=2, precision="bf16") and the
          kernel smoothers ("kernel-fused", then "kernel": one launch a
          level for the four cases), 3 + 5 locksteps: ms a lockstep
          beside step-fleet's (the plain smoother) in the same call,
          launches per lockstep by kernel and level, health; one lockstep
          against the four cases stepped alone with the same smoother
          (bit for bit expected, FLEET_PARITY_TOL at worst), the
          lockstep's multisweep launches equal to its slowest case's alone
  step-fleet-sharded  the same four cases through
          parallel.mesh.make_sharded_fleet_step on a mesh of four blocks of
          the one card (one case each), 3 + 5 locksteps: bit for bit
          against step-fleet's lockstep
  step-fleet-mgcg  run_piso_batched with its default MGCGBackend(rtol=
          1e-5) on four 256 x 1024 cases: per-case CG iterations
  step-fleet-auto  the four cases of step-fleet with AutoBackend() (the
          sm_ref512 warm start, the batched momentum launch), 2 + 3
          event-timed locksteps: escalations per case, per-case health,
          launches per lockstep; one lockstep each with
          HybridBackend(predict=sm) and SurrogateBackend(predict=sm); each
          backend's lockstep against the four cases stepped alone (every
          fleet solve also solved case by case: the same result and, for
          AutoBackend, the same escalation verdicts)
  case-graded  the graded 2D-1 case of artifacts/validation/
          st_2d1_graded_h05.json (grading h_fine 0.0005, h_coarse 0.004,
          ratio 1.12, band 0.07): 543 x 990, 537,570 cells, as the artifact
          records; its SDF on the card against the CPU's (bit for bit)
  kernel-graded  stencil_matvec and the three multisweep kernels in
          float32 and bfloat16 at every level of the graded case's
          multigrid hierarchy, on its first-corrector operator, iters 1,
          2 and the most each takes: each launch counted under the
          variant pass_geometry / multisweep_geometry names, bit for bit
          against its plain version; their device time at the finest
          level beside tools/kernel_bounds.py's bound
  step-graded  the graded case with the artifact's settings (MGCG rtol
          1e-6 with the kernel smoother, BDF2, maxCo 0.4, max_dt 5e-4, the
          momentum kernel): 2 + 3 steps timed with CUDA events (drag and
          lift after each), then 1 under torch.profiler (busy ms, idle
          share); the pressure kernels' launches per step by variant and
          level, on every level
  step-options  the same for the three option runs at their published
          widths: 2D-1 at delta 0.002133 with wall_link="tangential" and
          with wall_order=2 (Euler), and 2D-2 at delta 0.0032 with BDF2 and
          ddt_corr
  step-alg1  the main hybrid path with sm_before_predictor=False
          (Algorithm 1): one prediction a step, after the momentum
          kernel's launch
  parity-options  for each of the five new paths, one step with the plain
          momentum and pressure smoothers against one with the kernels,
          from the path's state, at the parity (hybrid) or
          parity-pressure (MGCG) tolerances
  case-turb  the turbulent channel of artifacts/validation/
          turb_channel_hybrid_ny256.json (turbulent_channel_case, nu 5e-5,
          length 32, delta 2/256: 256 x 4096); its 1/7-power inlet and SDF
          on the card against the CPU's (bit for bit)
  step-turb  that run's lane: the k-omega SST model with wall functions
          (run_piso_sst_eager), sm_turb256 (lstsq), MG bf16, the momentum
          kernel: 2 + 5 event-timed steps, 2 under torch.profiler; k,
          omega, nu_t finite and at their floors or above; the channel's
          wall shear (channel_wall_cf)
  step-turb-mgcg  the Dean lane (turb_channel_dean_ny256.json): the same
          with MGCGBackend(rtol=1e-5) and the multisweep kernel smoother;
          CG iterations per solve, launches by variant and level
  step-turb-sharded  the decomposed make_sharded_sst_step on a 2 x 2
          mesh of the card (k, omega, nu_t resident per block), one step
          from step-turb's state against piso_step_sst: bit for bit, the
          momentum kernel once per block, no whole-field sharded launch
  parity-turb  one SST step (MGCG) on the card against the same step on
          the CPU, from the Dean lane's state: u, v, p, k, omega, and nu_t
          by the limiter's branch; the SST alone from one velocity on
          both, and in float64 from each side's velocity
  step-poisson  the poisson family's held-out case (triangle 0.55, nu
          6e-3, 128 x 512) with sm_poisson128 (lstsq), MG bf16, the
          momentum kernel; its prediction against the CPU's
  gradp-tier  sm_gradp128 on that case: blocks forward, the two gradient
          channels stitched and integrated to p (integrate_gradp), against
          the CPU; make_predictor refuses the bundle
  sm-options  the predictor's options on the main path's state with
          sm_ref512: precision='bf16' against the f32 predictor (rel-L2,
          predict ms), apply_filter with the scan stitch (the filter alone
          with cuDNN's TF32 on outside it, against the CPU), and
          near_wall_dist=0.1 (the guarded cells against the CPU's)
  models  the attention and conv1d models of ARCH_TABLE at their full
          widths (sm_ref512's PC counts, a batch of its 105 blocks),
          seeded parameters in the JAX layout, against the CPU; ms per
          forward
  train-data  the training path at scripts/train_ref_scale.py's envelope,
          one of its ten cases (the cylinder, obstacle 0.5, nu 8e-3, 256 x
          1024): the PISO rollout (MGCG rtol 1e-6 with the multisweep
          kernel smoother, the momentum kernel) to frames
          (frames_from_rollout), then build_block_dataset (128-blocks, 3
          input channels: D 49,152; 120 samples a frame with the y-flip);
          the depth cuts; blocks, seconds, the rollout's kernel launches
  train-pca  the PCA stage of train_surrogate with pca_device_cache
          (_fit_encode_staged: each side staged on the card, StreamingPCA,
          max_num_pc 512 at variance 0.95); on a subset, the streaming fit
          against fit_pca_exact on the card (leading explained-variance
          ratios, principal angles of the top 8 components) and against
          the port's streaming fit on the CPU (pc count, explained-
          variance ratios)
  train-step  one make_sharded_train_step step (MLP_small, bf16 compute,
          batch 1024, Adam lr 2e-4) on a (1, 1) mesh of the card against
          the same step on the CPU, and on a (2, 2) mesh of the card (data
          and tensor parallel) against the (1, 1) one: the loss and the
          parameters
  train-step-tp  sm_ref512's MLP (13 -> 512 x 3 -> 512, bf16) and
          MLP_attention at the same dims through the data- and tensor-
          parallel step on the card's 1 x 1, 1 x 2 and 2 x 2 meshes
          (dense weights and Adam's moments cut over 'model'), batch
          1024, 3 steps from the same parameters and batches: 1 x 2 and
          2 x 2 against 1 x 1 (TRAIN_STEP_TOL), each block's shard
          shapes, ms a step (CUDA events), collectives a step
  train   train_surrogate from the PCA stage's codes (loss weighting
          'variance', batch 1024, lr 2e-4), with a checkpoint: epochs,
          epochs/s, krows/s, the best validation loss and epoch; the train
          loss must fall below half its first
  train-serve  the bundle trimmed, saved (the JAX package's three files,
          sm_ref512's array keys), loaded, and served by make_predictor
          (lstsq) on 2 hybrid steps of the same case (MG bf16, the
          momentum kernel)
  bridge  the port's BridgeServer (bridge/server.py) in a thread on the
          card, driven through the C API of the repo's bridge/ library
          (built with its Makefile into tpufoam_torch/_build/bridge/,
          called with ctypes): the cells of train-data's last 3 frames
          (rollout_to_records: the fluid cells of 256 x 1024) with the
          channel's boundary points; 3 steps each of the identity,
          poisson and sm:artifacts/sm_ref512 models; the server's grid,
          the prep's parts (the SDF on the card, both Delaunay builds),
          ms per step (tb_last_step_ms and the server's), the matvec's
          launches per step; the first step's raw output against the
          port's compute on the CPU (relative L2), and a 4-rank world
          (tb_init_rank, one thread a rank, contiguous quarters of the
          cells) against the single rank, bit for bit
  cli-piso  tpufoam_torch/cli.py's piso_main (tpufoam-piso) with
          bench.py's main path as flags (--backend hybrid, sm_ref512,
          lstsq, bf16, --momentum-smoother kernel, dt0 5e-4) at 512 x 2048:
          10 steps written to --state, then 2 resumed with --out and
          --forces-out; the resumed --out against 12 straight steps of
          run_piso_eager with the same config built by hand (bit for
          bit), one momentum launch a step, the matvec launches a step,
          the CLI's own ms/step lines, health; one more step under
          utils.profiling.trace (a trace file written) and
          utils.profiling.memory_report (device_0)
  cli-piso-small  the CLI's default 128 x 512 with --backend mgcg
          --smoother kernel (jacobi_multisweep and stencil_matvec
          launches) and with --turbulence kOmegaSST --turb-wall-fn (k,
          omega, nu_t finite and at their floors on the fluid cells), 2
          steps each
  cli-pinn  pinn_main at its defaults' width (7 x 50 tanh, 20,000
          collocation points), formulations 1 and 3, 50 Adam and 10
          L-BFGS steps each, writing a .pkl: the loss falls, the card's
          loss at the saved parameters against the CPU's; ms per Adam
          and per L-BFGS step
  pointcloud  the point-cloud model (models/pointnet.py) on train-data's
          last 4 frames as clouds (rollout_to_records, n_pts 4096, batch
          2, a fourth pair padded in its last 96 rows): train_pointcloud
          8 epochs after a 1-epoch warm-up (ms per train step; the loss
          falls), its forward against the CPU's, a 3-step rollout
          (padded rows stay PAD) and rollout_report
  cli-casegen  casegen_main --sweep 3 and one --shape of each kind: the
          files written; then one line naming the entry points that read
          or write HDF5 or plot (not driven here; the CPU tests do)
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

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()

NY, NX = 512, 2048            # the main path's grid (bench.py)
SWEEPS = 8
N_WARM, N_STEPS = 2, 10
N_SHARDED = 4                 # the decomposed step's timed steps (even)
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
# the graded 2D-1 case of artifacts/validation/st_2d1_graded_h05.json
# (scripts/validate_schafer_turek.py --grade 0.0005): 543 x 990, 537,570
# cells; its settings: MGCG rtol 1e-6, BDF2, maxCo 0.4, max_dt 5e-4 (the
# artifact's; 2e-3 is st_2d2_graded_h16.json's). The port takes the
# momentum kernel and the multisweep kernel smoother (the artifact ran
# the XLA ones), so every sweep of the path is a launch.
GRADED = dict(h_fine=0.0005, h_coarse=0.004, ratio=1.12, band=0.07)
GRADED_SHAPE, GRADED_CELLS = (543, 990), 537_570
GRADED_CFG = dict(max_co=0.4, max_dt=5e-4, ddt="backward",
                  momentum_smoother="kernel")
# the step options at their published widths: st_2d1_d47_tan.json and
# st_2d1_d47_ws2.json (2D-1, delta 0.002133: 192 x 1031; MGCG, Euler,
# max_dt 5e-3) and st_2d2ddt_d31_backward_corr.json (2D-2, delta 0.0032:
# 128 x 688; MGCG, BDF2 with ddt_corr, max_dt 5e-3); maxCo 0.4 (the
# script's default); (label, bench, delta, PisoConfig options)
OPTION_PATHS = (
    ("tangential", "2D-1", 0.002133, dict(wall_link="tangential")),
    ("wall-order-2", "2D-1", 0.002133, dict(wall_order=2)),
    ("ddt-corr", "2D-2", 0.0032, dict(ddt="backward", ddt_corr=True)),
)
# warm-up, timed and profiled steps of the new paths: an even number in
# all, after which the Courant gate holds from the impulsive start (cut
# from 2 + 4 + 2, whose profiled steps took most of the script's time)
N_PATH_WARM, N_PATH_STEPS, N_PATH_PROFILED = 2, 3, 1
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
# the fleet with AutoBackend() (scripts/bench_fleet_ab.py's cases): from
# the impulsive start, 2 + 3 event-timed locksteps. After an odd number of
# steps the damped dt control leaves the Courant number above maxCo (see
# FLEET), so this phase gates continuity and finiteness and reports Co.
N_AUTO_WARM, N_AUTO_STEPS = 2, 3
KERNEL_LEVELS = 6             # levels 512x2048 .. 16x64; 8x32 is plain
# the sharded kernels' meshes, all of one card; the first is the sharded
# step's (device_mesh(4) of one card) and the timed one
SHARD_MESHES = ((2, 2), (4, 1), (1, 4), (4, 2))
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
FLOW_FIELDS = ("u", "v", "p", "phi_x", "phi_y", "dt")
TURB_FIELDS = ("k", "omega", "nu_t", "k_in", "w_in")
# the turbulent channel of artifacts/validation/turb_channel_hybrid_ny256
# .json and turb_channel_dean_ny256.json (scripts/validate_turbulent_
# channel.py:89-109): nu 5e-5, length 32, delta 2/256 (256 x 4096), maxCo
# 0.5, max_dt 0.05, the SST wall functions, dt0 5e-3; the hybrid with
# sm_turb256 (lstsq) and MG bf16 (2 cycles), the Dean lane with MGCG
# rtol 1e-5. The port takes the momentum kernel on both and the
# multisweep kernel smoother on the Dean lane (the artifacts ran XLA's).
TURB = dict(nu=5e-5, length=32.0, delta=2.0 / 256)
TURB_SHAPE = (256, 4096)
TURB_CFG = dict(max_co=0.5, max_dt=0.05, turb_wall_fn=True,
                momentum_smoother="kernel")
TURB_DT0 = 5e-3
N_TURB_WARM, N_TURB_STEPS, N_TURB_PROFILED = 2, 5, 2
N_DEAN_WARM, N_DEAN_STEPS, N_DEAN_PROFILED = 2, 2, 2
# one SST step on the card against the CPU's (MGCG, float32): u, v, k,
# omega and nu_t as the float32 step parity (PARITY_TOL), p as the MGCG
# smoother parity (SMOOTHER_PARITY_TOL). nu_t = a1 k / max(a1 omega, S F2)
# is held at 1e-4 where the omega branch binds on both sides (nu_t =
# k / omega); where S F2 binds, nu_t takes S's relative difference, and S,
# a difference quotient of the step's u and v, is smallest in the core,
# where it carries the velocity's difference (v's, from the pressure
# solve to rtol 1e-5) as a larger share: 1e-3 there, admitted only with
# the witnesses that (a) the card's SST alone, from the CPU's velocity,
# gives the CPU's k, omega and nu_t within 1e-4 and (b) each float32 SST
# is within 1e-4 of a float64 SST from the same velocity, and only on the
# S-limited cells where nu_t differs by no more than S does, cell by cell
# (TURB_S_SLACK for the float32 arithmetic of k and F2)
TURB_PARITY_TOL = {"u": 1e-4, "v": 1e-4, "p": 5e-2, "k": 1e-4,
                   "omega": 1e-4, "nu_t": 1e-4, "nu_t_s_limited": 1e-3}
TURB_WITNESS_TOL = 1e-4
TURB_S_SLACK = 1e-5
# the poisson family's held-out case (docs/EVAL_REPORT.md:164-181):
# triangle 0.55, nu 6e-3, at delta 1/64 (128 x 512; sm_poisson128 was
# trained on 127 x 511 grids with 64-blocks)
POISSON = dict(shape_name="triangle", length=8.0, height=2.0,
               obstacle_size=0.55, nu=6e-3)
POISSON_DELTA, POISSON_SHAPE = 1.0 / 64, (128, 512)
# a prediction, the card's against the CPU's: the bf16 MLP rounds inputs
# that differ in their last float32 bit to neighbouring bf16 values
# (tests/test_torch_families.py holds the port to JAX at the same bound);
# the seam filter alone: float32 sums in another order (as against JAX
# and scipy in the CPU tests)
PRED_TOL = 2e-2
FILTER_TOL = 1e-5
# the training path at scripts/train_ref_scale.py's envelope: one of its
# ten cases (the cylinder, obstacle 0.5, nu 8e-3, delta 2/256: 256 x
# 1024), PisoConfig(max_co=0.5, max_dt=5e-3) and MGCGBackend(rtol=1e-6)
# (the port takes the momentum kernel and the multisweep kernel smoother
# where the artifact ran XLA's); 128-blocks of 3 channels (D 49,152), 120
# samples a frame with the y-flip, max_num_pc 512 at variance 0.95,
# MLP_small (bf16 compute), batch 1024, lr 2e-4, pca_device_cache,
# loss_weighting 'variance'. Depth cut: 1 of 10 cases, warm-up 100 ->
# TRAIN_WARMUP steps, 24 -> TRAIN_FRAMES frames of 5 -> TRAIN_SPF steps,
# 800 -> TRAIN_EPOCHS epochs.
TRAIN_CASE = dict(shape_name="cylinder", length=8.0, height=2.0,
                  obstacle_size=0.5, nu=8e-3)
TRAIN_DELTA, TRAIN_SHAPE = 2.0 / 256, (256, 1024)
TRAIN_PISO = dict(max_co=0.5, max_dt=5e-3, momentum_smoother="kernel")
TRAIN_WARMUP, TRAIN_FRAMES, TRAIN_SPF = 20, 12, 2
TRAIN_SAMPLES, TRAIN_BLOCK = 120, 128
TRAIN_EPOCHS = 100
TRAIN_MIN_ROWS = 2048
TRAIN_CFG = dict(arch="MLP_small", lr=2e-4, batch_size=1024,
                 max_epochs=TRAIN_EPOCHS, max_num_pc=512, var_in=0.95,
                 var_out=0.95, best_after_epoch=20, pca_device_cache=True,
                 loss_weighting="variance")
# the PCA checks' subset: rows of each side (an exact SVD on the card, a
# streaming fit on the CPU in well under 20 s); the streaming fit against
# the exact one (leading explained-variance ratios; principal angles of
# the top 8 components, rad) and against the CPU's (the ratios)
TRAIN_PCA_SUBSET = 1024
TRAIN_PCA_TOL = {"evr_exact": 1e-3, "angle_top8": 1e-2, "evr_cpu": 1e-4}
# one train step, card against CPU and the 2 x 2 mesh against the 1 x 1
# one: tests/test_torch_train.py's bf16 bounds (the loss, relative; the
# parameters' relative L2 norm over the tree). bf16 products rounded in
# other orders, and Adam's first step moves every element by about lr
# whatever its gradient's size, so a sign flip of a gradient near 0 moves
# its element by 2 lr: no per-leaf bound holds.
TRAIN_STEP_TOL = {"loss": 1e-3, "params_l2": 1e-2}
# train-step-tp: sm_ref512's MLP through the data- and tensor-parallel
# step on the one card's meshes TP_MESHES, TP_STEPS steps from the same
# parameters and batches (made from TP_SEED), each mesh against the 1 x 1
# one at TRAIN_STEP_TOL (the bf16 products of a split layer round in
# another order)
TP_MESHES = ((1, 1), (1, 2), (2, 2))
TP_STEPS, TP_SEED = 3, 19
# and MLP_attention at sm_ref512's in and out dims (13, 512), bf16: its
# dense layers placed as the dense kind's, the attention, LayerNorms and
# head replicated
TP_ATTENTION = "MLP_attention"
# Reverse mode. grad-step: bench.py's main path (l.217-258) in the
# configuration that JAX differentiates: the 512 x 2048 cylinder,
# PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3) with the plain
# momentum smoother (JAX's "xla"), MGBackend(cycles=2, precision="bf16")
# with the plain pressure smoother, no surrogate warm start (JAX's reverse
# mode refuses its safeguard's while_loop); GRAD_STEPS steps under
# autograd, then the gradient of tests/test_differentiable.py's loss (the
# sum of u^2 over the downstream half) w.r.t. inlet_u. Its central
# difference: tests/test_torch_wall_options.py's small case (a 2 x 1
# channel at delta 1/16, one corrector, fixed dt, two momentum sweeps,
# upwind, MGBackend(cycles=2) in float32, 3 steps), GRAD_EPS along a
# seeded direction, within GRAD_TOL of the card's gradient, relative.
# grad-fleet: run_piso_batched on the fleet's four cases at 512 x 2048,
# GRAD_FLEET_STEPS steps, the same configuration, the loss summed over
# the cases.
# grad-sharded: grad-step's configuration through the decomposed step on
# step-sharded's 2 x 2 mesh; its gradient within GRAD_SHARDED_TOL of
# grad-step's, relative L2: tests/test_torch_grad_rollout.py's bf16 bound
# (a halo cell's gradient is summed per window, then over the blocks, in
# another order than the whole step's, each partial sum rounded to
# bfloat16; on the CPU at 64 x 256 it lay 7.6e-3 on 2 x 2, 1.2e-2 on
# 2 x 1, 3.7e-3 on 1 x 2; at 128 x 512 4.5e-3 on 2 x 2). The windows the
# block levels tape: halo 1 (the finest level's residual), 2 (the
# post-smoother's sweeps) and 3 (the down leg's sweeps and residual).
# grad-fleet-sharded: grad-fleet through make_sharded_fleet_step over a
# mesh of 4 of the card.
GRAD_STEPS, GRAD_FLEET_STEPS = 2, 1
GRAD_SHARDED_TOL = 2e-2
GRAD_SHARDED_HALOS = (1, 2, 3)
GRAD_TOL, GRAD_EPS = 1e-3, 1e-2
GRAD_CFG = dict(n_correctors=2, max_co=0.5, max_dt=2e-3)
GRAD_SMALL = dict(length=2.0, height=1.0, shape=None, nu=0.05)
GRAD_SMALL_CFG = dict(n_correctors=1, adjust_dt=False, momentum_sweeps=2,
                      convection="upwind")
# the backward's gradients asked for: all six (the path's: the iterate
# and the operator both carry a gradient), and dx alone; for each, the
# fields it reads, those it writes and its operations per cell
GRAD_NEEDS = {"all": ((True,) * 6, 7, 6, 18),
              "dx": ((True,) + (False,) * 5, 6, 1, 9)}
# the bridge: 3 steps of each model on the last frames of train-data's
# rollout; the first step against the port's compute on the CPU from the
# same cells: sm (sm_ref512's bf16 MLP), the raw output's relative L2,
# PRED_TOL; poisson, the true residual of the card's grid solution in the
# CPU's system against that of the CPU's own, within a factor of 3 (a
# float32 MGCG from the PISO pressure reaches only a floor of the true
# residual, and solves that round apart land anywhere in it: see
# bridge_phase's poisson_check)
BRIDGE_STEPS = 3
BRIDGE_TOL = {"poisson": 3.0, "sm": PRED_TOL}
# The command-line entry points (tpufoam_torch/cli.py). cli-piso:
# bench.py's main path through tpufoam-piso's flags at its full width
# (512 x 2048, the defaults' length 8 and height 2), CLI_STEPS_A steps
# written to --state, then CLI_STEPS_B resumed from it: equal to
# CLI_STEPS_A + CLI_STEPS_B straight steps of run_piso_eager bit for bit.
# 12 steps in all, as the step phase's 2 + 10: from the impulsive start
# the flow accelerates under the dt that the last step's Courant number
# set, so the Courant number reaches maxCo only after some steps (0.562
# after 3, 0.524 after 5 on the H100).
# Then the defaults' 128 x 512 with the MGCG kernel smoother and with the
# SST, CLI_STEPS_SMALL steps each.
CLI_BUNDLE, CLI_DELTA, CLI_SHAPE = "artifacts/sm_ref512", 0.00390625, \
    (512, 2048)
CLI_PISO = ["--backend", "hybrid", "--bundle", CLI_BUNDLE, "--stitch",
            "lstsq", "--precision", "bf16", "--momentum-smoother", "kernel",
            "--delta", str(CLI_DELTA), "--dt0", "5e-4"]
CLI_STEPS_A, CLI_STEPS_B, CLI_STEPS_SMALL = 10, 2, 2
# cli-pinn: pinn_main at its defaults' width (7 x 50 tanh, 20,000
# collocation points), formulations 1 and 3, cut in depth from 5,000 Adam
# and 1,000 L-BFGS steps; the card's loss at the trained parameters
# against the CPU's, relative
CLI_PINN_FORMS, CLI_PINN_ADAM, CLI_PINN_LBFGS = (1, 3), 50, 10
CLI_PINN_TOL = 1e-4
# pointcloud: the point-cloud model on train-data's last PC_FRAMES frames
# (pairs of consecutive frames, pointcloud_main's n_pts 4096 and batch 2;
# a fourth pair is the first with its last PC_PAD rows padded, as a
# smaller mesh's cloud), PC_EPOCHS epochs after a 1-epoch warm-up call;
# the card's forward against the CPU's with TF32 off, relative
PC_FRAMES, PC_NPTS, PC_BATCH, PC_PAD, PC_EPOCHS = 4, 4096, 2, 96, 8
PC_TOL = 1e-4


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

    # a profile that holds no kernel of fn is taken again, up to three in
    # all: on the card's machine one profile lost every device event once,
    # in a phase whose kernels other calls had timed
    for _ in range(3):
        times = cold_kernels(fn, n, torch, flush)
        dev_us = sum(t for t, _ in times.values())
        if dev_us > 0:
            break
    check(dev_us > 0, "torch.profiler recorded no device time in three "
          "profiles")
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


def stencil_call(name, coef_, x, b, corr, iters, plain=False):
    """One call of the pressure kernel `name` (or its plain version) on
    the operands of `level_operands`; its outputs as a tuple."""
    from tpufoam_torch.ops import stencil as st
    fn = getattr(st, f"{name}_plain" if plain else name)
    if name == "corr_smooth":
        out_ = fn(coef_, x, corr, b, iters)
    else:
        out_ = fn(coef_, x, b, iters)
    return out_ if isinstance(out_, tuple) else (out_,)


def cast(coef_, dt):
    from tpufoam_torch.fv.pressure import PressureCoeffs
    return PressureCoeffs(*(getattr(coef_, f.name).to(dt).contiguous()
                            for f in dataclasses.fields(coef_)))


def level_operands(coef_, b, dt):
    """A level's real operator and right-hand side ((ny, nx), or a
    fleet's (B, ny, nx)) in `dt`, x from one Jacobi step of them, and a
    correction field."""
    x = b / coef_.diag
    return (cast(coef_, dt), x.to(dt), b.to(dt),
            (0.1 * x.roll(1, -1)).to(dt))


def fleet_backend_phases(torch, card, case_b, flow_b0, fcases, cfg,
                         predictor, reset_counts, counts, fleet_health,
                         check_fleet_health):
    """step-fleet-auto: the fleet of step-fleet with AutoBackend() (the
    surrogate warm start, the batched momentum launch), then one lockstep
    each with HybridBackend and SurrogateBackend (sm_ref512 as the
    backend's predictor), each backend's lockstep against the four cases
    stepped alone. Returns the AutoBackend locksteps' launches."""
    import numpy as np

    from tpufoam_torch.fv.case import fleet_member
    from tpufoam_torch.fv.pressure import PressureCoeffs
    from tpufoam_torch.piso.batched import run_piso_batched_eager
    from tpufoam_torch.piso.engine import piso_step
    from tpufoam_torch.solvers.backends import (AutoBackend, HybridBackend,
                                                SurrogateBackend)

    n_fleet = len(fcases)
    verdicts = []

    class CountedAuto(AutoBackend):
        """AutoBackend recording each solve's per-case verdicts."""

        def needs_escalation(self, case_, coef_, rhs_, p1_):
            need_ = super().needs_escalation(case_, coef_, rhs_, p1_)
            verdicts.append(need_)
            return need_

    class Alone:
        """A backend whose every fleet solve is also solved case by case
        from the same operands: the largest relative difference of a
        case's result, and the verdicts of the solves alone."""

        def __init__(self, backend):
            self.backend, self.diff, self.alone = backend, 0.0, []

        def __call__(self, case_, coef_, rhs_, p_prev_, aux_):
            out_ = self.backend(case_, coef_, rhs_, p_prev_, aux_)
            if rhs_.dim() == 3:
                n0 = len(verdicts)
                for k in range(rhs_.shape[0]):
                    one = self.backend(
                        fleet_member(case_, k),
                        PressureCoeffs(*(getattr(coef_, f.name)[k] for f in
                                         dataclasses.fields(coef_))),
                        rhs_[k], p_prev_[k], {n: a[k] for n, a in
                                             aux_.items()})
                    self.diff = max(self.diff, float(
                        (out_[k] - one).abs().max()
                        / one.abs().max().clamp(min=1e-30)))
                self.alone.append([bool(v) for v in verdicts[n0:]])
                del verdicts[n0:]
            return out_

    def events(n):
        return [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(n)]

    rows = {}
    auto = CountedAuto()
    with torch.no_grad():
        flow = run_piso_batched_eager(case_b, flow_b0, N_AUTO_WARM, cfg=cfg,
                                      backend=auto, sm_predict=predictor)
        torch.cuda.synchronize()
        reset_counts(predictor)
        verdicts.clear()
        # what re-resolving the predictor's stitch operators costs a call
        # (the engine binds it once a rollout; a backend's predict does not)
        t = time.perf_counter()
        for _ in range(20):
            predictor.bind(case_b)
        bind_us = (time.perf_counter() - t) / 20 * 1e6
        ev = events(N_AUTO_STEPS)
        t = time.time()
        for e0, e1 in ev:
            e0.record()
            flow = run_piso_batched_eager(case_b, flow, 1, cfg=cfg,
                                          backend=auto, sm_predict=predictor)
            e1.record()
        torch.cuda.synchronize()
        host_s = time.time() - t
        launches, calls = counts(), predictor.calls
    need = torch.stack(verdicts).cpu().numpy()          # (solves, cases)
    finite, cont, co = fleet_health(case_b, flow)
    rows["auto"] = dict(
        ms_per_lockstep=sum(a.elapsed_time(b) for a, b in ev)
        / N_AUTO_STEPS, host_ms_per_lockstep=host_s * 1e3 / N_AUTO_STEPS,
        solves=int(need.shape[0]),
        escalations_per_case=need.sum(axis=0).tolist(),
        continuity_error=cont, courant=co, finite=finite,
        momentum_batched_launches_per_lockstep=launches[
            "momentum_multisweep"] / N_AUTO_STEPS,
        stencil_matvec_launches_per_lockstep=launches["stencil_matvec"]
        / N_AUTO_STEPS, sm_predict_calls=calls,
        predictor_bind_us_per_call=bind_us)
    check_fleet_health("step-fleet-auto", finite, cont)
    check(launches["momentum_multisweep"] == N_AUTO_STEPS
          and calls == N_AUTO_STEPS,
          f"step-fleet-auto: {launches['momentum_multisweep']} momentum "
          f"launches, {calls} predictions in {N_AUTO_STEPS} locksteps")
    check(launches["stencil_matvec"] > 0,
          "step-fleet-auto: the pressure matvec never launched its kernel")

    # one lockstep each with the surrogate as the backend, from the
    # AutoBackend fleet's state; health: finite (a pure-surrogate p is
    # not held to continuity)
    others = {"hybrid": HybridBackend(predict=predictor),
              "surrogate": SurrogateBackend(predict=predictor)}
    with torch.no_grad():
        for name, be in others.items():
            torch.cuda.synchronize()
            reset_counts(predictor)
            (e0, e1), = events(1)
            e0.record()
            out = run_piso_batched_eager(case_b, flow, 1, cfg=cfg,
                                         backend=be)
            e1.record()
            torch.cuda.synchronize()
            k_ = counts()
            finite_o, cont_o, co_o = fleet_health(case_b, out)
            rows[name] = dict(ms_per_lockstep=e0.elapsed_time(e1),
                              continuity_error=cont_o, courant=co_o,
                              finite=finite_o,
                              momentum_batched_launches=k_[
                                  "momentum_multisweep"],
                              stencil_matvec_launches=k_["stencil_matvec"],
                              sm_predict_calls=predictor.calls)
            check(finite_o and k_["momentum_multisweep"] == 1,
                  f"step-fleet-auto {name}: finite {finite_o}, launches "
                  f"{k_}")

    # each backend's lockstep against the four cases stepped alone from
    # the same state; every fleet solve also solved case by case
    bound = predictor.bind(case_b)
    singles_sm = [predictor.bind(c) for c in fcases]
    parity = {}
    for name, be in (("auto", CountedAuto()), *others.items()):
        checked = Alone(be)
        sm_b, sm_1 = ((bound, singles_sm) if name == "auto"
                      else (None, [None] * n_fleet))
        verdicts.clear()
        with torch.no_grad():
            got = piso_step(case_b, flow, cfg, checked, sm_b)
            fleet_need = [v.tolist() for v in verdicts]
            verdicts.clear()
            alone_need = []
            singles = []
            for k, c in enumerate(fcases):
                singles.append(piso_step(c, fleet_member(flow, k), cfg, be,
                                         sm_1[k]))
                alone_need.append([bool(v) for v in verdicts])
                verdicts.clear()
            torch.cuda.synchronize()
        diffs = [{f: compare((getattr(got, f)[k],),
                             (getattr(single, f),))[1]
                  for f in ("u", "v", "p", "dt")}
                 for k, single in enumerate(singles)]
        parity[name] = dict(rel_diff=diffs, solve_rel_diff=checked.diff)
        for k, d in enumerate(diffs):
            for f, v in d.items():
                check(v <= FLEET_PARITY_TOL[f],
                      f"step-fleet-auto parity {name} case {k} {f}: rel "
                      f"diff {v:.3e}")
        check(checked.diff <= FLEET_PARITY_TOL["p"],
              f"step-fleet-auto {name}: a fleet solve against its cases "
              f"alone: rel diff {checked.diff:.3e}")
        if name == "auto":
            # every solve's verdict per case equals the case's alone; and
            # a case that escalates in the lockstep's kept solves does so
            # when stepped alone
            check([list(map(bool, v)) for v in fleet_need]
                  == checked.alone,
                  f"step-fleet-auto: verdicts {fleet_need} vs alone "
                  f"{checked.alone}")
            parity[name].update(verdicts_lockstep=fleet_need,
                                verdicts_alone=alone_need)
            for k in range(n_fleet):
                check(not fleet_need[0][k] or alone_need[k][0],
                      f"step-fleet-auto: case {k} escalates in the "
                      f"lockstep's first solve but not alone")
    say("step-fleet-auto", card=card, cases=n_fleet,
        locksteps=N_AUTO_STEPS, backends=rows, parity=parity,
        tol=FLEET_PARITY_TOL)
    return launches


def fleet_pressure_phase(torch, card, dev, case_b, flow_b0, cfg, backend,
                         predictor, flush, reset_counts):
    """kernel-fleet-pressure: rows 3-5 (jacobi_multisweep, smooth_residual,
    corr_smooth) in one launch on a (4, ny, nx) stack, at every level of
    the main path's hierarchy (512 x 2048 .. 8 x 32), float32 and
    bfloat16, iters 1, 2 and the most each takes, on the four fleet
    cases' first-corrector operators and on random operands: each call
    one launch (counted under the variant a case's plane takes), equal to
    its plain version and to four single-case launches bit for bit. Their
    device time at 4 x 512 x 2048, at the paths' dtype and sweeps, beside
    the four single launches and tools/kernel_bounds's bound of 4 planes.
    Returns {kernel: its row of the kernels line}."""
    from tpufoam_torch.fv.pressure import PressureCoeffs
    from tpufoam_torch.ops import stencil as st
    from tpufoam_torch.piso.engine import piso_step
    from tpufoam_torch.solvers import multigrid as mg
    from tpufoam_torch.tools import kernel_bounds

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    first = []

    def capture(case_, pcoef_, rhs_, p_prev_, aux_):
        if not first:
            first.append((pcoef_, rhs_))
        return backend(case_, pcoef_, rhs_, p_prev_, aux_)

    with torch.no_grad():
        piso_step(case_b, flow_b0, cfg, capture, predictor.bind(case_b))
    pcoef, rhs = first[0]
    levels = mg.build_hierarchy(pcoef)
    rhs_levels = [rhs]
    while len(rhs_levels) < len(levels):
        rhs_levels.append(mg.restrict(rhs_levels[-1]))
    n = rhs.shape[0]
    gen = torch.Generator(device=dev).manual_seed(19)

    def random_operands(shape, dt):
        def f(lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                               device=dev)

        c = [f(0.0, 1.0) for _ in range(4)]
        diag = c[0] + c[1] + c[2] + c[3] + f(0.1, 1.0)
        return (cast(PressureCoeffs(*c, torch.zeros_like(diag), diag), dt),
                f(-1, 1).to(dt), f(-1, 1).to(dt), f(-0.1, 0.1).to(dt))

    def case_of(ops, k):
        coef_, x, b, corr = ops
        return (PressureCoeffs(*(getattr(coef_, f.name)[k]
                                 for f in dataclasses.fields(coef_))),
                x[k], b[k], corr[k])

    def held(name, prec, ops, iters, where):
        """One launch on the stack (counted under the variant of a case's
        plane), bit for bit against the plain version and against the four
        cases launched alone; the max |diff| (0)."""
        fn, dt = getattr(st, name), dtypes[prec]
        plane = tuple(ops[1].shape[-2:])
        key = (st.multisweep_geometry(plane, dt, iters, kernel=name).variant,
               prec, plane)
        n0, by0 = fn.launches, fn.by_shape[key]
        got = stencil_call(name, *ops, iters)
        torch.cuda.synchronize()
        check(fn.launches == n0 + 1 and fn.by_shape[key] == by0 + 1,
              f"kernel-fleet-pressure {name} {prec} {where} iters {iters}: "
              f"not one launch of the {key[0]} kernel")
        err = compare(got, stencil_call(name, *ops, iters, True))[0]
        for k in range(n):
            one = stencil_call(name, *case_of(ops, k), iters)
            err = max(err, compare(tuple(g[k] for g in got), one)[0])
        check(err == 0.0, f"kernel-fleet-pressure {name} {prec} {where} "
              f"iters {iters}: max |diff| {err:.3e}, not 0")
        return err

    rows, checked = {}, 0
    for name in STENCIL:
        row = {"max_abs_err": 0.0}
        for prec, dt in dtypes.items():
            iters_ = sorted({1, 2, st._max_iters(dt, name)})
            for coef_l, b_l in zip(levels, rhs_levels):
                where = f"level {tuple(b_l.shape[-2:])}"
                for ops in (level_operands(coef_l, b_l, dt),
                            random_operands(tuple(b_l.shape), dt)):
                    for k in iters_:
                        row["max_abs_err"] = max(row["max_abs_err"],
                                                 held(name, prec, ops, k,
                                                      where))
                        checked += 1
        # time at 4 x 512 x 2048, the path's dtype and sweeps
        prec = PATH_DTYPE[name]
        dt, iters = dtypes[prec], PATH_SWEEPS[name][prec]
        ops = level_operands(levels[0], rhs_levels[0], dt)
        singles = [case_of(ops, k) for k in range(n)]
        t_k = timings(lambda: stencil_call(name, *ops, iters),
                      lambda: stencil_call(name, *ops, iters, True), 100,
                      10, torch, flush)
        singles_ms, singles_call_ms = time_ms(
            lambda: [stencil_call(name, *s_, iters) for s_ in singles], 100,
            torch, flush)
        b = kernel_bounds.bound(name, (NY, NX), prec, planes=n)
        row.update(dtype=prec, iters=iters, shape=[n, NY, NX], **t_k,
                   singles_ms=singles_ms, singles_call_ms=singles_call_ms,
                   bound_ms=b["bound_us"] / 1e3, bound_by=b["bound_by"],
                   variant=st.multisweep_geometry(
                       (NY, NX), dt, iters, kernel=name).variant)
        rows[name] = row
    reset_counts()
    say("kernel-fleet-pressure", card=card, cases=n,
        levels=[list(b_.shape[-2:]) for b_ in rhs_levels], checks=checked,
        kernels={name: {k: v for k, v in r.items()}
                 for name, r in rows.items()})
    return rows


def fleet_kernel_phase(torch, card, case_b, flow_b0, fcases, cfg,
                       predictor, reset_counts, counts, fleet_health,
                       check_fleet_health, plain_ms):
    """step-fleet-kernel: step-fleet's four cases (the sm_ref512 warm
    start, the batched momentum launch) with MGBackend(cycles=2,
    precision="bf16") and the kernel smoothers, "kernel-fused" then
    "kernel": 3 + 5 locksteps, ms a lockstep beside step-fleet's
    (`plain_ms`, the plain smoother, this call), launches per lockstep by
    kernel and level; one lockstep against the four cases stepped alone
    with the same smoother (bit for bit expected; FLEET_PARITY_TOL at
    worst), the lockstep's multisweep launches against the cases' alone.
    Returns {path: launch counts of its timed locksteps}."""
    from tpufoam_torch.fv.case import fleet_member
    from tpufoam_torch.ops import stencil as st
    from tpufoam_torch.piso.batched import run_piso_batched_eager
    from tpufoam_torch.piso.engine import piso_step
    from tpufoam_torch.solvers import multigrid as mg
    from tpufoam_torch.solvers.backends import MGBackend

    names = ("jacobi_multisweep", "smooth_residual", "corr_smooth")
    out = {}
    for smoother, used in (("kernel-fused", names[1:]),
                           ("kernel", names[:1])):
        be = MGBackend(cycles=2, precision="bf16", smoother=smoother)
        label = f"step-fleet-{smoother}"
        with torch.no_grad():
            flow_warm = run_piso_batched_eager(
                case_b, flow_b0, N_FLEET_WARM, cfg=cfg, backend=be,
                sm_predict=predictor)
            torch.cuda.synchronize()
            reset_counts(predictor)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t = time.time()
            ev0.record()
            flow = run_piso_batched_eager(case_b, flow_warm, N_FLEET_STEPS,
                                          cfg=cfg, backend=be,
                                          sm_predict=predictor)
            ev1.record()
            torch.cuda.synchronize()
            host_s = time.time() - t
            launches, cycles = counts(), mg.v_cycle.cycles
            calls = predictor.calls
            by_level = {name: sorted(
                ([v_, p_, list(sh_), n_ / N_FLEET_STEPS] for (v_, p_, sh_), n_
                 in getattr(st, name).by_shape.items()),
                key=lambda r: -r[2][0]) for name in used}
            # one lockstep against the four cases alone, from one state
            reset_counts()
            got = piso_step(case_b, flow_warm, cfg, be,
                            predictor.bind(case_b))
            torch.cuda.synchronize()
            lock = counts()
            singles, alone = [], []
            for k, c in enumerate(fcases):
                reset_counts()
                singles.append(piso_step(c, fleet_member(flow_warm, k), cfg,
                                         be, predictor.bind(c)))
                torch.cuda.synchronize()
                alone.append(counts())
        finite, cont, co = fleet_health(case_b, flow)
        diffs = [{name: compare((getattr(got, name)[k],),
                                (getattr(s_, name),))[1]
                  for name in ("u", "v", "p", "dt")}
                 for k, s_ in enumerate(singles)]
        ms = ev0.elapsed_time(ev1) / N_FLEET_STEPS
        say(label, card=card, cases=len(fcases), locksteps=N_FLEET_STEPS,
            backend=f"MGBackend(cycles=2, precision='bf16', "
                    f"smoother='{smoother}')",
            ms_per_lockstep=ms, step_fleet_plain_ms_per_lockstep=plain_ms,
            host_ms_per_lockstep=host_s * 1e3 / N_FLEET_STEPS,
            launches_per_lockstep={k_: v / N_FLEET_STEPS
                                   for k_, v in launches.items() if v},
            by_level=by_level, v_cycles_per_lockstep=cycles / N_FLEET_STEPS,
            sm_predict_calls=calls,
            parity_rel_diff=diffs, parity_tol=FLEET_PARITY_TOL,
            lockstep_launches={k_: lock[k_] for k_ in used},
            alone_launches={k_: [a[k_] for a in alone] for k_ in used},
            continuity_error=cont, courant=co, finite=finite)
        check_fleet_health(label, finite, cont, co)
        check(launches["momentum_multisweep"] == N_FLEET_STEPS
              and calls == N_FLEET_STEPS,
              f"{label}: {launches['momentum_multisweep']} momentum "
              f"launches, {calls} predictions in {N_FLEET_STEPS} locksteps")
        for name in used:
            check(launches[name] > 0, f"{label}: {name} never launched")
            # one launch a level for all the cases: the lockstep launches
            # what its slowest case (the most rescue solves) does alone
            check(lock[name] == max(a[name] for a in alone),
                  f"{label}: {lock[name]} {name} launches in a lockstep, "
                  f"{[a[name] for a in alone]} by the cases alone")
        for name in [n_ for n_ in names if n_ not in used]:
            check(launches[name] == 0, f"{label}: {name} launched")
        for k, d in enumerate(diffs):
            for name, v in d.items():
                check(v <= FLEET_PARITY_TOL[name],
                      f"{label} parity case {k} {name}: rel diff {v:.3e}")
        out[label] = launches
        del flow_warm, flow, got, singles
    return out


def train_tp_phase(torch, dev, card):
    """train-step-tp: sm_ref512's MLP (its manifest's mdef: 13 -> 512 x 3
    -> 512, bf16 compute) and MLP_attention at the same in and out dims
    through make_sharded_train_step on the one card's 1 x 1, 1 x 2 and
    2 x 2 meshes (the dense weights and Adam's moments cut over 'model',
    the batch over 'data'), batch 1024, Adam at TRAIN_CFG's lr, TP_STEPS
    steps from the same seeded parameters and batches after one warm-up
    step; 1 x 2 and 2 x 2 against 1 x 1 at TRAIN_STEP_TOL; each block's
    shard shapes, ms a step (CUDA events) and the collectives a step, a
    line a model."""
    import numpy as np

    from tpufoam_torch.models.mlp import ModelDef, init_model, tree_leaves
    from tpufoam_torch.parallel.mesh import (device_mesh,
                                             make_sharded_train_step,
                                             unshard_params)
    from tpufoam_torch.train.trainer import Adam

    with open(os.path.join(ROOT, "artifacts", "sm_ref512",
                           "manifest.json")) as f:
        spec = json.load(f)["mdef"]
    models = {"sm_ref512": ModelDef(**{**spec,
                                       "widths": tuple(spec["widths"])}),
              TP_ATTENTION: ModelDef.from_arch(
                  TP_ATTENTION, in_dim=spec["in_dim"],
                  out_dim=spec["out_dim"],
                  compute_dtype=spec["compute_dtype"])}
    for label, mdef in models.items():
        rng = np.random.default_rng(TP_SEED)
        bs = TRAIN_CFG["batch_size"]
        batches = [(torch.as_tensor(rng.standard_normal(
            (bs, mdef.in_dim)).astype(np.float32)),
            torch.as_tensor(rng.standard_normal(
                (bs, mdef.out_dim)).astype(np.float32)))
            for _ in range(TP_STEPS + 1)]
        p0 = init_model(TP_SEED, mdef, device="cpu")
        runs = {}
        for shape in TP_MESHES:
            n = shape[0] * shape[1]
            mesh = device_mesh(n, shape=shape, devices=[dev] * n)
            opt = Adam(TRAIN_CFG["lr"])
            step, shard = make_sharded_train_step(mesh, mdef, opt)
            # a warm-up step on the last batch, its result dropped
            step(*shard(p0, opt.init(p0), *batches[-1]))
            torch.cuda.synchronize()
            step.collectives.clear()
            p, s, losses, ms = p0, opt.init(p0), [], []
            for xb, yb in batches[:TP_STEPS]:
                p, s, xs, ys = shard(p, s, xb, yb)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                p, s, loss = step(p, s, xs, ys)
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1))
                losses.append(float(loss))
            names = [f"layers.{i}.{k}" for i in range(len(mdef.widths))
                     for k in ("b", "w")]
            leaves = [*(p["layers"][i][k] for i in range(len(mdef.widths))
                        for k in ("b", "w")), p["head"]["b"], p["head"]["w"]]
            runs[f"{shape[0]}x{shape[1]}"] = dict(
                losses=losses, ms_per_step=ms,
                mean_ms_per_step=sum(ms) / len(ms),
                collectives_per_step={k: v / TP_STEPS
                                      for k, v in step.collectives.items()},
                shard_shapes={nm: [list(b.shape) for b in a.blocks]
                              for nm, a in zip(names + ["head.b", "head.w"],
                                               leaves)},
                params=[a.cpu() for a in tree_leaves(unshard_params(p))])

        def diff(a, b):
            num = sum(float(((x.double() - y.double()) ** 2).sum())
                      for x, y in zip(a["params"], b["params"]))
            den = sum(float((y.double() ** 2).sum()) for y in b["params"])
            return {"loss": max(abs(x - y) / abs(y) for x, y in
                                zip(a["losses"], b["losses"])),
                    "params_l2": (num / den) ** 0.5}

        ref = runs["1x1"]
        chk = {k: diff(r, ref) for k, r in runs.items() if k != "1x1"}
        say("train-step-tp", card=card, model=label, kind=mdef.kind,
            widths=list(mdef.widths), in_dim=mdef.in_dim,
            out_dim=mdef.out_dim, compute_dtype=mdef.compute_dtype,
            batch=bs, steps=TP_STEPS,
            meshes={k: {n_: v for n_, v in r.items() if n_ != "params"}
                    for k, r in runs.items()},
            vs_1x1=chk, tol=TRAIN_STEP_TOL)
        half = mdef.widths[0] // 2
        check(runs["1x2"]["shard_shapes"]["layers.0.w"]
              == [[mdef.in_dim, half]] * 2,
              f"train-step-tp {label}: 1 x 2 shards of layer 0's w "
              f"{runs['1x2']['shard_shapes']['layers.0.w']}")
        for k, d_ in chk.items():
            check(d_["loss"] <= TRAIN_STEP_TOL["loss"]
                  and d_["params_l2"] <= TRAIN_STEP_TOL["params_l2"],
                  f"train-step-tp {label} {k} vs 1x1: {d_}")
        for k, r in runs.items():
            check(all(np.isfinite(r["losses"])),
                  f"train-step-tp {label} {k}: loss")


def _downstream_ke(u):
    """tests/test_differentiable.py's loss: the sum of u^2 over the
    downstream half (over every case of a stack)."""
    return (u[..., u.shape[-1] // 2:] ** 2).sum()


def rollout_grad(torch, case, flow, n, cfg, backend, reset_counts, counts,
                 run=None):
    """n steps of `run` (piso.engine.run_piso by default) under autograd
    from `flow`, then torch.autograd.grad of `_downstream_ke` w.r.t.
    case.inlet_u, every launch count set to 0 just before: a dict of the
    gradient, the loss, the forward's and the backward's ms (CUDA
    events), each kernel's launches in the forward and in the backward,
    the matvecs recorded on the tape (those with an operand that needs a
    gradient; the others launch the forward alone), and the device
    memory (allocated before; the peak during both)."""
    from tpufoam_torch.ops import stencil as st
    from tpufoam_torch.piso.engine import run_piso

    run = run or run_piso
    torch.cuda.synchronize()
    reset_counts()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    x = case.inlet_u.clone().requires_grad_(True)
    ev[0].record()
    f = run(dataclasses.replace(case, inlet_u=x), flow, n, cfg=cfg,
            backend=backend)
    loss = _downstream_ke(f.u)
    ev[1].record()
    fwd, taped = counts(), st.StencilMatvec.taped
    g, = torch.autograd.grad(loss, x)
    ev[2].record()
    torch.cuda.synchronize()
    total = counts()
    return dict(grad=g, loss=float(loss.detach()),
                fwd_ms=ev[0].elapsed_time(ev[1]),
                bwd_ms=ev[1].elapsed_time(ev[2]), fwd_launches=fwd,
                taped_matvecs=taped,
                bwd_launches={k: total[k] - fwd[k] for k in total},
                mem_before_bytes=mem0,
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def plain_matvec(torch):
    """ops.stencil.stencil_matvec replaced, inside the block, by a
    Function of its plain forward and plain backward
    (stencil_matvec_plain, stencil_matvec_grad_plain) on the card's
    tensors, which PyTorch's own kernels compute: the reference that a
    gradient through the two hand-written kernels equals bit for bit.
    The substitution lives in this script, not in the package."""
    from tpufoam_torch.ops import stencil as st

    class PlainMatvec(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, *coef):
            ctx.save_for_backward(x, *coef)
            return st.stencil_matvec_plain(st._Operator(*coef), x)

        @staticmethod
        def backward(ctx, g):
            x, *coef = ctx.saved_tensors
            return st.stencil_matvec_grad_plain(
                st._Operator(*coef), x, g.contiguous(), ctx.needs_input_grad)

    kernel = st.stencil_matvec
    st.stencil_matvec = lambda coef, x: PlainMatvec.apply(
        x, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag)
    try:
        yield
    finally:
        st.stencil_matvec = kernel


def _grad_summary(r):
    """A rollout_grad result as printed: no tensors."""
    return {k: v for k, v in r.items() if k != "grad"}


def matvec_grad_phase(torch, card, all_levels, stacked, random_edge_operands,
                      flush, csr_of):
    """kernel-matvec-grad: the matvec's backward kernel (stencil_matvec_grad,
    csrc/stencil_grad.cu) against stencil_matvec_grad_plain on the card,
    bit for bit, with all six gradients and with dx alone: at every level
    of both hierarchies (kernel-matvec's operands, g the level's
    right-hand side), on a (4, ny, nx) stack of each, and on random
    operands of the odd shapes, float32 and bfloat16, each call one
    launch. Its device time (L2 flushed), its plain version's and its
    bound at 512 x 2048 and 256 x 1375, beside the library's time for dx:
    the CSR product with the transpose of the same operator (`csr_of(coef,
    transpose=True)`). Also every window grad-sharded tapes: each block
    of a 2 x 2 mesh at every block level of 512 x 2048 (all but the
    coarsest, agglomerated whole), each halo of GRAD_SHARDED_HALOS, cut
    from the level's operands; and (1, ny, nx) stacks of each level
    (grad-fleet-sharded's one case a block). Returns (max |diff|, times,
    launches counted, the (dtype, plane shape) pairs checked)."""
    from tpufoam_torch.ops import stencil as st
    from tpufoam_torch.parallel.blocks import _span

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    err, checked = 0.0, 0
    shapes = set()
    n0 = st.stencil_matvec_grad.launches

    def exact(where, coef_, x_, g_):
        nonlocal err, checked
        shapes.add((st._DTYPES[x_.dtype], tuple(x_.shape[-2:])))
        for label, (need, *_) in GRAD_NEEDS.items():
            before = st.stencil_matvec_grad.launches
            got = st.stencil_matvec_grad(coef_, x_, g_, need)
            torch.cuda.synchronize()
            check(st.stencil_matvec_grad.launches == before + 1,
                  f"stencil_matvec_grad {where} {label}: not one launch")
            ref = st.stencil_matvec_grad_plain(coef_, x_, g_, need)
            check(all((a is None) == (not n_) for a, n_ in zip(got, need)),
                  f"stencil_matvec_grad {where} {label}: outputs")
            pairs = [(a, r) for a, r in zip(got, ref) if a is not None]
            e_ = compare([a for a, _ in pairs], [r for _, r in pairs])[0]
            check(e_ == 0.0, f"stencil_matvec_grad {where} {label}: max "
                  f"|diff| {e_:.3e}, not 0")
            err, checked = max(err, e_), checked + 1

    for prec, dt in dtypes.items():
        for lv in all_levels.values():
            for coef_l, b_l in lv:
                c_, x_, g_, _ = level_operands(coef_l, b_l, dt)
                where = f"{prec} {tuple(b_l.shape)}"
                exact(where, c_, x_, g_)
                cb, xb = stacked(c_, x_)
                exact(where + " x4", cb, xb, stacked(c_, g_)[1])
        for shape in ODD_SHAPES:
            c_, x_, g_ = random_edge_operands(shape, dt)
            exact(f"{prec} random {shape}", c_, x_, g_)
        for coef_l, b_l in all_levels["512x2048"]:
            c_, x_, g_, _ = level_operands(coef_l, b_l, dt)
            cb, xb = stacked(c_, x_, k=1)
            exact(f"{prec} {tuple(b_l.shape)} x1", cb, xb,
                  stacked(c_, g_, k=1)[1])
        for coef_l, b_l in all_levels["512x2048"][:-1]:
            c_, x_, g_, _ = level_operands(coef_l, b_l, dt)
            ny_, nx_ = b_l.shape
            for h in GRAD_SHARDED_HALOS:
                for i in range(2):
                    for j in range(2):
                        sl = (slice(*_span(ny_, 2, i, 0, h)),
                              slice(*_span(nx_, 2, j, 0, h)))
                        exact(f"{prec} {tuple(b_l.shape)} block {i},{j} "
                              f"halo {h}",
                              type(c_)(*(getattr(c_, f.name)[sl].contiguous()
                                         for f in dataclasses.fields(c_))),
                              x_[sl].contiguous(), g_[sl].contiguous())
    launches = st.stencil_matvec_grad.launches - n0

    times = {}
    for grid_name, lv in all_levels.items():
        for prec, dt in dtypes.items():
            c_, x_, g_, _ = level_operands(*lv[0], dt)
            size = torch.tensor([], dtype=dt).element_size()
            cells = x_.numel()
            row = {}
            for label, (need, n_read, n_write, n_ops) in GRAD_NEEDS.items():
                b_ms, b_by = bound((n_read + n_write) * cells * size,
                                   n_ops * cells)
                t_g = timings(
                    lambda: st.stencil_matvec_grad(c_, x_, g_, need),
                    lambda: st.stencil_matvec_grad_plain(c_, x_, g_, need),
                    200, 50, torch, flush)
                row[label] = dict(**t_g, bound_ms=b_ms, bound_by=b_by,
                                  share_of_bound=b_ms / t_g["ms"])
            try:
                a_t, g_col = csr_of(c_, transpose=True), g_.reshape(-1, 1)
                dx_lib = (a_t @ g_col).reshape(g_.shape)
            except RuntimeError as exc:    # no such product in this dtype
                row["dx"].update(library_ms=None,
                                 library_error=str(exc)[:200])
            else:
                # float32: the same function, summed in its own order;
                # bfloat16 rounds once where the kernel rounds after
                # every operation, so its distance is only recorded
                lib_rel = compare((dx_lib,), (st.stencil_matvec_grad_plain(
                    c_, x_, g_, GRAD_NEEDS["dx"][0])[0],))[1]
                check(prec != "f32" or lib_rel <= KERNEL_REL_TOL,
                      f"transposed sparse product vs dx: {lib_rel:.3e}")
                row["dx"].update(library_ms=time_ms(
                    lambda: a_t @ g_col, 200, torch, flush)[0],
                    library_rel_err=lib_rel)
            times[f"{grid_name} {prec}"] = row
    say("kernel-matvec-grad", card=card, checked=checked, max_abs_err=err,
        launches=launches, shapes=len(shapes), times=times)
    return err, times, launches, shapes


def grad_step_phase(torch, dev, card, case, flow0, reset_counts, counts):
    """grad-step: GRAD_STEPS steps of bench.py's main path in the
    configuration JAX differentiates (GRAD_CFG, the plain momentum
    smoother, MGBackend(cycles=2, precision="bf16")) under autograd
    through run_piso, then the gradient of `_downstream_ke` w.r.t.
    inlet_u: finite, nonzero, positive at the centre row (JAX's test);
    every taped matvec one launch of stencil_matvec and its backward one
    launch of stencil_matvec_grad (no other kernel launches); bit for bit
    equal to the same run with `plain_matvec` in the matvec's place; a
    directional central difference on the small case within GRAD_TOL.
    Its forward and backward ms and the device memory. Returns the launch
    counts of the run (forward and backward) and its rollout_grad
    result."""
    import numpy as np

    from tpufoam_torch.core.geometry import ChannelCase
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.piso.engine import PisoConfig, run_piso
    from tpufoam_torch.solvers.backends import MGBackend

    cfg = PisoConfig(**GRAD_CFG)
    backend = MGBackend(cycles=2, precision="bf16")
    res = rollout_grad(torch, case, flow0, GRAD_STEPS, cfg, backend,
                       reset_counts, counts)
    with plain_matvec(torch):
        ref = rollout_grad(torch, case, flow0, GRAD_STEPS, cfg, backend,
                           reset_counts, counts)
    g, ny = res["grad"], case.grid.ny
    fwd, bwd = res["fwd_launches"], res["bwd_launches"]
    path = {k: fwd[k] + bwd[k] for k in fwd}

    # the central difference on the small case, float32 multigrid
    small = build_channel_case(ChannelCase(**GRAD_SMALL), delta=1.0 / 16,
                               device=dev)
    f_small = initial_flow(small, dt0=5e-3)
    cfg_s, be_s = PisoConfig(**GRAD_SMALL_CFG), MGBackend(cycles=2)
    g_s = rollout_grad(torch, small, f_small, 3, cfg_s, be_s, reset_counts,
                       counts)["grad"]
    d = torch.as_tensor(np.random.default_rng(0).standard_normal(
        tuple(small.inlet_u.shape)).astype(np.float32), device=dev)

    def loss_at(inlet):
        f = run_piso(dataclasses.replace(small, inlet_u=inlet), f_small, 3,
                     cfg=cfg_s, backend=be_s)
        return float(_downstream_ke(f.u).double())

    with torch.no_grad():
        fd = (loss_at(small.inlet_u + GRAD_EPS * d)
              - loss_at(small.inlet_u - GRAD_EPS * d)) / (2 * GRAD_EPS)
    ad = float((g_s.double() * d.double()).sum())
    fd_rel = abs(fd - ad) / abs(ad)
    say("grad-step", card=card, grid=[ny, case.grid.nx], steps=GRAD_STEPS,
        config=GRAD_CFG, backend="MGBackend(cycles=2, precision='bf16')",
        **_grad_summary(res),
        grad_centre=float(g[ny // 2]), grad_abs_max=float(g.abs().max()),
        plain_fwd_ms=ref["fwd_ms"], plain_bwd_ms=ref["bwd_ms"],
        plain_launches=ref["fwd_launches"]["stencil_matvec"]
        + ref["bwd_launches"]["stencil_matvec_grad"],
        max_abs_diff_vs_plain=float((g - ref["grad"]).abs().max()),
        central_difference=dict(case=GRAD_SMALL, delta=1.0 / 16,
                                config=GRAD_SMALL_CFG, steps=3,
                                eps=GRAD_EPS, fd=fd, ad=ad, rel=fd_rel,
                                tol=GRAD_TOL))
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
          "grad-step: the gradient is not finite and nonzero")
    check(float(g[ny // 2]) > 0.0, "grad-step: centre-row gradient "
          f"{float(g[ny // 2]):.3e} not positive")
    _launch_gates("grad-step", res)
    check(ref["fwd_launches"]["stencil_matvec"] == 0
          and ref["bwd_launches"]["stencil_matvec_grad"] == 0,
          "grad-step: the plain run launched a kernel")
    check(torch.equal(g, ref["grad"]), "grad-step: the gradient differs "
          "from the plain Function's")
    check(fd_rel <= GRAD_TOL, f"grad-step: central difference {fd} against "
          f"{ad} (rel {fd_rel:.3e} > {GRAD_TOL})")
    return path, res


def grad_fleet_phase(torch, card, fcases, case_b, flow_b0, reset_counts,
                     counts):
    """grad-fleet: run_piso_batched on the fleet's four cases, GRAD_FLEET_STEPS
    steps of grad-step's configuration under autograd, the loss summed
    over the cases: each case's gradient equal to that case's stepped
    alone (run_piso) bit for bit; one backward launch for each batched
    forward launch of the matvec. ms and device memory of the fleet and
    of the four cases alone. Returns the launch counts of the fleet's run
    (forward and backward) and its rollout_grad result."""
    from tpufoam_torch.fv.case import fleet_member
    from tpufoam_torch.piso.batched import run_piso_batched
    from tpufoam_torch.piso.engine import PisoConfig
    from tpufoam_torch.solvers.backends import MGBackend

    cfg = PisoConfig(**GRAD_CFG)
    backend = MGBackend(cycles=2, precision="bf16")
    res = rollout_grad(torch, case_b, flow_b0, GRAD_FLEET_STEPS, cfg,
                       backend, reset_counts, counts, run=run_piso_batched)
    fwd, bwd = res["fwd_launches"], res["bwd_launches"]
    alone = [rollout_grad(torch, c, fleet_member(flow_b0, k),
                          GRAD_FLEET_STEPS, cfg, backend, reset_counts,
                          counts) for k, c in enumerate(fcases)]
    diffs = [float((res["grad"][k] - a["grad"]).abs().max())
             for k, a in enumerate(alone)]
    say("grad-fleet", card=card, cases=len(fcases),
        shape=list(case_b.fluid.shape), steps=GRAD_FLEET_STEPS,
        **_grad_summary(res),
        alone_fwd_ms=[a["fwd_ms"] for a in alone],
        alone_bwd_ms=[a["bwd_ms"] for a in alone],
        alone_matvec_launches=[a["fwd_launches"]["stencil_matvec"]
                               for a in alone],
        alone_max_memory_allocated_bytes=[a["max_memory_allocated_bytes"]
                                          for a in alone],
        max_abs_diff_vs_alone=diffs)
    check(all(torch.equal(res["grad"][k], a["grad"])
              for k, a in enumerate(alone)),
          f"grad-fleet: a case's gradient differs from it alone: {diffs}")
    _launch_gates("grad-fleet", res)
    return {k: fwd[k] + bwd[k] for k in fwd}, res


def _launch_gates(label, res):
    """The forward launches stencil_matvec alone, the backward
    stencil_matvec_grad alone, once for each taped matvec."""
    fwd, bwd = res["fwd_launches"], res["bwd_launches"]
    check(res["taped_matvecs"] > 0
          and bwd["stencil_matvec_grad"] == res["taped_matvecs"]
          and sum(fwd.values()) == fwd["stencil_matvec"]
          and sum(bwd.values()) == bwd["stencil_matvec_grad"],
          f"{label}: forward launches {fwd} ({res['taped_matvecs']} "
          f"taped), backward {bwd}")


def _rel_l2(torch, got, ref):
    got, ref = got.double(), ref.double()
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


def grad_sharded_phase(torch, card, case, flow0, mesh, step_res, checked,
                       reset_counts, counts):
    """grad-sharded: grad-step's configuration and GRAD_STEPS steps
    through the decomposed step (make_sharded_piso_step) on `mesh`, the
    gradient of `_downstream_ke` of the gathered u w.r.t. the whole
    inlet_u (shard_case splits it on the tape). Gates: the loss equals
    grad-step's (`step_res`) bit for bit; finite, centre row positive;
    the forward launches stencil_matvec alone and the backward
    stencil_matvec_grad alone, once for each taped matvec, each at a
    (dtype, window shape) kernel-matvec-grad checked (`checked`); bit for
    bit equal to the same run with `plain_matvec`; within
    GRAD_SHARDED_TOL of grad-step's gradient; the momentum kernel and
    the kernel pressure smoothers refuse a gradient, naming the kernel.
    Returns the launch counts of the run (forward and backward)."""
    from tpufoam_torch.ops import stencil as st
    from tpufoam_torch.parallel.mesh import (make_sharded_piso_step,
                                             shard_case, shard_flow,
                                             unshard_flow)
    from tpufoam_torch.piso.engine import PisoConfig
    from tpufoam_torch.solvers.backends import MGBackend

    def sharded_run(cfg_, backend_):
        step = make_sharded_piso_step(mesh, cfg_, backend_)

        def run(case_, flow_, n, cfg=None, backend=None):
            sc, sf = shard_case(mesh, case_), shard_flow(mesh, flow_)
            for _ in range(n):
                sf = step(sc, sf)
            return unshard_flow(sf)

        return run

    cfg = PisoConfig(**GRAD_CFG)
    backend = MGBackend(cycles=2, precision="bf16")
    res = rollout_grad(torch, case, flow0, GRAD_STEPS, cfg, backend,
                       reset_counts, counts, run=sharded_run(cfg, backend))
    by_window = dict(st.stencil_matvec_grad.by_shape)
    with plain_matvec(torch):
        ref = rollout_grad(torch, case, flow0, GRAD_STEPS, cfg, backend,
                           reset_counts, counts,
                           run=sharded_run(cfg, backend))
    refused = {}
    for label, cfg_k, be_k in (
            ("momentum kernel", PisoConfig(**GRAD_CFG,
                                           momentum_smoother="kernel"),
             backend),
            ("jacobi_multisweep kernel", cfg,
             MGBackend(cycles=2, precision="bf16", smoother="kernel")),
            ("smooth_residual kernel", cfg,
             MGBackend(cycles=2, precision="bf16",
                       smoother="kernel-fused"))):
        x = case.inlet_u.clone().requires_grad_(True)
        try:
            sharded_run(cfg_k, be_k)(dataclasses.replace(case, inlet_u=x),
                                     flow0, 1)
        except ValueError as exc:
            refused[label] = str(exc)
        else:
            refused[label] = None
    torch.cuda.synchronize()
    g, ny = res["grad"], case.grid.ny
    fwd, bwd = res["fwd_launches"], res["bwd_launches"]
    rel = _rel_l2(torch, g, step_res["grad"])
    say("grad-sharded", card=card, mesh=mesh.shape, grid=[ny, case.grid.nx],
        steps=GRAD_STEPS, config=GRAD_CFG,
        backend="MGBackend(cycles=2, precision='bf16')",
        **_grad_summary(res),
        bwd_launches_by_window={f"{v_} {p_} {sh_[0]}x{sh_[1]}": n_
                                for (v_, p_, sh_), n_ in sorted(
                                    by_window.items(),
                                    key=lambda kv: (kv[0][1], -kv[0][2][0],
                                                    kv[0][2][1]))},
        grad_step_loss=step_res["loss"],
        grad_step_fwd_ms=step_res["fwd_ms"],
        grad_step_bwd_ms=step_res["bwd_ms"],
        grad_step_taped_matvecs=step_res["taped_matvecs"],
        grad_step_max_memory_allocated_bytes=step_res[
            "max_memory_allocated_bytes"],
        grad_centre=float(g[ny // 2]), grad_abs_max=float(g.abs().max()),
        rel_l2_vs_grad_step=rel, tol=GRAD_SHARDED_TOL,
        plain_fwd_ms=ref["fwd_ms"], plain_bwd_ms=ref["bwd_ms"],
        max_abs_diff_vs_plain=float((g - ref["grad"]).abs().max()),
        refused={k_: v_ and v_[:160] for k_, v_ in refused.items()})
    check(res["loss"] == step_res["loss"], f"grad-sharded: loss "
          f"{res['loss']!r} is not grad-step's {step_res['loss']!r}")
    check(bool(torch.isfinite(g).all()), "grad-sharded: non-finite gradient")
    check(float(g[ny // 2]) > 0.0, "grad-sharded: centre-row gradient "
          f"{float(g[ny // 2]):.3e} not positive")
    _launch_gates("grad-sharded", res)
    check(all((p_, sh_) in checked for _v, p_, sh_ in by_window),
          f"grad-sharded: a backward window kernel-matvec-grad did not "
          f"check: {sorted(by_window)}")
    check(ref["fwd_launches"]["stencil_matvec"] == 0
          and ref["bwd_launches"]["stencil_matvec_grad"] == 0,
          "grad-sharded: the plain run launched a kernel")
    check(torch.equal(g, ref["grad"]), "grad-sharded: the gradient differs "
          "from the plain Function's")
    check(rel <= GRAD_SHARDED_TOL, f"grad-sharded: {rel:.3e} from "
          f"grad-step's gradient > {GRAD_SHARDED_TOL}")
    for label, msg in refused.items():
        check(msg is not None and label in msg and "no backward" in msg,
              f"grad-sharded: the {label} under autograd: {msg}")
    return {k: fwd[k] + bwd[k] for k in fwd}


def grad_fleet_sharded_phase(torch, card, dev, case_b, flow_b0, fleet_res,
                             reset_counts, counts):
    """grad-fleet-sharded: grad-fleet through make_sharded_fleet_step over
    a mesh of 4 of the card, one case a block (shard_fleet and
    unshard_fleet on the tape): the loss and each case's gradient equal
    grad-fleet's (`fleet_res`) bit for bit; the forward launches
    stencil_matvec alone and the backward stencil_matvec_grad alone, once
    for each taped matvec. Returns the launch counts of the run."""
    from tpufoam_torch.parallel.mesh import (device_mesh,
                                             make_sharded_fleet_step,
                                             shard_fleet, unshard_fleet)
    from tpufoam_torch.piso.engine import PisoConfig
    from tpufoam_torch.solvers.backends import MGBackend

    cfg = PisoConfig(**GRAD_CFG)
    backend = MGBackend(cycles=2, precision="bf16")
    mesh = device_mesh(4, devices=[dev] * 4)
    step = make_sharded_fleet_step(mesh, cfg, backend)

    def run(case_, flow_, n, cfg=None, backend=None):
        parts_c, parts_f = shard_fleet(mesh, case_), shard_fleet(mesh, flow_)
        for _ in range(n):
            parts_f = step(parts_c, parts_f)
        return unshard_fleet(mesh, parts_f)

    res = rollout_grad(torch, case_b, flow_b0, GRAD_FLEET_STEPS, cfg,
                       backend, reset_counts, counts, run=run)
    fwd, bwd = res["fwd_launches"], res["bwd_launches"]
    diffs = [float((res["grad"][k] - fleet_res["grad"][k]).abs().max())
             for k in range(len(res["grad"]))]
    say("grad-fleet-sharded", card=card, mesh=mesh.shape,
        shape=list(case_b.fluid.shape), steps=GRAD_FLEET_STEPS,
        **_grad_summary(res), grad_fleet_loss=fleet_res["loss"],
        grad_fleet_fwd_ms=fleet_res["fwd_ms"],
        grad_fleet_bwd_ms=fleet_res["bwd_ms"],
        grad_fleet_taped_matvecs=fleet_res["taped_matvecs"],
        grad_fleet_max_memory_allocated_bytes=fleet_res[
            "max_memory_allocated_bytes"],
        max_abs_diff_vs_grad_fleet=diffs)
    check(res["loss"] == fleet_res["loss"], f"grad-fleet-sharded: loss "
          f"{res['loss']!r} is not grad-fleet's {fleet_res['loss']!r}")
    check(all(torch.equal(res["grad"][k], fleet_res["grad"][k])
              for k in range(len(diffs))),
          f"grad-fleet-sharded: a case's gradient differs from "
          f"grad-fleet's: {diffs}")
    _launch_gates("grad-fleet-sharded", res)
    return {k: fwd[k] + bwd[k] for k in fwd}


def train_phases(torch, dev, card, reset_counts, counts):
    """The training path's five phases (train-data, train-pca,
    train-step, train, train-serve). Returns the kernel launches of the
    training rollout and of the served steps, {path: {kernel: n}}, and
    the rollout's case and last PC_FRAMES frames."""
    import tempfile

    import numpy as np

    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.models.mlp import (ModelDef, init_model,
                                         tree_leaves)
    from tpufoam_torch.parallel.mesh import (device_mesh,
                                             make_sharded_train_step,
                                             unshard_params)
    from tpufoam_torch.piso.engine import (PisoConfig, continuity_error,
                                           courant_number, run_piso_eager)
    from tpufoam_torch.solvers.backends import MGBackend, MGCGBackend
    from tpufoam_torch.surrogate.pca import StreamingPCA, fit_pca_exact
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)
    from tpufoam_torch.train.dataset import (build_block_dataset,
                                             frames_from_rollout)
    from tpufoam_torch.train.trainer import (TrainConfig, _fit_encode_staged,
                                             Adam, normalize_pc_space,
                                             train_surrogate)

    def sync_time(t0):
        torch.cuda.synchronize()
        return time.time() - t0

    rows = ("momentum_multisweep", "stencil_matvec", "jacobi_multisweep")
    launches = {}

    # ---- train-data: the rollout's frames, then the block dataset --------
    case = build_channel_case(channel_case_geometry(**TRAIN_CASE),
                              delta=TRAIN_DELTA, device=dev)
    check(tuple(case.grid.shape) == TRAIN_SHAPE,
          f"train-data: grid {case.grid.shape}, not {TRAIN_SHAPE}")
    cfg = PisoConfig(**TRAIN_PISO)
    backend = MGCGBackend(rtol=1e-6, smoother="kernel")
    steps = TRAIN_WARMUP + TRAIN_FRAMES * TRAIN_SPF
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    flow = run_piso_eager(case, initial_flow(case, 1e-3), TRAIN_WARMUP,
                          cfg=cfg, backend=backend)
    frames = frames_from_rollout(case, flow, TRAIN_FRAMES, TRAIN_SPF,
                                 cfg=cfg, backend=backend)
    rollout_s = sync_time(t)
    launches["train-data"] = counts()
    t = time.time()
    ds = build_block_dataset(case, frames, family="deltaU_deltaP",
                             n_samples_per_frame=TRAIN_SAMPLES,
                             block_size=TRAIN_BLOCK, seed=0)
    dataset_s = sync_time(t)
    d_in = int(np.prod(ds.x.shape[1:]))
    tcfg = TrainConfig(**TRAIN_CFG)
    n_val = max(int(ds.n * tcfg.val_fraction), 1)
    cont = float(continuity_error(case, flow))
    say("train-data", card=card, shape=list(TRAIN_SHAPE),
        cuts={"cases": "1 of 10 (cylinder 0.5, nu 8e-3)",
              "warmup_steps": f"100 -> {TRAIN_WARMUP}",
              "frames": f"24 -> {TRAIN_FRAMES}",
              "steps_per_frame": f"5 -> {TRAIN_SPF}",
              "epochs": f"800 -> {TRAIN_EPOCHS}"},
        rollout_steps=steps, rollout_s=rollout_s,
        ms_per_rollout_step=rollout_s * 1e3 / steps, dataset_s=dataset_s,
        blocks=ds.n, train_rows=ds.n - n_val, d_in=d_in,
        d_out=int(np.prod(ds.y.shape[1:])),
        dataset_host_gb=(ds.x.nbytes + ds.y.nbytes) / 1e9,
        rollout_launches={k: launches["train-data"][k] for k in rows},
        continuity_error_after_warmup=cont)
    check(d_in == TRAIN_BLOCK**2 * 3, f"train-data: D {d_in}, not "
          f"{TRAIN_BLOCK**2 * 3}")
    check(ds.n - n_val >= TRAIN_MIN_ROWS,
          f"train-data: {ds.n - n_val} training rows < {TRAIN_MIN_ROWS}")
    check(launches["train-data"]["momentum_multisweep"] == steps,
          f"train-data: momentum launches {launches['train-data']}")
    check(all(launches["train-data"][k] > 0 for k in rows),
          f"train-data: a kernel of rows 1-3 never launched: "
          f"{launches['train-data']}")
    last_frames = frames[-max(PC_FRAMES, BRIDGE_STEPS):]
    del frames

    # ---- train-pca: the device-cached PCA fit and encode -----------------
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    pca_in, pca_out, pc_in, pc_out, z_in, z_out = _fit_encode_staged(
        ds, tcfg, dev)
    pca_s = sync_time(t)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the subset checks, on the inputs side (D 49,152)
    sub = ds.flat_normalized(slice(0, TRAIN_PCA_SUBSET), side=0)
    k_sub = min(tcfg.max_num_pc, len(sub))
    t = time.time()
    s_card = StreamingPCA(k_sub, seed=tcfg.seed).fit(
        lambda: iter([torch.as_tensor(sub, device=dev)]))
    sub_card_s = sync_time(t)
    e_card = fit_pca_exact(torch.as_tensor(sub, device=dev), k_sub)
    t = time.time()
    s_cpu = StreamingPCA(k_sub, seed=tcfg.seed).fit(lambda: iter([sub]),
                                                    device="cpu")
    sub_cpu_s = time.time() - t
    evr_s = s_card.explained_variance_ratio.cpu().numpy()
    evr_e = e_card.explained_variance_ratio.cpu().numpy()
    evr_c = s_cpu.explained_variance_ratio.numpy()
    lead = s_card.n_components_for_variance(tcfg.var_in, k_sub)
    # principal angles of the top 8: the singular values of Qa Qb^T
    top = 8
    sv = torch.linalg.svdvals(s_card.components[:top].double()
                              @ e_card.components[:top].double().T)
    angle = float(torch.arccos(torch.clamp(sv.min(), max=1.0)))
    pca_chk = dict(
        rows=len(sub), k=k_sub,
        evr_vs_exact=float(np.abs(evr_s[:lead] - evr_e[:lead]).max()),
        angle_top8_vs_exact=angle,
        pc_count_card_cpu=[lead, s_cpu.n_components_for_variance(
            tcfg.var_in, k_sub)],
        evr_card_vs_cpu=float(np.abs(evr_s - evr_c).max()),
        streaming_card_s=sub_card_s, streaming_cpu_s=sub_cpu_s)
    say("train-pca", card=card, blocks=ds.n, d_in=d_in, pc_in=pc_in,
        pc_out=pc_out, k_cap=min(tcfg.max_num_pc, ds.n),
        evr_in_at_pc=float(pca_in.explained_variance_ratio[:pc_in].sum()),
        evr_out_at_pc=float(pca_out.explained_variance_ratio[:pc_out].sum()),
        seconds=pca_s, peak_device_gb=peak_gb, subset=pca_chk,
        tol=TRAIN_PCA_TOL)
    check(pca_chk["evr_vs_exact"] <= TRAIN_PCA_TOL["evr_exact"]
          and angle <= TRAIN_PCA_TOL["angle_top8"],
          f"train-pca: streaming vs exact {pca_chk}")
    check(pca_chk["pc_count_card_cpu"][0] == pca_chk["pc_count_card_cpu"][1]
          and pca_chk["evr_card_vs_cpu"] <= TRAIN_PCA_TOL["evr_cpu"],
          f"train-pca: card vs CPU {pca_chk}")
    check(np.isfinite(z_in).all() and np.isfinite(z_out).all(),
          "train-pca: non-finite codes")
    del sub, s_card, e_card, s_cpu

    # ---- train-step: one data-parallel step, card against the CPU --------
    x_n, y_n, _ = normalize_pc_space(z_in, z_out, tcfg.standardization)
    xb = torch.as_tensor(x_n[:tcfg.batch_size], dtype=torch.float32)
    yb = torch.as_tensor(y_n[:tcfg.batch_size], dtype=torch.float32)
    mdef = ModelDef.from_arch(tcfg.arch, in_dim=pc_in, out_dim=pc_out)
    p0 = init_model(tcfg.seed, mdef, device="cpu")

    def one_step(devices):
        mesh = device_mesh(len(devices), devices=devices)
        opt = Adam(tcfg.lr, b1=tcfg.beta1)
        step, shard = make_sharded_train_step(mesh, mdef, opt)
        p, s_, xs, ys = shard(p0, opt.init(p0), xb, yb)
        t0 = time.time()
        p, _, loss = step(p, s_, xs, ys)
        loss = float(loss)
        return [a.cpu() for a in tree_leaves(unshard_params(p))], loss, \
            time.time() - t0

    def diff(a, b):
        (pa, la, _), (pb, lb, _) = a, b
        num = sum(float(((x.double() - y.double()) ** 2).sum())
                  for x, y in zip(pa, pb))
        den = sum(float((y.double() ** 2).sum()) for y in pb)
        return {"loss": abs(la - lb) / abs(lb), "params_l2": (num / den)**.5,
                "params_leaf_max": max(
                    float((x - y).abs().max() / y.abs().max().clamp(
                        min=1e-30)) for x, y in zip(pa, pb))}

    card1 = one_step([dev])
    card1 = one_step([dev])      # the first call's set-up left out
    cpu1 = one_step(["cpu"])
    card4 = one_step([dev] * 4)
    step_chk = {"card_vs_cpu": diff(card1, cpu1),
                "mesh2x2_vs_1x1": diff(card4, card1)}
    say("train-step", card=card, batch=tcfg.batch_size, arch=tcfg.arch,
        compute_dtype=mdef.compute_dtype, in_dim=pc_in, out_dim=pc_out,
        loss=card1[1], step_ms_1x1=card1[2] * 1e3,
        step_ms_2x2=card4[2] * 1e3, tol=TRAIN_STEP_TOL, **step_chk)
    for name, d_ in step_chk.items():
        check(d_["loss"] <= TRAIN_STEP_TOL["loss"]
              and d_["params_l2"] <= TRAIN_STEP_TOL["params_l2"],
              f"train-step {name}: {d_}")

    # ---- train: train_surrogate from the PCA stage's codes ----------------
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        bundle, state = train_surrogate(
            ds, "deltaU_deltaP", tcfg, overlap_ratio=0.25,
            checkpoint_path=os.path.join(tmp, "ck.pt"),
            checkpoint_every=TRAIN_EPOCHS // 2,
            precomputed=(pca_in, pca_out, pc_in, pc_out, z_in, z_out),
            device=dev)
        train_s = sync_time(t)
        n_tr = ds.n - n_val
        bs = min(tcfg.batch_size, n_tr)
        epochs = len(state.history)
        hist = np.asarray(state.history)
        say("train", card=card, epochs=epochs, seconds=train_s,
            epochs_per_s=epochs / train_s,
            krows_per_s=epochs * (n_tr // bs) * bs / train_s / 1e3,
            train_rows=n_tr, batches_per_epoch=n_tr // bs,
            first_train_loss=float(hist[0]), last_train_loss=float(hist[-1]),
            best_val=state.best_val, best_epoch=state.best_epoch,
            val_first_last=[state.val_history[0], state.val_history[-1]])
        check(np.isfinite(hist).all() and np.isfinite(state.val_history).all(),
              "train: non-finite loss")
        check(hist[-1] < 0.5 * hist[0],
              f"train: last train loss {hist[-1]:.4g} not below half the "
              f"first {hist[0]:.4g}")

        # ---- train-serve: save, load, predict on the hybrid step ---------
        path = os.path.join(tmp, "sm")
        t = time.time()
        bundle.trimmed().save(path)
        files = sorted(os.listdir(path))
        with np.load(path + "/arrays.npz") as a, \
                np.load(os.path.join(ROOT, "artifacts", "sm_ref512",
                                     "arrays.npz")) as ref:
            keys_ok = sorted(a.files) == sorted(ref.files)
        loaded = SurrogateBundle.load(path, device=dev)
        save_load_s = sync_time(t)
    predictor = make_predictor(loaded, stitch="lstsq")
    be = MGBackend(cycles=2, precision="bf16")
    n_serve = 2
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts(predictor)
        t = time.time()
        flow2 = run_piso_eager(case, flow, n_serve, cfg=cfg, backend=be,
                               sm_predict=predictor)
        serve_s = sync_time(t)
    launches["train-serve"] = counts()
    cont = float(continuity_error(case, flow2))
    co = float(courant_number(case, flow2))
    finite = all(bool(torch.isfinite(getattr(flow2, f)).all())
                 for f in ("u", "v", "p", "phi_x", "phi_y"))
    say("train-serve", card=card, files=files, sm_ref512_keys=keys_ok,
        pc_in=loaded.pc_in, pc_out=loaded.pc_out, save_load_s=save_load_s,
        steps=n_serve, ms_per_step=serve_s * 1e3 / n_serve,
        predictions=predictor.calls, continuity_error=cont, courant=co,
        finite=finite, kernel_launches={k: launches["train-serve"][k]
                                        for k in rows})
    check(files == ["arrays.npz", "manifest.json", "params_tree.json"]
          and keys_ok, f"train-serve: saved {files}, keys {keys_ok}")
    check(finite and cont < 1e-4 and co <= TRAIN_PISO["max_co"] + 1e-3,
          f"train-serve: finite {finite}, continuity {cont:.3e}, Co {co}")
    check(predictor.calls == n_serve
          and launches["train-serve"]["momentum_multisweep"] == n_serve,
          f"train-serve: {predictor.calls} predictions, launches "
          f"{launches['train-serve']} in {n_serve} steps")
    return launches, case, last_frames


def bridge_phase(torch, dev, card, case, frames, reset_counts, counts):
    """bridge: the port's BridgeServer on the card, driven through the C
    API of the repo's bridge/ library (built with its Makefile, called
    with ctypes), with the cells of the training rollout's last frames.
    Returns the kernel launches of the served steps, summed over the
    models."""
    import tempfile
    import threading

    import numpy as np

    from tpufoam_torch.bridge import client
    from tpufoam_torch.bridge import server as bridge_server
    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.eval import evaluation
    from tpufoam_torch.utils.hdf5_io import rollout_to_records

    sdf_impl, resample_impl = evaluation.domain_and_sdf, \
        evaluation.build_resample

    t = time.time()
    lib = client.load_library(client.build_library(
        os.path.join(ROOT, "tpufoam_torch", "_build", "bridge")))
    build_s = time.time() - t
    geom = channel_case_geometry(**TRAIN_CASE)
    top = geom.boundary_points_top(2000)
    obst = geom.shape.boundary_points(720)
    # the solver's cells, [Ux, Uy, Cx, Cy, p], one array a step
    steps = [np.ascontiguousarray(r[:, [0, 1, 3, 4, 2]], dtype=np.float64)
             for r in rollout_to_records(case, frames)]
    n = len(steps[0])

    # the one-time prep's parts, timed inside the servers' preps: the SDF
    # on the card (synchronized), the two Delaunay builds on the host
    # (cells -> grid, then grid -> cells)
    prep_s = collections.defaultdict(list)

    def timed(label, fn, sync=False):
        def run(*args, **kw):
            t0 = time.time()
            out_ = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            prep_s[label].append(time.time() - t0)
            return out_
        return run

    evaluation.domain_and_sdf = timed("sdf_on_card",
                                      evaluation.domain_and_sdf, sync=True)
    evaluation.build_resample = timed("delaunay", evaluation.build_resample)

    # a short path for the socket (AF_UNIX allows 107 bytes)
    sock_dir = tempfile.mkdtemp(prefix="tb")
    sock = os.path.join(sock_dir, "tb.sock")
    models = {"identity": "identity", "poisson": "poisson",
              "sm": "sm:" + os.path.join(ROOT, "artifacts", "sm_ref512")}
    rows, total = {}, collections.Counter()

    def world(n_ranks, world_id):
        """p of each step from n_ranks client threads, contiguous slices
        of the cells, through tb_init_rank."""
        cuts = [k * n // n_ranks for k in range(n_ranks + 1)]
        out = [[None] * len(steps) for _ in range(n_ranks)]
        errors = []

        def rank(k):
            try:
                lo, hi = cuts[k], cuts[k + 1]
                cl = client.Client(lib, sock, steps[0][lo:hi], top, obst,
                                   rank=k, n_ranks=n_ranks,
                                   world_id=world_id)
                for s_, c_ in enumerate(steps):
                    out[k][s_] = cl.step(c_[lo:hi])[0]
                cl.close()
            except Exception as e:
                errors.append(repr(e))

        ths = [threading.Thread(target=rank, args=(k,))
               for k in range(n_ranks)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        check(not errors and not any(th.is_alive() for th in ths),
              f"bridge world: {errors}")
        return [np.concatenate([out[k][s_] for k in range(n_ranks)])
                for s_ in range(len(steps))]

    def poisson_check(ref, cells):
        """The poisson model's solve, card against CPU, in the CPU's
        system: the same cells on the same mesh (moved to the card) give
        the same operator and right-hand side bit for bit, and each
        device's MGCG stops at rtol 1e-6 of its recurrence residual. Its
        right-hand side is the divergence of a nearly solenoidal velocity,
        small against the warm start's residual, so a float32 solve
        reaches only a floor of the true residual, and two solves that
        round apart differ widely inside it: the gate is the card's true
        residual against the CPU's own, with the rel-L2 of the two and of
        a CPU solve from a one-ulp change of the right-hand side beside
        it."""
        from tpufoam_torch.fv.case import fluxes_from_velocity
        from tpufoam_torch.fv.pressure import (pressure_coeffs,
                                               pressure_matvec, pressure_rhs)
        from tpufoam_torch.solvers.multigrid import mgcg_pressure

        def solve(compute, scale=1.0):
            uc = compute.ucase
            u, v, p = (uc.grid_field(cells[:, i].astype(np.float32))
                       for i in (0, 1, 4))
            case_ = uc.case
            coef = pressure_coeffs(case_, torch.ones(case_.grid.shape,
                                                     device=u.device)
                                   * case_.fluid)
            rhs = pressure_rhs(case_, *fluxes_from_velocity(case_, u, v))
            x = mgcg_pressure(coef, rhs * scale, x0=p,
                              rtol=1e-6).x * case_.fluid
            return x.cpu(), coef, rhs

        card = bridge_server._Compute(ref.model, TRAIN_DELTA,
                                      TRAIN_CASE["nu"], device=dev)
        card.attach(ref.ucase.to(dev))
        x_card, _, _ = solve(card)
        x_cpu, coef, rhs = solve(ref)
        x_ulp, _, _ = solve(ref, 1.0 + 2.0**-23)
        fluid = ref.ucase.case.fluid

        def residual(x):
            return float(torch.linalg.vector_norm(
                (rhs - pressure_matvec(coef, x)) * fluid)
                / torch.linalg.vector_norm(rhs * fluid))

        def rel_l2(a, b):
            return float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b))

        return dict(residual_card=residual(x_card),
                    residual_cpu=residual(x_cpu),
                    residual_cpu_one_ulp=residual(x_ulp),
                    grid_rel_l2_card_vs_cpu=rel_l2(x_card, x_cpu),
                    grid_rel_l2_one_ulp_vs_cpu=rel_l2(x_ulp, x_cpu),
                    bound=f"residual_card <= {BRIDGE_TOL['poisson']} x "
                          "residual_cpu")

    cpu_ref = {}

    def reference(model):
        """The port's compute on the CPU from the first step's cells: the
        mesh prepared once, then attached to each model's compute."""
        ref = bridge_server._Compute(model, TRAIN_DELTA, TRAIN_CASE["nu"],
                                     device="cpu")
        if not cpu_ref:
            ref.prepare(steps[0], top, obst)
            cpu_ref["ucase"] = ref.ucase
        else:
            ref.attach(cpu_ref["ucase"])
        return ref

    try:
        for name, model in models.items():
            srv = bridge_server.BridgeServer(sock, model, delta=TRAIN_DELTA,
                                             nu=TRAIN_CASE["nu"], device=dev)
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            try:
                prep_s.clear()
                t = time.time()
                cl = client.Client(lib, sock, steps[0], top, obst)
                row = dict(cells=n, init_s=time.time() - t,
                           prep_s={k: list(v) for k, v in prep_s.items()})
                torch.cuda.synchronize()
                reset_counts()
                srv.step_ms.clear()
                ps, raws, client_ms = [], [], []
                for c_ in steps:
                    p_, raw_ = cl.step(c_)
                    ps.append(p_)
                    raws.append(raw_)
                    client_ms.append(cl.last_step_ms)
                k_ = counts()
                cl.close()
                total.update(k_)
                row.update(client_ms=client_ms, server_ms=list(srv.step_ms),
                           stencil_matvec_launches_per_step=k_[
                               "stencil_matvec"] / len(steps),
                           finite=all(bool(np.isfinite(p_).all())
                                      for p_ in ps))
                rows[name] = row
                check(row["finite"], f"bridge {name}: non-finite p")
                if name == "identity":
                    check(all(np.array_equal(p_, c_[:, 4])
                              for p_, c_ in zip(ps, steps)),
                          "bridge identity: p is not the cells' p")
                    continue
                ref = reference(model)
                shape = tuple(ref.ucase.case.grid.shape)
                _, raw_cpu = ref.step(steps[0])
                rel = float(np.linalg.norm(raws[0] - raw_cpu)
                            / np.linalg.norm(raw_cpu))
                row.update(grid=list(shape), rel_l2_vs_cpu=rel,
                           p_range=[float(ps[-1].min()),
                                    float(ps[-1].max())])
                check(shape[0] >= TRAIN_SHAPE[0]
                      and shape[1] >= TRAIN_SHAPE[1],
                      f"bridge: the server's grid {shape} is below "
                      f"{TRAIN_SHAPE}")
                if name == "sm":
                    row["bound"] = BRIDGE_TOL[name]
                    check(rel <= BRIDGE_TOL[name],
                          f"bridge {name}: rel-L2 {rel:.3e} against the CPU")
                else:
                    row.update(poisson_check(ref, steps[0]))
                    check(row["residual_card"] <= BRIDGE_TOL[name]
                          * row["residual_cpu"],
                          f"bridge poisson: {row}")
                check(np.ptp(ps[-1]) > 0, f"bridge {name}: constant p")
                if name == "poisson":
                    check(k_["stencil_matvec"] > 0,
                          "bridge poisson: the matvec never launched")
                    # four ranks, contiguous quarters: the single rank's p
                    t = time.time()
                    multi = world(4, world_id=1)
                    row["world4_s"] = time.time() - t
                    row["world4_max_abs_diff"] = max(
                        float(np.abs(a_ - b_).max())
                        for a_, b_ in zip(ps, multi))
                    check(row["world4_max_abs_diff"] == 0.0,
                          f"bridge {name}: 4-rank world vs single rank "
                          f"{row['world4_max_abs_diff']:.3e}")
            finally:
                srv.stop()
                th.join(timeout=10)
    finally:
        evaluation.domain_and_sdf = sdf_impl
        evaluation.build_resample = resample_impl
    os.rmdir(sock_dir)
    say("bridge", card=card, build_s=build_s, grid=rows["poisson"]["grid"],
        client_grid=list(TRAIN_SHAPE), steps=len(steps), models=rows)
    return dict(total)


def cli_phases(torch, dev, card, case, frames, reset_counts, counts):
    """cli-piso, cli-pinn, pointcloud and cli-casegen: the port's
    command-line entry points on the card (tpufoam_torch/cli.py), the
    PINN and the point-cloud model. `case` and `frames` are train-data's
    channel and its rollout's last PC_FRAMES frames. Returns the kernel
    launches of each CLI run, {path: {kernel: n}}."""
    import contextlib
    import io
    import pickle
    import tempfile

    import numpy as np

    from tpufoam_torch import cli
    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.eval.pointcloud_rollout import rollout, rollout_report
    from tpufoam_torch.fv import momentum as fvm
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.fv.turbulence import K_FLOOR, W_FLOOR
    from tpufoam_torch.models import pinn
    from tpufoam_torch.models.pointnet import PAD, PointNetUNet
    from tpufoam_torch.piso.engine import (PisoConfig, continuity_error,
                                           courant_number, run_piso_eager)
    from tpufoam_torch.solvers.backends import MGBackend
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)
    from tpufoam_torch.train.pointcloud import (_pairs_from_array,
                                                train_pointcloud)
    from tpufoam_torch.utils import profiling
    from tpufoam_torch.utils.hdf5_io import rollout_to_records

    launches = {}
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    platform = ["--platform", torch.device(dev).type]

    def run(main, argv, path=None):
        """main(argv) with its printed lines captured (and echoed); its
        kernel launches under `path`, counted from 0."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        if path:
            reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if path:
            launches[path] = counts()
        text = buf.getvalue()
        sys.stdout.write(text)
        return text, wall

    def step_lines(text):
        """The per-step lines' Co, contErr and ms/step."""
        return [dict(co=float(m.group(1)), cont=float(m.group(2)),
                     ms_per_step=float(m.group(3)))
                for m in re.finditer(r"Co=([\d.e+-]+) contErr=([\d.e+-]+)"
                                     r".*\[([\d.]+) ms/step\]", text)]

    # ---- cli-piso: bench.py's main path through tpufoam-piso ---------------
    old_cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        state = os.path.join(work, "state.npz")
        out = os.path.join(work, "out.npz")
        csv = os.path.join(work, "forces.csv")
        text_a, wall_a = run(cli.piso_main, CLI_PISO + platform + [
            "--steps", str(CLI_STEPS_A), "--state", state])
        text_b, wall_b = run(cli.piso_main, CLI_PISO + platform + [
            "--steps", str(CLI_STEPS_B), "--state", state, "--out", out,
            "--forces-out", csv], path="cli-piso")
        loops = fvm.jacobi_momentum.sweep_loops
    finally:
        os.chdir(old_cwd)
    k_piso = launches["cli-piso"]
    got = np.load(out)
    rows = [line.split(",") for line in open(csv).read().split()]

    # the same config built by hand, CLI_STEPS_A + CLI_STEPS_B straight
    geom = channel_case_geometry("cylinder", length=8.0, height=2.0,
                                 obstacle_size=0.5, nu=8e-3)
    rcase = build_channel_case(geom, delta=CLI_DELTA, device=dev)
    check(tuple(rcase.grid.shape) == CLI_SHAPE,
          f"cli-piso: grid {tuple(rcase.grid.shape)}")
    rcfg = PisoConfig(n_correctors=2, max_co=0.5, convection="limitedLinear",
                      convection_blend=1.0, ddt="euler", ddt_corr=False,
                      wall_order=1, wall_link="full",
                      momentum_smoother="kernel", turb_wall_fn=False)
    rbe = MGBackend(cycles=2, precision="bf16", smoother="plain")
    rpred = make_predictor(SurrogateBundle.load(
        os.path.join(ROOT, CLI_BUNDLE), device=dev),
        stitch="lstsq", precision="bf16")
    ref = run_piso_eager(rcase, initial_flow(rcase, 5e-4),
                         CLI_STEPS_A + CLI_STEPS_B, cfg=rcfg, backend=rbe,
                         sm_predict=rpred)
    diff = {k: float(np.abs(got[k] - getattr(ref, k).cpu().numpy()).max())
            for k in ("u", "v", "p")}
    diff["t"] = abs(float(got["t"]) - float(ref.t))
    finite = all(bool(np.isfinite(got[k]).all()) for k in ("u", "v", "p"))
    cont = float(continuity_error(rcase, ref))
    co = float(courant_number(rcase, ref))
    # one more step under the profiling module's trace, and its memory
    trace_dir = os.path.join(work, "trace")
    with profiling.trace(trace_dir):
        ref = run_piso_eager(rcase, ref, 1, cfg=rcfg, backend=rbe,
                             sm_predict=rpred)
        torch.cuda.synchronize()
    traces = os.listdir(trace_dir)
    trace_bytes = sum(os.path.getsize(os.path.join(trace_dir, f))
                      for f in traces)
    with open(os.path.join(trace_dir, traces[0])) as f:
        trace_momentum = "momentum" in f.read()
    mem = profiling.memory_report()
    lines_b = step_lines(text_b)
    say("cli-piso", card=card, argv=CLI_PISO + platform,
        shape=list(CLI_SHAPE),
        steps=[CLI_STEPS_A, CLI_STEPS_B], resumed="resumed from" in text_b,
        cli_lines=step_lines(text_a) + lines_b,
        wall_s=[wall_a, wall_b],
        max_abs_diff_vs_run_piso_eager=diff, kernel_launches=k_piso,
        launches_per_step={k: v / CLI_STEPS_B for k, v in k_piso.items()},
        continuity_error=cont, courant=co, finite=finite,
        forces_rows=len(rows) - 1, momentum_sweep_loops=loops,
        trace_files=len(traces), trace_bytes=trace_bytes,
        trace_has_momentum_kernel=trace_momentum,
        memory_report={k: v for k, v in mem.items()
                       if k.startswith("device_")})
    for k, d in diff.items():
        check(d == 0.0, f"cli-piso: --out {k} against {CLI_STEPS_A} + "
              f"{CLI_STEPS_B} straight steps: max |diff| {d:.3e}")
    check(k_piso["momentum_multisweep"] == CLI_STEPS_B and loops == 0,
          f"cli-piso: {k_piso['momentum_multisweep']} momentum launches in "
          f"{CLI_STEPS_B} steps, {loops} sweep loops")
    check(k_piso["stencil_matvec"] > 0, f"cli-piso: launches {k_piso}")
    check(finite and cont < 1e-4 and co <= 0.5 + 1e-3,
          f"cli-piso: finite {finite}, continuity {cont:.3e}, Co {co}")
    check(all(l_["cont"] < 1e-4 and l_["co"] <= 0.5 + 1e-3
              for l_ in lines_b) and len(lines_b) == 1,
          f"cli-piso: the CLI's lines {lines_b}")
    check(len(rows) == 2 and rows[0] == ["t", "Cd", "Cl"]
          and all(np.isfinite(float(x)) for x in rows[1]),
          f"cli-piso: forces CSV {rows}")
    check(len(traces) == 1 and trace_bytes > 0,
          f"cli-piso: trace directory {traces}")
    check("device_0" in mem and mem["device_0"]["bytes_in_use"] > 0,
          f"cli-piso: memory_report {mem}")
    del rcase, ref, rpred, got

    # ---- the defaults' 128 x 512: MGCG with the kernel smoother, the SST ---
    small = {}
    for path, extra in (("cli-mgcg", ["--backend", "mgcg", "--smoother",
                                      "kernel"]),
                        ("cli-sst", ["--turbulence", "kOmegaSST",
                                     "--turb-wall-fn"])):
        o = os.path.join(work, f"{path}.npz")
        text, wall = run(cli.piso_main, extra + [
            "--steps", str(CLI_STEPS_SMALL), "--out", o] + platform,
            path=path)
        d = np.load(o)
        small[path] = dict(
            cli_lines=step_lines(text), wall_s=wall,
            kernel_launches=launches[path],
            finite={k: bool(np.isfinite(d[k]).all()) for k in d.files
                    if k != "t"},
            shape=list(d["u"].shape))
        if path == "cli-sst":
            # on the fluid cells, as step-turb's check (the solid ones
            # hold 0); the CLI's default grid, height / 128
            fl = build_channel_case(geom, delta=2.0 / 128,
                                    device=dev).fluid.cpu().numpy() > 0
            small[path]["min"] = {k: float(d[k][fl].min())
                                  for k in ("k", "omega", "nu_t")}
            small[path]["floors"] = dict(
                k=bool((d["k"][fl] >= K_FLOOR).all()),
                omega=bool((d["omega"][fl] >= W_FLOOR).all()),
                nu_t=bool((d["nu_t"][fl] >= 0).all()))
    say("cli-piso-small", card=card, **small)
    for path, r in small.items():
        check(all(r["finite"].values()) and r["shape"] == [128, 512]
              and all(l_["cont"] < 1e-4 and l_["co"] <= 0.5 + 1e-3
                      for l_ in r["cli_lines"]),
              f"{path}: {r}")
    check(launches["cli-mgcg"]["jacobi_multisweep"] > 0
          and launches["cli-mgcg"]["stencil_matvec"] > 0,
          f"cli-mgcg: launches {launches['cli-mgcg']}")
    check(all(small["cli-sst"]["floors"].values()),
          f"cli-sst: floors {small['cli-sst']['floors']}")

    # ---- cli-pinn: pinn_main at its defaults' width ----------------------
    phase_s = {"adam": [], "lbfgs": []}
    impl = {"adam": pinn._adam_phase, "lbfgs": pinn._lbfgs_phase}

    def timed(key):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            r = impl[key](*a, **kw)
            torch.cuda.synchronize()
            phase_s[key].append(time.time() - t0)
            return r
        return fn

    pinn_rows = []
    pinn._adam_phase, pinn._lbfgs_phase = timed("adam"), timed("lbfgs")
    try:
        for form in CLI_PINN_FORMS:
            pkl = os.path.join(work, f"pinn{form}.pkl")
            text, wall = run(cli.pinn_main, [
                "--formulation", str(form), "--adam-steps",
                str(CLI_PINN_ADAM), "--lbfgs-steps", str(CLI_PINN_LBFGS),
                "--out", pkl] + platform)
            with open(pkl, "rb") as f:
                blob = pickle.load(f)
            cfg = pinn.PinnConfig(**blob["cfg"])
            batch = pinn.make_training_points(cfg, n_colloc=20000,
                                              device="cpu")
            loss = {}
            for where in (dev, "cpu"):
                p = pinn.pinn_params_from_numpy(blob["params"], device=where)
                b = {k: v.to(where) for k, v in batch.items()}
                loss[str(where)] = float(pinn.pinn_loss(p, cfg, b).detach())
            hist = blob["history"]
            pinn_rows.append(dict(
                formulation=form, history=hist, wall_s=wall,
                ms_per_adam_step=phase_s["adam"][-1] * 1e3 / CLI_PINN_ADAM,
                ms_per_lbfgs_step=(phase_s["lbfgs"][-1] * 1e3
                                   / CLI_PINN_LBFGS),
                loss_card=loss[str(dev)], loss_cpu=loss["cpu"],
                rel_diff=abs(loss[str(dev)] - loss["cpu"])
                / abs(loss["cpu"])))
    finally:
        pinn._adam_phase, pinn._lbfgs_phase = impl["adam"], impl["lbfgs"]
    say("cli-pinn", card=card, width=[50] * 7, n_colloc=20000,
        adam_steps=CLI_PINN_ADAM, lbfgs_steps=CLI_PINN_LBFGS,
        runs=pinn_rows, tol=CLI_PINN_TOL)
    for r in pinn_rows:
        check(np.isfinite(r["history"]).all()
              and r["history"][-1] < r["history"][0],
              f"cli-pinn {r['formulation']}: history {r['history']}")
        check(r["rel_diff"] <= CLI_PINN_TOL,
              f"cli-pinn {r['formulation']}: card {r['loss_card']} vs CPU "
              f"{r['loss_cpu']}")

    # ---- pointcloud: train-data's last frames as point clouds -------------
    t0 = time.time()
    data = np.stack(rollout_to_records(case, frames))[None]
    ds = _pairs_from_array(data, n_pts=PC_NPTS)
    padded = {k: getattr(ds, k)[:1].copy()
              for k in ("fields", "targets", "coords")}
    for a in padded.values():
        a[:, -PC_PAD:] = PAD
    for k, a in padded.items():
        setattr(ds, k, np.concatenate([getattr(ds, k), a]))
    ds.sim_ids = np.concatenate([ds.sim_ids, ds.sim_ids[:1]])
    prep_s = time.time() - t0
    train_pointcloud(ds, epochs=1, batch_size=PC_BATCH, device=dev)
    n_steps = PC_EPOCHS * (len(ds.fields) // PC_BATCH)
    torch.cuda.synchronize()
    t0 = time.time()
    model, params, hist = train_pointcloud(ds, epochs=PC_EPOCHS,
                                           batch_size=PC_BATCH, device=dev)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    start = len(ds.fields) - 1             # the padded copy of pair 0
    f_ = torch.tensor(ds.fields[start:], device=dev)
    c_ = torch.tensor(ds.coords[start:], device=dev)
    with torch.no_grad():
        out_card = model(f_, c_)[0].cpu()
        cpu_model = PointNetUNet()
        cpu_model.load_state_dict({k: v.cpu() for k, v in params.items()})
        out_cpu = cpu_model(f_.cpu(), c_.cpu())[0]
    fwd_err = float((out_card - out_cpu).abs().max()
                    / out_cpu.abs().max())
    t0 = time.time()
    pred = rollout(model, None, ds.fields[start], ds.coords[start], 3)
    roll_s = time.time() - t0
    true = ds.targets[:3].copy()
    true[:, -PC_PAD:] = PAD
    rep = rollout_report(pred, true)
    pad_kept = bool((pred[:, -PC_PAD:] == PAD).all())
    say("pointcloud", card=card, pairs=len(ds.fields), n_pts=PC_NPTS,
        batch=PC_BATCH, epochs=PC_EPOCHS, history=hist, prep_s=prep_s,
        ms_per_train_step=train_s * 1e3 / n_steps, rollout_s=roll_s,
        forward_rel_err_vs_cpu=fwd_err, pad_rows_kept=pad_kept,
        rollout_rmse_pct={k: [r.rmse_pct for r in v]
                          for k, v in rep.items()})
    check(np.isfinite(hist).all() and hist[-1] < hist[0],
          f"pointcloud: loss history {hist}")
    check(fwd_err <= PC_TOL, f"pointcloud: card vs CPU forward {fwd_err:.3e}")
    check(pad_kept and np.isfinite(pred[:, :-PC_PAD]).all(),
          "pointcloud: the rollout's padded rows left PAD")
    del model, params, cpu_model

    # ---- cli-casegen: the OpenFOAM case writers ---------------------------
    made = {}
    for name, argv in [("sweep", ["--sweep", "3"])] + [
            (s, ["--shape", s]) for s in ("cylinder", "rectangle",
                                          "triangle", "ellipse", "plate")]:
        d = os.path.join(work, "cases", name)
        run(cli.casegen_main, argv + ["--out", d])
        made[name] = sorted(os.path.relpath(os.path.join(r, f), d)
                            for r, _, fs in os.walk(d) for f in fs)
    say("cli-casegen", files=made)
    check(made["sweep"] == sorted(
        f"{i}/{f}" for i in range(3) for f in (
            "params.json", "system/blockMeshDict", "system/mirrorMeshDict")),
        f"cli-casegen: sweep wrote {made['sweep']}")
    for name in ("cylinder", "rectangle", "triangle", "ellipse", "plate"):
        check("system/blockMeshDict" in made[name],
              f"cli-casegen {name}: {made[name]}")
    say("cli-not-driven", entry_points=[
        "datagen_main", "train_main", "eval_main",
        "bundle_main import-ref / export-ref", "pinn_main and "
        "pointcloud_main with .h5 files", "eval_main --save-plots",
        "pointcloud_main rollout --plots-dir"],
        why="they read or write HDF5 (h5py) or draw plots (matplotlib); "
            "tests/test_torch_cli_data.py, test_torch_pinn.py, "
            "test_torch_pointcloud.py and test_torch_utils.py drive them "
            "on the CPU")
    tmp.cleanup()
    return launches


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
    from tpufoam_torch.fv import turbulence
    from tpufoam_torch.fv.turbulence import K_FLOOR, W_FLOOR, init_turbulence
    from tpufoam_torch.models.mlp import (ModelDef, apply_model,
                                         count_params, params_from_numpy)
    from tpufoam_torch.parallel.mesh import (device_mesh,
                                             make_sharded_fleet_step,
                                             make_sharded_piso_step,
                                             make_sharded_sst_step,
                                             shard_case, shard_flow,
                                             shard_fleet, shard_turbulence,
                                             unshard_fleet, unshard_flow,
                                             unshard_turbulence)
    from tpufoam_torch.parallel import blocks as pblocks
    from tpufoam_torch.piso import engine
    from tpufoam_torch.piso.engine import (PisoConfig, continuity_error,
                                           courant_number, piso_step,
                                           piso_step_sst, run_piso_eager,
                                           run_piso_sst_eager)
    from tpufoam_torch.solvers import backends as backends_mod
    from tpufoam_torch.solvers import multigrid as mg
    from tpufoam_torch.solvers.backends import (AutoBackend, MGBackend,
                                                MGCGBackend)
    from tpufoam_torch.surrogate.blocks import (assemble_lstsq,
                                                build_block_layout,
                                                extract_blocks,
                                                gaussian_filter2d)
    from tpufoam_torch.surrogate.features import FAMILIES, u_max_norm
    from tpufoam_torch.surrogate.gradp_integrate import integrate_gradp
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor,
                                                  surrogate_blocks_forward)
    from tpufoam_torch.tools import kernel_bounds
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
                "stencil_matvec_grad": st.stencil_matvec_grad,
                "jacobi_sweep": st.jacobi_sweep,
                "jacobi_multisweep": st.jacobi_multisweep,
                "smooth_residual": st.smooth_residual,
                "corr_smooth": st.corr_smooth,
                "momentum_multisweep_sharded": sh.momentum_multisweep_sharded,
                "jacobi_multisweep_sharded": sh.jacobi_multisweep_sharded}

    def reset_counts(predictor=None):
        for fn in counters.values():
            fn.launches = 0
        st.StencilMatvec.taped = 0
        for fn in (sh.momentum_multisweep_sharded,
                   sh.jacobi_multisweep_sharded):
            fn.by_route.clear()
        # the counters' own objects: grad-step swaps st.stencil_matvec
        for name in ("stencil_matvec", "stencil_matvec_grad", "jacobi_sweep",
                     "jacobi_multisweep", "smooth_residual", "corr_smooth"):
            counters[name].by_shape.clear()
        mg.v_cycle.cycles = 0
        fvm.jacobi_momentum.sweep_loops = 0
        if predictor is not None:
            predictor.calls = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    def path_variants(fn, name, label):
        """Each launch of the kernel on the path just driven took the
        variant `multisweep_geometry` names for its level, dtype and the
        path's sweeps."""
        for (v_, p_, sh_), n_ in fn.by_shape.items():
            want = st.multisweep_geometry(sh_, dtypes[p_],
                                          PATH_SWEEPS[name][p_],
                                          kernel=name).variant
            check(v_ == want, f"{label}: {n_} launches of {name} at "
                  f"{sh_} {p_} in the {v_} kernel, not the {want}")

    def launches_by_level(names, steps):
        """Launches per step of each multisweep kernel by variant, dtype
        and level, from the counts of the steps just driven."""
        return {name: [{"variant": v_, "dtype": p_, "shape": list(sh_),
                        "launches_per_step": n_ / steps}
                       for (v_, p_, sh_), n_ in sorted(
                           getattr(st, name).by_shape.items(),
                           key=lambda kv: (kv[0][1], -kv[0][2][0]))]
                for name in names}

    # ---- build ----------------------------------------------------------
    t = time.time()
    sources = ("momentum_multisweep", "pressure_stencil", "stencil_grad")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(lambda n: build.build(n)[1],
                                          sources)))
    say("build", kernels=list(sources), seconds=round(time.time() - t, 3),
        ptxas={name: [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "smem" in ln
                      or "spill" in ln or "Compiling entry" in ln]
               for name, log in logs.items()})
    # the window launches' instantiations (their last template argument
    # WINDOW = true): registers and spills, one entry each, named by the
    # kernel and its mangled template arguments
    window_ptxas = []
    for log in logs.values():
        entry = None
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                name = ln.split("'")[1]
                entry = None
                if "Lb1EEEv" in name:
                    # <length><name>_kernel, then I<arguments>EEEv
                    m = re.search(r"\d\d([a-z_]+_kernel)(I.*?EEE)v", name)
                    entry = "".join(m.groups())
            elif entry and "spill" in ln:
                window_ptxas.append({"entry": entry, "spills": ln.strip()})
            elif entry and "registers" in ln:
                window_ptxas[-1]["registers"] = int(
                    ln.split("Used ")[1].split()[0])
    # (nothing is printed for a library that was up to date)
    check(not all(logs.values()) or len(window_ptxas) == 9 and all(
        w["spills"].startswith("0 bytes stack frame, 0 bytes spill stores")
        for w in window_ptxas), f"window instantiations: {window_ptxas}")

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

    def random_operands(dt):
        """Conductances in [0, 1), nonzero on the domain's edges too, diag
        above their sum; x, b and a correction."""
        c = [field(0.0, 1.0) for _ in range(4)]
        diag = c[0] + c[1] + c[2] + c[3] + field(0.1, 1.0)
        return (cast(PressureCoeffs(*c, torch.zeros_like(diag), diag), dt),
                field(-1, 1).to(dt), field(-1, 1).to(dt),
                field(-0.1, 0.1).to(dt))

    def variant(name, shape, dt, iters, aligned=True):
        """The kernel a launch takes, in the geometry of
        multisweep_geometry: the run kernel on aligned planes of whole
        16-byte runs (one sweep of jacobi_multisweep a single pass), the
        region kernel elsewhere."""
        return st.multisweep_geometry(tuple(shape), dt, iters, aligned,
                                      kernel=name).variant

    def held(name, prec, ops, iters, where):
        """The kernel against its plain version, bit for bit, and its
        launch counted under the variant the geometry names; max abs err
        (0)."""
        shape = tuple(ops[1].shape)
        key = (variant(name, shape, dtypes[prec], iters), prec, shape)
        n0 = getattr(st, name).by_shape[key]
        got = stencil_call(name, *ops, iters)
        torch.cuda.synchronize()
        check(getattr(st, name).by_shape[key] == n0 + 1,
              f"{name} {prec} {where}, iters {iters}: not one launch of "
              f"the {key[0]} kernel")
        return exact(f"{name} {prec} {where}, iters {iters}", got,
                     stencil_call(name, *ops, iters, True))

    def exact(label, got, ref):
        err = compare(got, ref)[0]
        check(err == 0.0, f"{label}: max |diff| {err:.3e}, not 0")
        return err

    @contextlib.contextmanager
    def region_kernel():
        """The three multisweep kernels forced onto the region kernel
        (the first port's) by the geometry's size threshold."""
        threshold = st._REGION_BELOW_CELLS
        st._REGION_BELOW_CELLS = 1 << 62
        try:
            yield
        finally:
            st._REGION_BELOW_CELLS = threshold

    stencil_rows = {}
    for name, (n_in, n_out, ops_sweep, ops_once, _) in STENCIL.items():
        row = {"max_abs_err": 0.0}
        for prec, dt in dtypes.items():
            iters = PATH_SWEEPS[name][prec]
            top = st._max_iters(dt, name)
            # the path's sweeps, 1, 2 and the most the kernel takes
            checked = sorted({iters, 1, 2, top})
            per_level = []
            for coef_l, b_l in fine:
                ops = level_operands(coef_l, b_l, dt)
                err = max(held(name, prec, ops, k,
                               f"level {tuple(b_l.shape)}")
                          for k in checked)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                per_level.append({"shape": list(b_l.shape),
                                  "variant": variant(name, b_l.shape, dt,
                                                     iters),
                                  "iters_checked": checked,
                                  "max_abs_err": err})
            # random operands at the finest shape, the most sweeps taken
            err_r = held(name, prec, random_operands(dt), top, "random")
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
                levels=per_level, random={"iters": top, "max_abs_err": err_r},
                **t_k, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / t_k["ms"])
            if prec == PATH_DTYPE[name]:
                row.update(ms=t_k["ms"], plain_ms=t_k["plain_ms"],
                           bound_ms=b_ms, bound_by=b_by)
        stencil_rows[name] = row
    # each level of the path's dtype and sweeps: the variant the geometry
    # picks and its device time, beside the region kernel's (the first
    # port's), which is held to the plain version too
    for name in STENCIL:
        n_in, n_out, ops_sweep, ops_once, _ = STENCIL[name]
        prec = PATH_DTYPE[name]
        dt, iters = dtypes[prec], PATH_SWEEPS[name][prec]
        size = torch.tensor([], dtype=dt).element_size()
        rows_ = []
        for coef_l, b_l in fine:
            ops = level_operands(coef_l, b_l, dt)
            cells = b_l.numel()
            ms_l = time_ms(lambda: stencil_call(name, *ops, iters), 100,
                           torch, flush)[0]
            with region_kernel():
                region_ms = time_ms(lambda: stencil_call(name, *ops, iters),
                                    100, torch, flush)[0]
                n_region = getattr(st, name).by_shape[
                    "region", prec, tuple(b_l.shape)]
                region_err = exact(
                    f"{name} {prec} {tuple(b_l.shape)} region kernel",
                    stencil_call(name, *ops, iters),
                    stencil_call(name, *ops, iters, True))
                check(getattr(st, name).by_shape[
                    "region", prec, tuple(b_l.shape)] == n_region + 1,
                      f"{name}: the forced region kernel did not launch")
            b_ms = bound((n_in + n_out) * cells * size,
                         (ops_sweep * iters + ops_once) * cells)[0]
            rows_.append({"shape": list(b_l.shape),
                          "variant": variant(name, b_l.shape, dt, iters),
                          "ms": ms_l, "region_ms": region_ms,
                          "region_max_abs_err": region_err,
                          "bound_ms": b_ms, "share_of_bound": b_ms / ms_l})
        say("kernel-pressure", part="levels", kernel=name, dtype=prec,
            iters=iters, levels=rows_)

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

    def csr_operator(coef_, transpose=False):
        """A (A^T with `transpose`) as a (ny nx)^2 CSR matrix: the
        library's sparse product is the yardstick of the matvec and of
        its backward's dx (it rounds in its own order)."""
        ny_, nx_ = coef_.diag.shape
        idx = torch.arange(ny_ * nx_, device=dev).reshape(ny_, nx_)
        parts = [(idx, idx, coef_.diag),
                 (idx[:, :-1], idx[:, 1:], -coef_.c_e[:, :-1]),
                 (idx[:, 1:], idx[:, :-1], -coef_.c_w[:, 1:]),
                 (idx[:-1], idx[1:], -coef_.c_n[:-1]),
                 (idx[1:], idx[:-1], -coef_.c_s[1:])]
        rows, cols, vals = (torch.cat([p[k].reshape(-1) for p in parts])
                            for k in range(3))
        if transpose:
            rows, cols = cols, rows
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

    # ---- the matvec's backward against its plain version, bit for bit ----
    mgrad_err, mgrad_times, _, mgrad_shapes = matvec_grad_phase(
        torch, card, all_levels, stacked, random_edge_operands, flush,
        csr_operator)

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

    # ---- the three multisweep kernels at every level of both
    # hierarchies, iters 1, 2 and the most each takes, on the level's
    # operator, on random operands of its shape (and with a solid disc:
    # zero dividends on every sweep), and on the operator one element off
    # 16 bytes (the region kernel; the cell kernel for one sweep of
    # jacobi_multisweep): bit for bit, each launch in its variant
    def disc_operands(shape, dt):
        """random_edge_operands with a solid disc, as the cylinder (a
        quarter of the height across, a quarter of the length in): no
        conductance, diag 1, x = b = correction = 0 there."""
        c_, x_, b_ = random_edge_operands(shape, torch.float32)
        yy = torch.arange(shape[0], device=dev)[:, None] - shape[0] / 2
        xx = torch.arange(shape[1], device=dev)[None] - shape[1] / 4
        fl = (yy * yy + xx * xx >= (shape[0] / 8) ** 2).float()
        c_ = PressureCoeffs(c_.c_e * fl, c_.c_w * fl, c_.c_n * fl,
                            c_.c_s * fl, c_.c_out, c_.diag * fl + (1 - fl))
        return (cast(c_, dt), (x_ * fl).to(dt), (b_ * fl).to(dt),
                (0.1 * torch.roll(x_, 1, 1) * fl).to(dt))

    multi = {"checked": 0, "max_abs_err": 0.0,
             "variants": collections.Counter()}
    for prec, dt in dtypes.items():
        for grid_name, lv in all_levels.items():
            for coef_l, b_l in lv:
                shape = tuple(b_l.shape)
                real = level_operands(coef_l, b_l, dt)
                c_, x_, b_ = random_edge_operands(shape, dt)
                rand = (c_, x_, b_, (0.1 * torch.roll(x_, 1, 1)).to(dt))
                disc = disc_operands(shape, dt)
                off = tuple(offset_by_one(t) for t in real)
                for name in STENCIL:
                    for k in (1, 2, st._max_iters(dt, name)):
                        for label, ops in (("level", real),
                                           ("random", rand),
                                           ("disc", disc)):
                            multi["max_abs_err"] = max(
                                multi["max_abs_err"],
                                held(name, prec, ops, k,
                                     f"{label} {shape}"))
                            multi["variants"][
                                variant(name, shape, dt, k)] += 1
                        v_off = variant(name, shape, dt, k, aligned=False)
                        check(v_off in ("region", "cell"),
                              f"{name} {prec} {shape}: operands off 16 "
                              f"bytes would take the {v_off} kernel")
                        key = (v_off, prec, shape)
                        n0 = getattr(st, name).by_shape[key]
                        got = stencil_call(name, *off, k)
                        torch.cuda.synchronize()
                        check(getattr(st, name).by_shape[key] == n0 + 1,
                              f"{name} {prec} {shape}: operands off 16 "
                              f"bytes did not take the {v_off} kernel")
                        exact(f"{name} {prec} {shape} iters {k} off 16 "
                              "bytes", got,
                              stencil_call(name, *real, k, True))
                        multi["variants"][v_off] += 1
                        multi["checked"] += 4
    say("kernel-pressure", part="hierarchies",
        grids=list(all_levels), **multi)

    # ---- B.7: the sharded kernels on meshes of the one card --------------
    def card_mesh(shape):
        return device_mesh(shape[0] * shape[1], shape=shape,
                           devices=[dev] * (shape[0] * shape[1]))

    def own_share(times, kernels, n):
        """The kernels' own device ms, the rest (on the exchange route the
        split, exchange, stack and crop; none on the window route) and the
        launches, per call of a cold profile."""
        own = sum(t for k, (t, _) in times.items()
                  if any(name in k for name in kernels))
        check(own > 0, f"no device time of {kernels} in the profile")
        total = sum(t for t, _ in times.values())
        return dict(kernel_ms=own / 1e3 / n,
                    assembly_ms=(total - own) / 1e3 / n,
                    launches_per_call=sum(c for _, c in times.values()) / n)

    def zero_diag_disc(shape, dt):
        """disc_operands with the disc's diag 0 (no conductance, x = b =
        0 there): the cells whose diag the sharded wrappers fill with 1
        (the single kernel would divide 0 by 0 there)."""
        c_, x_, b_, _ = disc_operands(shape, dt)
        yy = torch.arange(shape[0], device=dev)[:, None] - shape[0] / 2
        xx = torch.arange(shape[1], device=dev)[None] - shape[1] / 4
        solid = yy * yy + xx * xx < (shape[0] / 8) ** 2
        return (PressureCoeffs(c_.c_e, c_.c_w, c_.c_n, c_.c_s, c_.c_out,
                               c_.diag.masked_fill(solid, 0)), x_, b_, None)

    def routed(fn, call, launches, route, where):
        """call(), checking that it made `launches` launches of `fn`'s
        kernel, all by `route`."""
        n0, r0 = fn.launches, fn.by_route[route]
        got = call()
        torch.cuda.synchronize()
        check(fn.launches == n0 + launches
              and fn.by_route[route] == r0 + launches,
              f"{where}: {fn.launches - n0} launches, "
              f"{fn.by_route[route] - r0} by the {route} route, not "
              f"{launches}")
        return got

    jac_ops = {prec: (("level 512x2048", level_operands(*fine[0], dt)),
                      ("random", random_operands(dt)),
                      ("zero-diag disc", zero_diag_disc((NY, NX), dt)))
               for prec, dt in dtypes.items()}
    msh = {"max_abs_err": 0.0, "max_rel_err": 0.0, "checked": 0}
    jsh = {"max_abs_err": 0.0, "checked": 0}
    for shape in SHARD_MESHES:
        mesh = card_mesh(shape)
        for label, ops in (("random", ops_rand), ("first step", ops_real)):
            where = f"momentum_multisweep_sharded {shape} {label}"
            got = routed(sh.momentum_multisweep_sharded,
                         lambda: sh.momentum_multisweep_sharded(
                             mesh, *ops, sweeps=SWEEPS), 1, "window", where)
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
                # the disc's zero diag: the single kernel divides 0 by 0
                # there, the sharded functions fill it (both routes)
                single = label != "zero-diag disc"
                for iters in (1, 2, st._halo_for(dt)):
                    where = (f"jacobi_multisweep_sharded {shape} {prec} "
                             f"{label} iters {iters}")
                    got = routed(sh.jacobi_multisweep_sharded,
                                 lambda: sh.jacobi_multisweep_sharded(
                                     mesh, c_, x_, b_, iters), 1, "window",
                                 where)
                    if single:
                        exact(where + " vs the single kernel", (got,),
                              (st.jacobi_multisweep(c_, x_, b_, iters),))
                    plain = sh.jacobi_multisweep_sharded_plain(
                        mesh, c_, x_, b_, iters)
                    check(bool(torch.isfinite(plain).all()),
                          f"{where}: plain not finite")
                    jsh["max_abs_err"] = max(jsh["max_abs_err"], exact(
                        where + " vs plain", (got,), (plain,)))
                    if single:
                        exact(where + ": plain vs the global plain",
                              (plain,), (st.jacobi_multisweep_plain(
                                  c_, x_, b_, iters),))
                    jsh["checked"] += 1
    # the window form's cell variant (one sweep, fewer than 2^19 cells in
    # all) and the exchange route (blocks of 1030 columns: no whole number
    # of 16-byte runs), on the 2 x 2 mesh
    mesh22 = card_mesh(SHARD_MESHES[0])
    for prec, dt in dtypes.items():
        for shape, route, per_call in (((128, 512), "window", 1),
                                       ((NY, 2060), "exchange", 4)):
            c_, x_, b_, _ = zero_diag_disc(shape, dt)
            c_r, x_r, b_r = random_edge_operands(shape, dt)
            for iters in ((1,) if route == "window"
                          else (1, 2, st._halo_for(dt))):
                check(set(sh.sharded_routes(
                    mesh22, shape, dt, "jacobi", iters).values())
                    == {route}, f"{shape} {prec}: not the {route} route")
                where = (f"jacobi_multisweep_sharded {shape} {prec} "
                         f"iters {iters} ({route})")
                for ops_, single in (((c_, x_, b_), False),
                                     ((c_r, x_r, b_r), True)):
                    got = routed(sh.jacobi_multisweep_sharded,
                                 lambda: sh.jacobi_multisweep_sharded(
                                     mesh22, *ops_, iters), per_call, route,
                                 where)
                    if single:
                        exact(where + " vs the single kernel", (got,),
                              (st.jacobi_multisweep(*ops_, iters),))
                    exact(where + " vs plain", (got,),
                          (sh.jacobi_multisweep_sharded_plain(
                              mesh22, *ops_, iters),))
                    jsh["checked"] += 1
    # times on the 2 x 2 mesh: the momentum kernel on the first step's
    # operands; the pressure multisweep in float32 with one sweep (MGCG's
    # V(1,1)), and in bfloat16 at 2 sweeps and at the halo; each with the
    # kernels' own device time, the rest (allocation, and on the exchange
    # route the assembly) and the launches of a call
    kernel_names = ("momentum_multisweep_kernel", "stencil_run_kernel",
                    "stencil_cell_kernel", "multisweep_run_kernel",
                    "pressure_stencil_kernel")

    def msh_call():
        return sh.momentum_multisweep_sharded(mesh22, *ops_real,
                                              sweeps=SWEEPS)

    t_msh = timings(msh_call, lambda: sh.momentum_multisweep_sharded_plain(
        mesh22, *ops_real, sweeps=SWEEPS), 200, 20, torch, flush)
    split_msh = own_share(cold_kernels(msh_call, 50, torch, flush),
                          kernel_names, 50)
    b_msh = sharded_bound("momentum_multisweep", (NY, NX),
                          SHARD_MESHES[0], "f32")
    jsh_times = {}
    for prec, iters in (("f32", 1), ("bf16", 2),
                        ("bf16", st._halo_for(torch.bfloat16))):
        c_, x_, b_, _ = jac_ops[prec][0][1]

        def jsh_call():
            return sh.jacobi_multisweep_sharded(mesh22, c_, x_, b_, iters)

        t_j = timings(jsh_call, lambda: sh.jacobi_multisweep_sharded_plain(
            mesh22, c_, x_, b_, iters), 200, 20, torch, flush)
        b_j = sharded_bound("jacobi_multisweep", (NY, NX), SHARD_MESHES[0],
                            prec, sweeps=iters)
        jsh_times[f"{prec} iters {iters}"] = dict(
            **t_j, **own_share(cold_kernels(jsh_call, 50, torch, flush),
                               kernel_names, 50),
            bound_ms=b_j["bound_us"] / 1e3, bound_by=b_j["bound_by"],
            share_of_bound=b_j["bound_us"] / 1e3 / t_j["ms"])
    t_jsh = jsh_times["f32 iters 1"]
    say("kernel-sharded", meshes=[list(m) for m in SHARD_MESHES],
        by_route={"momentum": dict(sh.momentum_multisweep_sharded.by_route),
                  "jacobi": dict(sh.jacobi_multisweep_sharded.by_route)},
        ptxas_window=window_ptxas,
        momentum={**msh, **t_msh, **split_msh,
                  "bound_ms": b_msh["bound_us"] / 1e3,
                  "bound_by": b_msh["bound_by"],
                  "share_of_bound": b_msh["bound_us"] / 1e3 / t_msh["ms"]},
        jacobi={**jsh, "times": jsh_times})

    # ---- the main path ---------------------------------------------------
    def drive(label, flow, n, be, sm, warm=0, run=None,
              momentum="momentum_multisweep", per_step=1, whole=None):
        """`warm` steps, then `n` steps with the counters set to 0 just
        before and read just after; checks the step's health and that the
        `momentum` kernel launched `per_step` times a step. `run(flow, k)`
        takes k steps (run_piso_eager by default); `whole(flow)` gives the
        whole fields of its flow for the health checks. The device memory
        the steps took: the peak allocated during them, less what was
        allocated before them (torch.cuda.max_memory_allocated)."""
        if run is None:
            def run(flow_, k):
                return run_piso_eager(case, flow_, k, cfg=cfg, backend=be,
                                      sm_predict=sm)
        with torch.no_grad():
            if warm:
                flow = run(flow, warm)
            torch.cuda.synchronize()
            reset_counts(predictor)
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t = time.time()
            ev0.record()
            flow = run(flow, n)
            ev1.record()
            torch.cuda.synchronize()
            host_s = time.time() - t
            mem_peak = torch.cuda.max_memory_allocated()
            launched, cycles = counts(), mg.v_cycle.cycles
            loops = fvm.jacobi_momentum.sweep_loops
            sm_calls = predictor.calls
        flow_w = flow if whole is None else whole(flow)
        finite = all(bool(torch.isfinite(getattr(flow_w, f)).all())
                     for f in ("u", "v", "p", "phi_x", "phi_y"))
        cont = float(continuity_error(case, flow_w))
        co = float(courant_number(case, flow_w))
        stats = dict(steps=n, ms_per_step=ev0.elapsed_time(ev1) / n,
                     host_ms_per_step=host_s * 1e3 / n,
                     continuity_error=cont, courant=co,
                     t_sim=float(flow_w.t), dt=float(flow_w.dt),
                     kernel_launches=launched,
                     momentum_sweep_loops=loops, v_cycles=cycles,
                     sm_predict_calls=sm_calls, finite=finite,
                     mem_before_steps_bytes=mem0,
                     max_memory_allocated_bytes=mem_peak,
                     mem_of_steps_bytes=mem_peak - mem0)
        del flow_w
        check(finite, f"{label}: non-finite field")
        check(cont < 1e-4, f"{label}: continuity error {cont:.3e} >= 1e-4")
        check(co <= 0.5 + 1e-3, f"{label}: Courant number {co:.4f} > 0.501")
        check(launched[momentum] == per_step * n and loops == 0,
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

    # ---- reverse mode through the main path (grad-step) ----------------
    grad_step_launches, grad_step_res = grad_step_phase(
        torch, dev, card, case, flow0, reset_counts, counts)

    # ---- the main path through the decomposed step, 2 x 2 blocks of the
    # card: every field resident per block, the stages on haloed windows,
    # the momentum kernel and the pressure kernels once per block
    mesh_step = device_mesh(4, devices=[dev] * 4)
    torch.cuda.synchronize()
    mem_case0 = torch.cuda.memory_allocated()
    case_sh = shard_case(mesh_step, case)
    torch.cuda.synchronize()
    case_sh_bytes = torch.cuda.memory_allocated() - mem_case0
    step_sh = make_sharded_piso_step(mesh_step, cfg, backend,
                                     sm_predict=predictor)

    def run_sharded(flow_, k):
        for _ in range(k):
            flow_ = step_sh(case_sh, flow_)
        return flow_

    flow_sh, stats_sh = drive(
        "step-sharded", shard_flow(mesh_step, flow0), N_SHARDED, backend,
        predictor, warm=N_WARM, run=run_sharded, per_step=mesh_step.size,
        whole=unshard_flow)
    k = stats_sh["kernel_launches"]
    matvec_blocks = {f"{v_} {p_} {sh_[0]}x{sh_[1]}": n_ / N_SHARDED
                     for (v_, p_, sh_), n_ in sorted(
                         st.stencil_matvec.by_shape.items(),
                         key=lambda kv: (kv[0][1], -kv[0][2][0]))}
    whole_case_bytes = sum(getattr(case, f_.name).numel() * 4
                           for f_ in dataclasses.fields(case)
                           if isinstance(getattr(case, f_.name),
                                         torch.Tensor))
    say("step-sharded", mesh=mesh_step.shape,
        step_ms_per_step=stats["ms_per_step"],
        step_max_memory_allocated_bytes=stats["max_memory_allocated_bytes"],
        step_mem_of_steps_bytes=stats["mem_of_steps_bytes"],
        step_launches_per_step={n_: v_ / N_STEPS for n_, v_ in
                                stats["kernel_launches"].items()},
        launches_per_step={n_: v_ / N_SHARDED for n_, v_ in k.items()},
        launches_by_route_per_step={
            "momentum_multisweep (block)":
                k["momentum_multisweep"] / N_SHARDED,
            "momentum_multisweep_sharded (window)":
                sh.momentum_multisweep_sharded.by_route["window"]
                / N_SHARDED,
            "momentum_multisweep_sharded (exchange)":
                sh.momentum_multisweep_sharded.by_route["exchange"]
                / N_SHARDED},
        matvec_launches_per_step_by_block_shape=matvec_blocks,
        case_bytes_whole=whole_case_bytes,
        case_bytes_sharded=sum(
            b_.numel() * b_.element_size()
            for f_ in dataclasses.fields(case_sh)
            if isinstance(getattr(case_sh, f_.name), pblocks.BlockField)
            for b_ in getattr(case_sh, f_.name).blocks),
        case_allocated_sharded=case_sh_bytes, **stats_sh)
    check(k["momentum_multisweep_sharded"] == 0
          and k["jacobi_multisweep_sharded"] == 0,
          f"step-sharded: whole-field sharded kernels launched {k}")
    # every level but the coarsest (agglomerated) stays on the blocks
    block_levels = set(kernel_bounds.level_shapes(NY, NX)[:-1])
    check(not block_levels & {sh_ for (_v, _p, sh_)
                              in st.stencil_matvec.by_shape},
          f"step-sharded: a matvec launch on a whole level "
          f"{matvec_blocks}")
    sharded_step_launches = k

    # the residency at full size: during one decomposed step no op makes
    # a whole-field tensor but the surrogate's gather and the
    # agglomerated coarse levels
    from torch.utils._python_dispatch import TorchDispatchMode
    whole_shapes = {(NY, NX), (NY, NX + 1), (NY + 1, NX)}

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            where = pblocks.current_whole_stage()
            for t_ in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t_, torch.Tensor) \
                        and tuple(t_.shape) in whole_shapes:
                    self.seen[where or "blocks"] += 1
            return out

    rec = Shapes()
    with torch.no_grad(), rec:
        flow_sh = step_sh(case_sh, flow_sh)
        torch.cuda.synchronize()
    say("step-sharded", part="residency", grid=[NY, NX],
        whole_field_outputs_by_stage=dict(rec.seen))
    check(rec.seen["blocks"] == 0 and rec.seen["surrogate"] > 0,
          f"step-sharded: whole-field outputs outside the whole-field "
          f"stages: {dict(rec.seen)}")
    del flow_sh

    # ---- reverse mode through the decomposed step (grad-sharded) --------
    grad_sharded_launches = grad_sharded_phase(
        torch, card, case, flow0, mesh_step, grad_step_res, mgrad_shapes,
        reset_counts, counts)

    # ---- one decomposed step against one piso_step, same state ----------
    # with the plain smoother and each kernel smoother: bit for bit
    parity_sh, parity_launches = {}, {}
    for label, be in (("plain", backend),
                      ("kernel", MGBackend(cycles=2, precision="bf16",
                                           smoother="kernel")),
                      ("kernel-fused", MGBackend(cycles=2, precision="bf16",
                                                 smoother="kernel-fused"))):
        step_p = make_sharded_piso_step(mesh_step, cfg, be,
                                        sm_predict=predictor)
        with torch.no_grad():
            f_single = piso_step(case, flow, cfg, be, predictor.bind(case))
            torch.cuda.synchronize()
            reset_counts()
            f_sh = unshard_flow(step_p(case_sh, shard_flow(mesh_step,
                                                           flow)))
            torch.cuda.synchronize()
            parity_launches[label] = counts()
        parity_sh[label] = {name: compare((getattr(f_sh, name),),
                                          (getattr(f_single, name),))[0]
                            for name in ("u", "v", "p", "phi_x", "phi_y",
                                         "dt")}
        del f_single, f_sh
    say("parity-sharded", max_abs_diff=parity_sh,
        kernel_launches=parity_launches)
    for label, diffs in parity_sh.items():
        for name, d in diffs.items():
            check(d == 0.0, f"decomposed step parity ({label}) {name}: "
                  f"max |diff| {d:.3e}")
    kl, kf = parity_launches["kernel"], parity_launches["kernel-fused"]
    check(kl["jacobi_multisweep"] > 0 and kf["smooth_residual"] > 0
          and kf["corr_smooth"] > 0
          and kl["momentum_multisweep"] == mesh_step.size
          and kl["momentum_multisweep_sharded"] == 0,
          f"decomposed step with the kernel smoothers launched "
          f"{parity_launches}")

    # ---- path 1: the fused V-cycle legs in bf16 --------------------------
    fused_be = MGBackend(cycles=2, precision="bf16", smoother="kernel-fused")
    flow_f, stats = drive("step-fused", flow0, N_STEPS, fused_be, predictor,
                          warm=N_WARM)
    say("step-fused", **stats, by_level=launches_by_level(
        ("smooth_residual", "corr_smooth"), N_STEPS))
    k = stats["kernel_launches"]
    legs = KERNEL_LEVELS * stats["v_cycles"]
    check(stats["v_cycles"] > 0 and k["smooth_residual"] == legs
          and k["corr_smooth"] == legs and k["jacobi_multisweep"] == 0,
          f"step-fused: launches {k} for {stats['v_cycles']} V-cycles")
    fused_launches = k
    # each kernel level once a V-cycle in each leg, in the variant the
    # geometry names for it (the run kernel at every level)
    fine_shapes = {tuple(b_l.shape) for _, b_l in fine}
    for name in ("smooth_residual", "corr_smooth"):
        path_variants(getattr(st, name), name, "step-fused")
        per_level = collections.Counter()
        for (_v, p_, sh_), n_ in getattr(st, name).by_shape.items():
            per_level[p_, sh_] += n_
        check(set(per_level) == {("bf16", sh_) for sh_ in fine_shapes}
              and set(per_level.values()) == {stats["v_cycles"]},
              f"step-fused: {name} launches by level {dict(per_level)} "
              f"for {stats['v_cycles']} V-cycles")

    # ---- path 2: MGCG with the multisweep kernel in f32 ------------------
    mgcg_be = MGCGBackend(rtol=1e-6, maxiter=60, smoother="kernel")
    cg_iters = []

    def mgcg_counted(*args):
        c0 = mg.v_cycle.cycles
        p_ = mgcg_be(*args)
        cg_iters.append(mg.v_cycle.cycles - c0 - 1)  # one cycle per iter + 1
        return p_

    _, stats = drive("step-mgcg", flow0, N_MGCG, mgcg_counted, None)
    say("step-mgcg", cg_iters_per_solve=cg_iters, **stats,
        by_level=launches_by_level(("jacobi_multisweep",), N_MGCG))
    k = stats["kernel_launches"]
    check(stats["v_cycles"] > 0
          and k["jacobi_multisweep"] == 2 * KERNEL_LEVELS * stats["v_cycles"]
          and k["smooth_residual"] + k["corr_smooth"] == 0,
          f"step-mgcg: launches {k} for {stats['v_cycles']} V-cycles")
    mgcg_launches = k
    path_variants(st.jacobi_multisweep, "jacobi_multisweep", "step-mgcg")

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

    # ---- the graded Schaefer-Turek case (st_2d1_graded_h05.json) ---------
    t = time.time()
    case_g, u_mean_g = bench.schafer_turek_case("2D-1", delta=None,
                                                grading=GRADED, device=dev)
    torch.cuda.synchronize()
    t_case_g = time.time() - t
    t = time.time()
    sdf_g_cpu = bench.schafer_turek_case("2D-1", delta=None, grading=GRADED,
                                         device="cpu")[0].sdf
    t_sdf_g_cpu = time.time() - t
    sdf_g_equal = torch.equal(case_g.sdf.cpu(), sdf_g_cpu)
    del sdf_g_cpu
    xs_g, ys_g = case_g.grid.spacing_arrays()
    say("case-graded", shape=list(case_g.grid.shape),
        n_cells=case_g.grid.n_cells, grading=GRADED, u_mean=u_mean_g,
        seconds=round(t_case_g, 3), cpu_case_seconds=round(t_sdf_g_cpu, 3),
        sdf_equal_cpu=sdf_g_equal, fluid_cells=int(case_g.fluid.sum()),
        spacing_x=[float(xs_g.min()), float(xs_g.max())],
        spacing_y=[float(ys_g.min()), float(ys_g.max())])
    check(case_g.grid.shape == GRADED_SHAPE
          and case_g.grid.n_cells == GRADED_CELLS,
          f"case-graded: grid {case_g.grid.shape}, not {GRADED_SHAPE}")
    check(case_g.grid.stretched, "case-graded: the grid is not stretched")
    check(sdf_g_equal, "case-graded: the card's SDF differs from the CPU's")

    # ---- rows 2-5 at every level of the graded hierarchy -----------------
    cfg_g = PisoConfig(**GRADED_CFG)
    mgcg_kern = MGCGBackend(rtol=1e-6, smoother="kernel")
    first_g = []

    def capture_g(case_, pcoef_, rhs_, p_prev_, aux_):
        if not first_g:
            first_g.append((pcoef_, rhs_))
        return mgcg_kern(case_, pcoef_, rhs_, p_prev_, aux_)

    flow_g0 = initial_flow(case_g, dt0=ST_DT0)
    with torch.no_grad():
        piso_step(case_g, flow_g0, cfg_g, capture_g)
    graded_levels = hierarchy(*first_g[0])
    graded_shapes = [tuple(b.shape) for _, b in graded_levels]
    # neighbouring conductances of the finest operator: their largest
    # ratio across the grading
    c0 = first_g[0][0]
    ratio = max(float((torch.maximum(a[..., 1:], a[..., :-1]) / torch.clamp(
        torch.minimum(a[..., 1:], a[..., :-1]), min=1e-30))[
            (a[..., 1:] > 0) & (a[..., :-1] > 0)].max())
        for a in (c0.c_e, c0.c_n.t()))
    graded = {"checked": 0, "max_abs_err": 0.0,
              "variants": collections.Counter()}
    level_rows = []
    for prec, dt in dtypes.items():
        for coef_l, b_l in graded_levels:
            shape = tuple(b_l.shape)
            ops = level_operands(coef_l, b_l, dt)
            c_, x_ = ops[0], ops[1]
            v_mv = st.pass_geometry(shape, dt).variant
            key = (v_mv, prec, shape)
            n0 = st.stencil_matvec.by_shape[key]
            got = st.stencil_matvec(c_, x_)
            torch.cuda.synchronize()
            check(st.stencil_matvec.by_shape[key] == n0 + 1,
                  f"kernel-graded: stencil_matvec {prec} {shape} not one "
                  f"launch of the {v_mv} variant")
            graded["max_abs_err"] = max(graded["max_abs_err"], exact(
                f"kernel-graded stencil_matvec {prec} {shape}", (got,),
                (st.stencil_matvec_plain(c_, x_),)))
            graded["variants"][v_mv] += 1
            graded["checked"] += 1
            row = {"dtype": prec, "shape": list(shape),
                   "stencil_matvec": v_mv}
            for name in STENCIL:
                ks = sorted({1, 2, st._max_iters(dt, name)})
                for k in ks:
                    graded["max_abs_err"] = max(
                        graded["max_abs_err"],
                        held(name, prec, ops, k, f"graded level {shape}"))
                    graded["variants"][variant(name, shape, dt, k)] += 1
                    graded["checked"] += 1
                row[name] = {str(k): variant(name, shape, dt, k)
                             for k in ks}
            level_rows.append(row)
    # device time at the finest level, in each dtype at the sweeps each
    # kernel runs on its path, beside tools/kernel_bounds.py's bound
    graded_times = []
    coef_f, b_f = graded_levels[0]
    for prec, dt in dtypes.items():
        ops = level_operands(coef_f, b_f, dt)
        for name in ("stencil_matvec", *STENCIL):
            if name == "stencil_matvec":
                iters = 1
                v_ = st.pass_geometry(GRADED_SHAPE, dt).variant

                def call(ops=ops):
                    return st.stencil_matvec(ops[0], ops[1])

                def plain(ops=ops):
                    return st.stencil_matvec_plain(ops[0], ops[1])
            else:
                iters = kernel_bounds.KERNELS[name][4][prec]
                v_ = variant(name, GRADED_SHAPE, dt, iters)

                def call(name=name, ops=ops, iters=iters):
                    return stencil_call(name, *ops, iters)

                def plain(name=name, ops=ops, iters=iters):
                    return stencil_call(name, *ops, iters, True)
            t_k = timings(call, plain, 100, 20, torch, flush)
            b_k = kernel_bounds.bound(name, GRADED_SHAPE, prec)
            graded_times.append({
                "kernel": name, "dtype": prec, "iters": iters,
                "variant": v_, **t_k, "bound_ms": b_k["bound_us"] / 1e3,
                "bound_by": b_k["bound_by"],
                "share_of_bound": b_k["bound_us"] / 1e3 / t_k["ms"]})
    say("kernel-graded", levels=[list(s_) for s_ in graded_shapes],
        max_neighbour_conductance_ratio=ratio, **graded,
        by_level=level_rows, finest=graded_times)
    check(graded["checked"] > 0, "kernel-graded: nothing checked")

    # ---- the new paths: graded, the step options, Algorithm 1 ------------
    from torch.profiler import ProfilerActivity, profile

    def drive_path(label, case_, flow_, cfg_, be_, sm=None, u_ref=None,
                   sm_calls=None, turb=None, n_warm=N_PATH_WARM,
                   n_steps=N_PATH_STEPS, n_prof=N_PATH_PROFILED):
        """n_warm steps, then n_steps steps timed with CUDA events, the
        counters set to 0 just before and read just after, with the drag
        and lift after each step (the cfg's wall terms), then n_prof
        steps under torch.profiler for the device's busy time. With a
        TurbState `turb` the steps are run_piso_sst_eager's. Checks the
        health (finite, continuity < 1e-4, Courant <= maxCo + 1e-3; with
        turb, k, omega and nu_t finite and k, omega at their floors or
        above on fluid cells), one momentum launch a step and no sweep
        loop, and one prediction a step with a surrogate. Returns (flow,
        stats, turb)."""
        solves = [0]

        def counted(*args):
            solves[0] += 1
            return be_(*args)

        state = [turb]

        def run(f, k, bound_sm):
            if state[0] is None:
                return run_piso_eager(case_, f, k, cfg=cfg_, backend=counted,
                                      sm_predict=bound_sm)
            f, state[0] = run_piso_sst_eager(case_, f, state[0], k, cfg=cfg_,
                                             backend=counted,
                                             sm_predict=bound_sm)
            return f

        bound_sm = None if sm is None else sm.bind(case_)
        with torch.no_grad():
            flow_ = run(flow_, n_warm, bound_sm)
            torch.cuda.synchronize()
            reset_counts(sm_calls)
            solves[0] = 0
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(n_steps)]
            forces_ = []
            # each MGCG solve's CG iterations and final relative residual,
            # kept on the device until the timed steps are done
            solved, mgcg_impl = [], backends_mod.mgcg_pressure

            def mgcg_recorded(*args, **kw):
                res = mgcg_impl(*args, **kw)
                solved.append((res.iters, res.residual))
                return res

            backends_mod.mgcg_pressure = mgcg_recorded
            try:
                t = time.time()
                for e0, e1 in ev:
                    e0.record()
                    flow_ = run(flow_, 1, bound_sm)
                    e1.record()
                    if u_ref is not None:
                        rep = obstacle_force(
                            case_, flow_.u, flow_.v, flow_.p, u_ref=u_ref,
                            d_ref=bench.D_CYL, wall_order=cfg_.wall_order,
                            wall_link=cfg_.wall_link)
                        forces_.append((rep.cd, rep.cl))
                torch.cuda.synchronize()
                host_s = time.time() - t
            finally:
                backends_mod.mgcg_pressure = mgcg_impl
            launched, cycles = counts(), mg.v_cycle.cycles
            loops = fvm.jacobi_momentum.sweep_loops
            calls = None if sm_calls is None else sm_calls.calls
            n_solves = solves[0]
            by_level = launches_by_level(
                ("jacobi_multisweep", "smooth_residual", "corr_smooth"),
                n_steps)
            matvec_by = [{"variant": v_, "dtype": p_, "shape": list(sh_),
                          "launches_per_step": n_ / n_steps}
                         for (v_, p_, sh_), n_ in sorted(
                             st.stencil_matvec.by_shape.items(),
                             key=lambda kv: (kv[0][1], -kv[0][2][0]))]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.time()
                flow_ = run(flow_, n_prof, bound_sm)
                torch.cuda.synchronize()
                prof_wall_ms = (time.time() - t) * 1e3 / n_prof
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 \
            / n_prof
        finite_ = all(bool(torch.isfinite(getattr(flow_, f)).all())
                      for f in ("u", "v", "p", "phi_x", "phi_y"))
        cont_ = float(continuity_error(case_, flow_))
        co_ = float(courant_number(case_, flow_))
        cd_cl_ = [[float(cd), float(cl)] for cd, cl in forces_]
        stats_ = dict(
            shape=list(case_.grid.shape), steps=n_steps,
            ms_per_step=sum(e0.elapsed_time(e1) for e0, e1 in ev)
            / n_steps, host_ms_per_step=host_s * 1e3 / n_steps,
            profiled_steps=n_prof,
            profiled_wall_ms_per_step=prof_wall_ms,
            busy_ms_per_step=busy_ms if busy_ms > 0 else "not measured",
            idle_share=1.0 - busy_ms / prof_wall_ms if busy_ms > 0
            else "not measured",
            device_launches_per_step=sum(e.count for e in kern)
            / n_prof,
            top_kernels=[{"name": e.key[:60],
                          "launches_per_step": e.count / n_prof,
                          "ms_per_step": e.self_device_time_total / 1e3
                          / n_prof}
                         for e in sorted(
                             kern, key=lambda e: -e.self_device_time_total)[:6]],
            continuity_error=cont_, courant=co_, t_sim=float(flow_.t),
            dt=float(flow_.dt), kernel_launches=launched,
            momentum_sweep_loops=loops, v_cycles=cycles,
            pressure_solves_per_step=n_solves / n_steps,
            v_cycles_per_solve=cycles / max(n_solves, 1),
            cg_iters_per_solve=[int(i) for i, _ in solved],
            cg_residual_per_solve=[float(r) for _, r in solved],
            sm_predict_calls=calls, finite=finite_,
            pressure_launches_by_level=by_level,
            matvec_launches_by_level=matvec_by, cd_cl=cd_cl_)
        check(finite_, f"{label}: non-finite field")
        check(cont_ < 1e-4, f"{label}: continuity error {cont_:.3e}")
        check(co_ <= cfg_.max_co + 1e-3, f"{label}: Courant {co_:.4f}")
        check(launched["momentum_multisweep"] == n_steps and loops == 0,
              f"{label}: momentum kernel launched "
              f"{launched['momentum_multisweep']} times, the sweep loop "
              f"{loops} times in {n_steps} steps")
        check(calls in (None, n_steps),
              f"{label}: surrogate predicted {calls} times")
        check(all(np.isfinite(cd_cl_).ravel()), f"{label}: cd, cl {cd_cl_}")
        check(launched["stencil_matvec"] > 0,
              f"{label}: the matvec never launched its kernel")
        turb_ = state[0]
        if turb_ is not None:
            fl_ = case_.fluid > 0
            k_, w_ = turb_.k[fl_], turb_.omega[fl_]
            stats_["turb"] = dict(
                k_min=float(k_.min()), k_max=float(k_.max()),
                omega_min=float(w_.min()), omega_max=float(w_.max()),
                nu_t_max=float(turb_.nu_t.max()))
            check(all(bool(torch.isfinite(getattr(turb_, f_)).all())
                      for f_ in ("k", "omega", "nu_t")),
                  f"{label}: non-finite turbulence field")
            check(bool((k_ >= K_FLOOR).all()) and bool((w_ >= W_FLOOR).all()),
                  f"{label}: k or omega below its floor: {stats_['turb']}")
        return flow_, stats_, turb_

    def check_mgcg_levels(label, stats_, shapes):
        """The MGCG kernel smoother on every kernel level of the path's
        hierarchy, twice a V-cycle, each launch in its variant; no plain
        sweep and no fused leg."""
        k_ = stats_["kernel_launches"]
        n_lv = len(shapes) - 1
        check(stats_["v_cycles"] > 0 and k_["jacobi_multisweep"]
              == 2 * n_lv * stats_["v_cycles"]
              and k_["smooth_residual"] + k_["corr_smooth"] == 0,
              f"{label}: launches {k_} for {stats_['v_cycles']} V-cycles "
              f"on {n_lv} kernel levels")
        path_variants(st.jacobi_multisweep, "jacobi_multisweep", label)
        lv = {tuple(r_["shape"]) for r_ in
              stats_["pressure_launches_by_level"]["jacobi_multisweep"]}
        check(lv == set(shapes[:-1]),
              f"{label}: the multisweep kernel ran on {sorted(lv)}, not "
              f"every kernel level {shapes[:-1]}")
        check_matvec_levels(label, stats_, shapes)

    def check_matvec_levels(label, stats_, shapes):
        """The matvec kernel on every level of the path's hierarchy (the
        coarsest level's sweeps are matvecs), each launch in the variant
        pass_geometry names."""
        rows_ = stats_["matvec_launches_by_level"]
        for r_ in rows_:
            check(r_["variant"] == st.pass_geometry(
                tuple(r_["shape"]), dtypes[r_["dtype"]]).variant,
                f"{label}: matvec launches {r_}")
        lv = {tuple(r_["shape"]) for r_ in rows_}
        check(lv == set(shapes), f"{label}: the matvec kernel ran on "
              f"{sorted(lv)}, not every level {shapes}")

    path_flows = {}
    flow_g, stats_g, _ = drive_path("step-graded", case_g, flow_g0, cfg_g,
                                 mgcg_kern, u_ref=u_mean_g)
    say("step-graded", **stats_g)
    check_mgcg_levels("step-graded", stats_g, graded_shapes)
    path_flows["step-graded"] = (case_g, flow_g, cfg_g, u_mean_g)
    del first_g, graded_levels

    option_stats = {}
    for label, bench_name, delta_o, opts in OPTION_PATHS:
        case_o, u_mean_o = bench.schafer_turek_case(bench_name,
                                                    delta=delta_o,
                                                    device=dev)
        cfg_o = PisoConfig(max_co=0.4, max_dt=5e-3,
                           momentum_smoother="kernel", **opts)
        flow_o, stats_o, _ = drive_path(
            f"step-options {label}", case_o,
            initial_flow(case_o, dt0=ST_DT0), cfg_o, mgcg_kern,
            u_ref=u_mean_o)
        say("step-options", option=label, bench=bench_name, delta=delta_o,
            options=opts, **stats_o)
        shapes_o = kernel_bounds.level_shapes(*case_o.grid.shape)
        check_mgcg_levels(f"step-options {label}", stats_o, shapes_o)
        option_stats[label] = stats_o
        path_flows[label] = (case_o, flow_o, cfg_o, u_mean_o)

    # Algorithm 1 on the main path: the prediction after the momentum
    # solve, from the predicted U* and the old p
    cfg_a1 = dataclasses.replace(cfg, sm_before_predictor=False)
    at_launch = []
    bound_main = predictor.bind(case)

    class Alg1:
        """The main path's predictor, recording the momentum kernel's
        launch count at each prediction."""

        def bind(self, case_):
            def predict(c_, p_, aux_):
                at_launch.append(momentum_multisweep.launches)
                return bound_main(c_, p_, aux_)
            return predict

    flow_a1, stats_a1, _ = drive_path("step-alg1", case, flow0, cfg_a1,
                                      backend, sm=Alg1(), sm_calls=predictor)
    timed = at_launch[N_PATH_WARM:N_PATH_WARM + N_PATH_STEPS]
    say("step-alg1", **stats_a1, momentum_launches_at_predictions=timed)
    check_matvec_levels("step-alg1", stats_a1,
                        kernel_bounds.level_shapes(NY, NX))
    check(timed == list(range(1, N_PATH_STEPS + 1)),
          f"step-alg1: momentum launches at each prediction {timed}: not "
          "one prediction a step after the momentum kernel")
    path_flows["step-alg1"] = (case, flow_a1, cfg_a1, None)

    # ---- parity: one step with the plain momentum and pressure smoothers
    # against one with the kernels, from each path's state ---------------
    parity_options = {}
    for label, (case_p, flow_p, cfg_p, _) in path_flows.items():
        if label == "step-alg1":
            be_pl, be_k, sm_p = backend, backend, bound_main
            tol = PARITY_TOL["bf16"]
        else:
            be_pl = MGCGBackend(rtol=1e-6)
            be_k, sm_p = mgcg_kern, None
            tol = SMOOTHER_PARITY_TOL["mgcg"]
        with torch.no_grad():
            f_plain = piso_step(case_p, flow_p, dataclasses.replace(
                cfg_p, momentum_smoother="plain"), be_pl, sm_p)
            torch.cuda.synchronize()
            reset_counts()
            f_kern = piso_step(case_p, flow_p, cfg_p, be_k, sm_p)
            torch.cuda.synchronize()
        k_ = counts()
        diffs = {name: compare((getattr(f_kern, name),),
                               (getattr(f_plain, name),))[1]
                 for name in ("u", "v", "p")}
        parity_options[label] = dict(rel_diff=diffs, tol=tol,
                                     kernel_launches=k_)
        check(k_["momentum_multisweep"] == 1,
              f"parity-options {label}: launches {k_}")
        for name, d in diffs.items():
            check(d <= tol[name], f"parity-options {label} {name}: rel "
                  f"diff {d:.3e}")
    say("parity-options", paths=parity_options)
    del path_flows, flow_g, flow_a1, case_g

    # ---- the turbulent channel (turb_channel_*_ny256.json) ---------------
    def on(tree, device):
        """A Flow or TurbState with every tensor field on `device`."""
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).to(device)
            for f in dataclasses.fields(tree)})

    t = time.time()
    case_t, u_bulk = bench.turbulent_channel_case(**TURB, device=dev)
    torch.cuda.synchronize()
    t_case_t = time.time() - t
    t = time.time()
    case_tc, _ = bench.turbulent_channel_case(**TURB, device="cpu")
    t_case_tc = time.time() - t
    inlet_t_equal = torch.equal(case_t.inlet_u.cpu(), case_tc.inlet_u)
    sdf_t_equal = torch.equal(case_t.sdf.cpu(), case_tc.sdf)
    re_m = u_bulk * 2.0 / TURB["nu"]
    say("case-turb", shape=list(case_t.grid.shape),
        cells=case_t.grid.ny * case_t.grid.nx,
        fluid_cells=int(case_t.fluid.sum()), u_bulk=u_bulk, re_m=re_m,
        dean_cf=bench.dean_cf(re_m), seconds=round(t_case_t, 3),
        cpu_seconds=round(t_case_tc, 3), inlet_equal=inlet_t_equal,
        sdf_equal=sdf_t_equal)
    check(tuple(case_t.grid.shape) == TURB_SHAPE,
          f"case-turb: grid {case_t.grid.shape}, not {TURB_SHAPE}")
    check(inlet_t_equal and sdf_t_equal,
          "case-turb: the card's inlet profile or SDF differs from the CPU's")

    bundle_t = SurrogateBundle.load(os.path.join(ROOT, "artifacts",
                                                 "sm_turb256"), device=dev)
    pred_t = make_predictor(bundle_t, stitch="lstsq")
    cfg_t = PisoConfig(**TURB_CFG)
    turb_t0 = init_turbulence(case_t)
    flow_t0 = initial_flow(case_t, dt0=TURB_DT0)
    turb_shapes = kernel_bounds.level_shapes(*TURB_SHAPE)
    flow_t, stats_t, turb_t = drive_path(
        "step-turb", case_t, flow_t0, cfg_t, backend, sm=pred_t,
        sm_calls=pred_t, turb=turb_t0, n_warm=N_TURB_WARM,
        n_steps=N_TURB_STEPS, n_prof=N_TURB_PROFILED)
    cf_t = bench.channel_wall_cf(case_t, flow_t, turb_t, u_bulk)
    say("step-turb", **stats_t, wall_cf=cf_t)
    check(all(np.isfinite(v_) for v_ in cf_t.values()),
          f"step-turb: channel_wall_cf {cf_t}")
    check_matvec_levels("step-turb", stats_t, turb_shapes)
    turb_launches = stats_t["kernel_launches"]

    # the Dean lane: the pure solver with the multisweep kernel smoother
    be_dean = MGCGBackend(rtol=1e-5, smoother="kernel")
    flow_d, stats_d, turb_d = drive_path(
        "step-turb-mgcg", case_t, flow_t0, cfg_t, be_dean, turb=turb_t0,
        n_warm=N_DEAN_WARM, n_steps=N_DEAN_STEPS, n_prof=N_DEAN_PROFILED)
    say("step-turb-mgcg", **stats_d,
        wall_cf=bench.channel_wall_cf(case_t, flow_d, turb_d, u_bulk))
    check_mgcg_levels("step-turb-mgcg", stats_d, turb_shapes)
    dean_launches = stats_d["kernel_launches"]

    # the decomposed turbulent step over a 2 x 2 mesh of the card (k,
    # omega and nu_t resident per block), one step from step-turb's state,
    # against piso_step_sst
    mesh_t = device_mesh(4, devices=[dev] * 4)
    bound_t = pred_t.bind(case_t)
    step_tsh = make_sharded_sst_step(mesh_t, cfg_t, backend,
                                     sm_predict=bound_t)
    with torch.no_grad():
        args_sh = (shard_case(mesh_t, case_t), shard_flow(mesh_t, flow_t),
                   shard_turbulence(mesh_t, turb_t))
        torch.cuda.synchronize()
        reset_counts()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        f_tsh, t_tsh = step_tsh(*args_sh)
        ev1.record()
        torch.cuda.synchronize()
        tsh_ms = ev0.elapsed_time(ev1)
        tsh_launches, tsh_routes = counts(), dict(
            sh.momentum_multisweep_sharded.by_route)
        f_tsh, t_tsh = unshard_flow(f_tsh), unshard_turbulence(t_tsh)
        f_t1, t_t1 = piso_step_sst(case_t, flow_t, turb_t, cfg_t, backend,
                                   bound_t)
        torch.cuda.synchronize()
    diffs = {name: compare((getattr(f_tsh, name),), (getattr(f_t1, name),))[0]
             for name in FLOW_FIELDS}
    diffs.update({name: compare((getattr(t_tsh, name),),
                                (getattr(t_t1, name),))[0]
                  for name in TURB_FIELDS})
    say("step-turb-sharded", mesh=mesh_t.shape, max_abs_diff=diffs,
        kernel_launches=tsh_launches, routes=tsh_routes, ms=tsh_ms,
        step_turb_ms_per_step=stats_t["ms_per_step"])
    check(all(d == 0 for d in diffs.values()),
          f"step-turb-sharded: differs from piso_step_sst: {diffs}")
    check(tsh_launches["momentum_multisweep_sharded"] == 0
          and tsh_launches["momentum_multisweep"] == mesh_t.size
          and not tsh_routes,
          f"step-turb-sharded: launches {tsh_launches}, routes {tsh_routes}")
    del args_sh, f_tsh, t_tsh, f_t1, t_t1

    # one SST step on the card against the port's step on the CPU, from
    # the Dean lane's state (MGCG: a float32 solve to rtol 1e-5)
    def sst_on(case_, turb_, f_, dtype=None):
        """sst_step from a step's velocity and fluxes, in `dtype`."""
        def cast(x):
            return x.to(dtype) if dtype is not None else x
        turb_ = dataclasses.replace(turb_, **{
            n: cast(getattr(turb_, n)) for n in TURB_FIELDS})
        return turbulence.sst_step(
            case_, turb_, cast(f_.u), cast(f_.v), cast(f_.phi_x),
            cast(f_.phi_y), cast(f_.dt), wall_fn=cfg_t.turb_wall_fn)

    with torch.no_grad():
        f_gpu, t_gpu = piso_step_sst(case_t, flow_d, turb_d, cfg_t, be_dean)
        torch.cuda.synchronize()
        t = time.time()
        turb_dc = on(turb_d, "cpu")
        f_cpu, t_cpu = piso_step_sst(case_tc, on(flow_d, "cpu"), turb_dc,
                                     cfg_t, be_dean)
        cpu_step_s = time.time() - t
        f_gpu, t_gpu = on(f_gpu, "cpu"), on(t_gpu, "cpu")
        # the witnesses: the card's SST from the CPU's velocity, and float64
        # SSTs from each side's velocity
        t_iso = on(sst_on(case_t, turb_d, on(f_cpu, dev)), "cpu")
        t64_cpu = sst_on(case_tc, turb_dc, f_cpu, torch.float64)
        t64_gpu = sst_on(case_tc, turb_dc, f_gpu, torch.float64)
    diffs = {name: compare((getattr(f_gpu, name),), (getattr(f_cpu, name),))[1]
             for name in ("u", "v", "p")}
    diffs.update({name: compare((getattr(t_gpu, name),),
                                (getattr(t_cpu, name),))[1]
                  for name in ("k", "omega")})

    def strain(f_):
        """The SST step's strain rate S of a step's velocity, in float64."""
        dudx, dudy = turbulence._masked_grad(case_tc, f_.u.double())
        dvdx, dvdy = turbulence._masked_grad(case_tc, f_.v.double())
        return torch.sqrt(2.0 * (dudx ** 2 + dvdy ** 2) + (dudy + dvdx) ** 2)

    # nu_t by the limiter's branch: omega where nu_t = k / omega (to 1e-5)
    # on both sides, S F2 elsewhere. The 1e-3 bound holds only on
    # S-limited cells whose nu_t differs by no more than S does (nu_t ~
    # 1 / S there); every other cell is held at 1e-4
    fluid_t = case_tc.fluid > 0

    def omega_limited(t_):
        return (t_.nu_t.double() >= t_.k.double() / t_.omega.double()
                * (1.0 - 1e-5)) & fluid_t

    on_w = omega_limited(t_gpu) & omega_limited(t_cpu)
    on_s = fluid_t & ~on_w
    nu_g, nu_c = t_gpu.nu_t.double(), t_cpu.nu_t.double()
    d_nu, nu_max = (nu_g - nu_c).abs(), float(nu_c.abs().max())
    s_g, s_c = strain(f_gpu), strain(f_cpu)
    s_local = (s_g - s_c).abs() / s_c.clamp(min=1e-30)
    nu_local = d_nu / nu_c.clamp(min=1e-30)
    by_s = on_s & (nu_local <= s_local + TURB_S_SLACK)
    diffs["nu_t"] = float(d_nu[~by_s].max()) / nu_max
    diffs["nu_t_s_limited"] = (float(d_nu[by_s].max()) / nu_max
                               if bool(by_s.any()) else 0.0)
    at = int(d_nu.argmax())
    i_at, j_at = divmod(at, case_tc.grid.nx)
    witness = {
        "sst_card_vs_cpu_same_velocity": {
            n: compare((getattr(t_iso, n),), (getattr(t_cpu, n),))[1]
            for n in ("k", "omega", "nu_t")},
        "sst_f32_vs_f64_cpu_velocity": {
            n: compare((getattr(t_cpu, n),), (getattr(t64_cpu, n),))[1]
            for n in ("k", "omega", "nu_t")},
        "sst_f32_vs_f64_card_velocity": {
            n: compare((getattr(t_gpu, n),), (getattr(t64_gpu, n),))[1]
            for n in ("k", "omega", "nu_t")},
        "sst_f64_card_vs_cpu_velocity": {
            n: compare((getattr(t64_gpu, n),), (getattr(t64_cpu, n),))[1]
            for n in ("k", "omega", "nu_t")}}
    say("parity-turb", rel_diff=diffs, tol=TURB_PARITY_TOL,
        cells={"omega_limited": int(on_w.sum()), "s_limited": int(on_s.sum()),
               "nu_t_differs_as_s": int(by_s.sum())},
        largest_nu_t_diff={
            "i": i_at, "j": j_at, "sdf": float(case_tc.sdf[i_at, j_at]),
            "branch": "omega" if bool(on_w[i_at, j_at]) else "S",
            "nu_t": float(nu_c[i_at, j_at]),
            "k_over_omega": float(t_cpu.k[i_at, j_at]
                                  / t_cpu.omega[i_at, j_at]),
            "s": float(s_c[i_at, j_at]), "s_max": float(s_c.max()),
            "s_local_rel_diff": float(s_local[i_at, j_at]),
            "nu_t_local_rel_diff": float(nu_local[i_at, j_at])},
        strain_rel_diff=compare((s_g,), (s_c,))[1],
        witness=witness,
        witness_tol=TURB_WITNESS_TOL, s_slack=TURB_S_SLACK,
        cpu_step_s=round(cpu_step_s, 3))
    for name, d in diffs.items():
        check(d <= TURB_PARITY_TOL[name],
              f"parity-turb {name}: rel diff {d:.3e}")
    for label, ds in witness.items():
        if label == "sst_f64_card_vs_cpu_velocity":
            continue    # the velocity's difference itself, reported
        for name, d in ds.items():
            check(d <= TURB_WITNESS_TOL,
                  f"parity-turb witness {label} {name}: rel diff {d:.3e}")
    del f_gpu, t_gpu, f_cpu, t_cpu, t_iso, t64_cpu, t64_gpu, turb_dc
    del s_g, s_c, s_local, nu_local, d_nu, nu_g, nu_c, on_w, on_s, by_s
    del case_tc, flow_d, turb_d

    # ---- the poisson family's held-out case (docs/EVAL_REPORT.md) --------
    geom_p = channel_case_geometry(**POISSON)
    case_p = build_channel_case(geom_p, delta=POISSON_DELTA, device=dev)
    case_pc = build_channel_case(geom_p, delta=POISSON_DELTA, device="cpu")
    check(tuple(case_p.grid.shape) == POISSON_SHAPE,
          f"step-poisson: grid {case_p.grid.shape}, not {POISSON_SHAPE}")
    path_p = os.path.join(ROOT, "artifacts", "sm_poisson128")
    pred_p = make_predictor(SurrogateBundle.load(path_p, device=dev),
                            stitch="lstsq")
    flow_p, stats_p, _ = drive_path("step-poisson", case_p,
                                    initial_flow(case_p, dt0=5e-4), cfg,
                                    backend, sm=pred_p, sm_calls=pred_p)
    check_matvec_levels("step-poisson", stats_p,
                        kernel_bounds.level_shapes(*POISSON_SHAPE))
    poisson_launches = stats_p["kernel_launches"]

    def aux_of(flow_, device):
        return {n_: getattr(flow_, n_).to(device)
                for n_ in ("u", "v", "p", "u_prev", "v_prev", "p_prev")}

    def pred_change(pred_, case_, flow_, device):
        aux_ = aux_of(flow_, device)
        with torch.no_grad():
            return (pred_(case_, aux_["p"], aux_) - aux_["p"]).cpu()

    got = pred_change(pred_p, case_p, flow_p, dev)
    ref = pred_change(make_predictor(SurrogateBundle.load(
        path_p, device="cpu"), stitch="lstsq"), case_pc, flow_p, "cpu")
    rel_p = compare((got,), (ref,))[1]
    say("step-poisson", **stats_p, predicted_change_rel_err=rel_p,
        tol=PRED_TOL)
    check(rel_p <= PRED_TOL, f"step-poisson: the card's prediction differs "
          f"from the CPU's by {rel_p:.3e}")

    # ---- the U_gradP tier on step-poisson's case ---------------------------
    def gradp_tier(bundle_, case_, fields):
        """Blocks forward, each gradient channel stitched by least squares
        and scaled by maxs_out, integrated to p (the JAX package's
        eval/evaluation.py tier)."""
        lay = build_block_layout(case_.grid.ny, case_.grid.nx,
                                 bundle_.block_size, bundle_.overlap_ratio)
        um = u_max_norm(fields["u"], fields["v"])
        yb = surrogate_blocks_forward(
            bundle_, lay, FAMILIES["U_gradP"].build_inputs(case_, fields),
            case_.sdf)
        mb = extract_blocks(lay, case_.sdf)
        lx = case_.grid.nx * case_.grid.dx
        ly = case_.grid.ny * case_.grid.dy
        gx = assemble_lstsq(lay, yb[..., 0], mb) * bundle_.maxs_out[0]
        gy = assemble_lstsq(lay, yb[..., 1], mb) * bundle_.maxs_out[1]
        return integrate_gradp(case_, gx * um**2 / lx, gy * um**2 / ly)

    path_g = os.path.join(ROOT, "artifacts", "sm_gradp128")
    bundle_g = SurrogateBundle.load(path_g, device=dev)
    with torch.no_grad():
        p_g = gradp_tier(bundle_g, case_p, aux_of(flow_p, dev))
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(5):
            gradp_tier(bundle_g, case_p, aux_of(flow_p, dev))
        e1.record()
        torch.cuda.synchronize()
        p_gc = gradp_tier(SurrogateBundle.load(path_g, device="cpu"),
                          case_pc, aux_of(flow_p, "cpu"))
    rel_g = compare((p_g.cpu(),), (p_gc,))[1]
    try:
        make_predictor(bundle_g)
        refused = False
    except ValueError:
        refused = True
    say("gradp-tier", shape=list(case_p.grid.shape), rel_err=rel_g,
        tol=PRED_TOL, ms_per_tier=e0.elapsed_time(e1) / 5,
        finite=bool(torch.isfinite(p_g).all()),
        make_predictor_refuses=refused)
    check(bool(torch.isfinite(p_g).all()), "gradp-tier: non-finite p")
    check(rel_g <= PRED_TOL, f"gradp-tier: card vs CPU {rel_g:.3e}")
    check(refused, "gradp-tier: make_predictor served a U_gradP bundle")
    del case_pc, bundle_g, p_g, p_gc

    # ---- the predictor's options on the main path's state (sm_ref512) -----
    case_c = build_channel_case(geom, delta=delta, device="cpu")
    bundle_c = SurrogateBundle.load(os.path.join(ROOT, "artifacts",
                                                 "sm_ref512"), device="cpu")

    def predict_ms(pred_, n=5):
        bound_ = pred_.bind(case)
        aux_ = aux_of(flow, dev)
        with torch.no_grad():
            bound_(case, aux_["p"], aux_)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(n):
                bound_(case, aux_["p"], aux_)
            e1.record()
            torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    options = {}
    # bf16 PCA against the f32 predictor, on the card and on the CPU
    d_f = pred_change(predictor, case, flow, dev)
    d_b = pred_change(make_predictor(bundle, stitch="lstsq",
                                     precision="bf16"), case, flow, dev)
    d_fc = pred_change(make_predictor(bundle_c, stitch="lstsq"), case_c,
                       flow, "cpu")
    d_bc = pred_change(make_predictor(bundle_c, stitch="lstsq",
                                      precision="bf16"), case_c, flow, "cpu")
    options["bf16"] = dict(
        rel_l2_bf16_vs_f32=rel_l2(d_b, d_f),
        rel_l2_bf16_vs_f32_cpu=rel_l2(d_bc, d_fc),
        rel_err_bf16_vs_f32=compare((d_b,), (d_f,))[1],
        rel_err_card_vs_cpu=compare((d_b,), (d_bc,))[1],
        rel_err_f32_card_vs_cpu=compare((d_f,), (d_fc,))[1],
        predict_ms_f32=predict_ms(predictor),
        predict_ms_bf16=predict_ms(make_predictor(bundle, stitch="lstsq",
                                                  precision="bf16")))
    # the seam filter with the scan stitch: the filter alone on the card
    # with cuDNN's TF32 at PyTorch's default (on) outside the call, against
    # the CPU, and the predictor with it against the CPU's
    torch.backends.cudnn.allow_tf32 = True
    try:
        f_card = gaussian_filter2d(flow.p, 10.0).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    f_cpu = gaussian_filter2d(flow.p.cpu(), 10.0)
    d_sf = pred_change(make_predictor(bundle, stitch="scan",
                                      apply_filter=True), case, flow, dev)
    d_sfc = pred_change(make_predictor(bundle_c, stitch="scan",
                                       apply_filter=True), case_c, flow,
                        "cpu")
    options["filter"] = dict(
        filter_rel_err=compare((f_card,), (f_cpu,))[1],
        rel_err_card_vs_cpu=compare((d_sf,), (d_sfc,))[1],
        predict_ms=predict_ms(make_predictor(bundle, stitch="scan",
                                             apply_filter=True)))
    # the near-wall guard at 0.1
    pred_nw = make_predictor(bundle, stitch="lstsq", near_wall_dist=0.1)
    guard = (case.sdf < 0.1) | (case.fluid == 0)
    guard_c = (case_c.sdf < 0.1) | (case_c.fluid == 0)
    d_nw = pred_change(pred_nw, case, flow, dev)
    options["near-wall-0.1"] = dict(
        guarded=int(guard.sum()), guarded_cpu=int(guard_c.sum()),
        guarded_at_0_05=int(((case.sdf < 0.05) | (case.fluid == 0)).sum()),
        kept=bool((d_nw[guard.cpu()] == 0).all()))
    say("sm-options", shape=[NY, NX], tol=PRED_TOL, **options)
    check(options["bf16"]["rel_err_card_vs_cpu"] <= PRED_TOL
          and options["bf16"]["rel_l2_bf16_vs_f32"] <= PRED_TOL,
          f"sm-options bf16: {options['bf16']}")
    check(options["filter"]["filter_rel_err"] <= FILTER_TOL
          and options["filter"]["rel_err_card_vs_cpu"] <= PRED_TOL,
          f"sm-options filter: {options['filter']}")
    nw = options["near-wall-0.1"]
    check(nw["guarded"] == nw["guarded_cpu"] and nw["kept"]
          and nw["guarded"] > nw["guarded_at_0_05"],
          f"sm-options near-wall: {nw}")
    del case_c, bundle_c

    # ---- the attention and conv1d models at their full widths -------------
    def numpy_params(mdef, rng):
        """Glorot-uniform parameters in the JAX package's layout, with
        small random biases and LayerNorm gains."""
        def u(shape, fan):
            lim = np.sqrt(6.0 / fan)
            return rng.uniform(-lim, lim, shape).astype(np.float32)

        def b(n, base=0.0):
            return (base + 0.05 * rng.standard_normal(n)).astype(np.float32)

        w = list(mdef.widths)
        if mdef.kind == "conv1d":
            layers, c_in = [], 1
            for c in w:
                layers.append({"w": u((mdef.kernel_size, c_in, c),
                                      mdef.kernel_size * c_in + c),
                               "b": b(c)})
                c_in = c
            head_in = mdef.in_dim * w[-1]
        else:
            dims = [mdef.in_dim] + w
            layers = [{"w": u((dims[i], dims[i + 1]), dims[i] + dims[i + 1]),
                       "b": b(dims[i + 1])} for i in range(len(w))]
            head_in = w[-1]
        params = {"layers": layers,
                  "head": {"w": u((head_in, mdef.out_dim),
                                  head_in + mdef.out_dim),
                           "b": b(mdef.out_dim)}}
        if mdef.kind == "attention":
            d, h, kd = w[0], mdef.num_heads, mdef.key_dim
            params["attn"] = {n_: u((d, h, kd), d + h * kd)
                              for n_ in ("wq", "wk", "wv")}
            params["attn"]["wo"] = u((h, kd, d), d + h * kd)
            params["attn"]["bo"] = b(d)
            params["ln"] = [{"g": b(d, 1.0), "b": b(d)}
                            for _ in range(1 + len(w))]
        return params

    n_blocks = build_block_layout(NY, NX, bundle.block_size,
                                  bundle.overlap_ratio).n_blocks
    rng = np.random.default_rng(0)
    models = {}
    for arch in ("MLP_attention", "conv1D"):
        mdef = ModelDef.from_arch(arch, in_dim=bundle.pc_in,
                                  out_dim=bundle.pc_out)
        tree = numpy_params(mdef, rng)
        x_np = rng.standard_normal((n_blocks, mdef.in_dim)).astype(
            np.float32)
        p_dev, x_dev = params_from_numpy(tree, dev), torch.as_tensor(
            x_np, device=dev)
        with torch.no_grad():
            y_dev = apply_model(p_dev, mdef, x_dev)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(20):
                apply_model(p_dev, mdef, x_dev)
            e1.record()
            torch.cuda.synchronize()
            y_cpu = apply_model(params_from_numpy(tree, "cpu"), mdef,
                                torch.as_tensor(x_np))
        models[arch] = dict(
            kind=mdef.kind, widths=list(mdef.widths), in_dim=mdef.in_dim,
            out_dim=mdef.out_dim, batch=n_blocks,
            params=count_params(p_dev), rel_err=compare((y_dev.cpu(),),
                                                        (y_cpu,))[1],
            ms_per_forward=e0.elapsed_time(e1) / 20,
            finite=bool(torch.isfinite(y_dev).all()))
    say("models", tol=PRED_TOL, **models)
    for arch, r_ in models.items():
        check(r_["finite"] and r_["rel_err"] <= PRED_TOL,
              f"models {arch}: {r_}")

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

    # ---- reverse mode through the fleet's lockstep (grad-fleet) ---------
    grad_fleet_launches, grad_fleet_res = grad_fleet_phase(
        torch, card, fcases, case_b, flow_b0, reset_counts, counts)
    # ---- the same through the case-parallel fleet step ------------------
    grad_fleet_sharded_launches = grad_fleet_sharded_phase(
        torch, card, dev, case_b, flow_b0, grad_fleet_res, reset_counts,
        counts)

    # ---- rows 3-5 on the fleet's stack, one launch for the four cases ----
    fleet_pressure_rows = fleet_pressure_phase(
        torch, card, dev, case_b, flow_b0, cfg, backend, predictor, flush,
        reset_counts)

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

    # ---- the fleet with the kernel smoothers (one launch a level) --------
    fleet_kernel_launches = fleet_kernel_phase(
        torch, card, case_b, flow_b0, fcases, cfg, predictor, reset_counts,
        counts, fleet_health, check_fleet_health, fleet_ms)

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
    del flow_b, parts_c, parts_f, flow_fsh

    # ---- the fleet with AutoBackend, HybridBackend and SurrogateBackend --
    auto_launches = fleet_backend_phases(
        torch, card, case_b, flow_b0, fcases, cfg, predictor, reset_counts,
        counts, fleet_health, check_fleet_health)
    del case_b

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

    # ---- the training path -------------------------------------------------
    train_launches, train_case, train_frames = train_phases(
        torch, dev, card, reset_counts, counts)
    train_tp_phase(torch, dev, card)

    # ---- the bridge server on the training rollout's cells ----------------
    bridge_launches = bridge_phase(torch, dev, card, train_case,
                                   train_frames[-BRIDGE_STEPS:],
                                   reset_counts, counts)

    # ---- the command-line entry points, PINN, the point-cloud model -------
    cli_launches = cli_phases(torch, dev, card, train_case,
                              train_frames[-PC_FRAMES:], reset_counts, counts)
    del train_case, train_frames

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
    # the matvec's backward: the path's all six gradients at the finest
    # level in float32 (the bf16 polish's levels are in
    # kernel-matvec-grad), beside the library's transposed sparse product,
    # which computes dx alone (its kernel time and bound beside it)
    grad_row = mgrad_times["512x2048 f32"]
    kernels.append({
        "name": "stencil_matvec_grad",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/stencil_grad.cu",
        "replaces": "none: the reverse of tpufoam/ops/stencil.py:221, "
                    "which XLA takes of tpufoam/fv/pressure.py:65",
        "launches": grad_step_launches["stencil_matvec_grad"],
        "max_abs_err": mgrad_err,
        "ms": grad_row["all"]["ms"],
        "plain_ms": grad_row["all"]["plain_ms"],
        "bound_ms": grad_row["all"]["bound_ms"],
        "bound_by": grad_row["all"]["bound_by"],
        "library_ms": grad_row["dx"].get("library_ms"),
        "library_computes": "dx alone",
        "dx_ms": grad_row["dx"]["ms"],
        "dx_bound_ms": grad_row["dx"]["bound_ms"],
    })
    # no path of either package calls jacobi_sweep: its count over every
    # driven path, each path's counts set to 0 just before its steps
    paths = (*train_launches.values(), step_launches,
             grad_step_launches, grad_fleet_launches,
             grad_sharded_launches, grad_fleet_sharded_launches,
             sharded_step_launches, fused_launches,
             mgcg_launches, st_launches, fleet_launches, fsh_launches,
             k_mgcg, auto_launches, bridge_launches,
             *cli_launches.values(), *fleet_kernel_launches.values())
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
    # no driven path runs the sharded kernels of whole fields any more
    # (the decomposed step launches rows 1-5 per block; kernel-sharded
    # holds them): their counts over every driven path, as jacobi_sweep's
    jsh_launches = sum(k_["jacobi_multisweep_sharded"] for k_ in paths)
    msh_launches = sum(k_["momentum_multisweep_sharded"] for k_ in paths)
    check(jsh_launches == 0 and msh_launches == 0,
          f"a path launched the whole-field sharded kernels "
          f"{jsh_launches} and {msh_launches} times")
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
    # rows 3-5's launch on a fleet's stack: the four cases of
    # kernel-fleet-pressure at 512 x 2048, launched on step-fleet-kernel's
    # paths (one launch a level for the four cases)
    batched_paths = {"jacobi_multisweep": "step-fleet-kernel",
                     "smooth_residual": "step-fleet-kernel-fused",
                     "corr_smooth": "step-fleet-kernel-fused"}
    for name, row in fleet_pressure_rows.items():
        kernels.append({
            "name": f"{name} (batched launch)",
            "route": "cuda",
            "source": "tpufoam_torch/ops/csrc/pressure_stencil.cu",
            "replaces": STENCIL[name][4],
            "launches": fleet_kernel_launches[batched_paths[name]][name],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "singles_ms": row["singles_ms"],
            "library_ms": None,
        })
    kernels.append({
        "name": "momentum_multisweep_sharded",
        "route": "cuda",
        "source": "tpufoam_torch/ops/csrc/momentum_multisweep.cu",
        "replaces": "tpufoam/ops/stencil.py:850",
        "launches": msh_launches,
        "max_abs_err": msh["max_abs_err"],
        "ms": t_msh["ms"],
        "plain_ms": t_msh["plain_ms"],
        "bound_ms": b_msh["bound_us"] / 1e3,
        "bound_by": b_msh["bound_by"],
        "call_ms": t_msh["call_ms"],
        "assembly_ms": split_msh["assembly_ms"],
        "launches_per_call": split_msh["launches_per_call"],
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
        "bound_ms": t_jsh["bound_ms"],
        "bound_by": t_jsh["bound_by"],
        "call_ms": t_jsh["call_ms"],
        "assembly_ms": t_jsh["assembly_ms"],
        "launches_per_call": t_jsh["launches_per_call"],
        "library_ms": None,
    })
    # the launches of each kernel on the turbulent and poisson paths (their
    # counts set to 0 just before each path's timed steps)
    # and on the fleet with AutoBackend (every momentum launch there is the
    # batched launch) and the bridge's served steps
    new_paths = {"step-sharded": sharded_step_launches,
                 "grad-step": grad_step_launches,
                 "grad-fleet": grad_fleet_launches,
                 "grad-sharded": grad_sharded_launches,
                 "grad-fleet-sharded": grad_fleet_sharded_launches,
                 "step-turb": turb_launches, "step-turb-mgcg": dean_launches,
                 "step-turb-sharded": tsh_launches,
                 "step-poisson": poisson_launches, **train_launches,
                 "bridge": bridge_launches, **cli_launches}
    # and on the fleet with the kernel smoothers (every launch there of
    # rows 1 and 3-5 is a batched launch)
    fleet_paths = {"step-fleet-auto": auto_launches, **fleet_kernel_launches}
    for row in kernels:
        name = row["name"].split(" ")[0]
        if row["name"].endswith("(batched launch)"):
            row["launches_by_path"] = {path: k_[name]
                                       for path, k_ in fleet_paths.items()}
            continue
        by_path = dict(new_paths)
        if name in STENCIL:
            by_path["step-fleet-auto"] = auto_launches
        elif name != "momentum_multisweep":
            by_path.update(fleet_paths)
        row["launches_by_path"] = {path: k_.get(name, 0)
                                   for path, k_ in by_path.items()}
    say("done", total_s=round(time.time() - T0, 3))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
