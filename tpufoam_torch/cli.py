"""Command-line entry points of the PyTorch port.

Mirrors the reference's console_scripts surface (setup.py:8-14,
entry_point.py:5-122: train_script / evaluation_script) plus the solver and
dataset drivers that the reference runs as shell pipelines
(make_dataset.py, sim_cmd.sh, DLPoissonFoam):

  tpufoam-torch-datagen    parametric case sweep -> PISO rollouts -> HDF5
  tpufoam-torch-train      dataset -> trained surrogate bundle
  tpufoam-torch-eval       bundle + dataset -> BIAS/STDE/RMSE report (+ plots)
  tpufoam-torch-piso       run a coupled simulation with a chosen pressure
                           backend (cg | mg | mgcg | sm | hybrid), timed
  tpufoam-torch-pinn       train a steady-NS PINN
  tpufoam-torch-pointcloud train / roll out the point-cloud model
  tpufoam-torch-casegen    OpenFOAM case generation
  tpufoam-torch-bundle     bundle <-> the reference's sidecar files

Every flag has the JAX package's name, default and choices (its
`tpufoam/cli.py`), so a JAX command line runs unchanged, but for three:
`--platform` takes `cpu` or `cuda` (default: the card) and chooses the
device each entry point computes on; `--distributed` joins a
torch.distributed world from torchrun's variables; and the smoother flags
take the port's `plain` and `kernel` beside JAX's `xla` and `pallas`,
which mean the same. The bundle conversions also take `--platform`.
"""

from __future__ import annotations

import argparse
import json
import time

from . import DEFAULT_DEVICE

# the JAX package's smoother names, taken as the port's
_SMOOTHERS = {"xla": "plain", "pallas": "kernel"}
_SMOOTHER_CHOICES = ["plain", "kernel", "xla", "pallas"]


def _add_platform_flag(p, distributed: bool = True):
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="the device to compute on (default: the CUDA card)")
    if distributed:
        p.add_argument("--distributed", action="store_true",
                       help="join a torch.distributed world before the run "
                            "(multi-process runs; world from torchrun's "
                            "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK — "
                            "parallel/distributed.py)")


def _apply_platform(args):
    """The torch.device the entry point computes on; joins the world
    with --distributed."""
    import torch

    device = torch.device(getattr(args, "platform", None) or "cuda")
    if getattr(args, "distributed", False):
        from .parallel.distributed import init_distributed
        try:
            ok = init_distributed(force=True, device=device)
        except Exception as e:
            raise SystemExit(f"--distributed bootstrap failed: {e}") from e
        if not ok:
            raise SystemExit(
                "--distributed: no world configuration found (set "
                "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK)")
    return device


def _add_case_flags(p):
    p.add_argument("--shape", default="cylinder",
                   choices=["cylinder", "rectangle", "triangle", "ellipse",
                            "plate"])
    p.add_argument("--length", type=float, default=8.0)
    p.add_argument("--height", type=float, default=2.0)
    p.add_argument("--obstacle-size", type=float, default=0.5)
    p.add_argument("--nu", type=float, default=8e-3)
    p.add_argument("--delta", type=float, default=None,
                   help="grid spacing (default height/128)")


def _build_case(args, device):
    from .core.geometry import channel_case_geometry
    from .fv.case import build_channel_case
    delta = args.delta or args.height / 128
    geom = channel_case_geometry(args.shape, length=args.length,
                                 height=args.height,
                                 obstacle_size=args.obstacle_size, nu=args.nu)
    return geom, build_channel_case(geom, delta=delta, device=device)


def _backend(name, bundle_path=None, stitch="lstsq", polish=6,
             precision="f32", smoother="plain", device=DEFAULT_DEVICE):
    """Returns (corrector_backend, sm_predict). 'hybrid' is the reference's
    Algorithm 2 (DLPoissonFoam.C:104-119): the SM predicts the pressure
    ONCE per timestep before the momentum predictor, and the corrector
    solves are capped multigrid cycles (the fvSolution maxIter-6 role).
    precision='bf16' runs the fixed multigrid cycles mixed-precision (f32
    residual, bf16 correction) and the surrogate PCA matmuls on bf16
    operands. It is NOT applied to the mgcg backend: plain CG stalls at
    rtol 1e-6 with a reduced-precision preconditioner. `smoother` is the
    multigrid smoother: 'plain' or 'kernel' (JAX's 'xla', 'pallas'). The
    surrogate bundle loads onto `device`."""
    from .solvers.backends import (CGBackend, MGBackend, MGCGBackend,
                                   SurrogateBackend)
    smoother = _SMOOTHERS.get(smoother, smoother)
    if name in ("cg", "mgcg") and precision == "bf16":
        # not silently ignored: plain CG stalls at rtol 1e-6 with a
        # reduced-precision preconditioner
        print(f"WARNING: --precision bf16 is not supported for the {name} "
              "backend (CG stalls with a reduced-precision preconditioner); "
              "running f32", flush=True)
    if name == "cg":
        return CGBackend(rtol=1e-6, maxiter=2000), None
    if name == "mg":
        return MGBackend(cycles=4, precision=precision,
                         smoother=smoother), None
    if name == "mgcg":
        return MGCGBackend(rtol=1e-6, smoother=smoother), None
    from .surrogate.pipeline import SurrogateBundle, make_predictor
    bundle = SurrogateBundle.load(bundle_path, device=device)
    predictor = make_predictor(bundle, stitch=stitch, precision=precision)
    if name == "sm":
        return SurrogateBackend(predict=predictor), None
    if name == "hybrid":
        return MGBackend(cycles=max(polish // 3, 1), precision=precision,
                         smoother=smoother), predictor
    raise ValueError(name)


# ---------------------------------------------------------------------------

def piso_main(argv=None):
    ap = argparse.ArgumentParser("tpufoam-piso",
                                 description="Run a PISO simulation "
                                 "(DLPoissonFoam.C role)")
    _add_case_flags(ap)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dt0", type=float, default=1e-3)
    ap.add_argument("--max-co", type=float, default=0.5)
    ap.add_argument("--n-correctors", type=int, default=2)
    ap.add_argument("--backend", default="mgcg",
                    choices=["cg", "mg", "mgcg", "sm", "hybrid"])
    ap.add_argument("--bundle", default=None, help="surrogate bundle dir")
    ap.add_argument("--stitch", default="lstsq", choices=["scan", "lstsq"])
    ap.add_argument("--smoother", default="plain", choices=_SMOOTHER_CHOICES,
                    help="multigrid smoother: 'kernel' (JAX's 'pallas') = "
                         "the hand-written multisweep kernels on the card; "
                         "'plain' (JAX's 'xla') = PyTorch operations")
    ap.add_argument("--momentum-smoother", default="plain",
                    choices=_SMOOTHER_CHOICES,
                    help="'kernel' (JAX's 'pallas') fuses all momentum "
                         "Jacobi sweeps into one launch of the "
                         "hand-written momentum kernel on the card")
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                    help="bf16 = mixed-precision multigrid cycles")
    ap.add_argument("--out", default=None, help=".npz output for final fields")
    ap.add_argument("--state", default=None,
                    help="solver-state .npz: resumed from if present, "
                         "written on completion (startFrom latestTime role)")
    ap.add_argument("--turbulence", default="laminar",
                    choices=["laminar", "kOmegaSST"],
                    help="momentum-transport model (createFields.H:66-71 "
                         "runtime-selectable turbulence role)")
    ap.add_argument("--turb-intensity", type=float, default=0.05)
    ap.add_argument("--turb-length-frac", type=float, default=0.1)
    ap.add_argument("--turb-wall-fn", action="store_true",
                    help="high-Re log-law wall functions (nutk/omega/kqR "
                         "wall-function roles) — use when the first cell "
                         "sits at y+ >~ 30; validated against Dean's "
                         "channel Cf correlation (fv/turbulence.py)")
    ap.add_argument("--convection", default="limitedLinear",
                    choices=["upwind", "blend", "limitedLinear"],
                    help="convection scheme; limitedLinear matches the "
                         "reference's `div(phi,U) Gauss limitedLinearV 1` "
                         "(fvSchemes:20) and is the default")
    ap.add_argument("--convection-blend", type=float, default=1.0,
                    help="deferred-central weight for --convection blend")
    ap.add_argument("--ddt", default="euler", choices=["euler", "backward"],
                    help="time scheme: 'euler' matches the reference's "
                         "ddtSchemes default (fvSchemes:19); 'backward' is "
                         "variable-step BDF2 (second-order in time)")
    ap.add_argument("--ddt-corr", action="store_true",
                    help="fvc::ddtCorr(U, phi) in the pressure equation "
                         "(pEqn.H:7 parity; Rhie-Chow transient "
                         "consistency)")
    ap.add_argument("--wall-order", type=int, default=1, choices=[1, 2],
                    help="embedded-wall shear closure order: 2 adds the "
                         "quadratic-profile deferred correction "
                         "tau_w = nu U_t/d - (d/2) dp/ds and the matching "
                         "force term (laminar cut/blank walls)")
    ap.add_argument("--wall-link", default="full",
                    choices=["full", "tangential"],
                    help="'tangential' restricts the embedded no-slip "
                         "link to the tangential velocity (the physical "
                         "viscous wall traction; laminar cut/blank walls)")
    ap.add_argument("--forces-out", default=None,
                    help="CSV path for the Cd/Cl time series (the "
                         "controlDict:61-107 forceCoeffs function object "
                         "role); logged every --forces-every steps")
    ap.add_argument("--forces-every", type=int, default=10)
    ap.add_argument("--jit-chunk", type=int, default=1,
                    help="steps per run_piso_chunked chunk (>1 runs the "
                         "laminar path through run_piso_chunked, which "
                         "equals run_piso_eager)")
    _add_platform_flag(ap)
    args = ap.parse_args(argv)
    device = _apply_platform(args)

    import os

    import numpy as np
    import torch

    from .fv.case import initial_flow, load_flow, load_turbulence, save_flow
    from .piso.engine import (PisoConfig, continuity_error, courant_number,
                              run_piso_chunked, run_piso_eager,
                              run_piso_sst_eager)
    from .utils.metrics import _host

    geom, case = _build_case(args, device)
    resumed = args.state and os.path.exists(args.state)
    if resumed:
        flow = load_flow(args.state, device=device)
        print(f"resumed from {args.state} at t={float(flow.t):.4f}", flush=True)
    else:
        flow = initial_flow(case, dt0=args.dt0)
    cfg = PisoConfig(n_correctors=args.n_correctors, max_co=args.max_co,
                     convection=args.convection,
                     convection_blend=args.convection_blend,
                     ddt=args.ddt, ddt_corr=args.ddt_corr,
                     wall_order=args.wall_order, wall_link=args.wall_link,
                     momentum_smoother=_SMOOTHERS.get(args.momentum_smoother,
                                                      args.momentum_smoother),
                     turb_wall_fn=args.turb_wall_fn)
    backend, sm_predict = _backend(args.backend, args.bundle, args.stitch,
                                   precision=args.precision,
                                   smoother=args.smoother, device=device)

    # a turbulent state file self-identifies: auto-resume its k/omega even
    # when --turbulence was not re-passed, rather than silently switching
    # physics mid-run and dropping the fields on the next save
    turb = load_turbulence(args.state, device=device) if resumed else None
    if turb is not None and args.turbulence != "kOmegaSST":
        print("state file contains k-omega SST fields: resuming turbulent "
              "(pass a fresh --state to run laminar)", flush=True)
    if turb is None and args.turbulence == "kOmegaSST":
        from .fv.turbulence import init_turbulence
        turb = init_turbulence(case, intensity=args.turb_intensity,
                               length_frac=args.turb_length_frac)

    chunk = max(1, min(50, args.steps))
    force_rows = []
    if args.forces_out:
        from .fv.forces import obstacle_force
        chunk = max(1, min(chunk, args.forces_every))
    done = 0
    t0 = time.perf_counter()
    while done < args.steps:
        n = min(chunk, args.steps - done)
        if turb is not None:
            flow, turb = run_piso_sst_eager(case, flow, turb, n, cfg=cfg,
                                            backend=backend,
                                            sm_predict=sm_predict)
        elif args.jit_chunk > 1:
            flow = run_piso_chunked(case, flow, n, cfg=cfg, backend=backend,
                                    sm_predict=sm_predict,
                                    chunk=args.jit_chunk)
        else:
            flow = run_piso_eager(case, flow, n, cfg=cfg, backend=backend,
                                  sm_predict=sm_predict)
        done += n
        el = time.perf_counter() - t0
        force_txt = ""
        if args.forces_out:
            with torch.no_grad():
                rep = obstacle_force(
                    case, flow.u, flow.v, flow.p,
                    u_ref=1.0, d_ref=args.obstacle_size,
                    nu_t=None if turb is None else turb.nu_t,
                    k_turb=turb.k if (turb is not None
                                      and cfg.turb_wall_fn) else None,
                    wall_order=cfg.wall_order, wall_link=cfg.wall_link)
            cd, cl = float(rep.cd), float(rep.cl)
            force_rows.append((float(flow.t), cd, cl))
            force_txt = f" Cd={cd:.4f} Cl={cl:.4f}"
        print(f"step {done}/{args.steps} t={float(flow.t):.4f} "
              f"dt={float(flow.dt):.2e} Co={float(courant_number(case, flow)):.3f} "
              f"contErr={float(continuity_error(case, flow)):.2e}"
              f"{force_txt} "
              f"[{el / done * 1000:.2f} ms/step]", flush=True)

    if args.forces_out:
        with open(args.forces_out, "w") as f:
            f.write("t,Cd,Cl\n")
            for t_, cd, cl in force_rows:
                f.write(f"{t_:.6f},{cd:.6f},{cl:.6f}\n")
        print(f"saved force coefficients to {args.forces_out}")

    if args.out:
        extra = {}
        if turb is not None:
            extra = dict(k=_host(turb.k), omega=_host(turb.omega),
                         nu_t=_host(turb.nu_t))
        np.savez(args.out, u=_host(flow.u), v=_host(flow.v),
                 p=_host(flow.p), t=float(flow.t), **extra)
        print(f"saved fields to {args.out}")
    if args.state:
        save_flow(args.state, flow, turb=turb)
        print(f"saved solver state to {args.state}")


def casegen_main(argv=None):
    """Per-shape external-flow OpenFOAM case generation — the
    Generate_blockMeshDict/*/gen_blockMeshDict.py + make_dataset.py roles
    (half-domain O-grid/lattice meshes + mirrorMeshDict + case skeleton;
    --sweep reproduces make_dataset.py's stratified cylinder sampling)."""
    ap = argparse.ArgumentParser("tpufoam-casegen")
    ap.add_argument("--shape", default="cylinder",
                    choices=["cylinder", "rectangle", "triangle", "ellipse",
                             "plate"])
    ap.add_argument("--out", required=True, help="case (or sweep root) dir")
    ap.add_argument("--size", type=float, default=0.5,
                    help="radius / half-height / semi-axis a / plate length")
    ap.add_argument("--size2", type=float, default=None,
                    help="shape-specific 2nd size (ellipse b, plate width, "
                         "rect/triangle streamwise extent)")
    ap.add_argument("--y-max", type=float, default=2.0)
    ap.add_argument("--alpha", type=float, default=30.0,
                    help="plate inclination [deg]")
    ap.add_argument("--refinement", type=float, default=1.0)
    ap.add_argument("--bl-grading", type=float, default=3.0,
                    help="wall expansion ratio; ~10 for the kwSST meshes "
                         "(For_kwSST/* role)")
    ap.add_argument("--sweep", type=int, default=0,
                    help="generate N cylinder cases with the reference's "
                         "stratified (y_max, r) sampling "
                         "(make_dataset.py:6-38)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from .data.blockmesh import SHAPE_SPECS, write_spec

    def build(shape, **kw):
        if shape == "cylinder":
            return SHAPE_SPECS[shape](kw["size"], kw["y_max"],
                                      refinement=args.refinement,
                                      bl_grading=args.bl_grading)
        if shape == "ellipse":
            return SHAPE_SPECS[shape](kw["size"], kw["size2"] or kw["size"] / 2,
                                      y_max=kw["y_max"],
                                      refinement=args.refinement,
                                      bl_grading=args.bl_grading)
        if shape in ("rectangle", "triangle"):
            x0 = 4.0
            return SHAPE_SPECS[shape](x0, x0 + (kw["size2"] or kw["size"]),
                                      kw["size"], cell_scale=args.refinement,
                                      y_max=kw["y_max"])
        return SHAPE_SPECS["plate"](5.0, kw["size"], kw["size2"] or 0.05,
                                    args.alpha, cell_scale=args.refinement,
                                    y_max=kw["y_max"])

    if args.sweep:
        rng = np.random.default_rng(args.seed)
        strata = [0.5, 0.6, 0.75, 0.9, 1.0]
        made = 0
        for i in range(args.sweep):
            y = strata[i % len(strata)]
            r = float(rng.uniform(0.2, 0.45 * y))
            spec = build(args.shape, size=r, size2=args.size2, y_max=y)
            case = f"{args.out}/{i}"
            write_spec(spec, case)
            with open(f"{case}/params.json", "w") as f:
                json.dump({"shape": args.shape, "size": r, "y_max": y}, f)
            made += 1
        print(f"generated {made} {args.shape} cases under {args.out}")
        return

    spec = build(args.shape, size=args.size, size2=args.size2,
                 y_max=args.y_max)
    write_spec(spec, args.out)
    print(f"wrote {args.out}/system/blockMeshDict"
          + (" + mirrorMeshDict" if spec.half_domain else ""))


def datagen_main(argv=None):
    ap = argparse.ArgumentParser("tpufoam-datagen",
                                 description="Case sweep -> PISO -> HDF5 "
                                 "(make_dataset.py + sim_cmd.sh + "
                                 "data_generation.py roles)")
    _add_case_flags(ap)
    ap.add_argument("--n-sims", type=int, default=3)
    ap.add_argument("--n-frames", type=int, default=20)
    ap.add_argument("--steps-per-frame", type=int, default=10)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turbulent", action="store_true",
                    help="k-omega SST + wall functions instead of laminar "
                         "(the For_kwSST dataset family role)")
    ap.add_argument("--out", required=True, help="output .h5 path")
    _add_platform_flag(ap)
    args = ap.parse_args(argv)
    device = _apply_platform(args)

    import numpy as np

    from .core.geometry import channel_case_geometry
    from .fv.case import build_channel_case, initial_flow
    from .piso.engine import PisoConfig, run_piso
    from .solvers.backends import MGCGBackend
    from .train.dataset import frames_from_rollout
    from .utils.hdf5_io import CH_DELTAS, rollout_to_records, write_dataset

    rng = np.random.default_rng(args.seed)
    delta = args.delta or args.height / 128
    sims = []
    for s in range(args.n_sims):
        # stratified size sweep like make_dataset.py:45-65
        size = float(rng.uniform(0.5, 1.2)) * args.obstacle_size
        cy = args.height * float(rng.uniform(0.4, 0.6))
        geom = channel_case_geometry(args.shape, length=args.length,
                                     height=args.height, obstacle_size=size,
                                     cy=cy, nu=args.nu)
        case = build_channel_case(geom, delta=delta, device=device)
        flow = initial_flow(case, dt0=1e-3)
        if args.turbulent:
            from .fv.turbulence import init_turbulence
            from .piso.engine import run_piso_sst_eager
            from .train.dataset import frames_from_sst_rollout
            cfg = PisoConfig(turb_wall_fn=True)
            turb = init_turbulence(case)
            flow, turb = run_piso_sst_eager(case, flow, turb,
                                            args.warmup_steps, cfg=cfg,
                                            backend=MGCGBackend())
            frames, _, _ = frames_from_sst_rollout(case, flow, turb,
                                                   args.n_frames,
                                                   args.steps_per_frame,
                                                   cfg=cfg,
                                                   backend=MGCGBackend())
        else:
            cfg = PisoConfig()
            flow = run_piso(case, flow, args.warmup_steps, cfg=cfg,
                            backend=MGCGBackend())
            frames = frames_from_rollout(case, flow, args.n_frames,
                                         args.steps_per_frame, cfg=cfg,
                                         backend=MGCGBackend())
        cells = rollout_to_records(case, frames)
        top = geom.boundary_points_top(2000)
        obst = geom.shape.boundary_points(720)
        sims.append([dict(cells=c, top=top, obst=obst) for c in cells])
        print(f"sim {s}: size={size:.3f} frames={len(cells)}", flush=True)

    write_dataset(args.out, sims, channels=CH_DELTAS)
    print(f"wrote {args.out}")


def train_main(argv=None):
    ap = argparse.ArgumentParser("tpufoam-train",
                                 description="Train a surrogate "
                                 "(train_script role, entry_point.py:5-68)")
    ap.add_argument("--dataset", required=True, help=".h5 dataset path")
    ap.add_argument("--family", default="deltaU_deltaP",
                    choices=["deltaU_deltaP", "poisson", "M_u", "M_fU",
                             "U_gradP"])
    ap.add_argument("--delta", type=float, default=5e-3,
                    help="grid spacing (reference default 5e-3)")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--overlap", type=float, default=0.25)
    ap.add_argument("--n-samples", type=int, default=int(1e4),
                    help="blocks per sim (reference default 1e4)")
    ap.add_argument("--num-sims", type=int, default=None)
    ap.add_argument("--first-t", type=int, default=0)
    ap.add_argument("--last-t", type=int, default=None)
    ap.add_argument("--var-in", type=float, default=0.95)
    ap.add_argument("--var-p", type=float, default=0.95)
    ap.add_argument("--max-num-pc", type=int, default=512)
    ap.add_argument("--arch", default="MLP_small")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--beta1", type=float, default=0.9)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=5000)
    ap.add_argument("--dropout", type=float, default=None)
    ap.add_argument("--regularization", type=float, default=None)
    ap.add_argument("--standardization", default="std",
                    choices=["std", "min_max", "max_abs"])
    ap.add_argument("--loss-weighting", default="uniform",
                    choices=["uniform", "variance"],
                    help="'variance' weights the standardized-PC MSE by "
                         "explained variance so the objective equals "
                         "physical-space block MSE (tpufoam extension; "
                         "the reference trains uniform, train.py:493-499)")
    ap.add_argument("--out", required=True, help="bundle output dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default=None,
                    help=".npz block-dataset cache (skip reprocessing if it "
                         "exists — the reference's outarray.h5 gate)")
    ap.add_argument("--checkpoint", default=None,
                    help="training checkpoint path for resume")
    ap.add_argument("--phis", default=None,
                    help="per-sim characteristic-length file for the "
                         "poisson family (one float per line, the "
                         "reference's phis.txt)")
    ap.add_argument("--k-smooth", type=float, default=2.0,
                    help="arcsinh smoothing std multiplier (poisson family)")
    _add_platform_flag(ap)
    args = ap.parse_args(argv)
    device = _apply_platform(args)

    import os

    from .eval.evaluation import UnstructuredCase
    from .train.dataset import (build_block_dataset, load_block_dataset,
                                save_block_dataset)
    from .train.trainer import TrainConfig, train_surrogate
    from .utils.hdf5_io import dataset_shape, read_frame

    n_sims, n_t = dataset_shape(args.dataset)
    n_sims = min(n_sims, args.num_sims or n_sims)
    last_t = min(n_t, args.last_t or n_t)

    phis = None
    if args.phis:
        import numpy as np
        phis = np.loadtxt(args.phis).reshape(-1)

    if args.cache and os.path.exists(args.cache):
        ds = load_block_dataset(args.cache)
        print(f"loaded cached dataset: {ds.n} blocks", flush=True)
    else:
        all_frames = []
        ucase = None
        for s in range(n_sims):
            ucase = UnstructuredCase.from_hdf5(args.dataset, s, args.delta,
                                               device=device)
            for t in range(args.first_t, last_t):
                fr = read_frame(args.dataset, s, t)
                fields = ucase.fields_from_frame(fr)
                # per-sim characteristic length + smoothing k for the
                # poisson feature family (pressureSM_Poisson/train.py:682-684)
                fields["length_scale"] = (float(phis[s]) if phis is not None
                                          else 1.0)
                fields["k_smooth"] = args.k_smooth
                all_frames.append(fields)
            print(f"prepared sim {s} ({last_t - args.first_t} frames)",
                  flush=True)

        n_per_frame = max(args.n_samples // (2 * max(last_t - args.first_t, 1)), 8)
        ds = build_block_dataset(ucase.case, all_frames, family=args.family,
                                 n_samples_per_frame=n_per_frame,
                                 block_size=args.block_size, seed=args.seed)
        if args.cache:
            save_block_dataset(args.cache, ds)
    print(f"dataset: {ds.n} blocks of {args.block_size}^2", flush=True)

    cfg = TrainConfig(arch=args.arch, lr=args.lr, beta1=args.beta1,
                      batch_size=args.batch_size, max_epochs=args.epochs,
                      var_in=args.var_in, var_out=args.var_p,
                      max_num_pc=args.max_num_pc, dropout=args.dropout,
                      l2=args.regularization,
                      standardization=args.standardization,
                      loss_weighting=args.loss_weighting, seed=args.seed)
    bundle, state = train_surrogate(ds, args.family, cfg,
                                    overlap_ratio=args.overlap,
                                    checkpoint_path=args.checkpoint,
                                    verbose=True, device=device)
    bundle.save(args.out)
    try:
        from .utils.plotting import plot_loss_history
        plot_loss_history(state.history, state.val_history,
                          os.path.join(args.out, "training"))
    except Exception as e:  # matplotlib optional at runtime
        print(f"loss-curve plot skipped: {e}", flush=True)
    print(json.dumps({"best_val": state.best_val,
                      "best_epoch": state.best_epoch,
                      "epochs_run": len(state.history),
                      "pc_in": bundle.pc_in, "pc_out": bundle.pc_out,
                      "bundle": args.out}))


def pinn_main(argv=None):
    ap = argparse.ArgumentParser("tpufoam-pinn",
                                 description="Train a steady-NS PINN "
                                 "(Chapter-3 PINN_steady.py role)")
    ap.add_argument("--formulation", type=int, default=1, choices=[1, 2, 3, 4])
    ap.add_argument("--beta", type=float, default=1.0,
                    help="BC-loss weight (the beta* directory sweep)")
    ap.add_argument("--nu", type=float, default=0.02)
    ap.add_argument("--n-colloc", type=int, default=20000)
    ap.add_argument("--adam-steps", type=int, default=5000)
    ap.add_argument("--lbfgs-steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="output .pkl for params")
    _add_platform_flag(ap)
    args = ap.parse_args(argv)
    device = _apply_platform(args)

    import pickle

    from .models.pinn import (PinnConfig, make_training_points,
                              pinn_params_to_numpy, train_pinn)

    cfg = PinnConfig(formulation=args.formulation, beta=args.beta, nu=args.nu)
    batch = make_training_points(cfg, n_colloc=args.n_colloc, seed=args.seed,
                                 device=device)
    params, history = train_pinn(cfg, batch, adam_steps=args.adam_steps,
                                 lbfgs_steps=args.lbfgs_steps, lr=args.lr,
                                 seed=args.seed, verbose=True)
    if args.out.endswith(".h5"):
        # Keras-layout checkpoint — the reference's my_model_ref.h5 /
        # my_model_ref_afterLFGS.h5 artifacts (PINN_steady.py:419,561)
        from .models.pinn import save_pinn_h5
        save_pinn_h5(args.out, params, cfg, history)
    else:
        # numpy arrays in the JAX package's layout: either package loads it
        with open(args.out, "wb") as f:
            pickle.dump(dict(cfg=cfg.__dict__,
                             params=pinn_params_to_numpy(params),
                             history=history), f)
    print(json.dumps({"final_loss": history[-1], "out": args.out}))


def pointcloud_main(argv=None):
    ap = argparse.ArgumentParser(
        "tpufoam-pointcloud",
        description="Train / roll out the Chapter-3 point-cloud next-step "
        "model (Chapter3/Data-driven/External_flow train.py + plot.py roles)")
    sub = ap.add_subparsers(dest="mode", required=True)

    tr = sub.add_parser("train")
    tr.add_argument("--dataset", required=True, help=".h5 dataset path")
    tr.add_argument("--n-pts", type=int, default=4096,
                    help="points per cloud (multiple of 16)")
    tr.add_argument("--num-sims", type=int, default=None)
    tr.add_argument("--first-t", type=int, default=0)
    tr.add_argument("--last-t", type=int, default=None)
    tr.add_argument("--epochs", type=int, default=50)
    tr.add_argument("--batch-size", type=int, default=2)
    tr.add_argument("--lr", type=float, default=1e-3)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--out", required=True, help="output .pkl for params")
    _add_platform_flag(tr)

    ro = sub.add_parser("rollout")
    ro.add_argument("--dataset", required=True)
    ro.add_argument("--params", required=True, help=".pkl from train")
    ro.add_argument("--sim", type=int, default=0)
    ro.add_argument("--first-t", type=int, default=0)
    ro.add_argument("--steps", type=int, default=10)
    ro.add_argument("--raster-shape", default="128,512",
                    help="ny,nx for error-map rasterization")
    ro.add_argument("--plots-dir", default=None,
                    help="save per-frame field/error imshow plots here")
    _add_platform_flag(ro)

    args = ap.parse_args(argv)
    device = _apply_platform(args)

    import pickle

    import numpy as np

    from .models.pointnet import (PointNetUNet, pointnet_state_from_flax,
                                  pointnet_state_to_flax)
    from .train.pointcloud import build_pointcloud_dataset, train_pointcloud

    if args.mode == "train":
        ds = build_pointcloud_dataset(args.dataset, n_pts=args.n_pts,
                                      n_sims=args.num_sims,
                                      first_t=args.first_t, last_t=args.last_t)
        print(f"dataset: {len(ds.fields)} next-step pairs of "
              f"{ds.fields.shape[1]} points", flush=True)
        model, params, history = train_pointcloud(
            ds, epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
            seed=args.seed, verbose=True, device=device)
        # the flax variables layout: either package loads the file
        np_params = pointnet_state_to_flax(params)
        if args.out.endswith(".h5"):
            # pickle-free checkpoint (the reference saves its point-cloud
            # model as Keras .h5 too — Chapter3 train.py)
            from .utils.h5ckpt import save_pytree_h5
            save_pytree_h5(args.out, np_params,
                           meta=dict(mins=list(map(float, np.ravel(ds.mins))),
                                     maxs=list(map(float, np.ravel(ds.maxs))),
                                     n_pts=args.n_pts, history=history))
        else:
            with open(args.out, "wb") as f:
                pickle.dump(dict(params=np_params,
                                 mins=ds.mins, maxs=ds.maxs, n_pts=args.n_pts,
                                 history=history), f)
        print(json.dumps({"final_loss": history[-1], "out": args.out}))
        return

    # rollout
    from .eval.pointcloud_rollout import rasterize, rollout, rollout_report

    if args.params.endswith(".h5"):
        from .utils.h5ckpt import load_pytree_h5
        _params, _meta = load_pytree_h5(args.params)
        blob = dict(params=_params, mins=np.asarray(_meta["mins"]),
                    maxs=np.asarray(_meta["maxs"]), n_pts=_meta["n_pts"])
    else:
        with open(args.params, "rb") as f:
            blob = pickle.load(f)
    # rescale with the TRAINING stats, not this subset's own min/max
    ds = build_pointcloud_dataset(args.dataset, n_pts=blob["n_pts"],
                                  n_sims=args.sim + 1, first_t=args.first_t,
                                  scale_stats=(blob["mins"], blob["maxs"]))
    sel = np.flatnonzero(ds.sim_ids == args.sim)
    if sel.size == 0:
        raise SystemExit(f"sim {args.sim} has no usable frames")
    model = PointNetUNet()
    model.load_state_dict(pointnet_state_from_flax(blob["params"]))
    model = model.to(device)
    f0 = ds.fields[sel[0]]
    coords = ds.coords[sel[0]]
    steps = min(args.steps, sel.size)
    pred = rollout(model, None, f0, coords, steps)
    true = ds.targets[sel[:steps]]
    rep = rollout_report(pred, true)
    for name, reports in rep.items():
        last = reports[-1]
        print(f"{name}: frame-{steps - 1} RMSE {last.rmse_pct:.3f}% "
              f"BIAS {last.bias_pct:.3f}% STDE {last.stde_pct:.3f}%",
              flush=True)
    if args.plots_dir:
        import os

        os.makedirs(args.plots_dir, exist_ok=True)
        ny, nx = (int(v) for v in args.raster_shape.split(","))
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        for t in range(steps):
            fig, axes = plt.subplots(3, 2, figsize=(12, 7))
            for c, name in enumerate(("Ux", "Uy", "p")):
                for k, (frm, ttl) in enumerate(((pred, "SM"), (true, "CFD"))):
                    img = rasterize(coords, frm[t][:, c], (ny, nx))
                    ax = axes[c][k]
                    ax.imshow(img, origin="lower")
                    ax.set_title(f"{name} ({ttl}) t+{t + 1}")
                    ax.axis("off")
            fig.tight_layout()
            fig.savefig(f"{args.plots_dir}/frame_{t:03d}.png", dpi=90)
            plt.close(fig)
        print(f"saved {steps} frames to {args.plots_dir}")
    print(json.dumps({"steps": steps,
                      "p_rmse_last": rep["p"][-1].rmse_pct}))


def eval_main(argv=None):
    ap = argparse.ArgumentParser("tpufoam-eval",
                                 description="Evaluate a surrogate bundle "
                                 "(evaluation_script role, entry_point.py:71-122)")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--delta", type=float, default=5e-3)
    ap.add_argument("--num-sims", type=int, default=None)
    ap.add_argument("--first-t", type=int, default=0)
    ap.add_argument("--last-t", type=int, default=None)
    ap.add_argument("--stitch", default="scan", choices=["scan", "lstsq"])
    ap.add_argument("--apply-filter", action="store_true")
    ap.add_argument("--weighted", action="store_true",
                    help="apply the deltaU-change blending and report the "
                         "weighted delta_p error tier "
                         "(apply_deltaU_change_wgt, SM_call.py:359-363)")
    ap.add_argument("--save-plots", action="store_true")
    ap.add_argument("--plots-dir", default="plots")
    _add_platform_flag(ap)
    args = ap.parse_args(argv)
    device = _apply_platform(args)

    from .eval.evaluation import UnstructuredCase, evaluate_bundle
    from .surrogate.pipeline import SurrogateBundle
    from .utils.hdf5_io import dataset_shape, read_frame

    bundle = SurrogateBundle.load(args.bundle, device=device)
    n_sims, n_t = dataset_shape(args.dataset)
    n_sims = min(n_sims, args.num_sims or n_sims)
    last_t = min(n_t, args.last_t or n_t)

    for s in range(n_sims):
        ucase = UnstructuredCase.from_hdf5(args.dataset, s, args.delta,
                                           device=device)
        frames = [ucase.fields_from_frame(read_frame(args.dataset, s, t))
                  for t in range(args.first_t, last_t)]
        rep = evaluate_bundle(bundle, ucase.case, frames, stitch=args.stitch,
                              apply_filter=args.apply_filter,
                              weighted=args.weighted)
        print(f"===== sim {s} =====\n{rep.summary()}\n", flush=True)
        if args.save_plots:
            from .utils.plotting import save_eval_plots
            save_eval_plots(ucase.case, bundle, frames, args.plots_dir, sim=s)


def bundle_main(argv=None):
    """Artifact interop with the reference's serving sidecar format
    (python_module.py:103-110): import a reference-trained sidecar dir as a
    bundle, or export a bundle so the reference's embedded serving stack
    (and its offline harness python_module_TEST.py) can run the model
    unchanged. Both conversions stage the bundle on --platform's device."""
    ap = argparse.ArgumentParser("tpufoam-bundle")
    sub = ap.add_subparsers(dest="mode", required=True)

    im = sub.add_parser("import-ref", help="reference sidecar dir -> bundle")
    im.add_argument("--sidecars", required=True,
                    help="dir with ipca_input[_more].pkl, ipca_p[_more].pkl, "
                         "maxs, maxs_PCA, weights.h5/model.h5")
    im.add_argument("--out", required=True, help="bundle output dir")
    im.add_argument("--family", default="deltaU_deltaP")
    im.add_argument("--block-size", type=int, default=128)
    im.add_argument("--overlap", type=float, default=0.25)
    _add_platform_flag(im, distributed=False)

    ex = sub.add_parser("export-ref", help="bundle -> reference sidecar dir")
    ex.add_argument("--bundle", required=True)
    ex.add_argument("--out", required=True, help="sidecar output dir")
    ex.add_argument("--suffix", default="_more",
                    help="ipca pickle suffix (the solver loads "
                         "ipca_*_more.pkl, python_module.py:103-104)")
    _add_platform_flag(ex, distributed=False)

    info = sub.add_parser("info", help="print a bundle's manifest")
    info.add_argument("--bundle", required=True)

    args = ap.parse_args(argv)
    from .surrogate.pipeline import SurrogateBundle

    if args.mode == "import-ref":
        from .surrogate.reference_io import bundle_from_reference_sidecars
        b = bundle_from_reference_sidecars(args.sidecars, family=args.family,
                                           block_size=args.block_size,
                                           overlap_ratio=args.overlap,
                                           device=_apply_platform(args))
        b.save(args.out)
        print(f"imported {args.sidecars} -> {args.out} "
              f"(pc_in={b.pc_in}, pc_out={b.pc_out}, norm={b.norm_method})")
    elif args.mode == "export-ref":
        from .surrogate.reference_io import export_reference_sidecars
        b = SurrogateBundle.load(args.bundle, device=_apply_platform(args))
        scales = export_reference_sidecars(b, args.out, suffix=args.suffix)
        print(f"exported {args.bundle} -> {args.out} "
              f"(maxs_PCA={scales['maxs_PCA']})")
    else:
        import os
        with open(os.path.join(args.bundle, "manifest.json")) as f:
            print(json.dumps(json.load(f), indent=2))
