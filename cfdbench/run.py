"""The benchmark of tpufoam_torch, the PyTorch and CUDA port.

    python3 cfdbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

One run is one process: it loads the cell's files by name (spec), builds
the cases from the seed (traffic), warms the step up, measures a closed
loop of the cell's entry for `--seconds` (at least the cell's
`min_steps`), checks `correct` (check) and prints one JSON line last.
`--trace 1` runs, in place of the window, `probe_steps` untraced steps
with the program's spans off (the step's time), `span_steps` untraced
steps with spans on (the spans' host times) and `trace_steps` steps under
torch.profiler with spans on, and prints the per-layer metrics
(metrics/<name>.py) with a breakdown. The window of `--trace 0` runs
with spans off. The
run needs as many CUDA devices as the cell asks for, and exits with 2
otherwise; `--device cpu` rehearses the whole run on the CPU (the
program's plain versions), which no measurement uses.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every cache of a run at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, ".cfdbench_cache", _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cfdbench import check, spec, trace, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpufoam")
# the rehearsal's sizes: a 128 x 960 grid (the surrogate's blocks are
# 128 wide), one case of each class, a few steps
REHEARSAL = {"grid": {"ny": 128, "nx": 960},
             "mix": {"per_class": 1, "warmup_steps": 2, "min_steps": 3,
                     "probe_steps": 2, "span_steps": 2, "trace_steps": 2}}
GiB = 2 ** 30


class _Clock:
    """Step boundaries: CUDA events recorded on the stream (read after
    the window, no synchronisation added), or the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m[:-1], m[1:])]


def _log(msg: str):
    print(f"cfdbench: {msg}", file=sys.stderr, flush=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _fields(obj, names, k=None):
    """Named tensors of a Case or Flow, of fleet member k if given."""
    return {f: (getattr(obj, f) if k is None else getattr(obj, f)[k])
            for f in names}


class Program:
    """The system under test, set up from the cell's files and the seed:
    the stacked cases (or the one case), their initial state, the
    predictor (whose counters the traced run reads) and its bound form,
    the pressure backend and one step of the cell's entry. The
    configuration's `geometry` and `surrogate` options reach the program
    whole (spec.geometry_options, spec.surrogate_options): a key it does
    not take fails the build."""

    def __init__(self, config: dict, workload: dict, members: list,
                 device):
        from tpufoam_torch.core.geometry import channel_case_geometry
        from tpufoam_torch.fv.case import build_channel_case, initial_flow
        from tpufoam_torch.piso.batched import (run_piso_batched_eager,
                                                stack_cases, stack_flows)
        from tpufoam_torch.piso.engine import PisoConfig, run_piso_eager
        from tpufoam_torch.solvers import backends
        from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                      make_predictor)

        g = config["grid"]
        delta = g["height"] / g["ny"]
        cases = [build_channel_case(channel_case_geometry(
            shape, length=g["length"], height=g["height"],
            obstacle_size=size, cx=spec.obstacle_x(config, size),
            nu=config["nu"], **spec.geometry_options(config)),
            delta=delta, device=device)
            for shape, size in members]
        if (cases[0].grid.ny, cases[0].grid.nx) != (g["ny"], g["nx"]):
            raise SystemExit("cfdbench: the case's grid is not the "
                             "configuration's")
        flows = [initial_flow(c, dt0=config["dt0"]) for c in cases]
        self.fleet = workload["entry"] == "fleet"
        if self.fleet:
            self.case, self.flow = stack_cases(cases), stack_flows(flows)
            self.entry = run_piso_batched_eager
        else:
            self.case, self.flow = cases[0], flows[0]
            self.entry = run_piso_eager
        del cases, flows
        self.cfg = PisoConfig(**config["piso"])
        self.backend = spec.backend(backends, config["backend"])
        sm = config["surrogate"]
        bundle = SurrogateBundle.load(os.path.join(ROOT, sm["bundle"]),
                                      device=device)
        spec.check_family(bundle.family, sm)
        self.predictor = make_predictor(bundle,
                                        **spec.surrogate_options(config))
        self.predict = self.predictor.bind(self.case)

    def step(self, flow, backend=None, predict=None):
        return self.entry(self.case, flow, 1, cfg=self.cfg,
                          backend=backend or self.backend,
                          sm_predict=predict or self.predict)

    def index(self, k):
        """Case k's index on the fleet axis (None: a single case)."""
        return k if self.fleet else None

    def member(self, obj, names, k, device):
        """Copies, on `device`, of case k's named tensors of a Case or
        Flow."""
        return {f: t.to(device, copy=True) for f, t in
                _fields(obj, names, self.index(k)).items()}


def _ranges(prog, calls):
    """Open the benchmark's ranges in the program for a traced window:
    around the bound predictor and the backend it is handed, and around
    the module attributes its callers look up for the momentum multisweep
    and the pressure matvec. Returns (backend, predictor, undo)."""
    import tpufoam_torch.fv.momentum as fvm
    import tpufoam_torch.ops.stencil as st

    def on_momentum(args, kwargs):
        calls["momentum_multisweep"].append(
            (args[0].numel(), "f32", kwargs.get("sweeps", 8)))

    def on_matvec(args, kwargs):
        x = args[1]
        calls["stencil_matvec"].append(
            (x.numel(), "bf16" if x.dtype == torch.bfloat16 else "f32", 1))

    saved = (fvm.momentum_multisweep, st.stencil_matvec)
    fvm.momentum_multisweep = trace.Ranged(saved[0], "momentum_multisweep",
                                           on_momentum)
    st.stencil_matvec = trace.Ranged(saved[1], "stencil_matvec", on_matvec)

    def undo():
        fvm.momentum_multisweep, st.stencil_matvec = saved

    return (trace.Ranged(prog.backend, "pressure"),
            trace.Ranged(prog.predict, "surrogate"), undo)


def _readers(names: list) -> dict:
    out = {}
    for name in names:
        path = os.path.join(HERE, "metrics", f"{name}.py")
        mod_spec = importlib.util.spec_from_file_location(
            f"cfdbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def _bundle_manifest(config: dict) -> dict:
    with open(os.path.join(ROOT, config["surrogate"]["bundle"],
                           "manifest.json")) as f:
        m = json.load(f)
    m["n_in"] = spec.reference(config).pipeline.FAMILIES[m["family"]].n_in
    return m


def _counters(predictor) -> dict:
    """The program's counters that the per-layer metrics read: host reads
    (and uploads), the safeguard's rescue solves and the cases they
    served, the predictor's calls and the cases its CUDA graphs
    predicted."""
    from tpufoam_torch.piso import engine
    from tpufoam_torch.utils import profiling
    rescue = engine._rescue_if_unconverged
    return {"host_reads": profiling.host_read.count,
            "rescue_solves": rescue.solves, "rescue_cases": rescue.cases,
            "predictor_calls": predictor.calls,
            "graph_replays": predictor.graph_replays}



def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", control: bool = False,
             min_steps: int | None = None, hooks=None,
             rehearse: bool = False) -> dict:
    """One run of the cell `name`; returns the result object (its
    `checks` last). `control` puts the reference with its state in
    bfloat16 in the program's place for the check; `min_steps` overrides
    the cell's; `hooks(program)` may replace the program's step (the
    harness's own tests break it); `rehearse` shrinks the cell to
    REHEARSAL's sizes (the CPU rehearsal and tests)."""
    entry, _, config, wl = spec.cell(name)
    if rehearse:
        config = {**config, "grid": {**config["grid"],
                                     **REHEARSAL["grid"]}}
        wl = {**wl, **REHEARSAL["mix"]}
    members = traffic.cases(wl, seed)
    n_min = int(min_steps if min_steps is not None else wl["min_steps"])
    n_window = int(wl["trace_steps"]) if traced else n_min
    picked = traffic.check_cases(wl, seed, members)

    prog = Program(config, wl, members, device)
    _sync(device)
    _log(f"set-up: cases, bundle and stitch operators at "
         f"{time.time() - T0:.2f} s")
    if device == "cuda":
        # the peak is the stepping's: the case build's transient SDF
        # chunks are left out
        torch.cuda.reset_peak_memory_stats()
    if hooks is not None:
        hooks(prog)
    g = config["grid"]
    gates = check.Gates(prog.case.fluid, prog.case.alpha,
                        g["height"] / g["ny"], g["length"] / g["nx"])

    # set-up: warm-up steps past the impulsive start; the first one's
    # state and calls are kept (on the host) for the check of the start
    rec = check.Recorder(prog.backend, prog.predict)
    flow = prog.step(prog.flow, rec.backend, rec.predict)
    start = ({k: prog.member(flow, check.FLOW_FIELDS, k, "cpu")
              for k in picked},
             {k: rec.member(prog.index(k), "cpu") for k in picked})
    del rec
    prog.flow = None
    for _ in range(int(wl["warmup_steps"]) - 1):
        flow = prog.step(flow)
    _sync(device)
    _log(f"set-up: {wl['warmup_steps']} warm-up steps done at "
         f"{time.time() - T0:.2f} s")
    from tpufoam_torch.solvers import multigrid
    from tpufoam_torch.utils import profiling

    clock, rows = _Clock(device), []
    backend, predict, undo, prof = prog.backend, prog.predict, None, None
    calls = {"momentum_multisweep": [], "stencil_matvec": []}
    probe_s = span_host = counters0 = None
    if traced:
        counters0 = _counters(prog.predictor)
        # untraced steps, timed as the window times them, with spans off:
        # the step's time without the profiler's or the spans' overhead
        probe = _Clock(device)
        probe.mark()
        for _ in range(int(wl["probe_steps"])):
            flow = prog.step(flow)
            probe.mark()
        _sync(device)
        probe_s = sum(probe.step_ms()) / 1e3 / int(wl["probe_steps"])
        # untraced steps with the program's spans on: their host times
        profiling.reset_spans()
        profiling.enable_spans(True)
        on = _Clock(device)
        on.mark()
        for _ in range(int(wl["span_steps"])):
            flow = prog.step(flow)
            on.mark()
        _sync(device)
        span_host = {"steps": int(wl["span_steps"]),
                     "step_s": sum(on.step_ms()) / 1e3
                     / int(wl["span_steps"]),
                     "spans": profiling.span_table()}
        # the traced steps keep spans on: the profiler puts each kernel
        # under the span that launched it
        from torch.profiler import ProfilerActivity, profile
        backend, predict, undo = _ranges(prog, calls)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        _sync(device)
    cycles0 = multigrid.v_cycle.cycles
    # no collector pauses inside the window (tensors are freed by their
    # counts; what the collector would find waits until the window ends)
    gc.collect()
    gc.disable()
    t_start = time.time()
    setup_s = t_start - T0
    steps, peak = 0, 0
    while True:
        # the last step of the window: its calls are recorded for the
        # check, and the peak memory is read before it
        last = steps + 1 >= n_window and (
            traced or time.time() - t_start >= seconds)
        if last:
            peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                    else 0)
            rec = check.Recorder(backend, predict)
        clock.mark()
        new = prog.step(flow, *((rec.backend, rec.predict) if last
                                else (backend, predict)))
        rows.append(gates(flow, new))
        if last:
            break
        flow, steps = new, steps + 1
    steps += 1
    clock.mark()
    _sync(device)
    window_s = time.time() - t_start
    gc.enable()
    v_cycles = multigrid.v_cycle.cycles - cycles0
    if traced:
        prof.__exit__(None, None, None)
        profiling.enable_spans(False)
        undo()
        counters = {k: v - counters0[k]
                    for k, v in _counters(prog.predictor).items()}
        counters["steps"] = (int(wl["probe_steps"])
                             + int(wl["span_steps"]) + steps)
        _log(f"the program's counters over the traced run's steps: "
             f"{counters}")
        _log(f"the profiler's overhead: {window_s / steps * 1e3:.1f} ms a "
             f"traced step against {probe_s * 1e3:.1f} ms untraced")
    step_ms = clock.step_ms()
    rows = torch.stack(rows)
    failed, gate_checks = check.gate_failures(rows, config)
    cases = prog.case.fluid.shape[0] if prog.fleet else 1
    attempted = steps * cases
    data = trace.read(prof) if traced else None

    # the check, once the program's state is freed: what it keeps is the
    # case, the window's last step (its state before and after, its
    # recorded calls) and the first step's copies
    case, index = prog.case, prog.index
    del prog, backend, predict, prof, rows, gates

    def each(obj, names):
        return lambda k: {f: t.to(device, copy=True) for f, t in
                          _fields(obj, names, index(k)).items()}

    def kept(d):
        return lambda k: {f: t.to(device) for f, t in d[k].items()}

    def kept_calls(k):
        v = start[1][k]
        return {"solves": [({f: t.to(device) for f, t in c.items()},
                            r.to(device), x.to(device), o.to(device))
                           for c, r, x, o in v["solves"]],
                "preds": [(p.to(device),
                           {f: t.to(device) for f, t in a.items()},
                           o.to(device)) for p, a, o in v["preds"]]}

    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.time()
    gaps = check.reference_gaps(
        config, members, each(case, check.CASE_FIELDS),
        [("start", picked, None, kept(start[0]), kept_calls),
         ("window", list(range(cases)), each(flow, check.FLOW_FIELDS),
          each(new, check.FLOW_FIELDS),
          lambda k: rec.member(index(k), device))], device,
        control=control)
    _log(f"check: the reference took {time.time() - t_check:.2f} s")
    del case, flow, new, rec
    limits = wl["limits"]
    checks = {k: [gaps[k], limits[k]] for k in check.LIMITED}
    checks.update(gate_checks)
    correct = failed == 0 and all(v <= lim for v, lim in
                                  (checks[k] for k in check.LIMITED))

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    grid_cells = g["ny"] * g["nx"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed}
    if not traced:
        values = {
            "cell_steps_per_s": cases * grid_cells * steps / window_s / 1e6,
            "step_ms_p90": float(np.percentile(step_ms, 90)),
            "peak_mem_GiB": peak / GiB,
            "setup_s": setup_s,
        }
        wanted = spec.metrics_of(name, "end_to_end")
    else:
        d = {"steps": steps, "window_s": window_s, "cases": cases,
             "probe_step_s": probe_s, "config": config,
             "bundle": _bundle_manifest(config), "v_cycles": v_cycles,
             "calls": calls, "trace": data, "spans": data["spans"],
             "span_host": span_host, "counters": counters}
        wanted = spec.metrics_of(name, "per_layer")
        readers = _readers([m["name"] for m in wanted])
        values = {n: r(d) for n, r in readers.items()}
        if device == "cuda":
            dev["busy_s"] = data["busy_s"]
            dev["window_s"] = window_s
            result["breakdown"] = {
                "device_ops": data["device_ops"],
                "idle_gaps": data["idle_gaps"],
                "spans": sorted(([n, v["device_s"]] for n, v in
                                 data["spans"].items()),
                                key=lambda r: -r[1])[:10],
                "idle_gaps_by_span": data["idle_gaps_by_span"][:10]}
    result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                     "unit": m["unit"]}
                         for m in wanted if values.get(m["name"]) is not None}
    result["device"] = dev
    result["checks"] = checks
    result["_window"] = {"steps": steps, "window_s": window_s,
                         "seconds": seconds, "picked": picked,
                         "members": members}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rehearse", action="store_true",
                    help="the cell at the rehearsal's sizes (with --device "
                    "cpu)")
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.rehearse:
        ap.error("--device cpu runs only the rehearsal (--rehearse)")
    entry = spec.cell(args.workload)[0]
    if args.device == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cfdbench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); this machine has {n}", file=sys.stderr)
        return 2
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
        print(f"cfdbench: card {card[:entry['chips']]}", file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), args.device,
                      rehearse=args.rehearse)
    leaked = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if leaked:
        print(f"cfdbench: the run loaded {leaked}; nothing it runs may "
              f"load JAX or the JAX package", file=sys.stderr)
        return 3
    w = result.pop("_window")
    print(f"cfdbench: {args.workload} seed {args.seed}: {w['steps']} steps "
          f"in a window of {w['window_s']:.3f} s; checked cases "
          f"{w['picked']} in the first step and every case in the "
          f"window's last",
          flush=True)
    for k, (v, lim) in result["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
