"""The program's spans and host reads in one cell, and what they cost.

    python3 cfdbench/span_probe.py --workload <cell> --seed <n>
        [--rounds 8] [--steps 8] [--sync-steps 2] [--out DIR]
        [--device cpu --rehearse]

Builds the cell as `run.py` does and warms it up, then, in one process:

1. `sync`: `--sync-steps` steps under torch.cuda.set_sync_debug_mode
   ("warn"): the synchronising calls it reports, by source line, against
   the calls `tpufoam_torch.utils.profiling.host_read` counted (a CUDA
   device only);
2. `overhead`: untraced steps with the program's spans off and on, in
   blocks of `--steps`, `--rounds` of each, alternated (off, on, on,
   off, ...), each step timed as `run.py` times its window; the span
   table of the blocks with spans on (host time and self time a step);
   the host cost of one empty span, off and on, and the share of a step
   it makes at the step's count of spans;
3. `traced`: the cell's `trace_steps` steps under torch.profiler with
   spans on, each entry call inside the range `cfdbench.entry` and
   followed by the gates, reduced by `spans.reduce`: device ms a step of
   the kernels launched inside each span (inclusive and self), the idle
   gaps by span, the launches, and the counters' deltas (V-cycles,
   rescue solves and the cases they served, host reads).

`metrics` holds five per-layer numbers as a benchmark would read them:
`fv_device_ms_per_step`, `safeguard_device_ms_per_step`,
`rescue_useful_share`, `host_reads_per_step` and `host_busy_share` (the
spans-on blocks' host time in `piso.step` less that in `host_read`,
over their step time). Device numbers are absent on the CPU. Prints one
JSON line; with a CUDA device also writes it to
DIR/span_probe_<cell>_<seed>.json (DIR: chiprun_out/ of the checkout).
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from collections import Counter  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from cfdbench import check, run, spans, spec, traffic  # noqa: E402

FV = ("piso.dt", "fv.momentum_assembly", "fv.pressure_assembly",
      "fv.correct")


def _counters():
    from tpufoam_torch.piso import engine
    from tpufoam_torch.solvers import multigrid
    from tpufoam_torch.utils import profiling
    rescue = engine._rescue_if_unconverged
    return {"v_cycles": multigrid.v_cycle.cycles, "solves": rescue.solves,
            "cases": rescue.cases, "host_reads": profiling.host_read.count}


def _delta(a, b):
    return {k: b[k] - a[k] for k in a}


def _sync_phase(prog, flow, n):
    from tpufoam_torch.utils import profiling
    torch.cuda.synchronize()
    n0 = profiling.host_read.count
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(n):
                flow = prog.step(flow)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in rec if "synchroniz" in str(w.message).lower()]
    sites = Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                    for w in syncs)
    return flow, {"steps": n, "syncs": len(syncs),
                  "host_reads": profiling.host_read.count - n0,
                  "sites": sites.most_common(40)}


def _overhead_phase(prog, flow, device, rounds, steps):
    from tpufoam_torch.utils import profiling
    profiling.reset_spans()
    blocks = []
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            profiling.enable_spans(on)
            clock = run._Clock(device)
            clock.mark()
            for _ in range(steps):
                flow = prog.step(flow)
                clock.mark()
            run._sync(device)
            blocks.append((on, sum(clock.step_ms()) / steps))
    profiling.enable_spans(False)
    table = profiling.span_table()
    ms = {on: [m for o, m in blocks if o == on] for on in (False, True)}
    n_on = steps * len(ms[True])
    per_step = {n[len(profiling.PREFIX):]: {
        "count": v["count"] / n_on, "host_ms": v["host_s"] * 1e3 / n_on,
        "self_ms": v["self_s"] * 1e3 / n_on} for n, v in table.items()}
    off, on = statistics.mean(ms[False]), statistics.mean(ms[True])
    # each round's on block against its off block
    pairs = [100.0 * (b / a - 1.0) for a, b in zip(ms[False], ms[True])]
    cost = _span_cost()
    n_spans = sum(v["count"] for v in per_step.values())
    return flow, {"steps_per_block": steps, "blocks": blocks,
                  "step_ms_off": off, "step_ms_on": on,
                  "cost_pct": 100.0 * (on / off - 1.0),
                  "cost_pct_by_round": pairs,
                  "span_us": cost, "spans_per_step": n_spans,
                  "span_cost_pct": 100.0 * n_spans * (cost["on"]
                                                      - cost["off"])
                  / 1e3 / off,
                  "span_table_per_step": per_step}


def _span_cost(n=200_000) -> dict:
    """Host microseconds of one empty `with span(...)`, spans off and on
    (no profiler session)."""
    from tpufoam_torch.utils import profiling
    out = {}
    for on in (False, True):
        profiling.enable_spans(on)
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("tpufoam_torch.probe"):
                pass
        out["on" if on else "off"] = (time.perf_counter() - t0) / n * 1e6
    profiling.enable_spans(False)
    profiling.reset_spans()
    return out


def _traced_phase(prog, flow, device, n, gates):
    from torch.profiler import ProfilerActivity, profile

    from tpufoam_torch.utils import profiling
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device == "cuda" else [])
    profiling.enable_spans(True)
    c0 = _counters()
    with profile(activities=acts) as prof:
        for _ in range(n):
            with torch.profiler.record_function("cfdbench.entry"):
                new = prog.step(flow)
            gates(flow, new)
            flow = new
        run._sync(device)
    profiling.enable_spans(False)
    d = _delta(c0, _counters())
    cpu, kernels = spans.events(prof)
    red = spans.reduce(cpu, kernels)
    in_entry, launches = spans.launched_in(cpu, kernels, "cfdbench.entry")
    step = red["spans"].get("tpufoam_torch.piso.step", {})
    busy, end = 0, 0
    for s, e in sorted((k[0], k[1]) for k in kernels):
        busy += max(0, e - max(s, end))
        end = max(end, e)
    return flow, {
        "steps": n, "counters": d, "busy_ms_per_step": busy / 1e6 / n,
        "launches_per_step": launches / n,
        "launches_in_entry": in_entry,
        "launches_in_step": step.get("launches", 0),
        "outside_spans": red["outside"],
        "spans_ms_per_step": {
            k[len(profiling.PREFIX):]: {
                "launches": v["launches"] / n,
                "device_ms": v["device_s"] * 1e3 / n,
                "self_ms": v["self_s"] * 1e3 / n}
            for k, v in sorted(red["spans"].items())},
        "idle_gaps_by_span_s": red["idle_gaps_by_span"],
    }


def _metrics(out, cases):
    tr, ov = out["traced"], out["overhead"]
    sp, d, n = tr["spans_ms_per_step"], tr["counters"], tr["steps"]
    m = {}
    if sp.get("piso.step", {}).get("device_ms"):
        m["fv_device_ms_per_step"] = sum(sp.get(k, {}).get("device_ms", 0.0)
                                         for k in FV)
        if "piso.safeguard" in sp:
            m["safeguard_device_ms_per_step"] = sp["piso.safeguard"][
                "device_ms"]
    if d["solves"]:
        m["rescue_useful_share"] = 100.0 * d["cases"] / (d["solves"]
                                                         * cases)
    m["host_reads_per_step"] = d["host_reads"] / n
    t = ov["span_table_per_step"]
    if "piso.step" in t:
        m["host_busy_share"] = 100.0 * (
            t["piso.step"]["host_ms"]
            - t.get("host_read", {}).get("host_ms", 0.0)) / ov["step_ms_on"]
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--sync-steps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.rehearse:
        ap.error("--device cpu runs only the rehearsal (--rehearse)")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("cfdbench: span_probe needs a CUDA device", file=sys.stderr)
        return 2
    _, _, config, wl = spec.cell(args.workload)
    if args.rehearse:
        config = {**config, "grid": {**config["grid"],
                                     **run.REHEARSAL["grid"]}}
        wl = {**wl, **run.REHEARSAL["mix"]}
        torch.set_num_threads(1)
    device = args.device
    members = traffic.cases(wl, args.seed)
    prog = run.Program(config, wl, members, device)
    flow, prog.flow = prog.flow, None
    for _ in range(int(wl["warmup_steps"])):
        flow = prog.step(flow)
    run._sync(device)
    g = config["grid"]
    gates = check.Gates(prog.case.fluid, prog.case.alpha,
                        g["height"] / g["ny"], g["length"] / g["nx"])
    cases = prog.case.fluid.shape[0] if prog.fleet else 1
    out = {"workload": args.workload, "seed": args.seed, "cases": cases,
           "setup_s": time.time() - T0}
    if device == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[:1]
        flow, out["sync"] = _sync_phase(prog, flow, args.sync_steps)
    flow, out["overhead"] = _overhead_phase(prog, flow, device, args.rounds,
                                            args.steps)
    flow, out["traced"] = _traced_phase(prog, flow, device,
                                        int(wl["trace_steps"]), gates)
    out["metrics"] = _metrics(out, cases)
    out["cycles_check"] = {
        "backend_cycles": config["backend"].get("cycles"),
        "n_correctors": config["piso"]["n_correctors"],
        "rescue_solves_per_step": out["traced"]["counters"]["solves"]
        / out["traced"]["steps"],
        "v_cycles_per_step": out["traced"]["counters"]["v_cycles"]
        / out["traced"]["steps"]}
    line = json.dumps(out)
    if device == "cuda":
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"span_probe_{args.workload}_"
                               f"{args.seed}.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
