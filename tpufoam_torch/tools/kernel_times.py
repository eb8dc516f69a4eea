"""Device times of the hand-written kernels on one CUDA card, with the L2
cache flushed before each call: the momentum multisweep, stencil_matvec
and the three multisweep pressure kernels.

    python tpufoam_torch/tools/kernel_times.py [--root DIR] [--reps N]
        [--flush dirty|clean|none] [--variants] [--fleet N]
        [--only momentum,matvec,multisweep,sharded]

`--root` imports `tpufoam_torch` from another checkout (default: the one
this file lies in), so that two trees can be timed in turns in one call on
one card, each built from its own sources. Times, each the least over
`--reps` rounds of the mean over 100 calls, from torch.profiler (the
flush's kernel, a bitwise-not, left out):
  momentum  the kernel at sweeps 1, 2, 4 and 8 on (512, 2048) random
            structured operands, and its batched launch on (4, 512, 2048)
  matvec    stencil_matvec at every level of the 512 x 2048 and 256 x 1375
            multigrid hierarchies, float32 and bfloat16, beside each
            level's bound (six operands read, one written, at 3.35 TB/s),
            on random operands with a solid disc (the cylinder's cells:
            no conductance, diag 1, zero x and b), as the multisweep
            kernels below
  multisweep  jacobi_multisweep, smooth_residual and corr_smooth at every
            kernel level of the 512 x 2048 hierarchy (512 x 2048 .. 16 x
            64), float32 and bfloat16, at the paths' sweeps (float32 1 for
            jacobi_multisweep, 2 elsewhere), 2, 4 and the halo, each beside
            its bound (seven operands read, corr_smooth eight, one written,
            smooth_residual two) and the launch's variant; jacobi_sweep
            with one sweep, the single-pass kernel that computes
            jacobi_multisweep(iters=1); and the three kernels' launch on a
            fleet's stack, (--fleet, 512, 2048) (default 4), float32 and
            bfloat16 at the paths' sweeps, beside --fleet single-case
            launches and --fleet times one plane's bound
  sharded   the two sharded functions (ops.sharded), each whole call, on
            a 2 x 2 mesh of the card at 512 x 2048:
            momentum_multisweep_sharded at 8 sweeps (the sharded step's),
            jacobi_multisweep_sharded in float32 at 1 sweep and in
            bfloat16 at 2 and 16 (the halo), on the operands above; with
            each call's device launches (kernels of any kind) from one
            more profile
`--variants` times stencil_matvec again with the vector and with the cell
variant wherever each can run (`ops.stencil._VECTOR_MIN_CELLS` 0 and
unbounded): the measurement that sets that threshold.
With `multisweep`, `--variants` also times the three multisweep kernels
at every level with the region kernel forced
(`ops.stencil._REGION_BELOW_CELLS` unbounded) beside the launch
`multisweep_geometry` picks, at the paths' sweeps and 2, and where the
run kernel takes a level, its blocks of three rows a thread and 4, 8 or
16 warps, and of one row and 16 warps (`ops.stencil._run_rows`,
`_run_warps`): the measurements that set the geometry.
Each launch's variant is the one the tree's wrapper counted
(`by_shape`).
`--only` times the named sections alone (default: all four).
Prints ptxas' registers, shared memory and spills of the build, the card's
name and power limit, and one JSON line. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_RATE = 3.35e12     # H100 SXM HBM3, bytes/s (published peak)
GRIDS = ((512, 2048), (256, 1375))


def level_shapes(ny, nx, min_size=8):
    """The shapes of `solvers.multigrid.build_hierarchy`."""
    shapes = [(ny, nx)]
    while min(shapes[-1]) >= 2 * min_size:
        y, x = shapes[-1]
        shapes.append(((y + 1) // 2, (x + 1) // 2))
    return shapes


def device_profile(torch, fn, flush, n=100, skip="bitwise_not"):
    """(mean device ms, device launches) per call of fn over n calls, each
    after `flush`; kernels whose name holds `skip` (the flush's) are left
    out."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and skip not in e.key]
    us = sum(e.self_device_time_total for e in events)
    if us <= 0:
        raise SystemExit("kernel_times: torch.profiler saw no device time")
    return us / 1e3 / n, sum(e.count for e in events) / n


def device_ms(torch, fn, flush, n=100, skip="bitwise_not"):
    """Mean device ms per call of fn over n calls (`device_profile`)."""
    return device_profile(torch, fn, flush, n, skip)[0]


# the multisweep kernels: (fields read, fields written, operations per
# cell and sweep, operations per cell once), and the sweeps of each
# dtype on its path (MGCG's float32 V(1,1) for jacobi_multisweep, the
# hybrid's bf16 V(2,2) for the fused legs)
MULTISWEEP = {"jacobi_multisweep": (7, 1, 13, 0),
              "smooth_residual": (7, 2, 13, 10),
              "corr_smooth": (8, 1, 13, 1)}
PATH_SWEEPS = {"jacobi_multisweep": {"f32": 1, "bf16": 2},
               "smooth_residual": {"f32": 2, "bf16": 2},
               "corr_smooth": {"f32": 2, "bf16": 2}}
F32_RATE = 67e12       # H100 SXM float32 outside the tensor cores, op/s
KERNEL_LEVELS = 6      # 512 x 2048 .. 16 x 64; the coarsest is plain


def variant(fn, call):
    """The variant of one launch as the tree's own wrapper counted it:
    the key of `fn.by_shape` that `call` grows (each tree names the
    kernels it has)."""
    before = collections.Counter(fn.by_shape)
    call()
    (key,) = (fn.by_shape - before).keys()
    return key[0]


def multisweep_levels(torch, st, operands, least):
    """{"<kernel> <dtype>": [{shape, iters, variant, ms, bound_ms}, ...]}
    at every kernel level of the 512 x 2048 hierarchy, and jacobi_sweep's
    one sweep beside jacobi_multisweep's."""
    times = {}
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        halo = st._halo_for(dt)
        rows = {name: [] for name in (*MULTISWEEP, "jacobi_sweep")}
        for shape in level_shapes(*GRIDS[0])[:KERNEL_LEVELS]:
            coef, x, b, corr = operands(shape, dt)
            cells, size = x.numel(), x.element_size()
            calls = {
                "jacobi_multisweep": lambda k: st.jacobi_multisweep(
                    coef, x, b, k),
                "smooth_residual": lambda k: st.smooth_residual(
                    coef, x, b, k),
                "corr_smooth": lambda k: st.corr_smooth(coef, x, corr, b,
                                                         k)}
            for name, (n_in, n_out, per_sweep, once) in MULTISWEEP.items():
                top = halo - (name == "smooth_residual")
                for k in sorted({PATH_SWEEPS[name][prec], 2, 4, top}):
                    bound_ms = max((n_in + n_out) * cells * size / MEM_RATE,
                                   (per_sweep * k + once) * cells / F32_RATE
                                   ) * 1e3
                    rows[name].append({
                        "shape": list(shape), "iters": k,
                        "variant": variant(getattr(st, name),
                                           lambda: calls[name](k)),
                        "ms": least(lambda: calls[name](k)),
                        "bound_ms": bound_ms})
            rows["jacobi_sweep"].append({
                "shape": list(shape), "iters": 1,
                "ms": least(lambda: st.jacobi_sweep(coef, x, b, 1)),
                "bound_ms": 8 * cells * size / MEM_RATE * 1e3})
        for name, r in rows.items():
            times[f"{name} {prec}"] = r
    return times


def multisweep_fleet(torch, st, operands, least, n):
    """{"<kernel> <dtype>": {shape, iters, variant, ms, singles_ms,
    bound_ms}}: each multisweep kernel's one launch on n stacked cases of
    512 x 2048 (each case its own operands), beside the n cases launched
    one by one, at the paths' sweeps."""
    import dataclasses

    from tpufoam_torch.fv.pressure import PressureCoeffs
    times = {}
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cases = [operands(GRIDS[0], dt) for _ in range(n)]
        coef = PressureCoeffs(*(
            torch.stack([getattr(c[0], f.name) for c in cases])
            for f in dataclasses.fields(PressureCoeffs)))
        x, b, corr = (torch.stack([c[i] for c in cases]) for i in (1, 2, 3))
        calls = {
            "jacobi_multisweep": lambda cf, x_, b_, c_, k:
                st.jacobi_multisweep(cf, x_, b_, k),
            "smooth_residual": lambda cf, x_, b_, c_, k:
                st.smooth_residual(cf, x_, b_, k),
            "corr_smooth": lambda cf, x_, b_, c_, k:
                st.corr_smooth(cf, x_, c_, b_, k)}
        for name, (n_in, n_out, per_sweep, once) in MULTISWEEP.items():
            k, call = PATH_SWEEPS[name][prec], calls[name]
            cells, size = x.numel(), x.element_size()
            times[f"{name} {prec}"] = {
                "shape": list(x.shape), "iters": k,
                "variant": variant(getattr(st, name),
                                   lambda: call(coef, x, b, corr, k)),
                "ms": least(lambda: call(coef, x, b, corr, k)),
                "singles_ms": least(lambda: [call(c[0], c[1], c[2], c[3], k)
                                             for c in cases]),
                "bound_ms": max((n_in + n_out) * cells * size / MEM_RATE,
                                (per_sweep * k + once) * cells / F32_RATE)
                * 1e3}
        del cases, coef, x, b, corr
    return times


def multisweep_variants(torch, st, operands, least):
    """The three multisweep kernels at every kernel level, at the paths'
    sweeps and 2: the launch the tree picks, the region kernel forced,
    and where the run kernel takes the level, its blocks of three rows a
    thread and 4, 8 or 16 warps, and where the tree has them, of one row
    and 16 warps."""
    saved = {k: getattr(st, k) for k in (
        "_REGION_BELOW_CELLS", "_run_warps", "_ONE_ROW_MAX_HALO")
        if hasattr(st, k)}
    rows_of = "_ONE_ROW_MAX_HALO" in saved
    times = {}
    try:
        for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for shape in level_shapes(*GRIDS[0])[:KERNEL_LEVELS]:
                coef, x, b, corr = operands(shape, dt)
                calls = {
                    "jacobi_multisweep": lambda k: st.jacobi_multisweep(
                        coef, x, b, k),
                    "smooth_residual": lambda k: st.smooth_residual(
                        coef, x, b, k),
                    "corr_smooth": lambda k: st.corr_smooth(coef, x, corr,
                                                             b, k)}
                for name, call in calls.items():
                    for k in sorted({PATH_SWEEPS[name][prec], 2}):
                        picked = variant(getattr(st, name),
                                         lambda: call(k))
                        row = {"shape": list(shape), "iters": k,
                               "variant": picked,
                               "ms": least(lambda: call(k))}
                        st._REGION_BELOW_CELLS = 1 << 62
                        row["region_ms"] = least(lambda: call(k))
                        st._REGION_BELOW_CELLS = saved["_REGION_BELOW_CELLS"]
                        halo = k + (name == "smooth_residual")
                        blocks = [(3, w) for w in (4, 8, 16)]
                        if rows_of:
                            blocks.append((1, 16))
                        for rows, w in blocks if picked == "run" else ():
                            if w * rows <= 2 * halo:
                                continue          # no tile
                            st._run_warps = lambda h, r=3, w=w: w
                            if rows_of:      # one row everywhere, or none
                                st._ONE_ROW_MAX_HALO = 99 if rows == 1 \
                                    else -1
                            row[f"run {rows} rows {w} warps"] = least(
                                lambda: call(k))
                            for key, v in saved.items():
                                setattr(st, key, v)
                        times.setdefault(f"{name} {prec}", []).append(row)
    finally:
        for k, v in saved.items():
            setattr(st, k, v)
    return times


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--flush", choices=["dirty", "clean", "none"],
                    default="dirty",
                    help="dirty: overwrite 96 MiB (bitwise-not in place, "
                    "as chip_smoke.py), leaving the L2 full of dirty lines; "
                    "clean: read 96 MiB (a max), leaving it full of clean "
                    "ones; none: no flush (the operands warm in L2, as a "
                    "coarse level's are on the multigrid's path)")
    ap.add_argument("--variants", action="store_true",
                    help="also time the matvec with each variant forced "
                    "wherever it can run")
    ap.add_argument("--fleet", type=int, default=4,
                    help="cases of the multisweep kernels' stacked launch")
    ap.add_argument("--only", default="momentum,matvec,multisweep,sharded",
                    help="comma-separated sections to time")
    args = ap.parse_args()
    sections = set(args.only.split(","))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from tpufoam_torch.fv.pressure import PressureCoeffs
    from tpufoam_torch.ops import build
    from tpufoam_torch.ops import momentum as mom
    from tpufoam_torch.ops import stencil as st

    dev = torch.device("cuda")
    ptxas = {}
    for name in ("momentum_multisweep", "pressure_stencil"):
        log = build.build(name)[1]
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling entry" in ln or "smem" in ln]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    junk = torch.zeros(96 << 20, dtype=torch.uint8, device=dev)
    flush, skip = {"dirty": (junk.bitwise_not_, "bitwise_not"),
                   "clean": (junk.max, "reduce_kernel"),
                   "none": (lambda: None, "no kernel has this name")}[
                       args.flush]
    rng = np.random.default_rng(0)

    def field(lo, hi, shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(
            np.float32), device=dev)

    def momentum_ops(shape):
        a = [field(0, 1, shape) for _ in range(4)]
        fluid = (field(0, 1, shape) > 0.02).float()
        api = fluid / (a[0] + a[1] + a[2] + a[3] + field(0.5, 2.0, shape))
        return (*a, api, field(-1, 1, shape), field(-1, 1, shape),
                field(-1, 1, shape) * fluid, field(-1, 1, shape) * fluid)

    def least(fn):
        return min(device_ms(torch, fn, flush, skip=skip)
                   for _ in range(args.reps))

    out = {"root": root, "card": card, "flush": args.flush, "ptxas": ptxas}
    # a yardstick of the rate this protocol allows: one copy that reads
    # and writes as many bytes as the f32 matvec at 512 x 2048 moves
    src = torch.empty(7 * 512 * 2048 // 2, device=dev)
    dst = torch.empty_like(src)
    copy_ms = least(lambda: dst.copy_(src))
    out["copy"] = {"bytes": 2 * src.numel() * 4, "ms": copy_ms,
                   "bytes_per_s": 2 * src.numel() * 4 / copy_ms * 1e3}
    del src, dst
    if "momentum" in sections:
        out["momentum"] = {}
        ops = momentum_ops((512, 2048))
        for sweeps in (1, 2, 4, 8):
            out["momentum"][f"sweeps {sweeps}"] = least(
                lambda: mom.momentum_multisweep(*ops, sweeps=sweeps))
        fleet = momentum_ops((4, 512, 2048))
        out["momentum"]["batched 4x512x2048"] = least(
            lambda: mom.momentum_multisweep(*fleet, sweeps=8))
        del ops, fleet

    def pressure_operands(shape, dt):
        """Conductances in [0, 1), diag above their sum, x, b and a
        correction, in `dt`; and a solid disc, as the channel's cylinder
        (a quarter of the height across, a quarter of the length in): no
        conductance, diag 1, x = b = correction = 0 there, so that the
        sweeps divide zeros by diag in those cells, as on the path."""
        ny, nx = shape
        y = torch.arange(ny, device=dev)[:, None] - ny / 2
        x = torch.arange(nx, device=dev)[None] - nx / 4
        fluid = (y * y + x * x >= (ny / 8) ** 2).float()
        c = [field(0, 1, shape) * fluid for _ in range(4)]
        diag = (c[0] + c[1] + c[2] + c[3] + field(0.1, 1, shape)) * fluid \
            + (1 - fluid)
        coef = PressureCoeffs(*(t.to(dt) for t in c),
                              torch.zeros_like(diag, dtype=dt), diag.to(dt))
        return (coef, *((field(lo, -lo, shape) * fluid).to(dt)
                        for lo in (-1, -1, -0.1)))

    def matvec_levels():
        times = {}
        for ny, nx in GRIDS:
            for prec, dt in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
                rows = []
                for shape in level_shapes(ny, nx):
                    coef, x, _, _ = pressure_operands(shape, dt)
                    size = x.element_size()
                    rows.append({
                        "shape": list(shape),
                        "ms": least(lambda: st.stencil_matvec(coef, x)),
                        "bound_ms": 7 * x.numel() * size / MEM_RATE * 1e3})
                times[f"{ny}x{nx} {prec}"] = rows
        return times

    if "sharded" in sections:
        from tpufoam_torch.ops import sharded as sh
        from tpufoam_torch.parallel.mesh import device_mesh

        mesh = device_mesh(4, shape=(2, 2), devices=[dev] * 4)
        ops = momentum_ops((512, 2048))
        calls = {"momentum 8 sweeps": lambda: sh.momentum_multisweep_sharded(
            mesh, *ops, sweeps=8)}
        for prec, dt, iters in (("f32", torch.float32, 1),
                                ("bf16", torch.bfloat16, 2),
                                ("bf16", torch.bfloat16, 16)):
            coef, x, b, _ = pressure_operands((512, 2048), dt)
            calls[f"jacobi {prec} {iters} sweeps"] = (
                lambda coef=coef, x=x, b=b, iters=iters:
                sh.jacobi_multisweep_sharded(mesh, coef, x, b, iters))
        out["sharded 2x2 512x2048"] = {
            name: {"ms": least(call), "launches_per_call": device_profile(
                torch, call, flush, n=10, skip=skip)[1]}
            for name, call in calls.items()}
        del ops, calls
    if "matvec" in sections:
        out["matvec"] = matvec_levels()
    if "multisweep" in sections:
        out["multisweep"] = multisweep_levels(torch, st, pressure_operands,
                                              least)
        if st.kernel_available_for((2, 8, 32), kernel="jacobi"):
            # a tree whose multisweep kernels take a stack
            out[f"multisweep fleet {args.fleet}"] = multisweep_fleet(
                torch, st, pressure_operands, least, args.fleet)
    if args.variants and "multisweep" in sections:
        out["multisweep variants"] = multisweep_variants(
            torch, st, pressure_operands, least)
    if args.variants and "matvec" in sections:
        threshold = st._VECTOR_MIN_CELLS
        for name, cells in (("vector", 0), ("cell", 1 << 62)):
            st._VECTOR_MIN_CELLS = cells
            out[f"matvec {name}"] = matvec_levels()
        st._VECTOR_MIN_CELLS = threshold
    print(card)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
