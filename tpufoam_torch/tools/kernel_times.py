"""Device times of the two kernels of the hybrid main path on one CUDA
card, with the L2 cache flushed before each call: the momentum multisweep
and stencil_matvec.

    python tpufoam_torch/tools/kernel_times.py [--root DIR] [--reps N]
        [--flush dirty|clean|none] [--variants]

`--root` imports `tpufoam_torch` from another checkout (default: the one
this file lies in), so that two trees can be timed in turns in one call on
one card, each built from its own sources. Times, each the least over
`--reps` rounds of the mean over 100 calls, from torch.profiler (the
flush's kernel, a bitwise-not, left out):
  momentum  the kernel at sweeps 1, 2, 4 and 8 on (512, 2048) random
            structured operands, its batched launch on (4, 512, 2048), and
            the sharded step's per-card launch on four haloed 272 x 1040
            blocks
  matvec    stencil_matvec at every level of the 512 x 2048 and 256 x 1375
            multigrid hierarchies, float32 and bfloat16, beside each
            level's bound (six operands read, one written, at 3.35 TB/s)
`--variants` times stencil_matvec again with the vector and with the cell
variant wherever each can run (`ops.stencil._VECTOR_MIN_CELLS` 0 and
unbounded): the measurement that sets that threshold.
Prints ptxas' registers, shared memory and spills of the build, the card's
name and power limit, and one JSON line. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
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


def device_ms(torch, fn, flush, n=100, skip="bitwise_not"):
    """Mean device ms per call of fn over n calls, each after `flush`;
    kernels whose name holds `skip` (the flush's) are left out."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and skip not in e.key)
    if us <= 0:
        raise SystemExit("kernel_times: torch.profiler saw no device time")
    return us / 1e3 / n


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
    args = ap.parse_args()
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

    out = {"root": root, "card": card, "flush": args.flush, "ptxas": ptxas,
           "momentum": {}, "matvec": {}}
    # a yardstick of the rate this protocol allows: one copy that reads
    # and writes as many bytes as the f32 matvec at 512 x 2048 moves
    src = torch.empty(7 * 512 * 2048 // 2, device=dev)
    dst = torch.empty_like(src)
    copy_ms = least(lambda: dst.copy_(src))
    out["copy"] = {"bytes": 2 * src.numel() * 4, "ms": copy_ms,
                   "bytes_per_s": 2 * src.numel() * 4 / copy_ms * 1e3}
    del src, dst
    ops = momentum_ops((512, 2048))
    for sweeps in (1, 2, 4, 8):
        out["momentum"][f"sweeps {sweeps}"] = least(
            lambda: mom.momentum_multisweep(*ops, sweeps=sweeps))
    fleet = momentum_ops((4, 512, 2048))
    out["momentum"]["batched 4x512x2048"] = least(
        lambda: mom.momentum_multisweep(*fleet, sweeps=8))
    blocks = momentum_ops((4, 272, 1040))
    out["momentum"]["sharded 2x2 per-card 4x272x1040"] = least(
        lambda: mom.momentum_multisweep(*blocks, sweeps=8))
    del ops, fleet, blocks

    def matvec_levels():
        times = {}
        for ny, nx in GRIDS:
            for prec, dt in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
                rows = []
                for shape in level_shapes(ny, nx):
                    c = [field(0, 1, shape) for _ in range(4)]
                    diag = c[0] + c[1] + c[2] + c[3] + field(0.1, 1, shape)
                    coef = PressureCoeffs(*(t.to(dt) for t in c),
                                          torch.zeros_like(diag, dtype=dt),
                                          diag.to(dt))
                    x = field(-1, 1, shape).to(dt)
                    size = x.element_size()
                    rows.append({
                        "shape": list(shape),
                        "ms": least(lambda: st.stencil_matvec(coef, x)),
                        "bound_ms": 7 * x.numel() * size / MEM_RATE * 1e3})
                times[f"{ny}x{nx} {prec}"] = rows
        return times

    out["matvec"] = matvec_levels()
    if args.variants:
        threshold = st._VECTOR_MIN_CELLS
        for name, cells in (("vector", 0), ("cell", 1 << 62)):
            st._VECTOR_MIN_CELLS = cells
            out[f"matvec {name}"] = matvec_levels()
        st._VECTOR_MIN_CELLS = threshold
    print(card)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
