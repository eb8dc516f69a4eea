"""Least time an H100 needs for each stencil kernel of the JAX package, at
every level of the multigrid hierarchy of a grid: by default the main
path's 512 x 2048 and the Schaefer-Turek path's 256 x 1375 (D/delta 62.5).

    python -m tpufoam_torch.tools.kernel_bounds [--ny NY --nx NX]
        [--fleet 4] [--mesh 2x2]

Each (ny, nx) operand is read once and each output written once, at the
H100 SXM's published 3.35 TB/s; the operations (counted per cell and
sweep, at the sweeps each kernel runs on its path) go at the f32 rate, 67
TFLOP/s, which the kernels use in both dtypes since they compute in
float32 registers. The bound is the larger of the two times. The
multisweep pressure kernels are listed at each level of `build_hierarchy`
that is not the coarsest (the coarsest level takes plain sweeps); the
matvec and the single sweep at every level (the coarsest level's plain
sweeps are matvecs); the momentum kernel runs at the finest level only.
The batched launches over a fleet of `--fleet` cases (piso.batched): the
momentum kernel's, and each multisweep pressure kernel's at the finest
level in both dtypes (the kernel smoothers on a fleet), move that many
planes in one launch: `--fleet` times one plane's bound. The sharded
kernels (ops.sharded) over a `--mesh DYxDX` mesh (default 2x2) have the
single kernel's bound, and beside it the bound of their haloed blocks,
each (ny/dy + 2h) x (nx/dx + 2h) along the split axes with the kernel's
halo h (8 in float32, 16 in bfloat16), read with their operations on every
haloed cell and written cropped: the extra cost of the exchange route (the
window route reads the global operands in place). Prints one JSON line,
keyed by grid. Runs anywhere; it measures nothing.
"""

from __future__ import annotations

import argparse
import json

MEM_RATE = 3.35e12   # bytes/s
F32_RATE = 67e12     # operations/s

# name: (operands read, outputs written, operations per cell and sweep,
# operations per cell once, {dtype: sweeps on its path}), per
# tpufoam/ops/stencil.py and tpufoam_torch/ops/csrc/*.cu
KERNELS = {
    # u, v, a_e, a_w, a_n, a_s, ap_inv, bu, bv; 8 sweeps
    "momentum_multisweep": (9, 2, 18, 0, {"f32": 8}),
    # x, c_e, c_w, c_n, c_s, diag
    "stencil_matvec": (6, 1, 0, 9, {"f32": 1, "bf16": 1}),
    # x, b, c_e, c_w, c_n, c_s, diag; one sweep per launch
    "jacobi_sweep": (7, 1, 13, 0, {"f32": 1, "bf16": 1}),
    # MGCG's f32 V(1,1); the bf16 hybrid's V(2,2)
    "jacobi_multisweep": (7, 1, 13, 0, {"f32": 1, "bf16": 2}),
    # returns (x, r); the residual costs 10 more operations
    "smooth_residual": (7, 2, 13, 10, {"f32": 2, "bf16": 2}),
    # x, corr, b and the coefficients; the add costs 1
    "corr_smooth": (8, 1, 13, 1, {"f32": 2, "bf16": 2}),
}
SIZES = {"f32": 4, "bf16": 2}
# the main path's grid and the Schaefer-Turek 2D-2 grid at D/delta 62.5
GRIDS = ((512, 2048), (256, 1375))
ALL_LEVELS = ("stencil_matvec", "jacobi_sweep")


def level_shapes(ny: int, nx: int, min_size: int = 8,
                 max_levels: int = 12) -> list[tuple[int, int]]:
    """The shapes of `solvers.multigrid.build_hierarchy` (odd sizes pad to
    even before each 2x2 coarsening)."""
    shapes = [(ny, nx)]
    while len(shapes) < max_levels and min(shapes[-1]) >= 2 * min_size:
        y, x = shapes[-1]
        shapes.append(((y + 1) // 2, (x + 1) // 2))
    return shapes


def bound(name: str, shape, dtype: str, planes: int = 1) -> dict:
    n_in, n_out, per_sweep, once, sweeps = KERNELS[name]
    cells = planes * shape[0] * shape[1]
    n_bytes = (n_in + n_out) * cells * SIZES[dtype]
    n_ops = (per_sweep * sweeps[dtype] + once) * cells
    t_mem, t_ops = n_bytes / MEM_RATE, n_ops / F32_RATE
    return {"shape": [planes, *shape] if planes > 1 else list(shape),
            "sweeps": sweeps[dtype], "bytes": n_bytes,
            "bound_us": max(t_mem, t_ops) * 1e6,
            "bound_by": "bytes" if t_mem >= t_ops else "operations"}


def sharded_bound(name: str, shape, mesh_shape, dtype: str,
                  sweeps: int | None = None) -> dict:
    """The least time of one sharded call of `name` ("momentum_multisweep"
    or "jacobi_multisweep") on a (dy, dx) mesh at global `shape`, at
    `sweeps` (the kernel's path sweeps if None). `bound_us` is the
    function's: the global operands read once, the outputs written once,
    the operations on every cell, as the single kernel's bound.
    `haloed_bound_us` is the exchange route's: every haloed block's
    operands read and its operations done on every haloed cell."""
    n_in, n_out, per_sweep, once, path = KERNELS[name]
    sweeps = path[dtype] if sweeps is None else sweeps
    (ny, nx), (dy, dx) = shape, mesh_shape
    h = 16 if dtype == "bf16" else 8
    nyh = ny // dy + (2 * h if dy > 1 else 0)
    nxh = nx // dx + (2 * h if dx > 1 else 0)

    def least(cells_in: int) -> tuple[int, float, str]:
        n_bytes = (n_in * cells_in + n_out * ny * nx) * SIZES[dtype]
        n_ops = (per_sweep * sweeps + once) * cells_in
        t_mem, t_ops = n_bytes / MEM_RATE, n_ops / F32_RATE
        return (n_bytes, max(t_mem, t_ops) * 1e6,
                "bytes" if t_mem >= t_ops else "operations")

    n_bytes, t, by = least(ny * nx)
    h_bytes, h_t, _ = least(dy * dx * nyh * nxh)
    return {"shape": list(shape), "mesh": [dy, dx], "block": [nyh, nxh],
            "sweeps": sweeps, "bytes": n_bytes, "bound_us": t,
            "bound_by": by, "haloed_bytes": h_bytes, "haloed_bound_us": h_t}


def bounds(ny: int, nx: int, fleet: int = 4, mesh=(2, 2)) -> dict:
    shapes = level_shapes(ny, nx)
    out = {}
    for name, spec in KERNELS.items():
        on = shapes[:1] if name == "momentum_multisweep" else shapes \
            if name in ALL_LEVELS else shapes[:-1]
        out[name] = {dt: [bound(name, s, dt) for s in on] for dt in spec[4]}
    return {"levels": [list(s) for s in shapes], "kernels": out,
            "fleet": {"cases": fleet, "momentum_multisweep": bound(
                "momentum_multisweep", (ny, nx), "f32", planes=fleet),
                **{name: {dt: bound(name, (ny, nx), dt, planes=fleet)
                          for dt in KERNELS[name][4]}
                   for name in ("jacobi_multisweep", "smooth_residual",
                                "corr_smooth")}},
            "sharded": {
                "momentum_multisweep": sharded_bound(
                    "momentum_multisweep", (ny, nx), mesh, "f32"),
                "jacobi_multisweep": {dt: sharded_bound(
                    "jacobi_multisweep", (ny, nx), mesh, dt)
                    for dt in ("f32", "bf16")}}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ny", type=int)
    ap.add_argument("--nx", type=int)
    ap.add_argument("--fleet", type=int, default=4)
    ap.add_argument("--mesh", default="2x2", help="DYxDX of the sharded "
                    "kernels' mesh")
    args = ap.parse_args()
    if (args.ny is None) != (args.nx is None):
        ap.error("give both --ny and --nx, or neither")
    mesh = tuple(int(k) for k in args.mesh.split("x"))
    grids = ((args.ny, args.nx),) if args.ny else GRIDS
    print(json.dumps({f"{ny}x{nx}": bounds(ny, nx, args.fleet, mesh)
                      for ny, nx in grids}))


if __name__ == "__main__":
    main()
