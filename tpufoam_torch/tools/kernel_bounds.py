"""Least time an H100 needs for each stencil kernel of the JAX package at the
main path's shape, from the bytes it must move.

    python -m tpufoam_torch.tools.kernel_bounds [--ny 512] [--nx 2048]

Each (ny, nx) operand is read once and each output written once, at the
H100 SXM's published 3.35 TB/s. All these kernels are memory-bound: their
few operations per cell stay far below the f32 rate (67 TFLOP/s). Prints
one JSON line. Runs anywhere; it measures nothing.
"""

from __future__ import annotations

import argparse
import json

MEM_RATE = 3.35e12   # bytes/s

# name: (operands read, outputs written), per tpufoam/ops/stencil.py
KERNELS = {
    "momentum_multisweep": (9, 2),   # u, v, a_e, a_w, a_n, a_s, ap_inv, bu, bv
    "stencil_matvec": (6, 1),        # x, c_e, c_w, c_n, c_s, diag
    "jacobi_sweep": (7, 1),          # x, b, c_e, c_w, c_n, c_s, diag
    "jacobi_multisweep": (7, 1),
    "smooth_residual": (7, 2),       # returns (x, r)
    "corr_smooth": (8, 1),           # x, corr, b, coefficients
}


def bounds(ny: int, nx: int) -> dict:
    out = {}
    for name, (n_in, n_out) in KERNELS.items():
        row = {}
        for dtype, size in (("f32", 4), ("bf16", 2)):
            nbytes = (n_in + n_out) * ny * nx * size
            row[dtype] = {"bytes": nbytes, "bound_us": nbytes / MEM_RATE * 1e6}
        out[name] = row
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ny", type=int, default=512)
    ap.add_argument("--nx", type=int, default=2048)
    args = ap.parse_args()
    print(json.dumps({"ny": args.ny, "nx": args.nx,
                      "kernels": bounds(args.ny, args.nx)}))


if __name__ == "__main__":
    main()
