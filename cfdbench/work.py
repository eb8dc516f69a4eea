"""The frozen work count: bytes and operations of the hybrid step's
operations, from call shapes and counters only, and the published peaks of
one NVIDIA H100 SXM (dense, 700 W) they are held against.

The kernel table and the level shapes are a copy of the port's
kernel_bounds tool: each operand read once, each output written once, the
operations counted per cell and sweep. `step_terms` counts the whole step
term by term (see PERF.md); it reads the same work whatever implements
the step.
"""

from __future__ import annotations

MEM_RATE = 3.35e12                          # bytes/s
PEAKS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp8": 1979e12}
SIZES = {"f32": 4, "bf16": 2}

# name: (operands read, outputs written, operations per cell and sweep,
# operations per cell once)
KERNELS = {
    # u, v, a_e, a_w, a_n, a_s, ap_inv, bu, bv -> u, v
    "momentum_multisweep": (9, 2, 18, 0),
    # x, c_e, c_w, c_n, c_s, diag -> A x
    "stencil_matvec": (6, 1, 0, 9),
    # x, b, coefficients -> x
    "jacobi_multisweep": (7, 1, 13, 0),
    # x, b, coefficients -> x, r; the residual costs 10 more operations
    "smooth_residual": (7, 2, 13, 10),
    # x, corr, b, coefficients -> x; the add costs 1
    "corr_smooth": (8, 1, 13, 1),
}


def level_shapes(ny: int, nx: int, min_size: int = 8,
                 max_levels: int = 12) -> list[tuple[int, int]]:
    """The multigrid hierarchy's level shapes (odd sizes pad to even
    before each 2x2 coarsening)."""
    shapes = [(ny, nx)]
    while len(shapes) < max_levels and min(shapes[-1]) >= 2 * min_size:
        y, x = shapes[-1]
        shapes.append(((y + 1) // 2, (x + 1) // 2))
    return shapes


def kernel_work(name: str, cells: int, dtype: str = "f32",
                sweeps: int = 1) -> tuple[int, dict]:
    """(bytes, {precision: operations}) of one call of `name` over
    `cells` cells (all planes of a stack)."""
    n_in, n_out, per_sweep, once = KERNELS[name]
    return ((n_in + n_out) * cells * SIZES[dtype],
            {"f32": (per_sweep * sweeps + once) * cells})


def least_seconds(n_bytes: float, ops: dict) -> float:
    """The least time of the work: bytes at the memory rate, or the
    operations at their precisions' peaks, whichever is longer."""
    t_ops = sum(n / PEAKS[p] for p, n in ops.items())
    return max(n_bytes / MEM_RATE, t_ops)


def block_count(ny: int, nx: int, size: int, overlap_ratio: float) -> int:
    """The surrogate's blocks of one case (the sliding-window layout:
    n_x + 1 columns, n_y + 1 rows and an extra bottom row where the rows
    leave a remainder)."""
    o = int(overlap_ratio * size)
    step = size - o
    n_x = -(-(nx - size) // step)
    n_y = (ny - size) // step
    extra = ny - (step * n_y + size) > 0
    return (n_x + 1) * (n_y + (2 if extra else 1))


def _add(acc: dict, n_bytes: float, ops: dict | None = None):
    acc["bytes"] += n_bytes
    for p, n in (ops or {}).items():
        acc["ops"][p] = acc["ops"].get(p, 0) + n


def step_terms(config: dict, bundle: dict, cases: int,
               v_cycles: float) -> dict:
    """The counted work of one step (one lockstep of `cases` cases) of the
    hybrid PISO step, term by term: {term: {"bytes", "ops"}}. `bundle` is
    the surrogate's manifest (its model widths, PC counts, block size);
    `v_cycles` the multigrid cycles of the step as the counter reports
    them (every case's solve in one cycle of the stack)."""
    g = config["grid"]
    ny, nx = g["ny"], g["nx"]
    cells = cases * ny * nx
    f32 = SIZES["f32"]
    piso, mg = config["piso"], config["backend"]
    lp = "bf16" if mg["precision"] == "bf16" else "f32"
    terms = {k: {"bytes": 0.0, "ops": {}} for k in
             ("state", "momentum", "pressure", "surrogate")}

    # the state (u, v, p, phi_x, phi_y and the three previous fields) and
    # the case (17 per-cell tensors) read once; the new state written once
    _add(terms["state"], (8 + 17 + 5) * cells * f32)

    # the momentum sweeps' operands once
    b, o = kernel_work("momentum_multisweep", cells, "f32",
                       piso["momentum_sweeps"])
    _add(terms["momentum"], b, o)

    # the pressure solves: per corrector, the coefficients and the
    # right-hand side written, the hierarchy coarsened and cast once; per
    # V-cycle, the f32 residual and update at the finest level, each
    # level's down and up legs and the coarsest level's sweeps, in the
    # correction's precision
    shapes = level_shapes(ny, nx, max_levels=mg["max_levels"])
    solves = v_cycles / mg["cycles"]
    for (y, x) in shapes:
        c = cases * y * x
        _add(terms["pressure"], solves * 5 * c * (f32 + f32 + SIZES[lp]))
    _add(terms["pressure"], solves * 6 * cells * f32)
    per_cycle = {"bytes": 0.0, "ops": {}}
    _add(per_cycle, *kernel_work("stencil_matvec", cells, "f32"))
    _add(per_cycle, 3 * cells * f32, {"f32": cells})
    for (y, x) in shapes[:-1]:
        c = cases * y * x
        _add(per_cycle, *kernel_work("smooth_residual", c, lp, mg["pre"]))
        _add(per_cycle, *kernel_work("corr_smooth", c, lp, mg["post"]))
    y, x = shapes[-1]
    _add(per_cycle, *kernel_work("jacobi_multisweep", cases * y * x, lp,
                                 mg["coarse_iters"]))
    _add(terms["pressure"], v_cycles * per_cycle["bytes"],
         {p: v_cycles * n for p, n in per_cycle["ops"].items()})

    # the surrogate, per case: its input channels read and blocked, the
    # PCA bases and the MLP weights read once, the three products, the
    # blocks written and stitched into one field
    s = bundle["block_size"]
    n_blk = block_count(ny, nx, s, bundle["overlap_ratio"])
    n_in = bundle["n_in"]
    pc_in, pc_out = bundle["pc_in"], bundle["pc_out"]
    md = bundle["mdef"]
    widths = [md["in_dim"], *md["widths"], md["out_dim"]]
    mlp_w = sum(a * b_ for a, b_ in zip(widths[:-1], widths[1:]))
    mlp_p = "bf16" if md["compute_dtype"] == "bfloat16" else "f32"
    per_case_bytes = (
        5 * ny * nx * f32                      # u, v, u_prev, v_prev, sdf
        + 2 * n_blk * s * s * n_in * f32       # the input blocks
        + (pc_in * s * s * n_in + pc_out * s * s) * f32   # PCA bases
        + mlp_w * f32                          # MLP weights
        + 2 * n_blk * s * s * f32              # output blocks
        + ny * nx * f32)                       # the stitched field
    per_case_ops = {
        "f32": 2 * n_blk * s * s * (n_in * pc_in + pc_out),
        mlp_p: 2 * n_blk * mlp_w}
    _add(terms["surrogate"], cases * per_case_bytes,
         {p: cases * n for p, n in per_case_ops.items()})
    return terms


def step_least_seconds(terms: dict) -> float:
    """The least time of the whole step's counted work: all its bytes at
    the memory rate, or all its operations at their peaks."""
    n_bytes = sum(t["bytes"] for t in terms.values())
    ops: dict = {}
    for t in terms.values():
        for p, n in t["ops"].items():
            ops[p] = ops.get(p, 0) + n
    return least_seconds(n_bytes, ops)
