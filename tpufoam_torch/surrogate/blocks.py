"""Patch decomposition and overlap-stitching of grid fields.

The grid is cut into S x S blocks with overlap (right-to-left within a row,
an extra clamped leftmost block, an extra bottom row anchored to the
domain bottom). The surrogate predicts per-block zero-mean pressure; two
stitchers reconstruct the global field:

  assemble_scan   the reference's sequential raster corrector (each block
                  offset from its already-corrected left and upper
                  neighbours), then overwrite placement in raster order;
  assemble_lstsq  per-block offsets solved in closed form from all
                  pairwise overlap mismatches (a small SPD system), then
                  smooth cosine-window blending.

Both end with the global outlet anchor; `gaussian_filter2d` is the
reference's optional seam filter after it (scipy's gaussian_filter).
Every device operation here is deterministic (no atomic accumulation),
so a prediction repeats bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import host_read, host_upload


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Static description of the block tiling of an (ny, nx) grid."""

    ny: int
    nx: int
    size: int          # block edge S
    overlap: int       # o
    n_x: int           # blocks-1 per row horizontally
    n_y: int           # last regular row index
    p_i: int           # uncovered bottom rows (0 => no extra row)
    izl: int           # overlap width of the clamped leftmost block
    has_extra_row: bool
    y0s: tuple         # per-block top-left corners, raster order
    x0s: tuple
    idx_i: tuple       # [idx_i, idx_j] block labels
    idx_j: tuple

    @property
    def n_blocks(self) -> int:
        return len(self.y0s)


def build_block_layout(ny: int, nx: int, size: int = 128,
                       overlap_ratio: float = 0.25) -> BlockLayout:
    """Sliding-window enumeration: right-to-left within each row, extra
    clamped leftmost block, extra bottom row anchored to the domain
    bottom."""
    size = int(size)
    o = int(overlap_ratio * size)
    step = size - o
    if ny < size or nx < size:
        raise ValueError(f"grid {ny}x{nx} smaller than block size {size}")

    n_x = int(np.ceil((nx - size) / step))
    n_y = int((ny - size) / step)
    p_i = ny - (step * n_y + size)
    p_j = nx - (step * n_x + size)   # <= 0
    izl = o - p_j
    has_extra_row = p_i > 0

    y0s, x0s, idx_i, idx_j = [], [], [], []
    n_rows = n_y + 2 if has_extra_row else n_y + 1
    for i in range(n_rows):
        y0 = i * step
        if has_extra_row and i == n_y + 1:
            y0 = ny - size
        for j in range(n_x + 1):
            x0 = nx - j * step - size
            if j == n_x:
                x0 = 0
            y0s.append(y0)
            x0s.append(x0)
            idx_i.append(i)
            idx_j.append(n_x - j)

    return BlockLayout(ny=ny, nx=nx, size=size, overlap=o, n_x=n_x, n_y=n_y,
                       p_i=p_i, izl=izl, has_extra_row=has_extra_row,
                       y0s=tuple(y0s), x0s=tuple(x0s),
                       idx_i=tuple(idx_i), idx_j=tuple(idx_j))


def _arith_step(vals, step: int) -> bool:
    return all(b - a == step for a, b in zip(vals, vals[1:]))


def _split_arith(vals, step: int):
    """Split a sorted corner set into (arithmetic run with difference
    `step`, <=1 leftover element at whichever end was clamped)."""
    vals = list(vals)
    if _arith_step(vals, step):
        return vals, []
    if len(vals) >= 2 and _arith_step(vals[1:], step):
        return vals[1:], [vals[0]]
    if len(vals) >= 2 and _arith_step(vals[:-1], step):
        return vals[:-1], [vals[-1]]
    return None


@functools.lru_cache(maxsize=16)
def _fast_groups(layout: BlockLayout):
    """Grouped space-to-depth plan for block extraction and placement.

    The corner set is a product Y x X where each axis is a step-strided
    run plus at most one clamped corner. It decomposes into <= 4
    sub-lattices, each split into parity groups whose blocks tile a
    gs-strided slab, so a whole group is one pad/reshape instead of one
    slice per block.

    Returns (groups, order, inv, gs): per-group (ys_g, xs_g, ks), the
    concatenation order, its inverse permutation back to raster order and
    the slab stride gs. Every layout `build_block_layout` makes
    decomposes; any other raises."""
    step = layout.size - layout.overlap
    ys = sorted(set(layout.y0s))
    xs = sorted(set(layout.x0s))
    pos_to_k = {(y, x): k
                for k, (y, x) in enumerate(zip(layout.y0s, layout.x0s))}
    sy = _split_arith(ys, step) if step > 0 else None
    sx = _split_arith(xs, step) if step > 0 else None
    if (len(pos_to_k) != len(layout.y0s)          # duplicate corners
            or len(layout.y0s) != len(ys) * len(xs)   # not a full product
            or sy is None or sx is None):
        raise ValueError("block layout is not a strided corner lattice")
    g = -(-layout.size // step)      # ceil: group stride g*step >= size
    groups = []
    order = []
    for ys_sub in sy:
        for xs_sub in sx:
            if not ys_sub or not xs_sub:
                continue
            for a in range(min(g, len(ys_sub))):
                ys_g = ys_sub[a::g]
                for b in range(min(g, len(xs_sub))):
                    xs_g = xs_sub[b::g]
                    if not ys_g or not xs_g:
                        continue
                    ks = [pos_to_k[(y, x)] for y in ys_g for x in xs_g]
                    groups.append((ys_g, xs_g, np.asarray(ks)))
                    order.extend(ks)
    inv = np.empty(len(order), dtype=np.int64)
    inv[np.asarray(order)] = np.arange(len(order))
    return groups, np.asarray(order), inv, g * step


@functools.lru_cache(maxsize=16)
def layout_indices(layout: BlockLayout, device: torch.device) -> tuple:
    """(inv, order) of `_fast_groups` on `device`, each uploaded once
    (through host_upload): later extractions and placements on the layout
    copy nothing, so nothing waits for the stream."""
    _, order, inv, _ = _fast_groups(layout)
    return host_upload(inv, device), host_upload(order, device)


def _pad_yx(field: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Zero-pad the high end of the two leading (y, x) axes."""
    pad = [0, 0] * (field.dim() - 2) + [0, px, 0, py]
    return F.pad(field, pad)


def extract_blocks(layout: BlockLayout, field: torch.Tensor) -> torch.Tensor:
    """All blocks as (N, S, S[, C]), in raster order."""
    s = layout.size
    groups, _, _, gs = _fast_groups(layout)
    fp = _pad_yx(field, gs, gs)
    trail = tuple(field.shape[2:])
    parts = []
    for ys_g, xs_g, _ in groups:
        my, mx = len(ys_g), len(xs_g)
        v = fp[ys_g[0]:ys_g[0] + my * gs, xs_g[0]:xs_g[0] + mx * gs]
        v = v.reshape((my, gs, mx, gs) + trail)
        v = torch.movedim(v, 2, 1)[:, :, :s, :s]
        parts.append(v.reshape((my * mx, s, s) + trail))
    return torch.cat(parts)[layout_indices(layout, field.device)[0]]


def extract_blocks_gather(layout: BlockLayout,
                          field: torch.Tensor) -> torch.Tensor:
    """All blocks as (N, S, S[, C]) by one indexed read (the JAX
    package's comparison variant of `extract_blocks`)."""
    dev = field.device
    ar = torch.arange(layout.size, device=dev)
    rows = torch.as_tensor(layout.y0s, device=dev)[:, None, None] \
        + ar[None, :, None]
    cols = torch.as_tensor(layout.x0s, device=dev)[:, None, None] \
        + ar[None, None, :]
    return field[rows, cols]


def block_zero_mean(blocks: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Remove the per-block masked mean (the surrogate predicts pressure
    only up to a per-block constant)."""
    m = (masks != 0).to(blocks.dtype)
    cnt = torch.clamp(m.sum(dim=(-2, -1), keepdim=True), min=1.0)
    mean = (blocks * m).sum(dim=(-2, -1), keepdim=True) / cnt
    return (blocks - mean) * m


def _masked_mean(x: torch.Tensor, m: torch.Tensor, dims):
    cnt = m.sum(dim=dims)
    mean = torch.where(cnt > 0, (x * m).sum(dim=dims)
                       / torch.clamp(cnt, min=1.0), 0.0)
    return mean, cnt


def _strip_means(layout: BlockLayout, blocks: torch.Tensor,
                 masks: torch.Tensor) -> dict:
    """Masked means (and fluid counts) of every overlap strip the
    stitchers compare, vectorized over blocks."""
    o, s, p_i, izl = layout.overlap, layout.size, layout.p_i, layout.izl
    izl = min(izl, s)
    m = (masks != 0).to(blocks.dtype)
    dims = (-2, -1)

    def mm(sl_y, sl_x):
        return _masked_mean(blocks[:, sl_y, sl_x], m[:, sl_y, sl_x], dims)

    out = {
        "right_col": mm(slice(None), slice(-1, None)),   # outlet anchor
        "right_o": mm(slice(None), slice(-o, None)),
        "left_o": mm(slice(None), slice(0, o)),
        "right_izl": mm(slice(None), slice(-izl, None)),
        "left_izl": mm(slice(None), slice(0, izl)),
        "top_o": mm(slice(0, o), slice(None)),
        "bot_o": mm(slice(-o, None), slice(None)),
    }
    if layout.has_extra_row:
        out["bot_pi"] = mm(slice(-(s - p_i), None), slice(None))
        out["excl_pi"] = mm(slice(0, s - p_i), slice(None))
        # fluid fraction of the strip itself (o * s cells), as the JAX
        # package normalizes it (see its stitch_offsets_scan)
        out["up_frac"] = m[:, -p_i - o:-p_i, :].sum(dim=dims) / float(o * s)
    return out


def stitch_offsets_scan(layout: BlockLayout, blocks: torch.Tensor,
                        masks: torch.Tensor,
                        ref_bc: float = 0.0) -> torch.Tensor:
    """Per-block additive corrections by the reference's sequential raster
    corrector: the JAX package's lax.scan over blocks, here a loop over
    the blocks in the same order, with the same two deviations from the
    reference (the full-overlap strip for the last row's rightmost block,
    and the up-strip fluid fraction normalized by the strip's size).

    The strip means are taken on the blocks' device; the recurrence, a
    few float32 scalar operations per block, runs on a host copy of them.
    Returns corr (N,) such that corrected block k = blocks[k] - corr[k]."""
    sm = _strip_means(layout, blocks, masks)
    n_x, n_y = layout.n_x, layout.n_y
    last_row_i = n_y + 1 if layout.has_extra_row else -1
    names = ("right_col", "right_o", "left_o", "right_izl", "left_izl",
             "top_o", "bot_o")
    stats = [sm[k][0] for k in names]
    zero = torch.zeros_like(stats[0])
    if layout.has_extra_row:
        stats += [sm["bot_pi"][0], sm["excl_pi"][0], sm["up_frac"]]
    else:
        stats += [zero, zero, zero]
    x = dict(zip(names + ("bot_pi", "excl_pi", "up_frac"),
                 host_read(torch.stack(stats).to(torch.float32))))
    zero = torch.zeros((), dtype=torch.float32)

    bc_ups = [zero] * (n_x + 1)   # upward overlap mean stored per column
    bc_set = [False] * (n_x + 1)
    old_left_o = old_left_izl = zero
    corr = []
    for k in range(layout.n_blocks):
        i, j = layout.idx_i[k], layout.idx_j[k]

        def g(name, k=k):
            return x[name][k]

        side = (g("right_izl") - old_left_izl if j == 0
                else g("right_o") - old_left_o)
        if i == 0:                              # first row
            c = g("right_col") - ref_bc if k == 0 and j != 0 else side
        elif i == last_row_i:                   # extra bottom row
            c = g("excl_pi") - bc_ups[j]
            if j != n_x:
                c = torch.where(g("up_frac") < 0.1, side, c)
        elif bc_set[j] or j == n_x:             # middle rows
            c = g("top_o") - bc_ups[j]
        else:
            c = side
        if i != last_row_i:
            bc_ups[j] = (g("bot_pi") if i == n_y else g("bot_o")) - c
            bc_set[j] = True
        old_left_o = g("left_o") - c
        old_left_izl = g("left_izl") - c
        corr.append(c)
    return host_upload(torch.stack(corr), blocks.device).to(blocks.dtype)


def _place_blocks(layout: BlockLayout, blocks: torch.Tensor) -> torch.Tensor:
    """Overwrite placement in raster order: later blocks win the overlap;
    last-row blocks contribute only their bottom p_i rows."""
    s, p_i = layout.size, layout.p_i
    last_row_i = layout.n_y + 1 if layout.has_extra_row else -1
    result = torch.zeros((layout.ny, layout.nx), dtype=blocks.dtype,
                         device=blocks.device)
    for k in range(layout.n_blocks):
        y0, x0 = layout.y0s[k], layout.x0s[k]
        if layout.idx_i[k] == last_row_i:
            result[y0 + s - p_i:y0 + s, x0:x0 + s] = blocks[k, s - p_i:, :]
        else:
            result[y0:y0 + s, x0:x0 + s] = blocks[k]
    return result


def _outlet_anchor(result: torch.Tensor) -> torch.Tensor:
    """Shift the field so that the pressure extrapolated to the outlet
    face, (3 p[-1] - p[-2]) / 2 averaged over rows, is zero."""
    return result - torch.mean(3.0 * result[:, -1] - result[:, -2]) / 3.0


def assemble_scan(layout: BlockLayout, blocks: torch.Tensor,
                  masks: torch.Tensor, ref_bc: float = 0.0,
                  apply_filter: bool = False,
                  filter_sigma: float = 10.0) -> torch.Tensor:
    """The reference's reconstruction: sequential corrections, overwrite
    placement, the global outlet anchor and, with `apply_filter`, the
    Gaussian filter of width `filter_sigma` that hides block seams."""
    corr = stitch_offsets_scan(layout, blocks, masks, ref_bc)
    result = _outlet_anchor(_place_blocks(layout,
                                          blocks - corr[:, None, None]))
    if apply_filter:
        result = gaussian_filter2d(result, filter_sigma)
    return result


def _neighbor_pairs(layout: BlockLayout):
    """Static neighbour-pair list with the strip names to compare:
    (a, b, strip_of_a, strip_of_b). Horizontal neighbours compare
    right/left overlap strips (izl-wide for the clamped leftmost block),
    vertical neighbours compare bottom/top strips (the thick overlap for
    the extra row)."""
    pos = {(layout.idx_i[k], layout.idx_j[k]): k
           for k in range(layout.n_blocks)}
    last_row_i = layout.n_y + 1 if layout.has_extra_row else None
    pairs = []
    for (i, j), k in pos.items():
        right = pos.get((i, j + 1))
        if right is not None:
            if j == 0:
                pairs.append((k, right, "right_izl", "left_izl"))
            else:
                pairs.append((k, right, "right_o", "left_o"))
        below = pos.get((i + 1, j))
        if below is not None:
            if layout.has_extra_row and i + 1 == last_row_i:
                pairs.append((k, below, "bot_pi", "excl_pi"))
            else:
                pairs.append((k, below, "bot_o", "top_o"))
    return pairs


@functools.lru_cache(maxsize=16)
def _pair_groups(layout: BlockLayout):
    """The neighbour pairs grouped by the strips they compare: a list of
    (strip of a, strip of b, a's blocks, b's blocks), and the
    concatenated (ia, ib) in that order."""
    pairs = _neighbor_pairs(layout)
    groups = []
    for sa, sb in sorted({(p[2], p[3]) for p in pairs}):
        ka = np.asarray([p[0] for p in pairs if (p[2], p[3]) == (sa, sb)])
        kb = np.asarray([p[1] for p in pairs if (p[2], p[3]) == (sa, sb)])
        groups.append((sa, sb, ka, kb))
    return (groups, np.concatenate([g[2] for g in groups]),
            np.concatenate([g[3] for g in groups]))


@functools.lru_cache(maxsize=16)
def _incidence(layout: BlockLayout) -> np.ndarray:
    """(n, d) indices into the 2P + 1 signed pair terms [w d, -w d, 0]:
    the pairs block k is the first of, then the pairs it is the second
    of, padded with the zero term. d, a block's most pairs, is at most 4."""
    _, ia, ib = _pair_groups(layout)
    n_pairs = len(ia)
    rows = [[p for p in range(n_pairs) if ia[p] == k]
            + [n_pairs + p for p in range(n_pairs) if ib[p] == k]
            for k in range(layout.n_blocks)]
    d = max(len(r) for r in rows)
    return np.asarray([r + [2 * n_pairs] * (d - len(r)) for r in rows])


@functools.lru_cache(maxsize=16)
def stitch_indices(layout: BlockLayout, device: torch.device) -> dict:
    """The lstsq stitch's constant index arrays on `device`, each uploaded
    once (through host_upload): `pairs` [(strips, ka, kb)] of its pair
    groups, the concatenated `ia`, `ib`, and its `incidence`. Later
    calls on the layout copy nothing, so nothing waits for the stream."""
    groups, ia, ib = _pair_groups(layout)
    return {"pairs": [(sa, sb, host_upload(ka, device),
                       host_upload(kb, device))
                      for sa, sb, ka, kb in groups],
            "ia": host_upload(ia, device), "ib": host_upload(ib, device),
            "incidence": host_upload(_incidence(layout), device)}


def _stitch_pair_system(layout: BlockLayout, blocks: torch.Tensor,
                        masks: torch.Tensor):
    """The pairwise overlap-mean constraint set (ia, ib, ws, diffs): block
    pairs, their shared-strip fluid weights, and the strip-mean
    mismatches. ws depends only on `masks`; `blocks` enter only through
    `diffs`."""
    sm = _strip_means(layout, blocks, masks)
    idx = stitch_indices(layout, blocks.device)

    mean_a_l, cnt_a_l, mean_b_l, cnt_b_l = [], [], [], []
    for sa, sb, ka_t, kb_t in idx["pairs"]:
        mean_a_l.append(sm[sa][0][ka_t])
        cnt_a_l.append(sm[sa][1][ka_t])
        mean_b_l.append(sm[sb][0][kb_t])
        cnt_b_l.append(sm[sb][1][kb_t])
    ia, ib = idx["ia"], idx["ib"]
    diffs = torch.cat(mean_a_l) - torch.cat(mean_b_l)
    ws = torch.minimum(torch.cat(cnt_a_l), torch.cat(cnt_b_l)) \
        / float(layout.size**2)
    return ia, ib, ws, diffs


def _stitch_matrix(n: int, ia, ib, ws) -> torch.Tensor:
    """SPD graph-Laplacian normal matrix of the offset problem. The small
    ridge term fixes the gauge (offsets are free up to one constant); the
    global outlet anchor is applied after assembly."""
    A = torch.zeros((n, n), dtype=ws.dtype, device=ws.device)
    A.index_put_((ia, ia), ws, accumulate=True)
    A.index_put_((ib, ib), ws, accumulate=True)
    A.index_put_((ia, ib), -ws, accumulate=True)
    A.index_put_((ib, ia), -ws, accumulate=True)
    return A + 1e-6 * torch.eye(n, dtype=ws.dtype, device=ws.device)


def stitch_solve_op(layout: BlockLayout, masks: torch.Tensor) -> torch.Tensor:
    """Host-precomputed dense solve operator for the offset system.

    The normal matrix depends only on the layout and the per-case block
    masks, so a serving path inverts it once per case; the per-step stitch
    is then one (n, n) @ (n,) matvec. The inverse is taken in float64 and
    deflated on both sides with P = I - 11^T/n, which removes the
    O(1/ridge) constant-mode amplification of the f32 matvec."""
    n = layout.n_blocks
    ia, ib, ws, _ = _stitch_pair_system(layout, masks, masks)
    A = _stitch_matrix(n, ia, ib, ws).cpu().numpy().astype(np.float64)
    P = np.eye(n) - np.full((n, n), 1.0 / n)
    M = P @ np.linalg.inv(A) @ P
    return torch.as_tensor(M.astype(np.float32), device=masks.device)


def stitch_offsets_lstsq(layout: BlockLayout, blocks: torch.Tensor,
                         masks: torch.Tensor, ref_bc: float = 0.0,
                         anchor_weight: float = 1.0,
                         solve_op: torch.Tensor | None = None) -> torch.Tensor:
    """Per-block offsets minimizing all neighbour overlap-mean mismatches:

        min_c  sum_pairs w_ab ((m_a - c_a) - (m_b - c_b))^2

    solved with one dense solve of the normal equations, or one matvec
    with the host-precomputed `solve_op`. `ref_bc` and `anchor_weight` are
    taken and change nothing, as in the JAX package: the pair graph fixes
    the offsets only up to one constant, which the ridge and the global
    outlet anchor after assembly fix (anchoring each outlet block to
    ref_bc would conflict with the row-to-row differences of their
    means). The right-hand side gathers each
    block's at most 4 pair terms and adds them in a fixed order (an
    index_add_ would accumulate them atomically, in no fixed order, on a
    CUDA tensor)."""
    n = layout.n_blocks
    ia, ib, ws, diffs = _stitch_pair_system(layout, blocks, masks)
    wd = ws * diffs
    terms = torch.cat([wd, -wd, torch.zeros_like(wd[:1])])
    g = terms[stitch_indices(layout, blocks.device)["incidence"]]
    rhs = g[:, 0]
    for j in range(1, g.shape[1]):
        rhs = rhs + g[:, j]
    if solve_op is not None:
        c = solve_op @ rhs
    else:
        c = torch.linalg.solve(_stitch_matrix(n, ia, ib, ws), rhs)
    return c - torch.mean(c)   # remove the (unconstrained) global mode


def _blend_window(s: int) -> np.ndarray:
    """Separable raised-cosine weight, > 0 everywhere, peaked at centre."""
    t = (np.arange(s) + 0.5) / s
    w1 = 0.05 + 0.95 * np.sin(np.pi * t) ** 2
    return np.outer(w1, w1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _blend_constants(layout: BlockLayout, device: torch.device):
    """(window, 1 / weight-sum canvas) on `device`; both depend only on
    the layout."""
    w_np = _blend_window(layout.size)
    s = layout.size
    den = np.zeros((layout.ny, layout.nx), dtype=np.float32)
    for y0, x0 in zip(layout.y0s, layout.x0s):
        den[y0:y0 + s, x0:x0 + s] += w_np
    return (host_upload(w_np, device),
            host_upload(1.0 / np.maximum(den, 1e-8), device))


def assemble_lstsq(layout: BlockLayout, blocks: torch.Tensor,
                   masks: torch.Tensor, ref_bc: float = 0.0,
                   solve_op: torch.Tensor | None = None) -> torch.Tensor:
    """Offset solve + smooth weighted blending, then the global outlet
    anchor. `solve_op` (stitch_solve_op) replaces the dense solve with one
    matvec; `ref_bc` changes nothing (see stitch_offsets_lstsq)."""
    corr = stitch_offsets_lstsq(layout, blocks, masks, ref_bc,
                                solve_op=solve_op)
    corrected = blocks - corr[:, None, None]
    w, inv_den = _blend_constants(layout, blocks.device)
    s = layout.size

    # grouped space-to-depth placement: one pad/reshape/slice-add per
    # parity group; blocks inside a group do not overlap
    groups, _, _, gs = _fast_groups(layout)
    _, order = layout_indices(layout, blocks.device)
    weighted = (corrected * w)[order]
    num = torch.zeros((layout.ny + gs, layout.nx + gs), dtype=blocks.dtype,
                      device=blocks.device)
    off = 0
    for ys_g, xs_g, _ in groups:
        my, mx = len(ys_g), len(xs_g)
        v = weighted[off:off + my * mx].reshape(my, mx, s, s)
        off += my * mx
        v = F.pad(v, (0, gs - s, 0, gs - s))
        v = torch.movedim(v, 1, 2).reshape(my * gs, mx * gs)
        num[ys_g[0]:ys_g[0] + my * gs, xs_g[0]:xs_g[0] + mx * gs] += v
    return _outlet_anchor(num[:layout.ny, :layout.nx] * inv_den)


def apply_deltaU_weighting(result: torch.Tensor, dp_prev_grid: torch.Tensor,
                           du_change_grid: torch.Tensor,
                           sigma_wgt: float = 50.0,
                           sigma_out: float = 10.0) -> torch.Tensor:
    """The reference's delta-U weighting: where the velocity delta barely
    changed since the previous step, trust the previous delta-p over the
    fresh prediction.

        w          = gaussian(du_change_grid, sigma_wgt)
        change     = gaussian((result - dp_prev) * w, sigma_out)
        weighted   = dp_prev + change

    `du_change_grid` is |dU - dU_prev| summed over components and
    normalized to [0, 1]."""
    w = gaussian_filter2d(du_change_grid, sigma_wgt)
    change = gaussian_filter2d((result - dp_prev_grid) * w, sigma_out)
    return dp_prev_grid + change


@functools.lru_cache(maxsize=32)
def _symmetric_index(n: int, radius: int) -> np.ndarray:
    """Indices of numpy's 'symmetric' pad of a length-n axis by `radius`
    on both sides (the edge sample repeated, reflected again as often as
    the radius needs)."""
    i = np.arange(-radius, n + radius) % (2 * n)
    return np.where(i >= n, 2 * n - 1 - i, i)


def gaussian_filter2d(field: torch.Tensor, sigma: float,
                      truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of a (ny, nx) field matching
    scipy.ndimage.gaussian_filter's defaults (its 'reflect' boundary is
    numpy's 'symmetric' pad): radius int(truncate sigma + 0.5), a float32
    kernel normalized to sum 1, each axis one float32 convolution. TF32
    is off inside the call, so that the card sums in float32 as the CPU
    does."""
    radius = int(truncate * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=field.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).to(field.dtype).reshape(1, 1, -1)

    def conv1d(f, dim):
        f = f.movedim(dim, -1)
        idx = host_upload(_symmetric_index(f.shape[-1], radius), f.device)
        fp = f.index_select(-1, idx)
        out = F.conv1d(fp.reshape(-1, 1, fp.shape[-1]), k)
        return out.reshape(f.shape).movedim(-1, dim)

    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    deterministic=True, allow_tf32=False):
        return conv1d(conv1d(field, 0), 1)
