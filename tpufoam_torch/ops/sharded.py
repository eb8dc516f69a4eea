"""The momentum and pressure multisweeps on a mesh of devices: the
hand-written kernels run per block of the domain, each block with a halo
of its neighbours' cells.

The counterpart of the JAX package's shard_map wrappers
(tpufoam/ops/stencil.py:765-928: `momentum_multisweep_pallas_sharded`,
`jacobi_multisweep_pallas_sharded`, `_exchange_halos`,
`pallas_sharded_available_for`). A mesh (`parallel.mesh.Mesh`) is a
(dy, dx) grid of devices, and a device may repeat: four blocks of a 2 x 2
mesh may all lie on one card. The wrappers take and return global
(ny, nx) tensors on one device (the mesh's lead device on the sharded
step), as the JAX wrappers take and return global arrays; each block
(ny/dy, nx/dx) of the result is the kernel's on that block extended by
its halo.

Halo. S sweeps need S rows and columns of valid neighbour data (the
trapezoid argument of the temporal-blocked kernels: after S sweeps a cell
S or more cells inside the haloed block is exact). The TPU wrappers
exchange 128 columns, because the Pallas kernels' E/W lane rolls wrap at
the block edge. The CUDA kernels bound their reads instead, so the
kernels' own halo is exact in both directions: 8 rows and columns in
float32, 16 in bfloat16 (`_halo_for`), along each axis the mesh splits
(`_halos`). Beyond the domain the halo is zero, as the single-device
kernels read zero there.

Two routes, chosen per card (`sharded_routes`), both launching the
hand-written kernels:
- "window": the blocks on the card that holds the operands, every block
  of a mesh of one card. One launch sweeps all of them (`blockIdx.z` is
  the block): its tiles cover each block's interior, read the global
  operands in place, load a cell outside the block's haloed window (or
  the domain) as 0, and store only the block's cells, straight into the
  global output. Nothing else runs on the device but the outputs'
  allocation. The pressure kernels' window form takes one sweep (the
  single-pass kernels) and the run kernel (`stencil.window_geometry`),
  on blocks whose width is a whole number of 16-byte runs, from 16-byte
  aligned operands.
- "exchange": the blocks on another card, and the pressure multisweep's
  blocks that the window form cannot take (the region kernel's). The
  operands are cut into blocks on their devices, `exchange_halos` gives
  every block its neighbours' strips (a `torch.cat` per split axis), the
  kernel runs on the haloed blocks (the momentum kernel once per card,
  over a stack of its blocks; the pressure multisweep once per block,
  its kernels taking no case axis) and the interiors are cropped back
  into the global output. About twenty small copies a call on a 2 x 2
  mesh, as the JAX package's `jnp.stack`, `ppermute` and
  `jnp.concatenate` are to XLA.
Each launch is counted (`launches`) and counted by route (`by_route`).
A failed launch raises; neither route stands in for the other.

These wrappers take whole fields, as the JAX functions do. The
domain-decomposed step (parallel.blocks, piso.decomposed) keeps its
fields per block and launches the single-device kernels once per block
on haloed windows; `exchange_halos` serves both, with clipped windows,
staggered face fields and the blocks of other processes for the latter.

The pressure wrappers fill the haloed diag as the JAX wrapper does when
the mesh splits an axis: every zero becomes 1 (the halo's zeros beyond
the domain would divide by zero in the sweeps; a solid cell's zero diag
inside the domain is filled too). The window form does that as it loads.

On CPU tensors the wrappers run the kernels' plain versions on the same
routes. The `*_plain` functions run the plain version on every block's
haloed window, cut from the zero-padded global operands, whatever the
blocks' devices: what the tests and chip_smoke.py hold both routes to.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from . import momentum as _mom
from . import stencil as _st
from .momentum import momentum_multisweep_plain
from .stencil import _halo_for, jacobi_multisweep_plain, kernel_available_for

# the operands of the pressure kernels; c_out is folded into diag
_Stencil = collections.namedtuple("_Stencil", "c_e c_w c_n c_s diag")


def _dims(mesh) -> tuple[int, int]:
    return len(mesh.devices), len(mesh.devices[0])


def _halos(mesh, dtype) -> tuple[int, int]:
    """(hy, hx): the halo along each axis, 0 along an axis not split."""
    dy, dx = _dims(mesh)
    h = _halo_for(dtype)
    return (h if dy > 1 else 0), (h if dx > 1 else 0)


def sharded_available_for(shape, mesh, dtype=torch.float32,
                          kernel: str = "momentum") -> bool:
    """Can the sharded wrappers take global fields of `shape` over `mesh`?
    The counterpart of `pallas_sharded_available_for`: the grid must
    divide into the mesh's blocks, each block must be at least the halo
    along every split axis (its neighbours' strips come from it), and the
    kernel must take the haloed block (`kernel_available_for`; the
    momentum kernel takes every float32 block). `kernel` is "momentum" or
    "jacobi". A caller that gets False runs the sweep loop, as the JAX
    package runs XLA's."""
    if kernel not in ("momentum", "jacobi"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if len(shape) != 2:
        return False
    (ny, nx), (dy, dx) = shape, _dims(mesh)
    if ny % dy or nx % dx:
        return False
    nyl, nxl = ny // dy, nx // dx
    hy, hx = _halos(mesh, dtype)
    if nyl < hy or nxl < hx:
        return False
    if kernel == "momentum":
        return dtype == torch.float32
    return kernel_available_for((nyl + 2 * hy, nxl + 2 * hx), dtype,
                                "jacobi")


def exchange_halos(blocks, mesh, hy: int, hx: int, clip: bool = False,
                   extra: tuple = (0, 0)):
    """blocks: the (dy, dx) grid (a list of rows) of local operands
    (..., rows, cols), each on its mesh device; None where another
    process of the world owns the block (`Mesh.owners`). Returns the grid
    of haloed blocks along the split axes (None where not owned). Per
    direction one copy moves every operand's edge strip to its
    neighbour's device, as the JAX package's one stacked `ppermute` does:
    first the N/S strips, then the E/W strips of the N/S-extended blocks,
    so that the corners come right. Between processes the strips go by
    point-to-point copies (parallel.distributed.exchange).

    Beyond the domain the halo is zero, or with `clip` absent: a block at
    the domain's edge then ends there, as the whole field does, so that
    a boundary condition applied at an array's edge lands on the domain's
    (the domain-decomposed step's windows). `extra` (rows, columns) is a
    face field's stagger: phi_x has one column more than its cells and
    phi_y one row more, owned by the last block along that axis, so a
    block's strip from its upper neighbour is one face deeper than the
    halo: the window of cells [y0 - h, y1 + h) has the faces
    [y0 - h, y1 + h]."""
    dy, dx = _dims(mesh)
    grid = [list(row) for row in blocks]
    if dy > 1 and hy:
        grid = _extend(grid, mesh, -2, hy, extra[0], clip)
    if dx > 1 and hx:
        grid = _extend(grid, mesh, -1, hx, extra[1], clip)
    return grid


def _extend(grid, mesh, axis: int, h: int, e: int, clip: bool):
    """Each block of `grid` with its neighbours' strips along `axis` (-2:
    the rows i, -1: the columns j): h cells from below, h + e from
    above, zeros beyond the domain unless `clip`."""
    dy, dx = len(grid), len(grid[0])
    n = dy if axis == -2 else dx

    def at(i, j, d):
        return (i + d, j) if axis == -2 else (i, j + d)

    def strip(t, d):
        # the strip of neighbour t that the block at its -d side takes
        return t.narrow(axis, t.shape[axis] - h, h) if d < 0 \
            else t.narrow(axis, 0, h + e)

    local = [(i, j) for i in range(dy) for j in range(dx)
             if grid[i][j] is not None]
    remote = {} if len(local) == dy * dx else _remote_strips(
        grid, mesh, axis, h, e, at, strip)
    out = [[None] * dx for _ in range(dy)]
    for i, j in local:
        b = grid[i][j]
        q = i if axis == -2 else j
        side = {}
        for d in (-1, 1):
            if not 0 <= q + d < n:
                if not clip:
                    shape = list(b.shape)
                    shape[axis] = h
                    side[d] = b.new_zeros(shape)
                continue
            ni, nj = at(i, j, d)
            nb = grid[ni][nj]
            side[d] = strip(nb, d).to(b.device) if nb is not None \
                else remote[i, j, d]
        parts = [t for t in (side.get(-1), b, side.get(1)) if t is not None]
        out[i][j] = torch.cat(parts, dim=axis)
    return out


def _remote_strips(grid, mesh, axis, h, e, at, strip) -> dict:
    """The strips that cross processes, exchanged in one round of
    point-to-point copies: {(i, j, d): strip} for the local blocks whose
    neighbour at d lies on another process."""
    from ..parallel.distributed import exchange
    dy, dx = len(grid), len(grid[0])
    like = next(b for row in grid for b in row if b is not None)
    sends, recvs, keys = [], [], []
    for i in range(dy):
        for j in range(dx):
            for d in (-1, 1):
                ni, nj = at(i, j, d)
                if not (0 <= ni < dy and 0 <= nj < dx):
                    continue
                mine, theirs = grid[i][j], grid[ni][nj]
                if (mine is None) == (theirs is None):
                    continue
                tag = ((i * dx + j) * 2 + (d > 0)) * 2 + (axis == -1)
                if theirs is not None:       # a neighbour of ours: send
                    sends.append((strip(theirs, d),
                                  mesh.owners[i * dx + j], tag))
                else:                        # our block: receive
                    shape = list(mine.shape)
                    shape[axis] = h if d < 0 else h + e
                    recvs.append((shape, like.dtype, mine.device,
                                  mesh.owners[ni * dx + nj], tag))
                    keys.append((i, j, d))
    return dict(zip(keys, exchange(sends, recvs)))


def _layout(mesh, ops, steps: int, name: str):
    """(hy, hx, nyl, nxl) of the global operands `ops` over `mesh`; raises
    where the blocks cannot be exact."""
    x = ops[0]
    if x.dim() != 2 or any(t.shape != x.shape or t.dtype != x.dtype
                           or t.device != x.device for t in ops):
        raise ValueError(f"{name} takes global (ny, nx) operands of one "
                         f"dtype on one device; got "
                         f"{[(tuple(t.shape), t.dtype) for t in ops]}")
    (ny, nx), (dy, dx) = x.shape, _dims(mesh)
    hy, hx = _halos(mesh, x.dtype)
    if ny % dy or nx % dx:
        raise ValueError(f"{name}: ({ny}, {nx}) does not divide into the "
                         f"mesh's {dy} x {dx} blocks")
    nyl, nxl = ny // dy, nx // dx
    if nyl < hy or nxl < hx:
        raise ValueError(f"{name}: blocks of ({nyl}, {nxl}) are smaller "
                         f"than the halo ({hy}, {hx})")
    if not 0 <= steps <= _halo_for(x.dtype):
        raise ValueError(f"{name}: {steps} sweeps are exact only up to the "
                         f"halo, {_halo_for(x.dtype)}")
    return hy, hx, nyl, nxl


def _haloed_blocks(mesh, ops, hy, hx, nyl, nxl):
    """The exchange route's operands: the global operands stacked, cut
    into the mesh's blocks on their devices, and haloed by
    `exchange_halos`; the grid of (n_ops, nyl + 2 hy, nxl + 2 hx)."""
    st = torch.stack(ops)                                # (n_ops, ny, nx)
    blocks = [[st[:, i * nyl:(i + 1) * nyl, j * nxl:(j + 1) * nxl].to(d)
               for j, d in enumerate(row)]
              for i, row in enumerate(mesh.devices)]
    return exchange_halos(blocks, mesh, hy, hx)


def _windows(ops, where, hy, hx, nyl, nxl):
    """The haloed windows of blocks `where` ((i, j) pairs), cut from the
    global operands zero-padded by the halo: what `exchange_halos` gives
    each block, (n_ops, nyl + 2 hy, nxl + 2 hx), on the operands'
    device. The plain versions' route."""
    padded = F.pad(torch.stack(ops), (hx, hx, hy, hy))
    return [padded[:, i * nyl:i * nyl + nyl + 2 * hy,
                   j * nxl:j * nxl + nxl + 2 * hx] for i, j in where]


def _by_device(mesh) -> dict:
    """{device: [(i, j), ...]}: each device's blocks, row-major."""
    groups: dict = {}
    for i, row in enumerate(mesh.devices):
        for j, d in enumerate(row):
            groups.setdefault(d, []).append((i, j))
    return groups


def sharded_routes(mesh, shape, dtype=torch.float32,
                   kernel: str = "momentum", iters: int = 2,
                   operands_on=None, aligned: bool = True) -> dict:
    """{device: "window" or "exchange"}: the route of each card's blocks
    of the global `shape` over `mesh` when the operands lie on the device
    `operands_on` (the mesh's lead device if None) and, for `kernel`
    "jacobi", `iters` sweeps from operands all 16-byte aligned or not
    (`aligned`). The
    window route takes the operands' card's blocks, up to
    `MAX_WINDOW_BLOCKS` of them, and for the pressure multisweep only
    where `stencil.window_geometry` has a launch for them; every other
    card's blocks take the exchange route."""
    if kernel not in ("momentum", "jacobi"):
        raise ValueError(f"unknown kernel {kernel!r}")
    device = mesh.lead if operands_on is None else torch.device(operands_on)
    (ny, nx), (dy, dx) = shape, _dims(mesh)
    block = (ny // dy, nx // dx)
    routes = {}
    for d, where in _by_device(mesh).items():
        window = d == device and len(where) <= _st.MAX_WINDOW_BLOCKS
        if window and kernel == "jacobi":
            window = _st.window_geometry(len(where), block, dtype, iters,
                                         aligned) is not None
        routes[d] = "window" if window else "exchange"
    return routes


def _origins(where, nyl, nxl):
    return [(i * nyl, j * nxl) for i, j in where]


def _put(out, i, j, nyl, nxl, part):
    out[i * nyl:(i + 1) * nyl, j * nxl:(j + 1) * nxl].copy_(part)


def _count(fn, route):
    fn.launches += 1
    fn.by_route[route] += 1


def _momentum(mesh, ops, sweeps, plain):
    hy, hx, nyl, nxl = _layout(mesh, ops, sweeps,
                               "momentum_multisweep_sharded")
    x = ops[7]
    u, v = torch.empty_like(x), torch.empty_like(x)
    groups = _by_device(mesh)
    routes = {d: "window" for d in groups} if plain else sharded_routes(
        mesh, tuple(x.shape), x.dtype, "momentum", operands_on=x.device)
    haloed = None
    for d, where in groups.items():
        if routes[d] == "window":
            if plain or _mom._check(ops, sweeps):
                for (i, j), win in zip(where, _windows(ops, where, hy, hx,
                                                       nyl, nxl)):
                    for out, part in zip((u, v), momentum_multisweep_plain(
                            *win, sweeps=sweeps)):
                        _put(out, i, j, nyl, nxl,
                             part[hy:hy + nyl, hx:hx + nxl])
            else:
                _mom._launch(ops, sweeps, out=(u, v), window=(
                    (nyl, nxl), _origins(where, nyl, nxl), (hy, hx)))
                _count(momentum_multisweep_sharded, "window")
            continue
        if haloed is None:
            haloed = _haloed_blocks(mesh, ops, hy, hx, nyl, nxl)
        # (9, blocks, nyh, nxh): each operand a contiguous stack of planes
        stack = torch.stack([haloed[i][j] for i, j in where], dim=1)
        planes = tuple(stack)
        if _mom._check(planes, sweeps):
            uv = torch.stack(momentum_multisweep_plain(*planes,
                                                       sweeps=sweeps))
        else:
            uv = stack.new_empty((2, *stack.shape[1:]))
            _mom._launch(planes, sweeps, out=(uv[0], uv[1]))
            _count(momentum_multisweep_sharded, "exchange")
        for k, (i, j) in enumerate(where):
            for out, part in zip((u, v), uv[:, k]):
                _put(out, i, j, nyl, nxl, part[hy:hy + nyl, hx:hx + nxl])
    return u, v


def momentum_multisweep_sharded(mesh, a_e, a_w, a_n, a_s, ap_inv, bu, bv,
                                u0, v0, sweeps: int = 8):
    """`momentum_multisweep` over `mesh` (replaces the TPU kernel
    `momentum_multisweep_pallas_sharded`, tpufoam/ops/stencil.py:850):
    global (ny, nx) operands in, global (u, v) out, on the operands'
    device; equal to the single-device kernel for sweeps <= 8. One launch
    of the momentum kernel per card: the window launch on the operands'
    card, a launch over the stacked haloed blocks on any other."""
    return _momentum(mesh, (a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0),
                     sweeps, plain=False)


def momentum_multisweep_sharded_plain(mesh, a_e, a_w, a_n, a_s, ap_inv, bu,
                                      bv, u0, v0, sweeps: int = 8):
    """`momentum_multisweep_plain` on every block's haloed window, the
    interiors put together."""
    return _momentum(mesh, (a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0),
                     sweeps, plain=True)


def _jacobi(mesh, coef, x, b, iters, omega, plain):
    ops = (x, b, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag)
    hy, hx, nyl, nxl = _layout(mesh, ops, iters,
                               "jacobi_multisweep_sharded")
    out = torch.empty_like(x)
    groups = _by_device(mesh)
    aligned = all(t.data_ptr() % 16 == 0 for t in ops)
    routes = {d: "window" for d in groups} if plain else sharded_routes(
        mesh, tuple(x.shape), x.dtype, "jacobi", iters, x.device, aligned)
    stencil = _Stencil(*ops[2:])
    cpu = plain or _st._check("jacobi_multisweep_sharded", stencil, (x, b),
                              iters, "jacobi")
    haloed = None
    for d, where in groups.items():
        if routes[d] == "window" and not cpu:
            _st._launch_window(
                stencil, x, b, out, iters, omega, (nyl, nxl),
                _origins(where, nyl, nxl), (hy, hx),
                _st.window_geometry(len(where), (nyl, nxl), x.dtype, iters,
                                    aligned))
            _count(jacobi_multisweep_sharded, "window")
            continue
        if routes[d] == "window":
            blocks = _windows(ops, where, hy, hx, nyl, nxl)
        else:
            if haloed is None:
                haloed = _haloed_blocks(mesh, ops, hy, hx, nyl, nxl)
            blocks = [haloed[i][j] for i, j in where]
        for (i, j), blk in zip(where, blocks):
            if hy or hx:
                # the zero halo beyond the domain would divide by a zero
                # diag in the halo's sweeps (cropped away, but kept
                # finite); as the JAX wrapper does, every zero of the
                # haloed diag becomes 1
                blk[6].masked_fill_(blk[6] == 0, 1.0)
            cf = _Stencil(*blk[2:7])
            fields = (blk[0], blk[1])
            if cpu or _st._check("jacobi_multisweep_sharded", cf, fields,
                                 iters, "jacobi"):
                res = jacobi_multisweep_plain(cf, *fields, iters, omega)
            else:
                res = torch.empty_like(blk[0])
                _st._launch_multisweep("jacobi_multisweep_sharded",
                                       "jacobi_multisweep", cf, fields,
                                       (res,), iters, omega)
                _count(jacobi_multisweep_sharded, "exchange")
            _put(out, i, j, nyl, nxl, res[hy:hy + nyl, hx:hx + nxl])
    return out


def jacobi_multisweep_sharded(mesh, coef, x, b, iters: int = 2,
                              omega: float = 0.8):
    """`jacobi_multisweep` over `mesh` (replaces the TPU kernel
    `jacobi_multisweep_pallas_sharded`, tpufoam/ops/stencil.py:886), in
    float32 or bfloat16, for iters <= halo. Global operands in, the
    global result out, on the operands' device: one window launch for
    the operands' card's blocks, one launch of the jacobi_multisweep
    kernel per block on the exchange route."""
    return _jacobi(mesh, coef, x, b, iters, omega, plain=False)


def jacobi_multisweep_sharded_plain(mesh, coef, x, b, iters: int = 2,
                                    omega: float = 0.8):
    """`jacobi_multisweep_plain` on every block's haloed window, its diag
    filled, the interiors put together."""
    return _jacobi(mesh, coef, x, b, iters, omega, plain=True)


# launches, and launches by route ("window" or "exchange")
for _fn_ in (momentum_multisweep_sharded, jacobi_multisweep_sharded):
    _fn_.launches = 0
    _fn_.by_route = collections.Counter()
del _fn_
