"""The momentum and pressure multisweeps on a mesh of devices: the
hand-written kernels run per block of the domain, on halo-extended blocks.

The counterpart of the JAX package's shard_map wrappers
(tpufoam/ops/stencil.py:765-928: `momentum_multisweep_pallas_sharded`,
`jacobi_multisweep_pallas_sharded`, `_exchange_halos`,
`pallas_sharded_available_for`). A mesh (`parallel.mesh.Mesh`) is a
(dy, dx) grid of devices, and a device may repeat: four blocks of a 2 x 2
mesh may all lie on one card. The wrappers take and return global
(ny, nx) tensors on the mesh's lead device, as the JAX wrappers take and
return global arrays. They cut the operands into (ny/dy, nx/dx) blocks,
place each block on its device, and `exchange_halos` gives every block
the rows and columns of its neighbours that the sweeps need. Each card
then runs its blocks, and the results are cropped and put back together
on the lead device.

Halo. S sweeps need S rows and columns of valid neighbour data (the
trapezoid argument of the temporal-blocked kernels: after S sweeps a cell
S or more cells inside the haloed block is exact). The TPU wrappers
exchange 128 columns, because the Pallas kernels' E/W lane rolls wrap at
the block edge. The CUDA kernels bound their reads instead, so the
kernels' own halo is exact in both directions: 8 rows and columns in
float32, 16 in bfloat16 (`_halo_for`), 16 times fewer bytes per E/W
exchange than the TPU wrappers move. Beyond the domain the halo is zero,
as the single-device kernels read zero there; every haloed block then has
the same shape.

Cost. The split, the exchange (`torch.cat` of each block with its
neighbours' strips), the stack for the kernel and the crop are plain
PyTorch copies: about twenty small launches per call on a 2 x 2 mesh
beside the kernel's one. On one card this is what the JAX package's
`jnp.stack`, `ppermute` and `jnp.concatenate` are to XLA.

On the card the momentum wrapper makes one launch of the momentum kernel
per card for all that card's blocks (`blockIdx.z` is the block), and the
pressure wrapper one launch of the jacobi_multisweep kernel per block
(that kernel takes no case axis). A block on the CPU runs the kernel's
plain version; the `*_plain` functions run it for every block, whatever
its device.
"""

from __future__ import annotations

import collections

import torch

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


def exchange_halos(blocks, mesh, hy: int, hx: int):
    """blocks: the (dy, dx) grid (a list of rows) of stacked local
    operands (n_ops, nyl, nxl), each on its mesh device. Returns the grid
    of haloed blocks (n_ops, nyl + 2 hy, nxl + 2 hx) along the split
    axes. Per direction one copy moves every operand's edge strip to its
    neighbour's device, as the JAX package's one stacked `ppermute` does:
    first the N/S strips, then the E/W strips of the N/S-extended blocks,
    so that the corners come right. Beyond the domain the halo is zero."""
    dy, dx = _dims(mesh)
    zeros = {}

    def zero(like, shape):
        key = (like.device, like.dtype, shape)
        if key not in zeros:
            zeros[key] = like.new_zeros(shape)
        return zeros[key]

    if dy > 1:
        blocks = [[torch.cat([
            blocks[i - 1][j][:, -hy:].to(b.device) if i > 0
            else zero(b, (b.shape[0], hy, b.shape[2])),
            b,
            blocks[i + 1][j][:, :hy].to(b.device) if i < dy - 1
            else zero(b, (b.shape[0], hy, b.shape[2]))], dim=1)
            for j, b in enumerate(row)] for i, row in enumerate(blocks)]
    if dx > 1:
        blocks = [[torch.cat([
            row[j - 1][:, :, -hx:].to(b.device) if j > 0
            else zero(b, (b.shape[0], b.shape[1], hx)),
            b,
            row[j + 1][:, :, :hx].to(b.device) if j < dx - 1
            else zero(b, (b.shape[0], b.shape[1], hx))], dim=2)
            for j, b in enumerate(row)] for row in blocks]
    return blocks


def _haloed_blocks(mesh, ops, steps: int, name: str):
    """Stack the global operands, cut them into the mesh's blocks on
    their devices and exchange the halos. Returns (haloed blocks, hy, hx,
    nyl, nxl). Raises where the blocks cannot be exact."""
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
    st = torch.stack(ops)                                # (n_ops, ny, nx)
    blocks = [[st[:, i * nyl:(i + 1) * nyl, j * nxl:(j + 1) * nxl].to(d)
               for j, d in enumerate(row)]
              for i, row in enumerate(mesh.devices)]
    return exchange_halos(blocks, mesh, hy, hx), hy, hx, nyl, nxl


def _by_device(mesh) -> dict:
    """{device: [(i, j), ...]}: each device's blocks, row-major."""
    groups: dict = {}
    for i, row in enumerate(mesh.devices):
        for j, d in enumerate(row):
            groups.setdefault(d, []).append((i, j))
    return groups


def _momentum(mesh, ops, sweeps, plain):
    blocks, hy, hx, nyl, nxl = _haloed_blocks(
        mesh, ops, sweeps, "momentum_multisweep_sharded")
    out = ops[0].new_empty((2, *ops[0].shape))
    for where in _by_device(mesh).values():
        # (9, blocks, nyh, nxh): each operand a contiguous stack of planes
        stack = torch.stack([blocks[i][j] for i, j in where], dim=1)
        planes = tuple(stack)
        if plain or _mom._check(planes, sweeps):
            uv = torch.stack(momentum_multisweep_plain(*planes,
                                                       sweeps=sweeps))
        else:
            uv = stack.new_empty((2, *stack.shape[1:]))
            _mom._launch(planes, sweeps, out=(uv[0], uv[1]))
            momentum_multisweep_sharded.launches += 1
        for k, (i, j) in enumerate(where):
            out[:, i * nyl:(i + 1) * nyl, j * nxl:(j + 1) * nxl].copy_(
                uv[:, k, hy:hy + nyl, hx:hx + nxl])
    return out[0], out[1]


def momentum_multisweep_sharded(mesh, a_e, a_w, a_n, a_s, ap_inv, bu, bv,
                                u0, v0, sweeps: int = 8):
    """`momentum_multisweep` over `mesh` (replaces the TPU kernel
    `momentum_multisweep_pallas_sharded`, tpufoam/ops/stencil.py:850):
    global (ny, nx) operands in, global (u, v) out, on the lead device;
    equal to the single-device kernel for sweeps <= 8. One launch of the
    momentum kernel per card, over all its haloed blocks."""
    return _momentum(mesh, (a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0),
                     sweeps, plain=False)


def momentum_multisweep_sharded_plain(mesh, a_e, a_w, a_n, a_s, ap_inv, bu,
                                      bv, u0, v0, sweeps: int = 8):
    """The same split, exchange and crop, with `momentum_multisweep_plain`
    on every block."""
    return _momentum(mesh, (a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0),
                     sweeps, plain=True)


def _jacobi(mesh, coef, x, b, iters, omega, plain):
    ops = (x, b, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag)
    blocks, hy, hx, nyl, nxl = _haloed_blocks(
        mesh, ops, iters, "jacobi_multisweep_sharded")
    out = torch.empty_like(x)
    for i, j in ((i, j) for i in range(len(blocks))
                 for j in range(len(blocks[0]))):
        blk = blocks[i][j]
        if hy or hx:
            # the zero halo beyond the domain would divide by a zero diag
            # in the halo's sweeps (cropped away, but kept finite); as the
            # JAX wrapper does, every zero of the haloed diag becomes 1
            blk[6].masked_fill_(blk[6] == 0, 1.0)
        cf = _Stencil(*blk[2:7])
        fields = (blk[0], blk[1])
        if plain or _st._check("jacobi_multisweep_sharded", cf, fields,
                               iters, "jacobi"):
            res = jacobi_multisweep_plain(cf, *fields, iters, omega)
        else:
            res = torch.empty_like(blk[0])
            _st._launch_multisweep("jacobi_multisweep_sharded",
                                   "jacobi_multisweep", cf, fields, (res,),
                                   iters, omega)
            jacobi_multisweep_sharded.launches += 1
        out[i * nyl:(i + 1) * nyl, j * nxl:(j + 1) * nxl].copy_(
            res[hy:hy + nyl, hx:hx + nxl])
    return out


def jacobi_multisweep_sharded(mesh, coef, x, b, iters: int = 2,
                              omega: float = 0.8):
    """`jacobi_multisweep` over `mesh` (replaces the TPU kernel
    `jacobi_multisweep_pallas_sharded`, tpufoam/ops/stencil.py:886), in
    float32 or bfloat16, for iters <= halo: one launch of the
    jacobi_multisweep kernel per block. Global operands in, the global
    result out, on the lead device."""
    return _jacobi(mesh, coef, x, b, iters, omega, plain=False)


def jacobi_multisweep_sharded_plain(mesh, coef, x, b, iters: int = 2,
                                    omega: float = 0.8):
    """The same split, exchange, diag fill and crop, with
    `jacobi_multisweep_plain` on every block."""
    return _jacobi(mesh, coef, x, b, iters, omega, plain=True)


momentum_multisweep_sharded.launches = 0
jacobi_multisweep_sharded.launches = 0
