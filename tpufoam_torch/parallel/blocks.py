"""Fields resident per block of a mesh: the layout of the
domain-decomposed step (parallel.mesh.shard_case / shard_flow and
piso.decomposed).

A `BlockField` holds one tensor per block of a `parallel.mesh.Mesh`, each
on its block's device (None for the blocks another process of the world
owns), with the field's global shape and its split:
- a cell field (ny, nx) splits over (y, x) into (ny/dy, nx/dx) blocks;
- a face field splits the same way along both axes, its one extra face
  owned by the last block along that axis: phi_x (ny, nx + 1) gives the
  blocks of the last mesh column nx/dx + 1 columns (the outlet's face),
  phi_y (ny + 1, nx) the blocks of the last mesh row ny/dy + 1 rows (the
  top wall's face), and every other block its cells' west (south) faces;
- a profile over rows (the inlet, (ny,)) splits over y, each block
  holding its rows;
- a scalar (dt, t) is replicated, one copy per block on its device.
A field may store a halo with its blocks (the case's static fields do:
each block holds its window of cells, clipped at the domain's edges), so
that a stage cuts the window it needs as a view.

`windows` gives every local block its window of halo h, a view of a
stored halo or after `ops.sharded.exchange_halos` (clipped: a block at
the domain's edge ends there, as the whole field does, so that a
boundary closure applied at an array's edge lands on the domain's). A
stage computes on the windows and `crop` keeps each block's own cells
and faces: a cell h or more cells from a window's inner edge is exact
when h is at least the stage's reach.

Reductions take one value per block, then combine the blocks in mesh
order, the same on every process (`block_sum`, `block_max`, `block_all`;
in a world the per-block values are all-gathered first, so every process
adds the same numbers in the same order as one process would).

`gather` moves a whole field to one device; the only whole fields of the
decomposed step are the surrogate's (piso.decomposed) and the coarsest
multigrid levels (solvers.decomposed), each inside `whole_field_stage`,
which tests read to tell them from a leak.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools

import torch

from ..core.grid import Grid2D
from ..ops.sharded import exchange_halos
from ..utils.profiling import host_read


def _dims(mesh) -> tuple[int, int]:
    return len(mesh.devices), len(mesh.devices[0])


def _span(n: int, parts: int, q: int, e: int, h: int) -> tuple[int, int]:
    """[a, b) of block q's window of halo h along an axis of n cells
    split into `parts`, for a field of stagger e (0 cells, 1 faces)."""
    size = n // parts
    if h == 0:
        return q * size, (q + 1) * size + (e if q == parts - 1 else 0)
    return max(0, q * size - h), min(n + e, (q + 1) * size + h + e)


def _offset(n: int, parts: int, q: int, h: int) -> int:
    """Where block q's own cells start in its window of halo h."""
    return min(h, q * (n // parts))


class BlockField:
    """One tensor per block of `mesh` (see the module docstring):
    `blocks[k]` is block k's (row-major) on `mesh.device_list[k]`, None
    where another process owns it. `shape` is the global shape, `stagger`
    (0, 1) for phi_x and (1, 0) for phi_y, `halo` the (hy, hx) each block
    stores (its window, clipped at the domain's edges)."""

    __slots__ = ("mesh", "shape", "blocks", "stagger", "halo")

    def __init__(self, mesh, shape, blocks, stagger=(0, 0), halo=(0, 0)):
        self.mesh, self.shape = mesh, tuple(shape)
        self.blocks = tuple(blocks)
        self.stagger, self.halo = tuple(stagger), tuple(halo)

    def __repr__(self):
        return (f"BlockField(shape={self.shape}, mesh={_dims(self.mesh)}, "
                f"stagger={self.stagger}, halo={self.halo})")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self.blocks[self.mesh.local_blocks[0]].dtype

    def local(self):
        """(k, block) for this process's blocks, row-major."""
        return [(k, self.blocks[k]) for k in self.mesh.local_blocks]

    def interior(self, k: int) -> torch.Tensor:
        """Block k without its stored halo."""
        t = self.blocks[k]
        if self.halo == (0, 0) or self.ndim == 0:
            return t
        return _cut(self, k, t, self.halo, (0, 0))

    def gather(self) -> torch.Tensor:
        """The whole field on the mesh's lead device (this process's first
        device: in a world every process receives it)."""
        device = self.mesh.lead
        if self.ndim == 0:
            return self.blocks[self.mesh.local_blocks[0]].to(device)
        parts = _all_blocks(self)
        dy, dx = _dims(self.mesh)
        if self.ndim == 1:
            return torch.cat([parts[i * dx].to(device) for i in range(dy)])
        return torch.cat([torch.cat([parts[i * dx + j].to(device)
                                     for j in range(dx)], dim=-1)
                          for i in range(dy)], dim=-2)


def _cut(field: BlockField, k: int, t: torch.Tensor, have, want):
    """The window of halo `want` of block k, from its window of halo
    `have` (a view)."""
    dy, dx = _dims(field.mesh)
    i, j = divmod(k, dx)
    ny = field.shape[-2 if field.ndim == 2 else 0] - field.stagger[0]
    ay, by = _span(ny, dy, i, field.stagger[0], have[0])
    wy, zy = _span(ny, dy, i, field.stagger[0], want[0])
    t = t.narrow(-2 if field.ndim == 2 else 0, wy - ay, zy - wy)
    if field.ndim == 1:
        return t
    nx = field.shape[-1] - field.stagger[1]
    ax, bx = _span(nx, dx, j, field.stagger[1], have[1])
    wx, zx = _span(nx, dx, j, field.stagger[1], want[1])
    return t.narrow(-1, wx - ax, zx - wx)


def _all_blocks(field: BlockField) -> list:
    """Every block of `field` (their own cells), on the device that holds
    it here: in a world the other processes' blocks arrive by
    point-to-point copies (parallel.distributed.exchange)."""
    mesh = field.mesh
    own = {k: field.interior(k) for k in mesh.local_blocks}
    if len(own) == mesh.size:
        return [own[k] for k in range(mesh.size)]
    from .distributed import exchange
    dy, dx = _dims(mesh)
    like = next(iter(own.values()))
    sends, recvs, keys = [], [], []
    for k in range(mesh.size):
        for r in sorted(set(mesh.owners)):
            if r == mesh.owners[k]:
                continue
            if k in own:
                sends.append((own[k], r, k))
            elif r == mesh.rank:
                shape = list(like.shape)
                i, j = divmod(k, dx)
                if field.ndim >= 1:
                    n = field.shape[-2 if field.ndim == 2 else 0] \
                        - field.stagger[0]
                    a, b = _span(n, dy, i, field.stagger[0], 0)
                    shape[-2 if field.ndim == 2 else 0] = b - a
                if field.ndim == 2:
                    a, b = _span(field.shape[-1] - field.stagger[1], dx, j,
                                 field.stagger[1], 0)
                    shape[-1] = b - a
                recvs.append((shape, like.dtype, mesh.lead,
                              mesh.owners[k], k))
                keys.append(k)
    own.update(zip(keys, exchange(sends, recvs)))
    return [own[k] for k in range(mesh.size)]


def split(mesh, t: torch.Tensor, stagger=(0, 0), halo=(0, 0)) -> BlockField:
    """The whole tensor `t` ((ny, nx) cells or faces, (ny,) rows, or a
    scalar) as a BlockField over `mesh`, each of this process's blocks a
    contiguous copy on its device, with a stored `halo` (cells and rows
    only). Raises where the field does not divide over the mesh or a
    block cannot hold the halo."""
    dy, dx = _dims(mesh)
    devs = mesh.device_list
    blocks = [None] * mesh.size
    if t.dim() == 0:
        for k in mesh.local_blocks:
            blocks[k] = t.to(devs[k])
        return BlockField(mesh, (), blocks)
    ny = t.shape[-2 if t.dim() == 2 else 0] - stagger[0]
    nx = t.shape[-1] - stagger[1] if t.dim() == 2 else None
    _check_split(ny, dy, "rows")
    if nx is not None:
        _check_split(nx, dx, "columns")
    field = BlockField(mesh, t.shape, blocks, stagger, halo)
    check_halo(field, max(halo), "the stored halo")
    for k in mesh.local_blocks:
        i, j = divmod(k, dx)
        ay, by = _span(ny, dy, i, stagger[0], halo[0] if dy > 1 else 0)
        part = t.narrow(-2 if t.dim() == 2 else 0, ay, by - ay)
        if nx is not None:
            ax, bx = _span(nx, dx, j, stagger[1], halo[1] if dx > 1 else 0)
            part = part.narrow(-1, ax, bx - ax)
        blocks[k] = part.to(devs[k], copy=True).contiguous()
    field.blocks = tuple(blocks)
    return field


def _check_split(n: int, parts: int, what: str):
    if n % parts:
        raise ValueError(f"{n} {what} do not divide over the mesh's "
                         f"{parts} blocks")


def check_halo(field: BlockField, h: int, what: str = "a stage"):
    """Raise where a block of `field` cannot hold a halo of h along an
    axis the mesh splits: its neighbours' strips come from one block
    each, h cells from below and h + stagger from above."""
    if h == 0 or field.ndim == 0:
        return
    dy, dx = _dims(field.mesh)
    axes = [(field.shape[-2 if field.ndim == 2 else 0] - field.stagger[0],
             dy, field.stagger[0])]
    if field.ndim == 2:
        axes.append((field.shape[-1] - field.stagger[1], dx,
                     field.stagger[1]))
    for n, parts, e in axes:
        if parts > 1 and (n // parts < h or (parts > 2 and n // parts
                                               < h + e)):
            raise ValueError(
                f"{what} needs a halo of {h}, which blocks of {n // parts} "
                f"cells over a mesh axis of {parts} cannot hold")


def windows(fields, h: int) -> dict:
    """{k: [window of each field]} for this process's blocks: the window
    of halo h (clipped at the domain's edges) of each BlockField, a view
    of its stored halo or after one exchange; a scalar's block as it is;
    anything else as it is."""
    mesh = next(f.mesh for f in fields if isinstance(f, BlockField))
    dy, dx = _dims(mesh)
    hy, hx = (h if dy > 1 else 0), (h if dx > 1 else 0)
    per = {k: [] for k in mesh.local_blocks}
    for f in fields:
        if not isinstance(f, BlockField):
            for k in per:
                per[k].append(f)
        elif f.ndim == 0:
            for k in per:
                per[k].append(f.blocks[k])
        elif f.halo != (0, 0) or h == 0 or f.ndim == 1:
            if f.halo[0] < hy or (f.ndim == 2 and f.halo[1] < hx):
                raise ValueError(f"{f} stores a halo below the {h} a "
                                 "stage needs")
            for k in per:
                per[k].append(_cut(f, k, f.blocks[k], f.halo, (hy, hx)))
        else:
            check_halo(f, h)
            grid = [[f.blocks[i * dx + j] for j in range(dx)]
                    for i in range(dy)]
            got = exchange_halos(grid, mesh, hy, hx, clip=True,
                                 extra=f.stagger)
            for k in per:
                per[k].append(got[k // dx][k % dx])
    return per


def crop(mesh, shape, k: int, t: torch.Tensor, h: int,
         stagger=(0, 0)) -> torch.Tensor:
    """Block k's own cells (or faces) of its window `t` of halo h of a
    field of global `shape`."""
    dy, dx = _dims(mesh)
    i, j = divmod(k, dx)
    ny, nx = shape[-2] - stagger[0], shape[-1] - stagger[1]
    oy = _offset(ny, dy, i, h) if dy > 1 else 0
    ox = _offset(nx, dx, j, h) if dx > 1 else 0
    ay, by = _span(ny, dy, i, stagger[0], 0)
    ax, bx = _span(nx, dx, j, stagger[1], 0)
    return t[..., oy:oy + by - ay, ox:ox + bx - ax]


def window_grid(grid: Grid2D, mesh, k: int, h: int) -> Grid2D:
    """The grid of block k's window of halo h: its local dims, origin and,
    on a graded grid, its slice of the spacings (whose metric terms equal
    the whole grid's at every cell but the window's inner edges, which
    the halo covers). dx and dy stay the whole grid's: the conservative
    guards read them."""
    dy, dx = _dims(mesh)
    i, j = divmod(k, dx)
    ya, yb = _span(grid.ny, dy, i, 0, h if dy > 1 else 0)
    xa, xb = _span(grid.nx, dx, j, 0, h if dx > 1 else 0)
    xs = grid.xs[xa:xb] if grid.xs is not None else None
    ys = grid.ys[ya:yb] if grid.ys is not None else None
    x0 = grid.x0 + (sum(grid.xs[:xa]) if xs is not None else xa * grid.dx)
    y0 = grid.y0 + (sum(grid.ys[:ya]) if ys is not None else ya * grid.dy)
    return Grid2D(nx=xb - xa, ny=yb - ya, dx=grid.dx, dy=grid.dy, x0=x0,
                  y0=y0, xs=xs, ys=ys)


def bmap(fn, *args) -> BlockField:
    """fn applied block by block: each BlockField argument as its block's
    own cells (a scalar as its block's copy), anything else as it is;
    the result takes the first 2-D field's layout (a scalar's if none)."""
    first = next((a for a in args if isinstance(a, BlockField)
                  and a.ndim == 2), None) or next(
        a for a in args if isinstance(a, BlockField))
    mesh = first.mesh
    out = {}
    for k in mesh.local_blocks:
        out[k] = fn(*[a.interior(k) if isinstance(a, BlockField) else a
                      for a in args])
    full = [None] * mesh.size
    for k, t in out.items():
        full[k] = t
    return BlockField(mesh, first.shape, full, first.stagger)


def stage(mesh, h: int, fn, inputs, outputs):
    """Run `fn(k, *windows)` on every local block's windows of halo h of
    `inputs` (see `windows`) and keep each block's own part of its
    outputs. `outputs` gives each output's (global shape, stagger), or
    None for a scalar (kept as it is). Returns the BlockFields."""
    per = windows(inputs, h)
    got = {k: fn(k, *w) for k, w in per.items()}
    res = []
    for n, spec in enumerate(outputs):
        blocks = [None] * mesh.size
        for k, outs in got.items():
            t = outs[n]
            blocks[k] = t if spec is None else crop(mesh, spec[0], k, t, h,
                                                    spec[1])
        res.append(BlockField(mesh, () if spec is None else spec[0], blocks,
                              (0, 0) if spec is None else spec[1]))
    return res


# ---- reductions ----------------------------------------------------------


def _combine(mesh, values: dict, fold) -> BlockField:
    """One value per block ({k: tensor}), combined by `fold` (the list of
    the values in mesh order, on the lead device) and replicated to every
    block's device. In a world the values arrive by an all-gather
    (parallel.distributed.gather_blocks, differentiable in a world_tape),
    so every process folds the same values in the same order."""
    if mesh.owners is not None:
        from .distributed import gather_blocks
        mine = torch.stack([values[k].to(mesh.lead)
                            for k in mesh.local_blocks])
        ranks = sorted(set(mesh.owners))
        every = dict(zip(ranks, gather_blocks(mine)))
        seen = {r: 0 for r in ranks}
        values = {}
        for k, r in enumerate(mesh.owners):
            values[k] = every[r][seen[r]]
            seen[r] += 1
    acc = fold([values[k].to(mesh.lead) for k in range(mesh.size)])
    blocks = [None] * mesh.size
    copies = {}
    for k in mesh.local_blocks:
        d = mesh.device_list[k]
        if d not in copies:
            copies[d] = acc.to(d)
        blocks[k] = copies[d]
    return BlockField(mesh, (), blocks)


def block_sum(mesh, values: dict) -> BlockField:
    """The blocks' values summed in mesh order."""
    return _combine(mesh, values, lambda vs: functools.reduce(torch.add, vs))


def block_max(mesh, values: dict) -> BlockField:
    """The blocks' max, one amax of the stacked values: a tie splits the
    gradient evenly over the tied blocks, as jnp.max does (a fold of
    pairwise maxima would halve it at every tie)."""
    return _combine(mesh, values,
                    lambda vs: torch.amax(torch.stack(vs), dim=0))


def block_all(mesh, values: dict) -> BlockField:
    """Every block's bool is true (combined as bytes: gloo moves no
    bools)."""
    return bmap(lambda t: t.bool(), _combine(
        mesh, {k: t.to(torch.uint8) for k, t in values.items()},
        lambda vs: torch.amin(torch.stack(vs), dim=0)))


def dot(a: BlockField, b: BlockField) -> BlockField:
    """The inner product over the whole domain: each block's sum of a*b,
    summed over the blocks in mesh order."""
    return block_sum(a.mesh, {k: (a.interior(k) * b.interior(k)).sum()
                              for k in a.mesh.local_blocks})


def norm(a: BlockField) -> BlockField:
    """The 2-norm over the whole domain: the square root of the blocks'
    sums of squares, summed in mesh order."""
    s = block_sum(a.mesh, {k: torch.square(a.interior(k)).sum()
                           for k in a.mesh.local_blocks})
    return bmap(torch.sqrt, s)


def value(s: BlockField):
    """A replicated scalar's value on the host (one read)."""
    return host_read(s.blocks[s.mesh.local_blocks[0]])


# ---- the whole-field stages ----------------------------------------------

_WHOLE = contextvars.ContextVar("whole_field_stage", default=None)


@contextlib.contextmanager
def whole_field_stage(name: str):
    """Marks the stages that hold a whole field (the surrogate's gather,
    the agglomerated multigrid levels): `current_whole_stage()` names the
    innermost while it runs."""
    token = _WHOLE.set(name)
    try:
        yield
    finally:
        _WHOLE.reset(token)


def current_whole_stage():
    return _WHOLE.get()


def shard_tree(mesh, tree, staggers: dict, halo=(0, 0)):
    """The dataclass `tree` with each tensor field split over `mesh`
    (`staggers` by field name, (0, 0) by default; scalars replicated)."""
    return dataclasses.replace(tree, **{
        f.name: split(mesh, getattr(tree, f.name),
                      staggers.get(f.name, (0, 0)),
                      halo if getattr(tree, f.name).dim() else (0, 0))
        for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def unshard_tree(tree):
    """The dataclass `tree` with each BlockField gathered whole on the
    mesh's lead device."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).gather()
        for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), BlockField)})
