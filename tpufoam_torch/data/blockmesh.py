"""Parametric external-flow blockMeshDict generators.

The reference ships ten per-shape mesh generator scripts
(Thesis_Work/Generate_blockMeshDict/{cylinder,rectangle,triangle,ellipse,
inclined_plate}/gen_blockMeshDict*.py plus the For_kwSST variants with
turbulent-boundary-layer grading, e.g. For_kwSST/rect_alpha.py:4-30), each
hand-writing vertex/hex lists for one topology. Here one generic 2D
multi-block spec (`MeshSpec2D`) + emitter (`emit_blockmesh`) replaces the
duplicated file-writing, and each shape is a small topology function:

  cylinder_spec       — 10-block half-domain O-grid around a half cylinder
                        (gen_blockMeshDict.py:4-196 parametrization:
                        r_int, y_max, refinement; r_ext = 2 r_int, domain
                        x in [-r-4, -r+11])
  rectangle_spec      — 8-block half-domain mesh around a bottom-mounted
                        rectangle (rectangle/gen_blockMeshDict.py:4)
  triangle_spec       — 4-block half-domain mesh around a right-pointing
                        half triangle (triangle/gen_blockMeshDict.py:4)
  ellipse_spec        — 6-block full-domain mesh with elliptical arc
                        obstacle edges (ellipse/gen_blockMeshDict_elipse.py)
  plate_spec          — 8-block full-domain pinwheel around an inclined
                        plate/rectangle (inclined_plate/gen_blockMeshDict.py
                        and For_kwSST/rect_alpha.py share this topology)

Half-domain specs are meant to be mirrored about y=0 with mirrorMesh
(sim_cmd.sh:13-27; casegen.write_mirror_mesh_dict). `bl_grading` < 1
refines toward the obstacle wall — the For_kwSST role.

The port's own copy of the JAX package's module of this name (text
writers only; the port imports nothing of that package): each function
writes the same bytes.
"""

from __future__ import annotations

import dataclasses
import math
import os

from .casegen import _HEADER, write_mirror_mesh_dict


@dataclasses.dataclass(frozen=True)
class Block2D:
    quad: tuple            # 4 vertex ids, CCW in the xy plane
    nx: int
    ny: int
    gx: object = 1.0       # float or a multi-grading string
    gy: object = 1.0


@dataclasses.dataclass
class MeshSpec2D:
    verts: list            # [(x, y)]
    blocks: list           # [Block2D]
    arcs: list             # [(v0, v1, (mx, my))] interpolation point
    patches: dict          # name -> (type, [(va, vb)]) directed 2D edges
    dz: float = 0.05
    half_domain: bool = False   # True => mirror about y=0 afterwards


def _g(v) -> str:
    return v if isinstance(v, str) else f"{v:.6g}"


def _orient_patch_edges(spec: MeshSpec2D) -> dict:
    """Re-orient every patch edge to match its owning block's CCW
    traversal. For a CCW quad the interior lies LEFT of each traversal
    edge, so the extruded face (va vb vb' va') automatically gets an
    outward normal — no per-shape hand-reasoning about face orientation."""
    block_edges, counts = {}, {}
    for b in spec.blocks:
        q = b.quad
        for k in range(4):
            e = (q[k], q[(k + 1) % 4])
            key = frozenset(e)
            block_edges[key] = e
            counts[key] = counts.get(key, 0) + 1
    out = {}
    for name, (ptype, edges) in spec.patches.items():
        fixed = []
        for (va, vb) in edges:
            key = frozenset((va, vb))
            if key not in block_edges:
                raise ValueError(
                    f"patch '{name}' edge ({va},{vb}) is not a block edge")
            if counts[key] != 1:
                raise ValueError(
                    f"patch '{name}' edge ({va},{vb}) is interior "
                    f"(shared by {counts[key]} blocks)")
            fixed.append(block_edges[key])
        out[name] = (ptype, fixed)
    return out


def emit_blockmesh(spec: MeshSpec2D) -> str:
    """Extrude a 2D spec to [-dz, +dz] and render the dictionary text.

    Hex ordering: the CCW xy quad at z=-dz then its +dz copy, so the
    right-hand rule points along +z (a valid OpenFOAM hex). Patch faces
    are (va vb vb' va') with edge direction chosen by
    `_orient_patch_edges` so normals point out of the domain."""
    spec = dataclasses.replace(spec, patches=_orient_patch_edges(spec))
    n = len(spec.verts)
    z = spec.dz
    lines = [_HEADER.format(obj="blockMeshDict"), "", "convertToMeters 1;",
             "", "vertices", "("]
    for zo in (-z, z):
        for (x, y) in spec.verts:
            lines.append(f"    ({x:.6g} {y:.6g} {zo:.6g})")
    lines += [");", "", "blocks", "("]
    for b in spec.blocks:
        idx = " ".join(str(k) for k in b.quad) + " " + \
            " ".join(str(k + n) for k in b.quad)
        lines.append(f"    hex ({idx}) ({b.nx} {b.ny} 1) "
                     f"simpleGrading ({_g(b.gx)} {_g(b.gy)} 1)")
    lines += [");", "", "edges", "("]
    for (v0, v1, (mx, my)) in spec.arcs:
        for off, zo in ((0, -z), (n, z)):
            lines.append(f"    arc {v0 + off} {v1 + off} "
                         f"({mx:.6g} {my:.6g} {zo:.6g})")
    lines += [");", "", "boundary", "("]
    for name, (ptype, edges) in spec.patches.items():
        lines += [f"    {name}", "    {", f"        type {ptype};",
                  "        faces", "        ("]
        for (va, vb) in edges:
            lines.append(f"            ({va} {vb} {vb + n} {va + n})")
        lines += ["        );", "    }"]
    lines += [");", "", "defaultPatch", "{",
              "    name frontAndBack;", "    type empty;", "}", ""]
    return "\n".join(lines)


def write_spec(spec: MeshSpec2D, case_dir: str) -> str:
    """Write system/blockMeshDict (+ mirrorMeshDict for half domains)."""
    sysd = os.path.join(case_dir, "system")
    os.makedirs(sysd, exist_ok=True)
    text = emit_blockmesh(spec)
    with open(os.path.join(sysd, "blockMeshDict"), "w") as f:
        f.write(text)
    if spec.half_domain:
        write_mirror_mesh_dict(os.path.join(sysd, "mirrorMeshDict"),
                               point=(3, 0, 0), normal=(0, -1, 0))
    return text


def _cells(extent: float, per_unit: float, floor: int = 3) -> int:
    return max(int(extent * per_unit), floor)


# ---------------------------------------------------------------------------
# cylinder — half-domain O-grid (gen_blockMeshDict.py:4-196)
# ---------------------------------------------------------------------------

def _half_ogrid_spec(rx: float, ry: float, y_max: float,
                     refinement: float = 1.0,
                     bl_grading: float = 3.0) -> MeshSpec2D:
    """Half-domain O-grid around a half ellipse with semi-axes (rx, ry)
    at the origin (circle when rx == ry), x in [-rx-4, -rx+11],
    y in [0, y_max]; ring to (2rx, 2ry) with radial expansion ratio
    `bl_grading` away from the wall (the reference's simpleGrading (3 ...);
    larger values pack cells harder at the wall — pass e.g. 10 for the
    turbulent-BL meshes, the For_kwSST variants' role)."""
    r, R = rx, 2.0 * rx
    xmin = -rx - 4.0
    xmax = xmin + 15.0
    if 2.0 * ry >= y_max:
        raise ValueError("outer ring (2x the semi-axis) must fit under y_max")
    c = math.cos(math.radians(45.0))

    def ring(scale, deg):
        th = math.radians(deg)
        return (scale * rx * math.cos(th), scale * ry * math.sin(th))

    verts = [
        ring(1, 0), ring(1, 45), ring(1, 90), ring(1, 135), ring(1, 180),
        ring(2, 0), ring(2, 45), ring(2, 90), ring(2, 135), ring(2, 180),
        (xmax, 0.0), (xmax, 2 * ry * c), (xmax, y_max),       # 10..12
        (R * c, y_max), (0.0, y_max), (-R * c, y_max),        # 13..15
        (xmin, 0.0), (xmin, 2 * ry * c), (xmin, y_max),       # 16..18
    ]
    i0, i45, i90, i135, i180 = 0, 1, 2, 3, 4
    o0, o45, o90, o135, o180 = 5, 6, 7, 8, 9
    d0, d45, dtop, t_r, t_c, t_l, u0, u45, utop = range(10, 19)

    sc = 40.0 * refinement
    n_ring = int(r * sc * 4 + 5)            # x_cell/y_cell (ref formulas)
    n_dn = max(int((xmax - R) * sc), 4)
    n_up = max(int((abs(xmin) - R) * sc), 4)
    n_top = int((y_max - 2 * ry) * sc * 4 + 5)

    g = bl_grading
    blocks = [
        Block2D((i45, o45, o90, i90), n_ring, n_ring, g, 1),
        Block2D((i0, o0, o45, i45), n_ring, n_ring, g, 1),
        Block2D((o0, d0, d45, o45), n_dn, n_ring, 10, 1),
        Block2D((o45, d45, dtop, t_r), n_dn, n_top, 10, 0.333),
        Block2D((o90, o45, t_r, t_c), n_ring, n_top, 1, 0.333),
        Block2D((o135, i135, i90, o90), n_ring, n_ring, 1.0 / g, 1),
        Block2D((o180, i180, i135, o135), n_ring, n_ring, 1.0 / g, 1),
        Block2D((u0, o180, o135, u45), n_up, n_ring, 0.1, 1),
        Block2D((u45, o135, t_l, utop), n_up, n_top, 0.1, 0.333),
        Block2D((o135, o90, t_c, t_l), n_ring, n_top, 1, 0.333),
    ]
    arcs = [(i0, i45, ring(1, 22.5)), (i45, i90, ring(1, 67.5)),
            (i90, i135, ring(1, 112.5)), (i135, i180, ring(1, 157.5)),
            (o0, o45, ring(2, 22.5)), (o45, o90, ring(2, 67.5)),
            (o90, o135, ring(2, 112.5)), (o135, o180, ring(2, 157.5))]
    patches = {
        "inlet": ("patch", [(u45, u0), (utop, u45)]),
        "outlet": ("patch", [(d0, d45), (d45, dtop)]),
        "top": ("wall", [(dtop, t_r), (t_r, t_c), (t_c, t_l), (t_l, utop)]),
        "obstacle": ("wall", [(i45, i0), (i90, i45), (i135, i90),
                              (i180, i135)]),
        "axis": ("patch", [(o0, i0), (d0, o0),
                           (i180, o180), (o180, u0)]),
    }
    return MeshSpec2D(verts=verts, blocks=blocks, arcs=arcs, patches=patches,
                      half_domain=True)


def cylinder_spec(r_int: float, y_max: float, refinement: float = 1.0,
                  bl_grading: float = 3.0) -> MeshSpec2D:
    """Half cylinder of radius r_int (gen_blockMeshDict.py:4-196:
    `python gen_blockMeshDict.py r_int y_max refinement`)."""
    return _half_ogrid_spec(r_int, r_int, y_max, refinement, bl_grading)


# ---------------------------------------------------------------------------
# rectangle — half-domain, bottom-mounted (rectangle/gen_blockMeshDict.py:4)
# ---------------------------------------------------------------------------

def rectangle_spec(x_front: float, x_back: float, half_height: float,
                   cell_scale: float = 1.0, grading: float = 4.0,
                   x_max: float = 15.0, y_max: float = 1.0) -> MeshSpec2D:
    """Rectangle spanning x in [x_front, x_back], y in [0, half_height] on
    the mirror axis. 3x3 block lattice minus the obstacle cell; `grading`
    packs cells toward the obstacle row (the reference's simpleGrading
    pairs g / 1/g across the mid row)."""
    if not (0 < x_front < x_back < x_max and 0 < half_height < y_max):
        raise ValueError("rectangle does not fit in the domain")
    h = half_height
    ym = 0.5 * (h + y_max)
    xs = [0.0, x_front, x_back, x_max]
    ys = [0.0, h, ym, y_max]
    verts = [(x, y) for y in ys for x in xs]
    vid = lambda i, j: j * 4 + i   # noqa: E731

    s = cell_scale * 20.0
    nx = [_cells(x_front, s), _cells(x_back - x_front, s),
          _cells(x_max - x_back, s * 0.5)]
    ny = [_cells(h, s), _cells(ym - h, s), _cells(y_max - ym, s)]
    gx = [0.2, 1.0, 5.0]
    gy = [1.0, grading, 1.0 / grading]

    blocks = []
    for j in range(3):
        for i in range(3):
            if (i, j) == (1, 0):
                continue   # the rectangle
            blocks.append(Block2D(
                (vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)),
                nx[i], ny[j], gx[i], gy[j]))

    patches = {
        "inlet": ("patch", [(vid(0, j + 1), vid(0, j)) for j in range(3)]),
        "outlet": ("patch", [(vid(3, j), vid(3, j + 1)) for j in range(3)]),
        "top": ("wall", [(vid(i + 1, 3), vid(i, 3)) for i in range(3)]),
        "obstacle": ("wall", [(vid(1, 1), vid(1, 0)),     # front face
                              (vid(2, 1), vid(1, 1)),     # top face
                              (vid(2, 0), vid(2, 1))]),   # back face
        "axis": ("patch", [(vid(0, 0), vid(1, 0)), (vid(2, 0), vid(3, 0))]),
    }
    return MeshSpec2D(verts=verts, blocks=blocks, arcs=[], patches=patches,
                      half_domain=True)


# ---------------------------------------------------------------------------
# triangle — half-domain, right-pointing (triangle/gen_blockMeshDict.py:4)
# ---------------------------------------------------------------------------

def triangle_spec(x_front: float, x_back: float, half_height: float,
                  cell_scale: float = 1.0, grading: float = 2.0,
                  x_max: float = 15.0, y_max: float = 1.0) -> MeshSpec2D:
    """Isoceles triangle with vertical base at x_front (half-height
    `half_height` above the axis) and apex at (x_back, 0): four blocks,
    with the over-triangle block's bottom edge following the hypotenuse."""
    if not (0 < x_front < x_back < x_max and 0 < half_height < y_max):
        raise ValueError("triangle does not fit in the domain")
    h = half_height
    verts = [(0.0, 0.0), (x_front, 0.0),                 # 0 1
             (0.0, h), (x_front, h),                     # 2 3 (base top)
             (x_back, 0.0),                              # 4 (apex)
             (0.0, y_max), (x_front, y_max), (x_back, y_max),  # 5 6 7
             (x_max, 0.0), (x_max, y_max)]               # 8 9

    s = cell_scale * 20.0
    n0 = _cells(x_front, s)
    n1 = _cells(x_back - x_front, s)
    n2 = _cells(x_max - x_back, s * 0.5)
    nyl = _cells(h, s)
    nyu = _cells(y_max - h, s)

    # conformity: blocks 1-3 share vertical edges, so all use nyu cells;
    # gy = grading (> 1) packs cells toward the obstacle/axis side
    blocks = [
        Block2D((0, 1, 3, 2), n0, nyl, 1.0 / grading, 1),
        Block2D((2, 3, 6, 5), n0, nyu, 1.0 / grading, grading),
        Block2D((3, 4, 7, 6), n1, nyu, 1, grading),
        Block2D((4, 8, 9, 7), n2, nyu, grading, grading),
    ]
    patches = {
        "inlet": ("patch", [(2, 0), (5, 2)]),
        "outlet": ("patch", [(8, 9)]),
        "top": ("wall", [(9, 7), (7, 6), (6, 5)]),
        "obstacle": ("wall", [(3, 1),        # base (vertical front face)
                              (4, 3)]),      # hypotenuse
        "axis": ("patch", [(0, 1), (4, 8)]),
    }
    return MeshSpec2D(verts=verts, blocks=blocks, arcs=[], patches=patches,
                      half_domain=True)


# ---------------------------------------------------------------------------
# ellipse — full-domain (ellipse/gen_blockMeshDict_elipse.py)
# ---------------------------------------------------------------------------

def ellipse_spec(a: float, b: float, y_max: float = 1.0,
                 refinement: float = 1.0,
                 bl_grading: float = 3.0) -> MeshSpec2D:
    """Half ellipse with semi-axes (a, b) at the origin
    (ellipse/gen_blockMeshDict_elipse.py parametrization `a b`).

    Deliberate deviation: the reference writes a full-domain 6-block mesh
    with duplicated vertices along the obstacle; here the ellipse reuses
    the half-domain O-grid + mirrorMesh pipeline (same as the cylinder,
    with per-axis scaled ring points and elliptical arcs) — the same mesh
    class with body-fitted wall layers and no duplicate-vertex seams."""
    return _half_ogrid_spec(a, b, y_max, refinement, bl_grading)


# ---------------------------------------------------------------------------
# inclined plate / inclined rectangle — full domain
# (inclined_plate/gen_blockMeshDict.py:4; For_kwSST/rect_alpha.py:4-30)
# ---------------------------------------------------------------------------

def plate_spec(x_c: float, length: float, width: float, alpha_deg: float,
               cell_scale: float = 1.0, grading: float = 3.0,
               x_max: float = 20.0, y_max: float = 1.0) -> MeshSpec2D:
    """Plate (thin rectangle) of length `length`, half-width `width`,
    centred at (x_c, 0), inclined `alpha_deg` from vertical: the 8-block
    pinwheel of the reference (corner points A/B/C/D,
    inclined_plate/gen_blockMeshDict.py:25-28)."""
    al = math.radians(alpha_deg)
    L, bw = length, width
    A = (x_c - L / 2 * math.cos(al) + bw * math.sin(al),
         L / 2 * math.sin(al) + bw * math.cos(al))
    B = (x_c - L / 2 * math.cos(al) - bw * math.sin(al),
         L / 2 * math.sin(al) - bw * math.cos(al))
    C = (x_c + L / 2 * math.cos(al) + bw * math.sin(al),
         -L / 2 * math.sin(al) + bw * math.cos(al))
    D = (x_c + L / 2 * math.cos(al) - bw * math.sin(al),
         -L / 2 * math.sin(al) - bw * math.cos(al))
    if not (0 < min(p[0] for p in (A, B, C, D))
            and max(p[0] for p in (A, B, C, D)) < x_max
            and max(abs(A[1]), abs(D[1])) < y_max):
        raise ValueError("plate does not fit in the domain")

    verts = [A, B, C, D,                                   # 0..3
             (0.0, A[1]), (0.0, B[1]), (0.0, D[1]),        # 4..6 left wall
             (x_max, A[1]), (x_max, C[1]), (x_max, D[1]),  # 7..9 right wall
             (0.0, y_max), (A[0], y_max), (x_max, y_max),  # 10..12 top
             (0.0, -y_max), (D[0], -y_max), (x_max, -y_max)]  # 13..15 bottom
    vA, vB, vC, vD = 0, 1, 2, 3
    lA, lB, lD = 4, 5, 6
    rA, rC, rD = 7, 8, 9
    tl, tA, tr = 10, 11, 12
    bl, bD, br = 13, 14, 15

    s = cell_scale * 20.0
    n_left = _cells(B[0], s)
    n_right = _cells(x_max - A[0], s * 0.5)
    n_AB = _cells(A[1] - B[1], 3 * s)
    n_BD = _cells(B[1] - D[1], 3 * s)
    n_CD = _cells(C[1] - D[1], 3 * s)
    n_AC = _cells(A[1] - C[1], 3 * s)
    n_out = _cells(y_max - A[1], 2 * s)
    g = grading

    blocks = [
        Block2D((lB, vB, vA, lA), n_left, n_AB, 1.0 / g, 1),   # front face
        Block2D((lA, vA, tA, tl), n_left, n_out, 1.0 / g, g),  # left-top
        Block2D((vA, rA, tr, tA), n_right, n_out, g, g),       # top-right
        Block2D((vC, rC, rA, vA), n_right, n_AC, g, 1),        # right of C-A
        Block2D((lD, vD, vB, lB), n_left, n_BD, 1.0 / g, 1),   # left of D-B
        Block2D((bl, bD, vD, lD), n_left, n_out, 1.0 / g, 1.0 / g),
        Block2D((bD, br, rD, vD), n_right, n_out, g, 1.0 / g),
        Block2D((vD, rD, rC, vC), n_right, n_CD, g, 1),        # right-lower
    ]
    patches = {
        "inlet": ("patch", [(lB, lA), (lA, tl), (lD, lB), (bl, lD)]),
        "outlet": ("patch", [(rA, tr), (rC, rA), (rD, rC), (br, rD)]),
        "top": ("wall", [(tr, tA), (tA, tl), (bl, bD), (bD, br)]),
        "obstacle": ("wall", [(vA, vB),       # front (upper) short face
                              (vB, vD),       # lower long face
                              (vD, vC),       # back short face
                              (vC, vA)]),     # upper long face
    }
    return MeshSpec2D(verts=verts, blocks=blocks, arcs=[], patches=patches,
                      half_domain=False)


SHAPE_SPECS = {
    "cylinder": cylinder_spec,
    "rectangle": rectangle_spec,
    "triangle": triangle_spec,
    "ellipse": ellipse_spec,
    "plate": plate_spec,
}
