"""OpenFOAM case generation — interop with the reference's CFD toolchain.

tpufoam's own solver meshes geometry analytically (core.geometry ->
blanked-cell grids), but users of the reference pipeline drive OpenFOAM
with generated dictionaries (Generate_blockMeshDict/*/gen_blockMeshDict.py
— parametric multi-block meshes; make_dataset.py — case cloning;
mirrorMeshDict — half-domain mirror trick; system/ dictionaries). This
module emits those artifacts:

  * `write_blockmesh_dict` — a 12-block channel-with-obstacle mesh: a
    4-block O-ring around the obstacle (arc edges for the cylinder,
    straight for rectangles) embedded in a 3x3 block lattice, with radial
    grading toward the wall (the role of gen_blockMeshDict.py:4-196's
    O-grid, re-parametrized for the channel benchmark geometry).
  * `write_mirror_mesh_dict` — the mirrorMesh dictionary (plane y=0) used
    by the half-domain external-flow cases (sim_cmd.sh:13-27).
  * `write_openfoam_case` — a runnable case skeleton: 0/{U,p},
    constant/transportProperties, system/{controlDict,fvSchemes,
    fvSolution,decomposeParDict} matching the reference benchmark configs
    (parallelized/test_case/system/*).

The port's own copy of the JAX package's module of this name (text
writers only; the port imports nothing of that package): each function
writes the same bytes.
"""

from __future__ import annotations

import math
import os

_HEADER = """/*--------------------------------*- C++ -*----------------------------------*\\
  Generated by tpufoam (casegen.py)
\\*---------------------------------------------------------------------------*/
FoamFile
{{
    version     2.0;
    format      ascii;
    class       dictionary;
    object      {obj};
}}
"""


def _vtx(x, y, z):
    return f"    ({x:.6g} {y:.6g} {z:.6g})"


def write_blockmesh_dict(path: str, length: float = 15.0, height: float = 2.0,
                         cx: float = 5.0, cy: float = 1.0, r: float = 0.25,
                         shape: str = "cylinder", refinement: int = 1,
                         dz: float = 0.1, bl_grading: float = 0.7) -> str:
    """Emit a blockMeshDict for a channel with an embedded obstacle.

    refinement scales all cell counts (the reference's third CLI argument,
    gen_blockMeshDict.py:190-196). bl_grading is the radial expansion of
    the O-ring cells toward the wall — set it small (e.g. 0.1) for the
    turbulent-boundary-layer meshes of the For_kwSST variants
    (For_kwSST/rect_alpha.py:4-30). Returns the written text.
    """
    a = r * 1.6 / math.sqrt(2.0)   # half-width of the O-ring outer square
    xs0, xs1 = cx - a, cx + a
    ys0, ys1 = cy - a, cy + a
    if not (0 < xs0 and xs1 < length and 0 < ys0 and ys1 < height):
        raise ValueError("obstacle ring does not fit inside the channel")

    xcols = [0.0, xs0, xs1, length]
    yrows = [0.0, ys0, ys1, height]

    verts = []          # (x, y) on the z=0 plane; duplicated at z=dz
    for y in yrows:
        for x in xcols:
            verts.append((x, y))
    lattice = lambda i, j: j * 4 + i            # noqa: E731  (col i, row j)

    # circle points at the diagonals (45 deg offsets)
    diag = [(225, (xs0, ys0)), (315, (xs1, ys0)), (45, (xs1, ys1)),
            (135, (xs0, ys1))]
    circ = []
    for ang, _ in diag:
        th = math.radians(ang)
        circ.append((cx + r * math.cos(th), cy + r * math.sin(th)))
    c_base = len(verts)
    verts.extend(circ)
    n2d = len(verts)

    def hex_block(quad, nx, ny, grading=1.0):
        idx = [str(k) for k in quad] + [str(k + n2d) for k in quad]
        return (f"    hex ({' '.join(idx)}) "
                f"({nx} {ny} 1) simpleGrading (1 {grading:.4g} 1)")

    n = 10 * refinement          # base cells per block edge
    nring = 8 * refinement       # radial cells in the ring

    blocks = []
    # 3x3 lattice minus centre
    for j in range(3):
        for i in range(3):
            if i == 1 and j == 1:
                continue
            quad = [lattice(i, j), lattice(i + 1, j),
                    lattice(i + 1, j + 1), lattice(i, j + 1)]
            nx = n * (3 if i != 1 else 1)
            ny = n * (1 if j != 1 else 1)
            blocks.append(hex_block(quad, nx, ny))

    q = [lattice(1, 1), lattice(2, 1), lattice(2, 2), lattice(1, 2)]
    c0, c1, c2, c3 = (c_base + k for k in range(4))
    # ring blocks: quad (inner arc -> outer square edge), radial = y-дir
    blocks.append(hex_block([q[0], q[1], c1, c0], n, nring, bl_grading))  # south
    blocks.append(hex_block([q[1], q[2], c2, c1], n, nring, bl_grading))  # east
    blocks.append(hex_block([q[2], q[3], c3, c2], n, nring, bl_grading))  # north
    blocks.append(hex_block([q[3], q[0], c0, c3], n, nring, bl_grading))  # west

    edges = []
    if shape == "cylinder":
        arcs = [(c0, c1, 270), (c1, c2, 0), (c2, c3, 90), (c3, c0, 180)]
        for v0, v1, ang in arcs:
            th = math.radians(ang)
            mx, my = cx + r * math.cos(th), cy + r * math.sin(th)
            for zo in (0.0, dz):
                edges.append(f"    arc {v0 if zo == 0 else v0 + n2d} "
                             f"{v1 if zo == 0 else v1 + n2d} "
                             f"({mx:.6g} {my:.6g} {zo:.6g})")
    # non-circular shapes keep straight inner edges (square hole sized to
    # the shape's bounding circle)

    def faces(pairs):
        return "\n".join(f"            ({a} {b} {b + n2d} {a + n2d})"
                         for a, b in pairs)

    inlet = faces([(lattice(0, j), lattice(0, j + 1)) for j in range(3)])
    outlet = faces([(lattice(3, j), lattice(3, j + 1)) for j in range(3)])
    walls = faces([(lattice(i, 0), lattice(i + 1, 0)) for i in range(3)]
                  + [(lattice(i, 3), lattice(i + 1, 3)) for i in range(3)])
    obst = faces([(c0, c1), (c1, c2), (c2, c3), (c3, c0)])

    vert_txt = "\n".join(_vtx(x, y, z)
                         for z in (0.0, dz) for (x, y) in verts)
    text = _HEADER.format(obj="blockMeshDict") + f"""
convertToMeters 1;

vertices
(
{vert_txt}
);

blocks
(
{chr(10).join(blocks)}
);

edges
(
{chr(10).join(edges)}
);

boundary
(
    inlet
    {{
        type patch;
        faces
        (
{inlet}
        );
    }}
    outlet
    {{
        type patch;
        faces
        (
{outlet}
        );
    }}
    top
    {{
        type wall;
        faces
        (
{walls}
        );
    }}
    obstacle
    {{
        type wall;
        faces
        (
{obst}
        );
    }}
);

defaultPatch
{{
    name frontAndBack;
    type empty;
}}
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return text


def write_mirror_mesh_dict(path: str, point=(3, 0, 0), normal=(0, -1, 0)) -> str:
    """mirrorMeshDict (parallelized/test_case/system/mirrorMeshDict)."""
    text = _HEADER.format(obj="mirrorMeshDict") + f"""
planeType pointAndNormal;

pointAndNormalDict
{{
    point  ({point[0]} {point[1]} {point[2]});
    normal ({normal[0]} {normal[1]} {normal[2]});
}}

planeTolerance 1e-3;
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return text


def write_openfoam_case(case_dir: str, length: float = 15.0,
                        height: float = 2.0, cx: float = 5.0, cy: float = 1.0,
                        r: float = 0.25, nu: float = 8e-3,
                        u_mean: float = 1.0, end_time: float = 73.0,
                        max_co: float = 0.5, n_correctors: int = 2,
                        n_subdomains: int = 4,
                        refinement: int = 1) -> None:
    """Runnable pisoFoam/DLPoissonFoam case skeleton mirroring the
    reference benchmark configs (transportProperties:20 nu, controlDict
    maxCo/endTime, fvSolution nCorrectors/GAMG caps, decomposeParDict
    scotch)."""
    sysd = os.path.join(case_dir, "system")
    zerod = os.path.join(case_dir, "0")
    constd = os.path.join(case_dir, "constant")
    for d in (sysd, zerod, constd):
        os.makedirs(d, exist_ok=True)

    write_blockmesh_dict(os.path.join(sysd, "blockMeshDict"), length, height,
                         cx, cy, r, refinement=refinement)

    def put(rel, obj, body, cls="dictionary"):
        hdr = _HEADER.format(obj=obj).replace("class       dictionary",
                                              f"class       {cls}")
        with open(os.path.join(case_dir, rel), "w") as f:
            f.write(hdr + body)

    put("system/controlDict", "controlDict", f"""
application     pisoFoam;
startFrom       latestTime;
startTime       0;
stopAt          endTime;
endTime         {end_time};
deltaT          1e-3;
writeControl    adjustableRunTime;
writeInterval   0.5;
purgeWrite      0;
writeFormat     ascii;
writePrecision  7;
timeFormat      general;
timePrecision   6;
runTimeModifiable true;
adjustTimeStep  yes;
maxCo           {max_co};
""")
    put("system/fvSchemes", "fvSchemes", """
ddtSchemes      { default Euler; }
gradSchemes     { default Gauss linear; }
divSchemes
{
    default         none;
    div(phi,U)      Gauss limitedLinearV 1;
    div((nuEff*dev2(T(grad(U))))) Gauss linear;
}
laplacianSchemes { default Gauss linear corrected; }
interpolationSchemes { default linear; }
snGradSchemes   { default corrected; }
""")
    put("system/fvSolution", "fvSolution", f"""
solvers
{{
    p
    {{
        solver          GAMG;
        tolerance       1e-08;
        relTol          0;
        smoother        GaussSeidel;
        maxIter         6;
    }}
    pFinal
    {{
        solver          PCG;
        preconditioner  GAMG;
        tolerance       1e-08;
        relTol          0;
        maxIter         6;
    }}
    "(U|k|omega|epsilon)"
    {{
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-06;
        relTol          0;
    }}
}}

PISO
{{
    nCorrectors     {n_correctors};
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
}}
""")
    put("system/decomposeParDict", "decomposeParDict", f"""
numberOfSubdomains {n_subdomains};
method          scotch;
""")
    put("constant/transportProperties", "transportProperties", f"""
transportModel  Newtonian;
nu              [0 2 -1 0 0 0 0] {nu};
""")
    put("0/p", "p", """
dimensions      [0 2 -2 0 0 0 0];
internalField   uniform 0;
boundaryField
{
    inlet        { type zeroGradient; }
    outlet       { type fixedValue; value uniform 0; }
    top          { type zeroGradient; }
    obstacle     { type zeroGradient; }
    frontAndBack { type empty; }
}
""", cls="volScalarField")
    put("0/U", "U", f"""
dimensions      [0 1 -1 0 0 0 0];
internalField   uniform (0 0 0);
boundaryField
{{
    inlet
    {{
        type            codedFixedValue;
        value           uniform ({u_mean} 0 0);
        name            parabolicInlet;
        code
        #{{
            const fvPatch& p = patch();
            vectorField& f = *this;
            forAll(p, i)
            {{
                const scalar y = p.Cf()[i].y() / {height};
                f[i] = vector(6.0*{u_mean}*y*(1.0 - y), 0, 0);
            }}
        #}};
    }}
    outlet       {{ type zeroGradient; }}
    top          {{ type noSlip; }}
    obstacle     {{ type noSlip; }}
    frontAndBack {{ type empty; }}
}}
""", cls="volVectorField")
