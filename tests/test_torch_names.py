"""Every public name of a JAX module that has a port at the same path is
in the port; and the names this walk found missing, each against the JAX
package on the CPU.

The walk reads each module of `tpufoam` (package `__init__` files, which
re-export what their modules define, aside) whose path exists under
`tpufoam_torch`, and takes its top-level functions, classes and
assignments not starting with "_". It leaves out `ops/stencil.py`: its
Pallas entry points are replaced by the hand-written kernels' launchers
of `tpufoam_torch/ops/` by design. A name the port does not define is
listed in `UNPORTED` with the ROADMAP.md section A item that ports it,
or in `DELIBERATE` as a difference by design.

Tolerances:
- `domain_and_sdf`: the domain mask exact; the SDF bit for bit (the
  port's min distance rounds as XLA rounds on the CPU,
  tests/test_torch_fv.py). The convex-hull membership equals
  matplotlib's on points off the hull's edges; a point on an edge or a
  vertex is outside (`inside_convex_hull`), whatever matplotlib says.
- `scatter_to_grid`, `gather_from_grid`, `extract_blocks_gather`: exact
  (copies of values).
"""

import ast
import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core import grid as jgrid
from tpufoam.core import sdf as jsdf
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.solvers import backends as jback
from tpufoam.surrogate import blocks as jblocks
from tpufoam_torch.core import grid as tgrid
from tpufoam_torch.core import sdf as tsdf
from tpufoam_torch.solvers import backends as tback
from tpufoam_torch.surrogate import blocks as tblocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIPPED = {"ops/stencil.py"}
# Names of ported JAX modules that the port does not define yet, each
# with the ROADMAP.md section A item that ports it.
UNPORTED: dict = {}
ROADMAP_A_ITEMS = {"A.5", "A.6", "A.7"}
# Differences by design: the port's shard_fleet returns one sub-stack per
# mesh device, so no NamedSharding (a JAX placement object) exists to
# return.
DELIBERATE = {"parallel/mesh.py": {"fleet_sharding"}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _public_names(path: str) -> list:
    tree = ast.parse(open(path).read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _ported_modules() -> list:
    out = []
    for root, _, files in os.walk(os.path.join(ROOT, "tpufoam")):
        for f in sorted(files):
            if not f.endswith(".py") or f == "__init__.py":
                continue
            rel = os.path.relpath(os.path.join(root, f),
                                  os.path.join(ROOT, "tpufoam"))
            if (rel not in SKIPPED and os.path.exists(
                    os.path.join(ROOT, "tpufoam_torch", rel))):
                out.append(rel)
    return sorted(out)


MODULES = _ported_modules()


def test_the_walk_finds_this_slices_modules():
    for rel in ("core/sdf.py", "core/grid.py", "core/interp.py",
                "surrogate/blocks.py", "solvers/backends.py",
                "utils/hdf5_io.py", "eval/evaluation.py",
                "models/keras_compat.py", "surrogate/reference_io.py",
                "bridge/server.py", "parallel/mesh.py", "cli.py",
                "data/casegen.py", "data/blockmesh.py", "models/pinn.py",
                "models/pointnet.py", "train/pointcloud.py",
                "eval/pointcloud_rollout.py", "utils/determinism.py",
                "utils/h5ckpt.py", "utils/plotting.py", "utils/profiling.py",
                "utils/vtk_io.py"):
        assert rel in MODULES, rel


def _modules(package: str) -> set:
    root = os.path.join(ROOT, package)
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files
            if f.endswith(".py")}


def test_every_jax_module_has_a_counterpart():
    """Every .py module of the JAX package (its package `__init__` files
    too) has one at the same path in the port, but `ops/stencil.py`,
    whose Pallas kernels the launchers of `tpufoam_torch/ops/` replace."""
    missing = _modules("tpufoam") - _modules("tpufoam_torch") - SKIPPED
    assert not missing, sorted(missing)
    assert "ops/stencil.py" in _modules("tpufoam")


@pytest.mark.parametrize("rel", MODULES)
def test_the_port_has_every_public_name(rel):
    """Each public name of the JAX module is an attribute of the port's,
    but for the listed ones; a listed name the port now has must leave
    the lists, so they stay the truth."""
    import importlib
    mod = importlib.import_module(
        "tpufoam_torch." + rel[:-3].replace("/", "."))
    names = _public_names(os.path.join(ROOT, "tpufoam", rel))
    missing = {n for n in names if not hasattr(mod, n)}
    listed = set(UNPORTED.get(rel, {})) | DELIBERATE.get(rel, set())
    assert missing == listed, (
        f"{rel}: the port lacks {sorted(missing - listed)} (unlisted) and "
        f"has {sorted(listed - missing)} (listed as missing)")


def test_every_listed_name_is_tied_to_a_roadmap_item():
    assert set(UNPORTED) | set(DELIBERATE) <= set(MODULES)
    for gaps in UNPORTED.values():
        assert set(gaps.values()) <= ROADMAP_A_ITEMS, gaps


def test_new_modules_import_without_h5py_matplotlib_or_jax():
    """The card's machine has neither h5py nor matplotlib: the modules
    that read the reference's files or take its hull membership import
    without them (and the port imports no JAX)."""
    code = ("import sys\n"
            "for m in ('h5py', 'matplotlib', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "import tpufoam_torch.utils.hdf5_io\n"
            "import tpufoam_torch.eval.evaluation\n"
            "import tpufoam_torch.core.sdf, tpufoam_torch.bridge.server\n"
            "import tpufoam_torch.core.interp, tpufoam_torch.bridge.client\n"
            "import tpufoam_torch.models.keras_compat\n"
            "import tpufoam_torch.surrogate.reference_io\n"
            "import tpufoam_torch.cli, tpufoam_torch.data.blockmesh\n"
            "import tpufoam_torch.models.pinn, tpufoam_torch.models.pointnet\n"
            "import tpufoam_torch.train.pointcloud\n"
            "import tpufoam_torch.eval.pointcloud_rollout\n"
            "import tpufoam_torch.utils.h5ckpt, tpufoam_torch.utils.plotting\n"
            "import tpufoam_torch.utils.profiling\n"
            "import tpufoam_torch.utils.determinism\n"
            "import tpufoam_torch.utils.vtk_io\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---- core/sdf.domain_and_sdf ---------------------------------------------

DOMAIN_CASES = [("cylinder", 0.5, 0.05), ("ellipse", 0.6, 0.05),
                ("triangle", 0.45, 0.04), ("rectangle", 0.37, 0.05),
                ("cylinder", 0.3, 0.0125)]


@pytest.mark.parametrize("shape,size,delta", DOMAIN_CASES)
def test_domain_and_sdf_matches_jax(shape, size, delta):
    """The hull membership (no obst_inside) as the JAX package's
    matplotlib path, and the SDF, on a channel's grid points."""
    geom = jax_geom(shape, length=3.0, height=1.0, obstacle_size=size)
    g = jgrid.make_grid(0.0, 3.0, 0.0, 1.0, delta)
    pts = g.cell_centers_flat()
    top = geom.boundary_points_top(800)
    obst = geom.shape.boundary_points(400)
    jd, js = jsdf.domain_and_sdf(pts, top, obst)
    td, ts = tsdf.domain_and_sdf(pts, top, obst, device="cpu")
    assert td.dtype == torch.bool and ts.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (~td).sum() > 0      # the obstacle is cut out


@pytest.mark.parametrize("shape,size,delta", DOMAIN_CASES)
def test_hull_membership_matches_matplotlib(shape, size, delta):
    from matplotlib.path import Path
    from scipy.spatial import ConvexHull

    geom = jax_geom(shape, length=3.0, height=1.0, obstacle_size=size)
    pts = jgrid.make_grid(0.0, 3.0, 0.0, 1.0, delta).cell_centers_flat()
    pts = pts.astype(np.float32)
    obst = geom.shape.boundary_points(400)
    ref = Path(obst[ConvexHull(obst).vertices]).contains_points(pts)
    got = tsdf.inside_convex_hull(pts, obst)
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def test_hull_edge_and_vertex_points_are_outside():
    """A point on a hull edge or vertex is outside; inside and outside
    points as matplotlib has them."""
    from matplotlib.path import Path

    square = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0],
                       [0.5, 0.0]])
    on_edge = np.array([[0.5, 0.0], [1.0, 0.5], [0.5, 1.0], [0.0, 0.5],
                        [0.0, 0.0], [1.0, 1.0]])
    assert not tsdf.inside_convex_hull(on_edge, square).any()
    off = np.array([[0.5, 0.5], [0.01, 0.99], [1.5, 0.5], [-0.01, 0.5]])
    got = tsdf.inside_convex_hull(off, square)
    np.testing.assert_array_equal(got, [True, True, False, False])
    np.testing.assert_array_equal(
        got, Path(square[[0, 1, 2, 3]]).contains_points(off))


def test_domain_and_sdf_with_obst_inside_and_subsample():
    geom = jax_geom("cylinder", length=3.0, height=1.0, obstacle_size=0.4)
    pts = jgrid.make_grid(0.0, 3.0, 0.0, 1.0, 0.05).cell_centers_flat()
    top = geom.boundary_points_top(800)
    obst = geom.shape.boundary_points(400)
    inside = geom.shape.inside(pts)
    for kw in (dict(obst_inside=inside), dict(obst_inside=inside,
                                              subsample=2)):
        jd, js = jsdf.domain_and_sdf(pts, top, obst, **kw)
        td, ts = tsdf.domain_and_sdf(pts, top, obst, device="cpu", **kw)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---- core/grid scatter and gather, blocks.extract_blocks_gather ----------

def test_scatter_and_gather_match_jax():
    g = jgrid.make_grid(0.0, 2.0, 0.0, 1.0, 0.1)
    rng = np.random.default_rng(3)
    flat = rng.choice(g.n_cells, size=60, replace=False)
    idx = np.stack(np.unravel_index(flat, g.shape), axis=-1).astype(np.int32)
    vals = rng.standard_normal(60).astype(np.float32)
    ref = np.asarray(jgrid.scatter_to_grid(g, jnp.asarray(idx),
                                           jnp.asarray(vals), fill=-2.0))
    tg = tgrid.Grid2D(**{k: getattr(g, k) for k in ("nx", "ny", "dx", "dy",
                                                    "x0", "y0")})
    for indices in (idx, torch.as_tensor(idx)):
        got = tgrid.scatter_to_grid(tg, indices, torch.as_tensor(vals),
                                    fill=-2.0)
        np.testing.assert_array_equal(got.numpy(), ref)
        back = tgrid.gather_from_grid(got, indices)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jgrid.gather_from_grid(
                jnp.asarray(ref), jnp.asarray(idx))))
        np.testing.assert_array_equal(back.numpy(), vals)


@pytest.mark.parametrize("ny,nx,size,channels", [(40, 100, 16, 0),
                                                 (37, 83, 16, 3),
                                                 (64, 64, 32, 2)])
def test_extract_blocks_gather_matches_jax(ny, nx, size, channels):
    shape = (ny, nx) if not channels else (ny, nx, channels)
    f = np.random.default_rng(ny).standard_normal(shape).astype(np.float32)
    jl = jblocks.build_block_layout(ny, nx, size)
    tl = tblocks.build_block_layout(ny, nx, size)
    ref = np.asarray(jblocks.extract_blocks_gather(jl, jnp.asarray(f)))
    got = tblocks.extract_blocks_gather(tl, torch.as_tensor(f))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), tblocks.extract_blocks(tl, torch.as_tensor(f)).numpy())


# ---- solvers/backends.PressureBackend ------------------------------------

def test_pressure_backend_protocol_has_jax_signature():
    port = list(inspect.signature(tback.PressureBackend.__call__).parameters)
    ref = list(inspect.signature(jback.PressureBackend.__call__).parameters)
    assert port == ref == ["self", "case", "coef", "rhs", "p_prev", "aux"]
    for backend in (tback.CGBackend, tback.MGBackend, tback.MGCGBackend,
                    tback.AutoBackend, tback.SurrogateBackend,
                    tback.HybridBackend):
        params = list(inspect.signature(backend.__call__).parameters)
        assert params == port, backend
