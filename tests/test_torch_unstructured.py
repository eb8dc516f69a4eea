"""The unstructured pieces of tpufoam_torch on the CPU, against the JAX
package: mesh <-> grid resampling (core/interp.py), the reference's HDF5
schema (utils/hdf5_io.py) and UnstructuredCase (eval/evaluation.py).

Tolerances:
- `build_resample`: the same simplices, vertices and float32 weights
  (the same host scipy code in float64); `apply_resample` bit for bit
  (the port sums the three weighted values as XLA's einsum does on the
  CPU, left to right, products rounded apart). A linear field is
  reproduced to 1e-4 (tests/test_core.py's bound).
- the HDF5 files and records: exact (float32 copies).
- UnstructuredCase: the grid, masks, indices and channels exact, the SDF
  bit for bit (tests/test_torch_names.py), the resampled fields exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core import interp as jinterp
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.eval import evaluation as jeval
from tpufoam.fv import case as jcase
from tpufoam.utils import hdf5_io as jio
from tpufoam_torch.core import interp as tinterp
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.core.grid import make_grid
from tpufoam_torch.eval import evaluation as teval
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.utils import hdf5_io as tio

DELTA = 1.0 / 24


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---- core/interp ----------------------------------------------------------

def test_resample_linear_exact():
    rng = np.random.default_rng(0)
    src = np.vstack([rng.uniform(0, 1, size=(500, 2)),
                     [[0, 0], [0, 1], [1, 0], [1, 1]]])
    dst = make_grid(0.0, 1.0, 0.0, 1.0, 0.05).cell_centers_flat()
    op = tinterp.build_resample(src, dst, device="cpu")
    assert op.vertices.dtype == torch.int64 and op.valid.all()
    f = 2.0 * src[:, 0] - 3.0 * src[:, 1] + 0.5
    np.testing.assert_allclose(tinterp.apply_resample(op, f).numpy(),
                               2.0 * dst[:, 0] - 3.0 * dst[:, 1] + 0.5,
                               rtol=1e-4, atol=1e-4)


def test_resample_out_of_hull_idw_fallback():
    src = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    dst = np.array([[0.5, 0.5], [2.0, 2.0]])
    op = tinterp.build_resample(src, dst, device="cpu")
    assert op.valid.tolist() == [True, False]
    np.testing.assert_allclose(op(np.ones(4)).numpy(), [1.0, 1.0], atol=1e-5)


@pytest.mark.parametrize("n_src,n_dst,span", [(3000, 5000, (-0.1, 1.1)),
                                              (400, 900, (0.0, 1.0))])
def test_resample_matches_jax(n_src, n_dst, span):
    rng = np.random.default_rng(n_src)
    src = rng.uniform(0, 1, (n_src, 2))
    dst = rng.uniform(*span, (n_dst, 2))
    jop = jinterp.build_resample(src, dst)
    top = tinterp.build_resample(src, dst, device="cpu")
    np.testing.assert_array_equal(top.vertices.numpy(),
                                  np.asarray(jop.vertices))
    np.testing.assert_array_equal(top.weights.numpy(),
                                  np.asarray(jop.weights))
    np.testing.assert_array_equal(top.valid.numpy(), np.asarray(jop.valid))
    vals = (rng.standard_normal(n_src) * 10).astype(np.float32)
    for fill in (0.0, -7.5):
        ref = np.asarray(jinterp.apply_resample(jop, vals, fill))
        got = tinterp.apply_resample(top, torch.as_tensor(vals), fill)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    if span[0] < 0:
        assert (~top.valid).sum() > 0       # the IDW fallback was taken


# ---- utils/hdf5_io ---------------------------------------------------------

def test_pad_ragged_and_first_pad_index_match_jax():
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((n, 3)).astype(np.float32)
              for n in (5, 9, 2)]
    for max_rows in (9, 4, 12):
        np.testing.assert_array_equal(tio.pad_ragged(arrays, max_rows),
                                      jio.pad_ragged(arrays, max_rows))
    padded = tio.pad_ragged(arrays, 12)
    for row in padded:
        assert tio.first_pad_index(row[:, 0]) == \
            jio.first_pad_index(row[:, 0])
    assert tio.first_pad_index(np.ones(4)) == 4
    assert (tio.PAD, tio.CH_MU, tio.CH_DELTAS) == \
        (jio.PAD, jio.CH_MU, jio.CH_DELTAS)


@pytest.fixture(scope="module")
def rollout():
    """JAX and port cases of one cylinder channel, and seeded frames."""
    kw = dict(shape_name="cylinder", length=3.0, height=1.0,
              obstacle_size=0.3)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=DELTA)
    tc = tcase.build_channel_case(channel_case_geometry(**kw), delta=DELTA,
                                  device="cpu")
    rng = np.random.default_rng(7)
    fluid = np.asarray(jc.fluid)
    frames = []
    for _ in range(3):
        frames.append({k: (rng.standard_normal(fluid.shape)
                           .astype(np.float32) * fluid)
                       for k in ("u", "v", "p", "u_prev", "v_prev",
                                 "p_prev")})
    geom = jax_geom(**kw)
    return jc, tc, frames, geom.boundary_points_top(800), \
        geom.shape.boundary_points(360)


def test_rollout_to_records_matches_jax(rollout):
    jc, tc, frames, _, _ = rollout
    ref = jio.rollout_to_records(jc, frames)
    got = tio.rollout_to_records(tc, frames)
    got_t = tio.rollout_to_records(
        tc, [{k: torch.as_tensor(v) for k, v in f.items()} for f in frames])
    assert len(got) == len(ref) == 3
    for g, gt, r in zip(got, got_t, ref):
        assert g.dtype == np.float32 and g.shape == r.shape
        assert g.shape[1] == len(tio.CH_DELTAS)
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(gt, r)


@pytest.fixture(scope="module")
def datasets(rollout, tmp_path_factory):
    """The same records written by each package (two sims, three frames)."""
    pytest.importorskip("h5py")
    jc, tc, frames, top, obst = rollout
    recs = jio.rollout_to_records(jc, frames)
    sims = [[dict(cells=c, top=top, obst=obst) for c in recs],
            [dict(cells=c[:-40], top=top, obst=obst) for c in recs[:2]]]
    d = tmp_path_factory.mktemp("h5")
    paths = {"jax": str(d / "jax.h5"), "port": str(d / "port.h5")}
    jio.write_dataset(paths["jax"], sims, max_bound=2000)
    tio.write_dataset(paths["port"], sims, max_bound=2000)
    return paths, sims


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hdf5_round_trip_across_packages(datasets, writer):
    paths, sims = datasets
    path = paths[writer]
    assert tio.dataset_shape(path) == jio.dataset_shape(path) == (2, 3)
    for s, frames in enumerate(sims):
        for t, fr in enumerate(frames):
            got = tio.read_frame(path, s, t)
            ref = jio.read_frame(path, s, t)
            assert got.channels == ref.channels == tio.CH_DELTAS
            for name in ("data", "top", "obst"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(ref, name))
            np.testing.assert_array_equal(got.data, fr["cells"])
            np.testing.assert_array_equal(got.obst,
                                          fr["obst"].astype(np.float32))


# ---- eval/evaluation.UnstructuredCase --------------------------------------

@pytest.mark.parametrize("sim", [0, 1])
def test_unstructured_case_from_hdf5_matches_jax(datasets, sim):
    paths, _ = datasets
    path = paths["port"]
    ref = jeval.UnstructuredCase.from_hdf5(path, sim, DELTA)
    got = teval.UnstructuredCase.from_hdf5(path, sim, DELTA, device="cpu")
    assert dataclasses.asdict(got.case.grid) == \
        dataclasses.asdict(ref.case.grid)
    assert got.channels == ref.channels
    np.testing.assert_array_equal(got.indices, ref.indices)
    for f in dataclasses.fields(got.case):
        g = getattr(got.case, f.name)
        r = getattr(ref.case, f.name)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), f.name)
        elif f.name != "grid":
            assert g == r, f.name
    for name in ("vertices", "weights", "valid"):
        for op_g, op_r in ((got.resample, ref.resample),
                           (got.resample_back, ref.resample_back)):
            np.testing.assert_array_equal(getattr(op_g, name).numpy(),
                                          np.asarray(getattr(op_r, name)))
    fr = tio.read_frame(path, sim, 1)
    fg = got.fields_from_frame(fr)
    fj = ref.fields_from_frame(jio.read_frame(path, sim, 1))
    assert set(fg) == set(fj) == {"u", "v", "p", "u_prev", "v_prev",
                                  "p_prev", "du_prev", "dv_prev", "dp_prev"}
    for k in fg:
        np.testing.assert_array_equal(fg[k].numpy(), np.asarray(fj[k]), k)
    col = fr.data[:, 1]
    np.testing.assert_array_equal(got.grid_field(col).numpy(),
                                  np.asarray(ref.grid_field(col)))


def test_unstructured_grid_rounds_the_extents(rollout):
    """The grid spans the cell centres' extents rounded to 2 decimals:
    at delta 1/24 the centres run from 1/48 = 0.0208 to 2.979 and 0.979,
    so the grid is [0.02, 2.98] x [0.02, 0.98], 23 x 71 cells against the
    case's 24 x 72."""
    jc, tc, frames, top, obst = rollout
    cells = tio.rollout_to_records(tc, frames)[0]
    fr = tio.SimFrame(data=cells, top=top, obst=obst,
                      channels=tio.CH_DELTAS)
    got = teval.UnstructuredCase.from_frame(fr, DELTA, device="cpu")
    ref = jeval.UnstructuredCase.from_frame(
        jio.SimFrame(data=cells, top=top, obst=obst,
                     channels=jio.CH_DELTAS), DELTA)
    assert tuple(tc.grid.shape) == (24, 72)
    assert got.case.grid.shape == ref.case.grid.shape == (23, 71)
    assert (got.case.grid.x0, got.case.grid.y0) == (0.02, 0.02)
    # a field resampled onto the grid and back keeps the cells' values
    # where the grid's fluid cells surround them
    u = cells[:, 0]
    back = got.resample_back(got.grid_field(u).reshape(-1)).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(ref.resample_back(
            jnp.asarray(ref.grid_field(u)).reshape(-1))))
