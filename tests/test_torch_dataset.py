"""The training data and the evaluation of the PyTorch port against the
JAX package on the CPU: every family's `build_targets`, the LHS block
sampler, `build_block_dataset` (with the JAX package's corners), the
dataset files, `evaluate_bundle` and `error_metrics`.

Inputs are seeded with numpy. Tolerances, max |port - JAX| / max |JAX|:
- targets, blocks and the dataset's constants: 1e-6 (float32 elementwise
  arithmetic; the per-block zero-mean is a float32 sum in another order);
- the dataset files: equal (the same npz keys and dtypes);
- the evaluation's metrics (bias, stde, rmse in percent, and the norm),
  on a float32-compute bundle: 1e-5 relative (the predictor's float32
  products and stitch in another order); the block tier, which has no
  stitch, and error_metrics itself: 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.eval import evaluation as jeval
from tpufoam.fv import case as jcase
from tpufoam.surrogate import features as jfeat
from tpufoam.surrogate import pipeline as jpipe
from tpufoam.train import dataset as jds
from tpufoam.train import sampler as jsamp
from tpufoam.utils import metrics as jmet
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.eval import evaluation as teval
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.surrogate import features as tfeat
from tpufoam_torch.surrogate import pipeline as tpipe
from tpufoam_torch.train import dataset as tds
from tpufoam_torch.train import sampler as tsamp
from tpufoam_torch.utils import metrics as tmet

DATA_TOL = 1e-6
EVAL_TOL = 1e-5
NY, NX = 32, 128
BLOCK = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def close(got, ref, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30)
    assert err <= rtol * scale, \
        f"{what}: max err {err:.3e} > {rtol:g} * {scale:.3e}"


@pytest.fixture(scope="module")
def cases():
    delta = 2.0 / NY
    kw = dict(shape_name="cylinder", length=NX * delta, height=2.0,
              obstacle_size=0.5, nu=8e-3)
    return (jcase.build_channel_case(jax_geom(**kw), delta=delta),
            tcase.build_channel_case(channel_case_geometry(**kw),
                                     delta=delta, device="cpu"))


def _fields(jc, seed, still=False):
    """A frame: the initial flow with seeded noise; `still`: no change
    since the previous step (the stationarity skip drops it)."""
    rng = np.random.default_rng(seed)
    fl = np.asarray(jc.fluid)
    u0 = np.asarray(jcase.initial_flow(jc).u)
    f = dict(u=u0 + 0.05 * rng.standard_normal(fl.shape),
             v=0.05 * rng.standard_normal(fl.shape),
             p=rng.standard_normal(fl.shape))
    if still:
        f.update(u_prev=f["u"], v_prev=f["v"], p_prev=f["p"])
    else:
        f.update(u_prev=u0 + 0.02 * rng.standard_normal(fl.shape),
                 v_prev=0.02 * rng.standard_normal(fl.shape),
                 p_prev=rng.standard_normal(fl.shape))
    return {k: (a * fl).astype(np.float32) for k, a in f.items()}


# ---- targets -----------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(jfeat.FAMILIES))
def test_build_targets_match_jax(cases, family):
    jc, tc = cases
    f = _fields(jc, 1)
    ref = jfeat.FAMILIES[family].build_targets(
        jc, {k: jnp.asarray(v) for k, v in f.items()})
    got = tfeat.FAMILIES[family].build_targets(
        tc, {k: torch.as_tensor(v) for k, v in f.items()})
    assert got.shape[-1] == tfeat.FAMILIES[family].n_out
    close(got, ref, DATA_TOL, family)


def test_build_targets_of_a_stack_are_per_case(cases):
    """A (B, ny, nx) stack gives each case's targets, with its own Um."""
    jc, tc = cases
    fs = [_fields(jc, s) for s in (2, 3)]
    for name in ("deltaU_deltaP", "M_u", "U_gradP"):
        fam = tfeat.FAMILIES[name]
        stacked = fam.build_targets(tc, {k: torch.stack(
            [torch.as_tensor(f[k]) for f in fs]) for k in fs[0]})
        for b, f in enumerate(fs):
            one = fam.build_targets(tc, {k: torch.as_tensor(v)
                                         for k, v in f.items()})
            close(stacked[b], one, DATA_TOL, name)


# ---- sampler -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 120])
def test_lhs_has_one_point_per_stratum(n):
    pts = tsamp.lhs_sample(torch.Generator().manual_seed(n), n, 3).numpy()
    assert pts.shape == (n, 3)
    for col in pts.T:
        assert sorted(np.floor(col * n).astype(int)) == list(range(n))
    # the same generator state draws the same points
    again = tsamp.lhs_sample(torch.Generator().manual_seed(n), n, 3)
    assert np.array_equal(again.numpy(), pts)


def test_sample_block_corners_are_unique_and_in_range():
    gen = torch.Generator().manual_seed(0)
    for ny, nx, block, n in ((256, 1024, 128, 120), (32, 128, 16, 200),
                             (16, 16, 16, 5)):
        c = tsamp.sample_block_corners(gen, n, ny, nx, block)
        assert c.dtype == np.int64 and c.shape[1] == 2 and 1 <= len(c) <= n
        assert len(np.unique(c, axis=0)) == len(c)
        assert (c >= 0).all() and (c[:, 0] <= ny - block).all() \
            and (c[:, 1] <= nx - block).all()
    with pytest.raises(ValueError, match="smaller than block"):
        tsamp.sample_block_corners(gen, 8, ny=127, nx=511, block=128)


def test_gather_training_blocks_matches_jax():
    rng = np.random.default_rng(4)
    grid = rng.standard_normal((40, 70, 3)).astype(np.float32)
    corners = np.array([[0, 0], [24, 54], [3, 17]])
    ref = jsamp.gather_training_blocks(jnp.asarray(grid), corners, 16)
    got = tsamp.gather_training_blocks(torch.as_tensor(grid), corners, 16)
    assert np.array_equal(got.numpy(), np.asarray(ref))


# ---- the block dataset --------------------------------------------------------


@pytest.fixture(scope="module")
def frames(cases):
    jc, _ = cases
    fs = [_fields(jc, s) for s in range(4)]
    # a stationary frame (skipped) and a repeat of the first frame
    return fs[:2] + [_fields(jc, 9, still=True)] + fs[2:] + [fs[0]]


@pytest.mark.parametrize("family,flip,dedup", [
    ("deltaU_deltaP", True, True), ("U_gradP", True, True),
    ("M_u", False, False)])
def test_build_block_dataset_matches_jax(cases, frames, monkeypatch, family,
                                         flip, dedup):
    """The JAX package's corners are recorded and the port's sampler
    returns them in turn: then every array equals JAX's. The repeat of
    the first frame is given the first frame's corners, so that all its
    blocks are duplicates."""
    jc, tc = cases
    drawn = []
    real = jds.sample_block_corners
    per = 2 if flip else 1
    first_of_repeat = 4 * per

    def recorder(*args):
        i = len(drawn)
        drawn.append(real(*args) if i < first_of_repeat
                     else drawn[i - first_of_repeat])
        return drawn[-1]

    monkeypatch.setattr(jds, "sample_block_corners", recorder)
    ref = jds.build_block_dataset(jc, frames, family=family,
                                  n_samples_per_frame=40, block_size=BLOCK,
                                  seed=3, augment_flip=flip, dedup=dedup)
    replay = iter(drawn)
    monkeypatch.setattr(tds, "sample_block_corners",
                        lambda *args: next(replay))
    got = tds.build_block_dataset(tc, frames, family=family,
                                  n_samples_per_frame=40, block_size=BLOCK,
                                  seed=3, augment_flip=flip, dedup=dedup)
    assert next(replay, None) is None
    assert len(drawn) == 5 * per    # the still frame skipped
    for name in ("x", "y", "mask", "maxs_in", "maxs_out"):
        a = getattr(got, name)
        assert a.dtype == np.float32, name
        close(a, getattr(ref, name), DATA_TOL, name)
    n_drawn = sum(len(c) for c in drawn)
    n_repeat = sum(len(c) for c in drawn[:per])
    assert got.n == (n_drawn - n_repeat if dedup else n_drawn)


def test_build_block_dataset_on_tensor_frames(cases, frames):
    """Tensor frames (the rollout's) give what array frames give."""
    _, tc = cases
    kw = dict(n_samples_per_frame=30, block_size=BLOCK, seed=5)
    a = tds.build_block_dataset(tc, frames, **kw)
    b = tds.build_block_dataset(tc, [{k: torch.as_tensor(v)
                                      for k, v in f.items()}
                                     for f in frames], **kw)
    for name in ("x", "y", "mask", "maxs_in", "maxs_out"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    with pytest.raises(ValueError, match="stationary"):
        tds.build_block_dataset(tc, [frames[2]], **kw)


def test_frame_is_relevant_matches_jax(cases):
    jc, _ = cases
    for seed, still, thr in ((0, False, 1e-4), (1, True, 1e-4),
                             (2, False, 0.9)):
        f = _fields(jc, seed, still)
        args = [f[k] for k in ("u", "v", "u_prev", "v_prev")]
        assert tds.frame_is_relevant(*args, threshold=thr) \
            == jds.frame_is_relevant(*args, threshold=thr)


def test_dataset_files_cross_load(tmp_path):
    rng = np.random.default_rng(6)
    ds = tds.BlockDataset(
        x=rng.standard_normal((5, 8, 8, 3)).astype(np.float32),
        y=rng.standard_normal((5, 8, 8, 1)).astype(np.float32),
        mask=(rng.uniform(size=(5, 8, 8)) > 0.3).astype(np.float32),
        maxs_in=np.ones(3, np.float32), maxs_out=np.ones(1, np.float32))
    tds.save_block_dataset(str(tmp_path / "port.npz"), ds)
    jds.save_block_dataset(str(tmp_path / "jax.npz"),
                           jds.BlockDataset(**dataclasses.asdict(ds)))
    for path in ("port.npz", "jax.npz"):
        a = tds.load_block_dataset(str(tmp_path / path))
        b = jds.load_block_dataset(str(tmp_path / path))
        for name in ("x", "y", "mask", "maxs_in", "maxs_out"):
            assert np.array_equal(getattr(a, name), getattr(b, name))
            assert getattr(a, name).dtype == getattr(b, name).dtype
        # x went through float16 and back
        close(a.x, ds.x, 1e-3, path)
    with np.load(tmp_path / "port.npz") as p, \
            np.load(tmp_path / "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        assert all(p[k].dtype == j[k].dtype for k in p.files)
    for side in (None, 0, 1):
        got = ds.flat_normalized(slice(1, 4), side=side)
        ref = jds.BlockDataset(**dataclasses.asdict(ds)).flat_normalized(
            slice(1, 4), side=side)
        for g, r in zip(got if side is None else (got,),
                        ref if side is None else (ref,)):
            assert np.array_equal(g, r)


# ---- evaluation -------------------------------------------------------------


def test_error_metrics_matches_jax():
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((20, 30))
    true = pred + 0.1 * rng.standard_normal((20, 30))
    pred[3, 4] = np.nan                          # dropped as non-finite
    mask = rng.uniform(size=(20, 30)) > 0.2
    for m in (None, mask):
        ref = jmet.error_metrics(pred, true, m)
        got = tmet.error_metrics(torch.as_tensor(pred), true, m)
        for name in ("bias_pct", "stde_pct", "rmse_pct", "norm"):
            assert getattr(got, name) == pytest.approx(getattr(ref, name),
                                                       rel=DATA_TOL), name
        assert str(got) == str(ref)


def _bundles(family, n_out, tmp_path):
    """A JAX tiny bundle of `family` with float32 compute, and the port's
    load of its files."""
    jb = _tiny_bundle(block_size=BLOCK, n_out=n_out, seed=1)
    jb = dataclasses.replace(jb, family=family, mdef=dataclasses.replace(
        jb.mdef, compute_dtype="float32"))
    path = str(tmp_path / family)
    jb.save(path)
    return jpipe.SurrogateBundle.load(path), \
        tpipe.SurrogateBundle.load(path, device="cpu")


def _reports_close(got, ref, tol, block_tol):
    def same(g, r, t, what):
        assert (g is None) == (r is None), what
        if r is None:
            return
        for name in ("bias_pct", "stde_pct", "rmse_pct", "norm"):
            assert getattr(g, name) == pytest.approx(
                getattr(r, name), rel=t, abs=t * abs(r.rmse_pct)), \
                (what, name)

    same(got.block, ref.block, block_tol, "block")
    same(got.field, ref.field, tol, "field")
    same(got.field_weighted, ref.field_weighted, tol, "field_weighted")
    same(got.p_field, ref.p_field, tol, "p_field")
    assert got.field_label == ref.field_label
    assert len(got.per_frame) == len(ref.per_frame)
    for g, r in zip(got.per_frame, ref.per_frame):
        assert (g is None) == (r is None)
        if r is not None:
            same(g["field"], r["field"], tol, "frame field")
            same(g["p"], r["p"], tol, "frame p")
    assert got.summary().count("**") == ref.summary().count("**")


@pytest.mark.parametrize("family,n_out,stitch,weighted", [
    ("deltaU_deltaP", 1, "scan", False),
    ("deltaU_deltaP", 1, "lstsq", True),
    ("U_gradP", 2, "lstsq", False)])
def test_evaluate_bundle_matches_jax(cases, frames, tmp_path, family, n_out,
                                     stitch, weighted):
    jc, tc = cases
    jb, tb = _bundles(family, n_out, tmp_path)
    ref = jeval.evaluate_bundle(jb, jc, frames, stitch=stitch,
                                weighted=weighted)
    got = teval.evaluate_bundle(tb, tc, frames, stitch=stitch,
                                weighted=weighted)
    assert ref.block is not None
    _reports_close(got, ref, EVAL_TOL, DATA_TOL * 10)


def test_evaluate_bundle_weights_from_in_frame_deltas(cases, frames,
                                                      tmp_path):
    """The weighting's previous-step deltas from the frame's own
    du_prev/dv_prev/dp_prev fields, and a sequence of only stationary
    frames (no tiers)."""
    jc, tc = cases
    jb, tb = _bundles("deltaU_deltaP", 1, tmp_path)
    rng = np.random.default_rng(8)
    fs = []
    for f in frames[:2]:
        f = dict(f)
        for k in ("du_prev", "dv_prev", "dp_prev"):
            f[k] = (0.01 * rng.standard_normal(f["u"].shape)).astype(
                np.float32)
        fs.append(f)
    ref = jeval.evaluate_bundle(jb, jc, fs, weighted=True)
    got = teval.evaluate_bundle(tb, tc, fs, weighted=True)
    _reports_close(got, ref, EVAL_TOL, DATA_TOL * 10)
    empty = teval.evaluate_bundle(tb, tc, [frames[2]])
    assert empty.block is None and empty.per_frame == [None]
