"""The surrogate families and predictor options of the PyTorch port
against the JAX package on the CPU: `surrogate.features` (`smart_arcsinh`,
`masked_gradient`, `poisson_source`, `f_u_term`, every family's inputs),
`surrogate.blocks` (`gaussian_filter2d`, `assemble_scan(apply_filter=)`,
the lstsq stitch's `ref_bc` and `anchor_weight`, `apply_deltaU_weighting`),
`surrogate.pipeline.make_predictor` with `family`, `near_wall_dist`,
`precision` and `apply_filter` on bundles of every norm method, the real
sm_poisson128 and sm_gradp128 bundles, and
`surrogate.gradp_integrate.integrate_gradp`.

Inputs are seeded with numpy. Tolerances, max |port - JAX| / max |JAX|:
- elementwise float32 features and the filter: FEAT_TOL 1e-5 (the
  population std and the whole-field means are float32 sums in another
  order);
- the filter against scipy.ndimage.gaussian_filter (float64): 1e-5;
- stitches and the gradient integration (cumulative float32 sums):
  1e-5;
- predictions, the predicted change: 2e-2 (tests/test_torch_surrogate.py:
  the bf16 MLP's rounding of inputs that differ in their last float32
  bit), also with precision='bf16' (bf16 PCA operands in both packages);
- the same predictor or stitch with and without an option that changes
  nothing: bit for bit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.surrogate import blocks as jblk
from tpufoam.surrogate import features as jfeat
from tpufoam.surrogate import gradp_integrate as jgi
from tpufoam.surrogate import pipeline as jpipe
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.surrogate import blocks as tblk
from tpufoam_torch.surrogate import features as tfeat
from tpufoam_torch.surrogate import gradp_integrate as tgi
from tpufoam_torch.surrogate import pipeline as tpipe

FEAT_TOL = 1e-5
FILTER_TOL = 1e-5
STITCH_TOL = 1e-5
PRED_TOL = 2e-2
NY, NX = 32, 128
ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, ref, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert err <= rtol * scale, \
        f"{what}: max err {err:.3e} > {rtol:g} * {scale:.3e}"


def _pair(shape_name="cylinder", ny=NY, nx=NX, size=0.5, nu=8e-3):
    delta = 2.0 / ny
    kw = dict(shape_name=shape_name, length=nx * delta, height=2.0,
              obstacle_size=size, nu=nu)
    return (jcase.build_channel_case(jax_geom(**kw), delta=delta),
            tcase.build_channel_case(channel_case_geometry(**kw),
                                     delta=delta, device="cpu"))


@pytest.fixture(scope="module")
def cases():
    return _pair()


def _fields(jc, seed):
    rng = np.random.default_rng(seed)
    fl = np.asarray(jc.fluid)
    u0 = np.asarray(jcase.initial_flow(jc).u)
    return {k: (a * fl).astype(np.float32) for k, a in dict(
        u=u0 + 0.05 * rng.standard_normal(fl.shape),
        v=0.05 * rng.standard_normal(fl.shape),
        p=rng.standard_normal(fl.shape),
        u_prev=u0 + 0.02 * rng.standard_normal(fl.shape),
        v_prev=0.02 * rng.standard_normal(fl.shape),
        p_prev=rng.standard_normal(fl.shape)).items()}


# ---- (a) features ------------------------------------------------------------


@pytest.mark.parametrize("band", ["both-signs", "positive", "negative"])
def test_smart_arcsinh_matches_jax(band):
    rng = np.random.default_rng(1)
    f = rng.standard_normal((32, 64)).astype(np.float32)
    f[3, 5], f[7, 9] = 40.0, -35.0               # outliers on both sides
    if band == "positive":
        f = f + 50.0                              # the band above zero
    elif band == "negative":
        f = f - 50.0
    for k in (1.0, 2.0):
        ref = jfeat.smart_arcsinh(jnp.asarray(f), k)
        got = tfeat.smart_arcsinh(T(f), k)
        close(got, ref, FEAT_TOL, f"{band} k {k}")
    # monotonic in the field, also when the band lies on one side of zero
    order = np.argsort(f.ravel())
    assert np.all(np.diff(got.numpy().ravel()[order]) >= 0)


def test_masked_gradient_matches_jax_and_numpy(cases):
    jc, tc = cases
    f = np.random.default_rng(2).standard_normal((NY, NX)).astype(np.float32)
    ref = jfeat.masked_gradient(jc, jnp.asarray(f))
    got = tfeat.masked_gradient(tc, T(f))
    for g, r in zip(got, ref):
        close(g, r, FEAT_TOL)
    # unit spacing, first-order one-sided edges: np.gradient's rule
    keep = got[0].numpy() != 0
    gy, _ = np.gradient(f)
    np.testing.assert_allclose(got[0].numpy()[keep], gy[keep], rtol=1e-6)


def test_poisson_source_and_f_u_term_match_jax(cases):
    jc, tc = cases
    f = _fields(jc, 3)
    um_j = jfeat.u_max_norm(jnp.asarray(f["u"]), jnp.asarray(f["v"]))
    um_t = tfeat.u_max_norm(T(f["u"]), T(f["v"]))
    close(um_t, um_j, FEAT_TOL)
    for ls, ks in ((1.0, 2.0), (2.5, 1.0)):
        close(tfeat.poisson_source(tc, T(f["u"]), T(f["v"]), um_t, ls, ks),
              jfeat.poisson_source(jc, jnp.asarray(f["u"]),
                                   jnp.asarray(f["v"]), um_j, ls, ks),
              FEAT_TOL, f"poisson_source {ls} {ks}")
    close(tfeat.f_u_term(tc, T(f["u"]), T(f["v"])),
          jfeat.f_u_term(jc, jnp.asarray(f["u"]), jnp.asarray(f["v"])),
          FEAT_TOL, "f_u_term")


@pytest.mark.parametrize("family", list(jfeat.FAMILIES))
def test_family_inputs_match_jax(cases, family):
    jc, tc = cases
    jfam, tfam = jfeat.FAMILIES[family], tfeat.FAMILIES[family]
    for attr in ("name", "n_in", "n_out", "target_zero_mean",
                 "predicts_delta"):
        assert getattr(tfam, attr) == getattr(jfam, attr), attr
    f = _fields(jc, 4)
    ref = jfam.build_inputs(jc, {k: jnp.asarray(v) for k, v in f.items()})
    got = tfam.build_inputs(tc, {k: T(v) for k, v in f.items()})
    assert got.shape == (NY, NX, jfam.n_in)
    for c in range(jfam.n_in):
        close(got[..., c], ref[..., c], FEAT_TOL, f"{family} channel {c}")


# ---- (d) the filter and the stitch options ----------------------------------


@pytest.mark.parametrize("sigma", [10.0, 3.0, 50.0])
def test_gaussian_filter_matches_jax_and_scipy(sigma):
    f = np.random.default_rng(5).standard_normal((48, 96)).astype(np.float32)
    got = tblk.gaussian_filter2d(T(f), sigma)
    close(got, jblk.gaussian_filter2d(jnp.asarray(f), sigma), FILTER_TOL,
          f"JAX, sigma {sigma}")
    # sigma 50: the radius (200) passes both axes, reflected again
    close(got, scipy.ndimage.gaussian_filter(f.astype(np.float64), sigma),
          FILTER_TOL, f"scipy, sigma {sigma}")


def test_symmetric_pad_is_numpys():
    for n, r in ((5, 2), (5, 5), (5, 13), (1, 3)):
        x = np.arange(n)
        np.testing.assert_array_equal(
            x[tblk._symmetric_index(n, r)], np.pad(x, r, mode="symmetric"))


@pytest.fixture(scope="module")
def stitch_problem(cases):
    jc, tc = cases
    layout = jblk.build_block_layout(NY, NX, 16, 0.25)
    tlayout = tblk.build_block_layout(NY, NX, 16, 0.25)
    blocks = np.random.default_rng(6).standard_normal(
        (layout.n_blocks, 16, 16)).astype(np.float32)
    jmb = jblk.extract_blocks(layout, jc.sdf)
    tmb = tblk.extract_blocks(tlayout, tc.sdf)
    return layout, tlayout, blocks, jmb, tmb


@pytest.mark.parametrize("sigma", [10.0, 2.0])
def test_assemble_scan_with_the_filter_matches_jax(stitch_problem, sigma):
    layout, tlayout, blocks, jmb, tmb = stitch_problem
    ref = jblk.assemble_scan(layout, jnp.asarray(blocks), jmb,
                             apply_filter=True, filter_sigma=sigma)
    got = tblk.assemble_scan(tlayout, T(blocks), tmb, apply_filter=True,
                             filter_sigma=sigma)
    close(got, ref, STITCH_TOL)
    plain = tblk.assemble_scan(tlayout, T(blocks), tmb)
    assert torch.equal(tblk.gaussian_filter2d(plain, sigma), got)


def test_lstsq_ref_bc_and_anchor_weight_change_nothing(stitch_problem):
    layout, tlayout, blocks, jmb, tmb = stitch_problem
    b = T(blocks)
    base = tblk.stitch_offsets_lstsq(tlayout, b, tmb)
    assert torch.equal(tblk.stitch_offsets_lstsq(
        tlayout, b, tmb, ref_bc=0.7, anchor_weight=5.0), base)
    assert torch.equal(tblk.assemble_lstsq(tlayout, b, tmb, ref_bc=0.7),
                       tblk.assemble_lstsq(tlayout, b, tmb))
    # as in JAX
    jbase = jblk.stitch_offsets_lstsq(layout, jnp.asarray(blocks), jmb)
    np.testing.assert_array_equal(
        np.asarray(jblk.stitch_offsets_lstsq(
            layout, jnp.asarray(blocks), jmb, ref_bc=0.7,
            anchor_weight=5.0)), np.asarray(jbase))
    close(base, jbase, STITCH_TOL)


def test_apply_deltaU_weighting_matches_jax():
    rng = np.random.default_rng(7)
    res, dp, du = (rng.standard_normal((40, 120)).astype(np.float32)
                   for _ in range(3))
    du = np.abs(du) / np.abs(du).max()
    for kw in ({}, dict(sigma_wgt=5.0, sigma_out=2.0)):
        close(tblk.apply_deltaU_weighting(T(res), T(dp), T(du), **kw),
              jblk.apply_deltaU_weighting(jnp.asarray(res), jnp.asarray(dp),
                                          jnp.asarray(du), **kw),
              FEAT_TOL, str(kw))


# ---- (e) the predictor's families and options --------------------------------

NORMS = {
    "std": None,
    "min_max": lambda pc_in, pc_out, rng: dict(
        min_in=-1.0 - rng.random(pc_in), max_in=1.0 + rng.random(pc_in),
        min_out=-0.5 - rng.random(pc_out), max_out=0.5 + rng.random(pc_out)),
    "max_abs": lambda pc_in, pc_out, rng: dict(
        max_abs_in=1.0 + rng.random(pc_in),
        max_abs_out=0.5 + rng.random(pc_out)),
}
PREDICTORS = {
    # (family, norm method, make_predictor options)
    "poisson": ("poisson", "std", dict(stitch="lstsq")),
    "M_u": ("M_u", "min_max", dict(stitch="scan", near_wall_dist=0.1)),
    "M_fU": ("M_fU", "max_abs", dict(stitch="lstsq", precision="bf16")),
    "poisson-filter": ("poisson", "max_abs",
                       dict(stitch="scan", apply_filter=True)),
}


def _bundle_dirs(tmp_path, family, norm):
    """A tiny JAX bundle of `family` with `norm`, written by JAX's save."""
    fam = jfeat.FAMILIES[family]
    jb = _tiny_bundle(block_size=16, n_in=fam.n_in, n_out=fam.n_out)
    rng = np.random.default_rng(8)
    jb = dataclasses.replace(jb, family=family,
                             maxs_in=(0.5 + rng.random(fam.n_in)).astype(
                                 np.float32))
    if NORMS[norm] is not None:
        jb = dataclasses.replace(jb, norm_method=norm, norm={
            k: jnp.asarray(v, jnp.float32)
            for k, v in NORMS[norm](jb.pc_in, jb.pc_out, rng).items()})
    path = str(tmp_path / f"{family}-{norm}")
    jb.save(path)
    return path


@pytest.mark.parametrize("name", list(PREDICTORS))
def test_make_predictor_families_and_options_match_jax(cases, tmp_path, name):
    family, norm, opts = PREDICTORS[name]
    jc, tc = cases
    path = _bundle_dirs(tmp_path, family, norm)
    jb = jpipe.SurrogateBundle.load(path)
    tb = tpipe.SurrogateBundle.load(path, device="cpu")
    assert tb.norm_method == norm
    f = _fields(jc, 9)
    ref = jpipe.make_predictor(jb, **opts)(
        jc, jnp.asarray(f["p"]), {k: jnp.asarray(v) for k, v in f.items()})
    pred = tpipe.make_predictor(tb, **opts)
    got = pred(tc, T(f["p"]), {k: T(v) for k, v in f.items()})
    close(got - T(f["p"]), np.asarray(ref) - f["p"], PRED_TOL, name)
    if opts.get("precision") == "bf16":
        assert pred.bundle.pca_in.components.dtype == torch.bfloat16
        assert tb.pca_in.components.dtype == torch.float32
    # the guard keeps p_prev on every cell within near_wall_dist
    guard = (tc.sdf < opts.get("near_wall_dist", 0.05)) | (tc.fluid == 0)
    assert torch.equal(got[guard], T(f["p"])[guard])


def test_family_argument_overrides_the_bundles(cases, tmp_path):
    """`family=` serves a bundle through another family's features: the
    same as a bundle of that family."""
    jc, tc = cases
    f = {k: T(v) for k, v in _fields(jc, 10).items()}
    tb = tpipe.SurrogateBundle.load(_bundle_dirs(tmp_path, "M_u", "std"),
                                    device="cpu")
    as_mu = tpipe.make_predictor(tb)(tc, f["p"], f)
    tb_d = dataclasses.replace(tb, family="deltaU_deltaP")
    via = tpipe.make_predictor(tb_d, family=tfeat.FAMILIES["M_u"])(
        tc, f["p"], f)
    assert torch.equal(via, as_mu)
    assert not torch.equal(tpipe.make_predictor(tb_d)(tc, f["p"], f), as_mu)


def test_gradient_family_is_refused_like_jax(tmp_path):
    path = _bundle_dirs(tmp_path, "U_gradP", "std")
    with pytest.raises(ValueError):
        jpipe.make_predictor(jpipe.SurrogateBundle.load(path))
    tb = tpipe.SurrogateBundle.load(path, device="cpu")
    with pytest.raises(ValueError):
        tpipe.make_predictor(tb)
    with pytest.raises(ValueError):
        tpipe.make_predictor(tb, family=tfeat.FAMILIES["U_gradP"])
    ok = tpipe.make_predictor(tb, family=tfeat.FAMILIES["M_u"])
    assert ok.family.name == "M_u"
    with pytest.raises(ValueError):
        tpipe.make_predictor(tb, family=tfeat.FAMILIES["M_u"],
                             precision="f16")


def test_trimmed_drops_the_components_beyond_the_pc_counts(tmp_path):
    tb = tpipe.SurrogateBundle.load(_bundle_dirs(tmp_path, "M_u", "std"),
                                    device="cpu")
    tb = dataclasses.replace(tb, pc_in=tb.pc_in - 5, pc_out=tb.pc_out - 3)
    tr = tb.trimmed()
    assert tr.pca_in.components.shape[0] == tb.pc_in
    assert tr.pca_out.explained_variance.shape[0] == tb.pc_out
    assert torch.equal(tr.pca_in.components,
                       tb.pca_in.components[:tb.pc_in])


# ---- (f) the real bundles on a 64 x 256 triangle case ------------------------


@pytest.fixture(scope="module")
def triangle():
    return _pair("triangle", ny=64, nx=256, size=0.55, nu=6e-3)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_sm_poisson128_matches_jax(triangle, precision):
    jc, tc = triangle
    path = os.path.join(ARTIFACTS, "sm_poisson128")
    jb = jpipe.SurrogateBundle.load(path)
    tb = tpipe.SurrogateBundle.load(path, device="cpu")
    assert tb.family == "poisson" and tb.block_size == 64
    f = _fields(jc, 12)
    ref = jpipe.make_predictor(jb, stitch="lstsq", precision=precision)(
        jc, jnp.asarray(f["p"]), {k: jnp.asarray(v) for k, v in f.items()})
    got = tpipe.make_predictor(tb, stitch="lstsq", precision=precision)(
        tc, T(f["p"]), {k: T(v) for k, v in f.items()})
    close(got - T(f["p"]), np.asarray(ref) - f["p"], PRED_TOL, precision)


def _gradp_tier(mod_blk, mod_pipe, mod_feat, mod_gi, bundle, case, fields):
    """The U_gradP evaluation tier of the JAX package's evaluation.py:
    blocks forward, each gradient channel stitched by least squares and
    scaled by maxs_out, then integrated to a pressure."""
    layout = mod_blk.build_block_layout(case.grid.ny, case.grid.nx,
                                        bundle.block_size,
                                        bundle.overlap_ratio)
    fam = mod_feat.FAMILIES["U_gradP"]
    um = mod_feat.u_max_norm(fields["u"], fields["v"])
    yb = mod_pipe.surrogate_blocks_forward(
        bundle, layout, fam.build_inputs(case, fields), case.sdf)
    mb = mod_blk.extract_blocks(layout, case.sdf)
    lx = case.grid.nx * case.grid.dx
    ly = case.grid.ny * case.grid.dy
    gx = mod_blk.assemble_lstsq(layout, yb[..., 0], mb) * bundle.maxs_out[0]
    gy = mod_blk.assemble_lstsq(layout, yb[..., 1], mb) * bundle.maxs_out[1]
    return mod_gi.integrate_gradp(case, gx * um**2 / lx, gy * um**2 / ly)


def test_sm_gradp128_tier_matches_jax(triangle):
    jc, tc = triangle
    path = os.path.join(ARTIFACTS, "sm_gradp128")
    jb = jpipe.SurrogateBundle.load(path)
    tb = tpipe.SurrogateBundle.load(path, device="cpu")
    assert tb.family == "U_gradP"
    f = _fields(jc, 13)
    ref = _gradp_tier(jblk, jpipe, jfeat, jgi, jb, jc,
                      {k: jnp.asarray(v) for k, v in f.items()})
    got = _gradp_tier(tblk, tpipe, tfeat, tgi, tb, tc,
                      {k: T(v) for k, v in f.items()})
    close(got, ref, PRED_TOL)
    with pytest.raises(ValueError):
        tpipe.make_predictor(tb)


# ---- (g) the gradient integration ----------------------------------------------


@pytest.mark.parametrize("obstacle", [True, False])
def test_integrate_gradp_matches_jax(cases, obstacle):
    if obstacle:
        jc, tc = cases
    else:
        jc = jcase.build_channel_case(
            jcase.ChannelCase(length=8.0, height=2.0, shape=None),
            delta=2.0 / NY)
        from tpufoam_torch.core.geometry import ChannelCase
        tc = tcase.build_channel_case(
            ChannelCase(length=8.0, height=2.0, shape=None),
            delta=2.0 / NY, device="cpu")
    rng = np.random.default_rng(14)
    # the gradient of a smooth field plus noise
    y, x = np.meshgrid(np.arange(NY), np.arange(NX), indexing="ij")
    p = np.sin(x / 9.0) * np.cos(y / 5.0)
    gy, gx = np.gradient(p)
    gx = (gx / jc.grid.dx + 0.01 * rng.standard_normal(p.shape)
          ).astype(np.float32)
    gy = (gy / jc.grid.dy + 0.01 * rng.standard_normal(p.shape)
          ).astype(np.float32)
    ref = jgi.integrate_gradp(jc, jnp.asarray(gx), jnp.asarray(gy))
    got = tgi.integrate_gradp(tc, T(gx), T(gy))
    close(got, ref, STITCH_TOL)
    centre = (NY // 3, NX // 3)
    close(tgi.integrate_gradp(tc, T(gx), T(gy), center=centre),
          jgi.integrate_gradp(jc, jnp.asarray(gx), jnp.asarray(gy),
                              center=centre), STITCH_TOL, "given centre")
