"""The Schaefer-Turek validation path of tpufoam_torch against the JAX
package, on the CPU: `eval.benchmark` (the case, the ramp, the force
series, its restart files and summaries) and `fv.forces`.

Tolerances:
- the case's masks, inlet and SDF: exact (the masks are numpy on the
  host in both; the port rounds the SDF's cancelling expression as XLA
  does on the CPU, so the predictor's near-wall guard, which compares it
  with 0.05, is the same on every Schaefer-Turek grid);
- forces from the same fields: 1e-5 relative to the largest component
  (float32 sums over the wall cells in another order);
- the summaries and the pressure probe: exact up to float64 rounding
  (1e-12), both are numpy on the same arrays;
- one sm_st128 prediction: 1e-4 with a float32 MLP, as in
  tests/test_torch_surrogate.py; 3e-2 with its bf16 MLP, whose three
  hidden layers of 512 each round their inputs to bf16, so a last-bit
  difference of an f32 input compounds over three roundings of 2^-8
  (measured 1.4e-2; sm_ref512's two layers stay under 1e-2);
- the hybrid AutoBackend force series (BDF2, sm_trust 1.0, the tiny
  bundle): test_torch_piso.py's TOL per polish precision, f32 1e-4 and
  bf16 5e-2, on every field and sample time. A force coefficient is a sum
  over the wall cells whose terms cancel (the start-up's drag and lift
  are small differences of large wall pressures), so cd and cl are held
  at TOL times the sum of the magnitudes of their terms (f32 measured
  2.6e-6 of it);
- a run-state file written by either package loads in the other exactly.
"""

import dataclasses
import functools
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.eval import benchmark as jbench
from tpufoam.fv import case as jcase
from tpufoam.fv import forces as jforces
from tpufoam.piso import engine as jeng
from tpufoam.solvers import backends as jbe
from tpufoam.surrogate import pipeline as jpipe
from tpufoam_torch.eval import benchmark as tbench
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv import forces as tforces
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers import backends as tbe
from tpufoam_torch.surrogate import pipeline as tpipe
from test_torch_piso import bundle_to_torch

DELTA = 0.0064     # 64 x 344, D/delta = 15.6
TOL = {"f32": 1e-4, "bf16": 5e-2}
FORCE_TOL = 1e-5
MASKS = ("fluid", "open_e", "open_w", "open_n", "open_s", "wall_e",
         "wall_w", "wall_n", "wall_s", "inlet_w", "outlet_e", "alpha",
         "wall_ax", "wall_ay", "wall_len", "wall_dist", "inlet_u")
FLOW = ("u", "v", "p", "phi_x", "phi_y", "dt", "t", "u_prev", "v_prev",
        "p_prev")
BUNDLE = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                      "sm_st128")


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
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    assert err <= rtol * scale, \
        f"{what}: max err {err:.3e} > {rtol:g} * {scale:.3e}"


@pytest.fixture(scope="module")
def st():
    jc, ju = jbench.schafer_turek_case("2D-2", delta=DELTA)
    tc, tu = tbench.schafer_turek_case("2D-2", delta=DELTA, device="cpu")
    return jc, tc, ju, tu


@functools.lru_cache(maxsize=None)
def _st_cases(delta):
    return (jbench.schafer_turek_case("2D-2", delta=delta)[0],
            tbench.schafer_turek_case("2D-2", delta=delta, device="cpu")[0])


@pytest.mark.parametrize("kw", [dict(bench="2D-1"), dict(bench="2D-2"),
                                dict(bench="2D-3"),
                                dict(bench="2D-1", cy=0.205, alpha_cut=0.1)],
                         ids=["2D-1", "2D-2", "2D-3", "2D-1-control"])
def test_schafer_turek_case_leaf_for_leaf(kw):
    jc, ju = jbench.schafer_turek_case(delta=DELTA, **kw)
    tc, tu = tbench.schafer_turek_case(delta=DELTA, device="cpu", **kw)
    assert tu == ju
    assert tc.grid.shape == jc.grid.shape == (64, 344)
    assert (tc.grid.dx, tc.grid.dy, tc.nu, tc.cut) \
        == (jc.grid.dx, jc.grid.dy, jc.nu, jc.cut)
    for name in MASKS:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    np.testing.assert_array_equal(tc.sdf.numpy(), np.asarray(jc.sdf))


@pytest.mark.parametrize("delta,shape", [(0.0032, (128, 688)),
                                         (0.0016, (256, 1375))],
                         ids=["128x688", "256x1375"])
def test_near_wall_guard_matches_jax(delta, shape):
    """The surrogate's near-wall guard on the grids of the sm_st128
    prediction and of the validation run: rows of cell centres sit 0.05
    from a wall (row 112 of 128 x 688), where the SDF's last bit decides
    it, so the SDFs must agree bit for bit."""
    jc, tc = _st_cases(delta)
    assert tc.grid.shape == shape
    fl = np.asarray(jc.fluid)
    j_guard = (np.asarray(jc.sdf) < 0.05) | (fl == 0)
    # the guard distance is make_predictor's default near_wall_dist
    near_wall = inspect.signature(tpipe.make_predictor).parameters[
        "near_wall_dist"].default
    t_guard = ((tc.sdf < near_wall) | (tc.fluid == 0)).numpy()
    rows = sorted(set(np.argwhere(j_guard != t_guard)[:, 0].tolist()))
    assert not rows, f"guard differs on rows {rows}"
    np.testing.assert_array_equal(tc.sdf.numpy(), np.asarray(jc.sdf))


def test_published_constants_are_the_jax_packages():
    assert tbench.PUBLISHED == jbench.PUBLISHED
    assert tbench.D_CYL == jbench.D_CYL and tbench.CHANNEL == jbench.CHANNEL


def test_ramp_2d3_matches_jax():
    t = np.array([-1.0, 0.0, 1e-3, 2.0, 4.0, 7.999, 8.0, 9.5],
                 dtype=np.float32)
    close(tbench.ramp_2d3(T(t)), jbench.ramp_2d3(jnp.asarray(t)), 1e-6)


def _seeded_fields(fluid, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(fluid.shape) * fluid).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("boundary", ["cutcell", "blank"])
def test_obstacle_force_matches_jax(boundary):
    from tpufoam.core.geometry import channel_case_geometry as jax_geom
    from tpufoam_torch.core.geometry import channel_case_geometry
    kw = dict(shape_name="cylinder", length=2.2, height=0.41,
              obstacle_size=0.1, cx=0.2, cy=0.2, u_mean=1.0, nu=1e-3)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=DELTA,
                                  boundary=boundary)
    tc = tcase.build_channel_case(channel_case_geometry(**kw), delta=DELTA,
                                  boundary=boundary, device="cpu")
    assert tc.cut == (boundary == "cutcell")
    u, v, p = _seeded_fields(np.asarray(jc.fluid), 4)
    ref = jforces.obstacle_force(jc, jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(p), u_ref=1.0, d_ref=0.1)
    got = tforces.obstacle_force(tc, T(u), T(v), T(p), u_ref=1.0,
                                 d_ref=0.1)
    scale = np.abs(np.asarray(ref.total)).max()
    for name in ("f_pressure", "f_viscous", "total"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=FORCE_TOL * scale, err_msg=name)
    q = 0.5 * 1.0 * 0.1
    np.testing.assert_allclose([float(got.cd), float(got.cl)],
                               [float(ref.cd), float(ref.cl)], rtol=0,
                               atol=FORCE_TOL * scale / q)


def _series(seed=2):
    """A shedding-like signal: 3 Hz lift with a drift and noise."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.004, 0.006, 600))
    cl = np.sin(2 * np.pi * 3.0 * t) + 0.01 * rng.standard_normal(t.size)
    cd = 3.2 + 0.02 * np.sin(2 * np.pi * 6.0 * t) + 0.01 * t
    return t, cd, cl


def test_strouhal_and_summaries_match_jax(st):
    jc, tc, _, _ = st
    t, cd, cl = _series()
    assert tbench.strouhal_from_cl(t, cl) == pytest.approx(
        jbench.strouhal_from_cl(t, cl), rel=1e-12)
    assert tbench.strouhal_from_cl(t, cl) == pytest.approx(0.3, rel=2e-2)
    js = jbench.ForceSeries(t=t, cd=cd, cl=cl, n_steps=600)
    ts_ = tbench.ForceSeries(t=t, cd=cd, cl=cl, n_steps=600)
    ref, got = jbench.summarize_2d2(js, 0.5), tbench.summarize_2d2(ts_, 0.5)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k
    p = _seeded_fields(np.asarray(jc.fluid), 9)[2]
    for x, y in ((0.15, 0.2), (0.25, 0.2), (1.0, 0.1)):
        assert tbench.pressure_probe(tc, T(p), x, y) == pytest.approx(
            jbench.pressure_probe(jc, jnp.asarray(p), x, y), rel=1e-12)
    ref3 = jbench.summarize_2d3(js, jc, jcase.Flow(
        *(None,) * 2, jnp.asarray(p), *(None,) * 7), t_skip=0.5)
    got3 = tbench.summarize_2d3(ts_, tc, dataclasses.replace(
        tcase.initial_flow(tc), p=T(p)), t_skip=0.5)
    for k in ref3:
        assert got3[k] == pytest.approx(ref3[k], rel=1e-12), k


def _state(jc, seed=6):
    """A flow with seeded fields and a series, as numpy arrays."""
    rng = np.random.default_rng(seed)
    f0 = jcase.initial_flow(jc, dt0=2e-4)
    flow = {k: np.asarray(getattr(f0, k)) for k in FLOW}
    for k in ("u", "v", "p", "phi_x", "phi_y"):
        flow[k] = (flow[k] + rng.standard_normal(flow[k].shape)
                   ).astype(np.float32)
    flow["t"] = np.float32(0.0123)
    flow["dt"] = np.float32(3.1e-4)
    t, cd, cl = (a[:40] for a in _series(seed))
    return flow, (t, cd, cl, 123)


META = dict(bench="2D-2", delta=DELTA, ddt="backward", backend="hybrid",
            hybrid_solver="auto", sm_trust=1.0)


def test_run_state_files_cross_packages(st, tmp_path):
    jc, tc, _, _ = st
    flow, (t, cd, cl, n) = _state(jc)
    # JAX writes, the port reads
    path = str(tmp_path / "jax.npz")
    jbench.save_run_state(
        path, jcase.Flow(**{k: jnp.asarray(v) for k, v in flow.items()}),
        jbench.ForceSeries(t=t, cd=cd, cl=cl, n_steps=n), meta=META)
    tf, ts_ = tbench.load_run_state(path, expect_meta=META, device="cpu")
    for k in FLOW:
        np.testing.assert_array_equal(getattr(tf, k).numpy(), flow[k], k)
        assert getattr(tf, k).dtype == torch.float32
    np.testing.assert_array_equal(ts_.t, t)
    np.testing.assert_array_equal(ts_.cl, cl)
    assert ts_.n_steps == n
    # the port writes, JAX reads
    path2 = str(tmp_path / "torch.npz")
    tbench.save_run_state(path2, tf, ts_, meta=META)
    jf, js = jbench.load_run_state(path2, expect_meta=META)
    for k in FLOW:
        np.testing.assert_array_equal(np.asarray(getattr(jf, k)), flow[k], k)
    np.testing.assert_array_equal(js.cd, cd)
    assert js.n_steps == n
    merged = tbench.merge_series(ts_, ts_)
    assert merged.n_steps == 2 * n and merged.t.size == 2 * t.size


@pytest.mark.parametrize("expect,defaults", [
    ({**META, "ddt": "euler"}, None),
    ({**META, "wall_order": 2}, {"wall_order": 1}),
], ids=["stored-differs", "absent-non-default"])
def test_run_state_fingerprint_mismatch_raises_like_jax(st, tmp_path,
                                                        expect, defaults):
    jc, _, _, _ = st
    flow, (t, cd, cl, n) = _state(jc)
    path = str(tmp_path / "state.npz")
    jbench.save_run_state(
        path, jcase.Flow(**{k: jnp.asarray(v) for k, v in flow.items()}),
        jbench.ForceSeries(t=t, cd=cd, cl=cl, n_steps=n), meta=META)
    with pytest.raises(ValueError) as jerr:
        jbench.load_run_state(path, expect_meta=expect, defaults=defaults)
    with pytest.raises(ValueError) as terr:
        tbench.load_run_state(path, expect_meta=expect, defaults=defaults,
                              device="cpu")
    assert str(terr.value) == str(jerr.value)
    # an absent key at its default still matches
    tbench.load_run_state(path, expect_meta={**META, "wall_order": 1},
                          defaults={"wall_order": 1}, device="cpu")
    # a file without a fingerprint is refused when one is expected
    bare = str(tmp_path / "bare.npz")
    tbench.save_run_state(bare, tcase.load_flow(path, device="cpu"),
                          tbench.ForceSeries(t=t, cd=cd, cl=cl, n_steps=n))
    with pytest.raises(ValueError, match="no configuration fingerprint"):
        tbench.load_run_state(bare, expect_meta=META, device="cpu")


@pytest.mark.parametrize("cdt,rtol", [("float32", 1e-4),
                                      ("bfloat16", 3e-2)])
def test_sm_st128_prediction_on_128x688(cdt, rtol):
    jb = jpipe.SurrogateBundle.load(BUNDLE)
    tb = tpipe.SurrogateBundle.load(BUNDLE, device="cpu")
    jb = dataclasses.replace(jb, mdef=dataclasses.replace(
        jb.mdef, compute_dtype=cdt))
    tb = dataclasses.replace(tb, mdef=dataclasses.replace(
        tb.mdef, compute_dtype=cdt))
    jc, tc = _st_cases(0.0032)
    assert tc.grid.shape == (128, 688)
    rng = np.random.default_rng(12)
    fl = np.asarray(jc.fluid)
    u0 = np.asarray(jcase.initial_flow(jc).u)
    f = {k: (a * fl).astype(np.float32) for k, a in dict(
        u=u0 + 0.05 * rng.standard_normal(fl.shape),
        v=0.05 * rng.standard_normal(fl.shape),
        p=0.1 * rng.standard_normal(fl.shape),
        u_prev=u0, v_prev=np.zeros(fl.shape),
        p_prev=0.1 * rng.standard_normal(fl.shape)).items()}
    ref = jpipe.make_predictor(jb, stitch="lstsq")(
        jc, jnp.asarray(f["p"]), {k: jnp.asarray(v) for k, v in f.items()})
    pred = tpipe.make_predictor(tb, stitch="lstsq")
    got = pred(tc, T(f["p"]), {k: T(v) for k, v in f.items()})
    assert pred.calls == 1
    close(got - T(f["p"]), np.asarray(ref) - f["p"], rtol, "dp")


# the artifact's configuration (artifacts/validation/
# st_2d2_hybrid_d62_auto.json), on the small grid
ST_KW = dict(max_co=0.4, max_dt=5e-3, ddt="backward", sm_safeguard=0.5,
             sm_safeguard_extra=3, sm_trust=1.0)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_hybrid_auto_force_series_matches_jax(st, prec):
    """Two samples of two steps of the hybrid path: AutoBackend polish in
    `prec`, BDF2, the trust gate, the tiny bundle's lstsq warm start."""
    jc, tc, ju, _ = st
    jbundle = _tiny_bundle(block_size=32)
    t_end = 1e-3    # dt grows 1.2x a step from 2e-4: 4 steps reach it
    scales = []     # per sample: the sum of |terms| of cd and cl

    def wall_terms(flow, make_series):
        a_wall = jc.nu * jc.wall_len / jc.wall_dist
        terms = (jnp.abs(flow.p) * (jnp.abs(jc.wall_ax) + jnp.abs(jc.wall_ay))
                 + a_wall * (jnp.abs(flow.u) + jnp.abs(flow.v)))
        scales.append(float(jnp.sum(terms)) / (0.5 * ju**2 * jbench.D_CYL))

    jf, js = jbench.run_force_series(
        jc, jcase.initial_flow(jc, dt0=2e-4), t_end, ju,
        cfg=jeng.PisoConfig(momentum_smoother="pallas", **ST_KW),
        backend=jbe.AutoBackend(cycles=2, tau=0.05, precision=prec),
        sample_steps=2,
        sm_predict=jpipe.make_predictor(jbundle, stitch="lstsq"),
        on_sample=wall_terms)
    pred = tpipe.make_predictor(bundle_to_torch(jbundle), stitch="lstsq")
    tf, ts_ = tbench.run_force_series(
        tc, tcase.initial_flow(tc, dt0=2e-4), t_end, ju,
        cfg=teng.PisoConfig(momentum_smoother="kernel", **ST_KW),
        backend=tbe.AutoBackend(cycles=2, tau=0.05, precision=prec),
        sample_steps=2, sm_predict=pred)
    assert ts_.n_steps == js.n_steps == 4 and len(ts_.t) == 2
    assert pred.calls == 4
    close(ts_.t, js.t, 1e-6, "t")
    for name in ("cd", "cl"):
        err = np.abs(getattr(ts_, name) - getattr(js, name))
        assert (err <= TOL[prec] * np.asarray(scales)).all(), (name, err,
                                                               scales)
    for name in ("u", "v", "p", "phi_x", "phi_y"):
        close(getattr(tf, name), getattr(jf, name), TOL[prec], name)
    assert np.isfinite(ts_.cd).all() and np.isfinite(ts_.cl).all()


def test_ramped_force_series_lands_on_t_end(st):
    """The 2D-3 ramp from rest: the single-step tail lands the last step
    on float32(t_end) in both packages, with the same samples."""
    jc, tc, ju, _ = st
    t_end = 1.5e-3
    kw = dict(max_co=0.4, max_dt=5e-3)
    jf, js = jbench.run_force_series(
        jc, jcase.initial_flow(jc.replace(inlet_u=jc.inlet_u * 0.0),
                               dt0=2e-4), t_end, ju,
        cfg=jeng.PisoConfig(**kw), backend=jbe.MGBackend(cycles=2),
        sample_steps=3, inlet_scale=jbench.ramp_2d3)
    tf, ts_ = tbench.run_force_series(
        tc, tcase.initial_flow(dataclasses.replace(
            tc, inlet_u=tc.inlet_u * 0.0), dt0=2e-4), t_end, ju,
        cfg=teng.PisoConfig(**kw), backend=tbe.MGBackend(cycles=2),
        sample_steps=3, inlet_scale=tbench.ramp_2d3)
    assert float(tf.t) == float(np.float32(t_end)) == float(jf.t)
    assert ts_.n_steps == js.n_steps and len(ts_.t) == len(js.t)
    close(ts_.t, js.t, 1e-6, "t")
    for name in ("u", "v", "p"):
        close(getattr(tf, name), getattr(jf, name), TOL["f32"], name)
