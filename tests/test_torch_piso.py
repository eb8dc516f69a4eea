"""The tpufoam_torch hybrid PISO step against tpufoam.piso.engine, on the
CPU: `run_piso_eager` on a 64 x 256 cylinder channel with the
deltaU_deltaP surrogate warm start, whose weights are carried across from
the JAX package's structural test bundle (`_tiny_bundle(block_size=32)`)
through `params_from_numpy`.

Tolerances (max |port - JAX| / max |JAX| per field):
- f32 multigrid: 1e-4. Measured near 5e-6: the same float32 step whose
  operations round differently in the two frameworks over three steps of
  two-cycle V-cycles.
- bf16 multigrid (the main path's MGBackend(cycles=2, precision="bf16")):
  5e-2. PyTorch rounds every bf16 operation, XLA each fused group, so the
  pressure corrections differ by bf16 ulps (2^-8 = 3.9e-3) of the
  correction; measured up to 1e-2 on p after three steps.

The multigrid kernel smoothers' two paths take two steps each against the
JAX package with its Pallas smoothers in interpret mode, at the same
tolerances: the hybrid step with MGBackend(smoother="kernel-fused") in
bf16, and the pure-solver step with MGCGBackend(smoother="kernel"). The
pure solver's p alone is held at 1e-2: each side stops its CG where the
relative residual falls below 1e-6, and p is fixed only to that residual
times the operator's condition (its outlet is the one Dirichlet boundary);
measured 2.5e-3 with the plain smoother on both sides, 4.7e-4 at rtol
1e-8, while u, v and the fluxes agree to 6e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.piso import engine as jeng
from tpufoam.solvers.backends import MGBackend as JMG
from tpufoam.solvers.backends import MGCGBackend as JMGCG
from tpufoam.surrogate import blocks as jblk
from tpufoam.surrogate.pipeline import make_predictor as jax_make_predictor
from tpufoam.surrogate.pipeline import surrogate_blocks_forward as jax_fwd
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.models.mlp import ModelDef, params_from_numpy
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers import multigrid as tmg
from tpufoam_torch.solvers.backends import MGBackend as TMG
from tpufoam_torch.solvers.backends import MGCGBackend as TMGCG
from tpufoam_torch.surrogate import blocks as tblk
from tpufoam_torch.surrogate.pca import PCAModel
from tpufoam_torch.surrogate.pipeline import SurrogateBundle, make_predictor
# the JAX Pallas smoothers in interpret mode, with a count of their calls
from test_torch_solvers import jax_kernels  # noqa: F401

NY, NX = 64, 256
TOL = {"f32": 1e-4, "bf16": 5e-2}
FIELDS = ("u", "v", "p", "phi_x", "phi_y", "dt", "t")
JAX_CFG = jeng.PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                          momentum_smoother="pallas")
TORCH_CFG = teng.PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                            momentum_smoother="kernel")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def bundle_to_torch(jb) -> SurrogateBundle:
    def pca(p):
        return PCAModel(T(p.mean), T(p.components), T(p.explained_variance),
                        T(p.explained_variance_ratio))

    return SurrogateBundle(
        family=jb.family, mdef=ModelDef(**dataclasses.asdict(jb.mdef)),
        params=params_from_numpy(jax.tree.map(np.asarray, jb.params),
                                 device="cpu"),
        pca_in=pca(jb.pca_in), pca_out=pca(jb.pca_out), pc_in=jb.pc_in,
        pc_out=jb.pc_out, norm_method=jb.norm_method,
        norm={k: T(v) for k, v in jb.norm.items()},
        maxs_in=T(jb.maxs_in), maxs_out=T(jb.maxs_out),
        block_size=jb.block_size, overlap_ratio=jb.overlap_ratio)


@pytest.fixture(scope="module")
def setup():
    delta = 2.0 / NY
    kw = dict(shape_name="cylinder", length=NX * delta, height=2.0,
              obstacle_size=0.5, nu=8e-3)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=delta)
    tc = tcase.build_channel_case(channel_case_geometry(**kw), delta=delta,
                                  device="cpu")
    jb = _tiny_bundle(block_size=32)
    return jc, tc, jax_make_predictor(jb, stitch="lstsq"), \
        make_predictor(bundle_to_torch(jb), stitch="lstsq")


@pytest.fixture(scope="module", params=["f32", "bf16"])
def rollouts(request, setup):
    """Flows after steps 1 and 3 of both engines."""
    jc, tc, jpred, tpred = setup
    prec = request.param
    jbe, tbe = JMG(cycles=2, precision=prec), TMG(cycles=2, precision=prec)
    jf1 = jeng.run_piso_eager(jc, jcase.initial_flow(jc, 5e-4), 1,
                              cfg=JAX_CFG, backend=jbe, sm_predict=jpred)
    snap = {k: np.asarray(getattr(jf1, k)) for k in FIELDS}
    jf3 = jeng.run_piso_eager(jc, jf1, 2, cfg=JAX_CFG, backend=jbe,
                              sm_predict=jpred)
    tpred.calls = 0
    tf1 = teng.run_piso_eager(tc, tcase.initial_flow(tc, 5e-4), 1,
                              cfg=TORCH_CFG, backend=tbe, sm_predict=tpred)
    tf3 = teng.run_piso_eager(tc, tf1, 2, cfg=TORCH_CFG, backend=tbe,
                              sm_predict=tpred)
    return prec, {1: (snap, tf1), 3: (jf3, tf3)}, tpred.calls


@pytest.mark.parametrize("steps", [1, 3])
def test_hybrid_rollout_matches_jax(rollouts, steps):
    prec, runs, _ = rollouts
    ref, got = runs[steps]
    for name in FIELDS:
        r = np.asarray(ref[name] if isinstance(ref, dict)
                       else getattr(ref, name))
        g = getattr(got, name).numpy()
        err = float(np.abs(g - r).max())
        scale = max(float(np.abs(r).max()), 1e-30)
        assert err <= TOL[prec] * scale, \
            f"{name} after {steps} steps ({prec} MG): {err:.3e} / {scale:.3e}"
    assert bool(torch.isfinite(got.p).all())


def test_surrogate_predicts_once_per_step(rollouts):
    _, _, calls = rollouts
    assert calls == 3


def test_plain_and_kernel_smoothers_agree_on_cpu(setup):
    """On the CPU both smoothers are plain PyTorch; they sum the source in
    another order, so one f32 step agrees to float32 rounding."""
    _, tc, _, tpred = setup
    flow = tcase.initial_flow(tc, 5e-4)
    be = TMG(cycles=2)
    a = teng.piso_step(tc, flow, TORCH_CFG, be, tpred)
    b = teng.piso_step(tc, flow, dataclasses.replace(
        TORCH_CFG, momentum_smoother="plain"), be, tpred)
    for name in ("u", "v"):
        x, y = getattr(a, name), getattr(b, name)
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


def test_gate_rejects_non_finite_prediction():
    p_prev = torch.ones(3, 4)
    fluid = torch.ones(3, 4)
    fluid[0, 0] = 0.0
    bad = torch.full((3, 4), 2.0)
    bad[1, 1] = float("nan")
    out = teng._gate_sm_prediction(bad, p_prev, fluid)
    assert torch.equal(out, p_prev * fluid)
    good = torch.full((3, 4), 2.0)
    assert torch.equal(teng._gate_sm_prediction(good, p_prev, fluid),
                       good * fluid)


def test_rescue_restarts_from_previous_pressure(setup):
    """A NaN candidate fails the residual gate; the rescue applies the
    backend to the fallback pressure, as the JAX safeguard does."""
    jc, tc, _, _ = setup
    rng = np.random.default_rng(6)
    fl = np.asarray(jc.fluid)
    rau = (rng.uniform(0.5, 1.5, fl.shape) * 1e-4 * fl).astype(np.float32)
    rhs = (rng.standard_normal(fl.shape) * fl).astype(np.float32)
    prev = (rng.standard_normal(fl.shape) * fl).astype(np.float32)
    cand = np.full(fl.shape, np.nan, np.float32)
    from tpufoam.fv.pressure import pressure_coeffs as jpc
    from tpufoam_torch.fv.pressure import pressure_coeffs as tpc
    ref = jeng._rescue_if_unconverged(
        jc, jpc(jc, jnp.asarray(rau)), jnp.asarray(rhs), jnp.asarray(cand),
        jnp.asarray(prev), JMG(cycles=2), {}, JAX_CFG)
    got = teng._rescue_if_unconverged(
        tc, tpc(tc, T(rau)), T(rhs), T(cand), T(prev), TMG(cycles=2), {},
        TORCH_CFG)
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    assert err <= 1e-4 * float(np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("path", ["hybrid-kernel-fused-bf16",
                                  "mgcg-kernel-f32"])
def test_kernel_smoother_paths_match_jax(setup, jax_kernels, path):
    jc, tc, jpred, tpred = setup
    if path.startswith("hybrid"):
        prec, jbe, tbe = "bf16", JMG(cycles=2, precision="bf16",
                                     smoother="pallas-fused"), \
            TMG(cycles=2, precision="bf16", smoother="kernel-fused")
        kernels = ("smooth_residual", "corr_smooth")
        tol = {}
    else:
        prec, jbe, tbe = "f32", JMGCG(rtol=1e-6, maxiter=60,
                                      smoother="pallas"), \
            TMGCG(rtol=1e-6, maxiter=60, smoother="kernel")
        tol = {"p": 1e-2}
        jpred = tpred = None
        kernels = ("jacobi_multisweep",)
    ref = jeng.run_piso_eager(jc, jcase.initial_flow(jc, 5e-4), 2,
                              cfg=JAX_CFG, backend=jbe, sm_predict=jpred)
    assert all(jax_kernels[k] > 0 for k in kernels), jax_kernels
    before = tmg.v_cycle.cycles
    got = teng.run_piso_eager(tc, tcase.initial_flow(tc, 5e-4), 2,
                              cfg=TORCH_CFG, backend=tbe, sm_predict=tpred)
    assert tmg.v_cycle.cycles > before
    for name in FIELDS:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        err = float(np.abs(g - r).max())
        scale = max(float(np.abs(r).max()), 1e-30)
        assert err <= tol.get(name, TOL[prec]) * scale, \
            f"{path} {name}: {err:.3e}"


def _close_fields(got, ref, tol, what):
    for name in FIELDS:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        err = float(np.abs(g - r).max())
        scale = max(float(np.abs(r).max()), 1e-30)
        assert err <= tol * scale, f"{what} {name}: {err:.3e}"


def test_kernel_smoother_beyond_the_halo_runs_the_sweep_loop(setup):
    """12 momentum sweeps with the kernel smoother: more than the kernel's
    halo, so the port runs the sweep loop, as the JAX package does with
    its Pallas smoother (f32 multigrid, f32 tolerance)."""
    jc, tc, _, _ = setup
    ref = jeng.run_piso_eager(
        jc, jcase.initial_flow(jc, 5e-4), 1,
        cfg=dataclasses.replace(JAX_CFG, momentum_sweeps=12),
        backend=JMG(cycles=2))
    got = teng.run_piso_eager(
        tc, tcase.initial_flow(tc, 5e-4), 1,
        cfg=teng.PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                            momentum_sweeps=12, momentum_smoother="kernel"),
        backend=TMG(cycles=2))
    _close_fields(got, ref, TOL["f32"], "sweeps=12")


def test_assemble_scan_on_the_tiny_bundles_blocks(setup):
    """The scan stitch of the tiny bundle's block predictions on the
    64 x 256 case (32-blocks: an extra bottom row), from the same blocks
    on both sides; float32 subtractions in the same order (1e-5)."""
    jc, tc, jpred, _ = setup
    jb = _tiny_bundle(block_size=32)
    layout = jblk.build_block_layout(NY, NX, jb.block_size, jb.overlap_ratio)
    assert layout.has_extra_row
    flow = jcase.initial_flow(jc, 5e-4)
    x_grid = jnp.stack([flow.u, flow.v, jc.sdf], axis=-1)
    blocks = np.asarray(jax_fwd(jb, layout, x_grid, jc.sdf)[..., 0])
    jmb = jblk.extract_blocks(layout, jc.sdf)
    tl = tblk.build_block_layout(NY, NX, jb.block_size, jb.overlap_ratio)
    ref = np.asarray(jblk.assemble_scan(layout, jnp.asarray(blocks), jmb))
    got = tblk.assemble_scan(tl, T(blocks), tblk.extract_blocks(tl, tc.sdf))
    assert float(np.abs(got.numpy() - ref).max()) <= \
        1e-5 * float(np.abs(ref).max())


def test_hybrid_step_with_the_scan_stitch_matches_jax(setup):
    """One hybrid step with make_predictor's default stitch, the scan, on
    both sides (f32 multigrid, f32 tolerance)."""
    jc, tc, _, _ = setup
    jb = _tiny_bundle(block_size=32)
    tpred = make_predictor(bundle_to_torch(jb))
    assert tpred.stitch == "scan"
    ref = jeng.run_piso_eager(jc, jcase.initial_flow(jc, 5e-4), 1,
                              cfg=JAX_CFG, backend=JMG(cycles=2),
                              sm_predict=jax_make_predictor(jb))
    got = teng.run_piso_eager(tc, tcase.initial_flow(tc, 5e-4), 1,
                              cfg=TORCH_CFG, backend=TMG(cycles=2),
                              sm_predict=tpred)
    assert tpred.calls == 1
    _close_fields(got, ref, TOL["f32"], "scan")
