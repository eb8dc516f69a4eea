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
from tpufoam.surrogate.pipeline import make_predictor as jax_make_predictor
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.models.mlp import ModelDef, params_from_numpy
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend as TMG
from tpufoam_torch.surrogate.pca import PCAModel
from tpufoam_torch.surrogate.pipeline import SurrogateBundle, make_predictor

NY, NX = 64, 256
TOL = {"f32": 1e-4, "bf16": 5e-2}
FIELDS = ("u", "v", "p", "phi_x", "phi_y", "dt", "t")
JAX_CFG = jeng.PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3,
                          momentum_smoother="pallas")
TORCH_CFG = teng.PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3)


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
        make_predictor(bundle_to_torch(jb))


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
