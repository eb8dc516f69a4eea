"""The batched AutoBackend, HybridBackend and SurrogateBackend on a
fleet's (B, ny, nx) operands, on the CPU: against the same backends one
case at a time, and against the JAX package's vmapped backends and fleet
(`jax.vmap` of the backend; tpufoam.piso.batched.run_piso_batched_eager).

The fleet is tests/test_torch_batched.py's: three geometries at 24 x 72.
Tolerances:
- a fleet solve or lockstep against each case alone: exact (the per-case
  norms and inner products reduce each case as alone, the predictor
  predicts case by case, and everything else acts per cell), with the
  same escalation verdicts and MGCG iterations per case; a case that
  needs no escalation keeps the polished result exactly.
- the backends against JAX's vmapped ones, max |port - JAX| / max |JAX|:
  the f32 AutoBackend 1e-4 (tests/test_torch_solvers.py's float32 bound
  for two V-cycles and MGCG), SurrogateBackend 1e-6 and HybridBackend
  1e-4 with the same stand-in predictor as that file's.
- the fleets against JAX's fleet over 2 locksteps: 1e-3, as
  tests/test_torch_batched.py's hybrid fleet (a bf16 MLP, a stitch
  inverted on the host where JAX solves in-graph).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.fv.pressure import PressureCoeffs as JCoeffs
from tpufoam.piso import batched as jbat
from tpufoam.piso import engine as jeng
from tpufoam.solvers import backends as jback
from tpufoam.surrogate.pipeline import make_predictor as jax_make_predictor
from tpufoam_torch.fv import pressure as tpr
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers import backends as tback
from tpufoam_torch.solvers import multigrid as tmg
from tpufoam_torch.surrogate.pipeline import make_predictor
from test_torch_batched import (FIELDS, _pressure_problem, against_jax,
                                fleet, per_case_equal, state)
from test_torch_piso import bundle_to_torch

__all__ = ["fleet", "state"]    # the fixtures this file takes


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _polish_residuals(bco, b, x0, fluid):
    """Each case's relative residual after AutoBackend's f32 polish."""
    p1 = tmg.mg_solve(bco, b, x0, cycles=2) * fluid
    r = (b - tpr.pressure_matvec(bco, p1)) * fluid
    return (torch.linalg.vector_norm(r, dim=(-2, -1))
            / torch.linalg.vector_norm(b * fluid, dim=(-2, -1))).tolist()


def _split_tau(ratios):
    """A tau between the two largest residuals: the worst case escalates,
    the others keep their polish."""
    top = sorted(ratios)
    assert top[-1] > 2 * top[-2], ratios
    return float(np.sqrt(top[-1] * top[-2]))


class _Verdicts(tback.AutoBackend):
    """AutoBackend recording its per-case escalation verdicts."""

    def __init__(self, log, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "log", log)

    def needs_escalation(self, case, coef, rhs, p1):
        need = super().needs_escalation(case, coef, rhs, p1)
        self.log.append(need.clone())
        return need


@pytest.fixture
def mgcg_iters(monkeypatch):
    """The iterations of every escalated MGCG, per case."""
    log = []
    real = tback.mgcg_pressure

    def recorded(*a, **kw):
        res = real(*a, **kw)
        log.append(np.atleast_1d(np.asarray(res.iters)).tolist())
        return res

    monkeypatch.setattr(tback, "mgcg_pressure", recorded)
    return log


def test_auto_fleet_escalates_per_case(state, mgcg_iters):
    bc, _, cases, _ = state
    bco, sco, b, x0 = _pressure_problem(state)
    tau = _split_tau(_polish_residuals(bco, b, x0, bc.fluid))
    log = []
    auto = _Verdicts(log, tau=tau, precision="f32")
    got = auto(bc, bco, b, x0, {})
    need = log[0]
    assert need.tolist().count(True) == 1, need     # one case escalates
    batched_iters = mgcg_iters[0]
    singles, single_iters = [], []
    for k, (c, s) in enumerate(zip(cases, sco)):
        singles.append(auto(c, s, b[k], x0[k], {}))
        assert bool(log[-1]) == bool(need[k]), k
        if need[k]:
            single_iters += mgcg_iters[-1]
    per_case_equal(got, singles)
    # the escalated case takes its own iterations in the stacked MGCG
    k_esc = int(torch.nonzero(need)[0])
    assert batched_iters[k_esc] == single_iters[0]
    # a case that needs no escalation keeps the polish exactly
    p1 = tmg.mg_solve(bco, b, x0, cycles=2) * bc.fluid
    for k in range(len(cases)):
        if not need[k]:
            assert torch.equal(got[k], p1[k]), k
    assert not torch.equal(got[k_esc], p1[k_esc])


def test_auto_fleet_escalates_a_non_finite_case(state, mgcg_iters):
    bc, _, _, _ = state
    bco, _, b, x0 = _pressure_problem(state)
    x0 = x0.clone()
    x0[2, 3, 4] = float("nan")
    log = []
    _Verdicts(log, tau=1e9, precision="f32")(bc, bco, b, x0, {})
    assert log[0].tolist() == [False, False, True]
    assert len(mgcg_iters) == 1


def _jax_vmapped(backend, bc, bco, b, x0):
    """JAX's backend under jax.vmap on the same operands; the case only
    lends its fluid mask."""
    def one(fluid, c_e, c_w, c_n, c_s, c_out, diag, rhs, p_prev):
        coef = JCoeffs(c_e=c_e, c_w=c_w, c_n=c_n, c_s=c_s, c_out=c_out,
                       diag=diag)
        return backend(types.SimpleNamespace(fluid=fluid), coef, rhs,
                       p_prev, {})

    args = [bc.fluid] + [getattr(bco, f.name)
                         for f in dataclasses.fields(bco)] + [b, x0]
    return np.asarray(jax.vmap(one)(*(jnp.asarray(a.numpy())
                                      for a in args)))


def test_auto_fleet_matches_jax_vmap(state):
    bc, _, _, _ = state
    bco, _, b, x0 = _pressure_problem(state)
    tau = _split_tau(_polish_residuals(bco, b, x0, bc.fluid))
    ref = _jax_vmapped(jback.AutoBackend(tau=tau, precision="f32"),
                       bc, bco, b, x0)
    got = tback.AutoBackend(tau=tau, precision="f32")(bc, bco, b, x0, {})
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), err


def _stand_in(shape, conv):
    """tests/test_torch_solvers.py's stand-in surrogate, per case."""
    y = np.linspace(0.0, 1.0, shape[-2], dtype=np.float32)
    guess = conv(np.outer(y, np.ones(shape[-1], np.float32)))

    def predict(case, p_prev, aux):
        return 0.5 * p_prev + guess
    return predict


@pytest.mark.parametrize("kind,tol", [("surrogate", 1e-6),
                                      ("hybrid", 1e-4)])
def test_surrogate_and_hybrid_fleet_match_jax_vmap(state, kind, tol):
    bc, _, cases, _ = state
    bco, sco, b, x0 = _pressure_problem(state)
    shape = tuple(b.shape)
    jcls, tcls = ((jback.SurrogateBackend, tback.SurrogateBackend)
                  if kind == "surrogate"
                  else (jback.HybridBackend, tback.HybridBackend))
    ref = _jax_vmapped(jcls(_stand_in(shape, jnp.asarray)), bc, bco, b, x0)
    backend = tcls(_stand_in(shape, torch.as_tensor))
    got = backend(bc, bco, b, x0, {})
    err = np.abs(got.numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), err
    singles = [tcls(_stand_in(shape[1:], torch.as_tensor))(
        c, s, b[k], x0[k], {}) for k, (c, s) in enumerate(zip(cases, sco))]
    per_case_equal(got, singles)


def _backends(jpred, tpred, tau):
    return {"auto": (jback.AutoBackend(tau=tau, precision="f32"),
                     tback.AutoBackend(tau=tau, precision="f32"), True),
            "hybrid": (jback.HybridBackend(predict=jpred),
                       tback.HybridBackend(predict=tpred), False),
            "surrogate": (jback.SurrogateBackend(predict=jpred),
                          tback.SurrogateBackend(predict=tpred), False)}


@pytest.mark.parametrize("kind", ["auto", "hybrid", "surrogate"])
def test_fleet_with_backend_matches_jax(fleet, kind):
    """Two locksteps of the fleet with each backend against JAX's vmapped
    fleet. The AutoBackend fleet takes the surrogate warm start, as the
    validation runs do; its tau splits the cases of the first solve."""
    jc, tc, jf, tf = fleet
    jb = _tiny_bundle(block_size=16)
    jpred = jax_make_predictor(jb, stitch="lstsq")
    tpred = make_predictor(bundle_to_torch(jb), stitch="lstsq")
    jbe, tbe, warm = _backends(jpred, tpred, 0.05)[kind]
    ref = jbat.run_piso_batched_eager(
        jbat.stack_cases(jc), jbat.stack_flows(jf), 2,
        cfg=jeng.PisoConfig(n_correctors=1), backend=jbe,
        sm_predict=jpred if warm else None)
    got = tbat.run_piso_batched_eager(
        tbat.stack_cases(tc), tbat.stack_flows(tf), 2,
        cfg=teng.PisoConfig(n_correctors=1), backend=tbe,
        sm_predict=tpred if warm else None)
    against_jax(got, ref, 1e-3)


@pytest.mark.parametrize("kind", ["auto", "hybrid", "surrogate"])
def test_lockstep_with_backend_equals_single_steps(state, kind):
    """One lockstep of the stacked state against each case's own step,
    for each backend (the surrogate's bundle predicting case by case)."""
    bc, bf, cases, flows = state
    tpred = make_predictor(bundle_to_torch(_tiny_bundle(block_size=16)),
                           stitch="lstsq")
    log = []
    backend = {"auto": _Verdicts(log, tau=0.05, precision="f32"),
               "hybrid": tback.HybridBackend(predict=tpred),
               "surrogate": tback.SurrogateBackend(predict=tpred)}[kind]
    sm = tpred if kind == "auto" else None
    cfg = teng.PisoConfig(n_correctors=2)
    with torch.no_grad():
        got = teng.piso_step(bc, bf, cfg, backend,
                             tpred.bind(bc) if sm else None)
        n_fleet = len(log)
        refs = [teng.piso_step(c, f, cfg, backend,
                               tpred.bind(c) if sm else None)
                for c, f in zip(cases, flows)]
    for name in FIELDS:
        per_case_equal(getattr(got, name), [getattr(r, name) for r in refs])
    if kind == "auto":
        fleet_need = torch.stack(log[:n_fleet])          # (solves, B)
        single_need = torch.stack(log[n_fleet:]).reshape(
            len(cases), n_fleet).T
        assert torch.equal(fleet_need, single_need)
        # tau 0.05 splits the first solve's cases (measured: case 1 alone)
        assert fleet_need[0].any() and not fleet_need[0].all()
