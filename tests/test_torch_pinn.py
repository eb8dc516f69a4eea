"""The port's PINN (`models/pinn.py`, `pinn_main`) against the JAX
package's, on the CPU, with JAX's parameters and collocation batch
carried across.

Tolerances:
- `pinn_loss` and the stacked residuals at 200 collocation points, each
  formulation: rel 1e-5 (float32 tanh network and its autograd
  derivatives to third order, summed in another order);
- ten Adam steps from the same parameters (the port's functional Adam
  against optax.adam): the loss before each step to rel 1e-4, the
  parameters after (all leaves as one vector) to rel-L2 1e-4;
- L-BFGS (torch.optim.LBFGS with a strong-Wolfe line search against
  optax's zoom search: not the same algorithm, so held by convergence):
  after 20 steps the loss is finite and below the Adam phase's end;
- the .h5 and .pkl files load across packages exactly.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpufoam import cli as jcli
from tpufoam.models import pinn as jp
from tpufoam_torch import cli as tcli
from tpufoam_torch.models import pinn as tp

LOSS_TOL = 1e-5
ADAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _carried(form, n_colloc=200, n_bc=50):
    jcfg, tcfg = jp.PinnConfig(formulation=form), \
        tp.PinnConfig(formulation=form)
    params = jp.init_pinn(jax.random.PRNGKey(form), jcfg)
    batch = jp.make_training_points(jcfg, n_colloc=n_colloc, n_bc=n_bc,
                                    seed=form)
    tparams = tp.pinn_params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    return jcfg, tcfg, params, batch, tparams, tbatch


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("form", [1, 2, 3, 4])
def test_loss_and_residuals_match_jax(form):
    jcfg, tcfg, params, batch, tparams, tbatch = _carried(form)
    ref = float(jp.pinn_loss(params, jcfg, batch))
    got = float(tp.pinn_loss(tparams, tcfg, tbatch).detach())
    assert abs(got - ref) <= LOSS_TOL * abs(ref)
    jr = np.asarray(jax.vmap(lambda z: jp._residuals_point(params, jcfg, z))(
        batch["colloc"]))
    tr = tp._residuals(tparams, tcfg, tbatch["colloc"]).detach().numpy()
    assert tr.shape == jr.shape == (len(jr), {1: 2, 2: 5, 3: 3, 4: 6}[form])
    assert _rel(tr, jr) <= LOSS_TOL
    ju = np.asarray(jax.vmap(jp.uvp_fn(params, jcfg))(batch["walls"]))
    tu = tp.uvp_fn(tparams, tcfg)(tbatch["walls"]).detach().numpy()
    assert _rel(tu, ju) <= LOSS_TOL


@pytest.mark.parametrize("form", [1, 3])
def test_ten_adam_steps_match_optax(form, monkeypatch):
    jcfg, tcfg, params, batch, tparams, tbatch = _carried(form)
    opt = optax.adam(1e-3)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(jp.pinn_loss)(p, jcfg, batch)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    ref_losses = []
    for _ in range(10):
        params, state, loss = step(params, state)
        ref_losses.append(float(loss))

    losses = []
    loss_fn = tp.pinn_loss

    def recorded(*a):
        out = loss_fn(*a)
        losses.append(float(out.detach()))
        return out

    monkeypatch.setattr(tp, "pinn_loss", recorded)
    history = []
    got = tp._adam_phase(tparams, tcfg, tbatch, 10, 1e-3, history)
    assert history == losses[:1]
    np.testing.assert_allclose(losses, ref_losses, rtol=ADAM_TOL)
    g = np.concatenate([t.numpy().ravel() for lyr in got["layers"]
                        for t in (lyr["w"], lyr["b"])])
    r = np.concatenate([np.asarray(lyr[k]).ravel()
                        for lyr in params["layers"] for k in ("w", "b")])
    assert np.linalg.norm(g - r) <= ADAM_TOL * np.linalg.norm(r)


def test_lbfgs_improves_on_adam():
    """After 50 Adam steps on 1,000 points, L-BFGS's first trial step
    (1 / |g|_1) raises the loss: the line search must have evaluations
    left to shorten it (with torch's default max_eval it has none and
    every step stays at the Adam phase's end)."""
    cfg = tp.PinnConfig(formulation=3)
    batch = tp.make_training_points(cfg, n_colloc=1000, n_bc=50, seed=0,
                                    device="cpu")
    params, history = tp.train_pinn(cfg, batch, adam_steps=50,
                                    lbfgs_steps=20, lr=1e-3)
    # history: the loss before Adam step 0, before L-BFGS step 0 (the
    # Adam phase's end), and after the last L-BFGS step
    assert len(history) == 3 and np.isfinite(history).all()
    assert history[2] < history[1] < history[0]
    assert all(bool(torch.isfinite(t).all())
               for lyr in params["layers"] for t in lyr.values())


def test_init_and_points_on_the_cpu():
    cfg = tp.PinnConfig(formulation=2)
    p = tp.init_pinn(7, cfg, device="cpu")
    assert [tuple(l["w"].shape) for l in p["layers"]] \
        == [(2, 50)] + [(50, 50)] * 6 + [(50, 5)]
    assert all(float(l["b"].abs().max()) == 0.0 for l in p["layers"])
    q = tp.init_pinn(torch.Generator().manual_seed(7), cfg, device="cpu")
    for a, b in zip(p["layers"], q["layers"]):
        torch.testing.assert_close(a["w"], b["w"], rtol=0, atol=0)
    b = tp.make_training_points(cfg, n_colloc=400, n_bc=20, device="cpu")
    c = np.asarray(cfg.cyl_center)
    r2 = ((b["colloc"].numpy() - c) ** 2).sum(1)
    assert (r2 > cfg.cyl_radius ** 2).all() and len(r2) < 400
    assert b["walls"].shape == (60, 2) and b["u_inlet_true"].shape == (20,)


def test_h5_files_load_across_packages(tmp_path):
    jcfg, tcfg, params, batch, tparams, tbatch = _carried(4)
    hist = [3.0, 2.0]
    tp.save_pinn_h5(str(tmp_path / "t.h5"), tparams, tcfg, hist)
    jp.save_pinn_h5(str(tmp_path / "j.h5"), params, jcfg, hist)
    jparams, jc, jh = jp.load_pinn_h5(str(tmp_path / "t.h5"))
    got, tc, th = tp.load_pinn_h5(str(tmp_path / "j.h5"), device="cpu")
    assert jc == jcfg and tc == tcfg and jh == th == hist
    for a, b, c in zip(jparams["layers"], got["layers"], params["layers"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(c[k]))
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(c[k]))


def test_pkl_files_load_across_packages(tmp_path, capsys):
    args = ["--formulation", "3", "--n-colloc", "300", "--adam-steps", "2",
            "--lbfgs-steps", "0", "--platform", "cpu"]
    tcli.pinn_main(args + ["--out", str(tmp_path / "t.pkl")])
    jcli.pinn_main(args + ["--out", str(tmp_path / "j.pkl")])
    with open(tmp_path / "t.pkl", "rb") as f:
        tb = pickle.load(f)
    with open(tmp_path / "j.pkl", "rb") as f:
        jb = pickle.load(f)
    assert tb["cfg"] == jb["cfg"] and len(tb["history"]) == 2
    assert jax.tree.structure(tb["params"]) == jax.tree.structure(jb["params"])
    cfg = jp.PinnConfig(**tb["cfg"])
    batch = jp.make_training_points(cfg, n_colloc=200, n_bc=50)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    for blob in (tb, jb):
        ref = float(jp.pinn_loss(jax.tree.map(jnp.asarray, blob["params"]),
                                 cfg, batch))
        got = float(tp.pinn_loss(tp.pinn_params_from_numpy(
            blob["params"], device="cpu"), tp.PinnConfig(**blob["cfg"]),
            tbatch).detach())
        assert abs(got - ref) <= LOSS_TOL * abs(ref)
    back = tp.pinn_params_to_numpy(tp.pinn_params_from_numpy(
        jb["params"], device="cpu"))
    for a, b in zip(back["layers"], jb["params"]["layers"]):
        for k in ("w", "b"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
