"""The port's point-cloud model (`models/pointnet.py`), its training
loop (`train/pointcloud.py`), rollout (`eval/pointcloud_rollout.py`)
and `pointcloud_main` against the JAX package's, on the CPU, with flax
variables carried across, at n_pts 32 and batch 2.

Tolerances (max |port - JAX| / max |JAX|):
- eval-mode forward, the summed orthogonality penalty, masked_mse and
  pointnet_loss: rel 1e-5 (float32 convolutions, LayerNorm and sums in
  another order);
- the converter: every flax leaf consumed, every tensor filled, and the
  round trip bit for bit;
- the dataset (host numpy): equal arrays, mins and maxs;
- a 3-step rollout: rel 1e-5, the padded rows PAD in every frame;
- rasterize and rollout_report (numpy): exact.
JAX's training is not run here (minutes on the CPU; its own tests are
marked slow): the JAX-side file is written by its `pointcloud_main` with
flax's initial variables in place of trained ones.
"""

import dataclasses
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam import cli as jcli
from tpufoam.eval import pointcloud_rollout as jro
from tpufoam.models import pointnet as jpn
from tpufoam.train import pointcloud as jtr
from tpufoam.utils.hdf5_io import CH_DELTAS, write_dataset
from tpufoam_torch import cli as tcli
from tpufoam_torch.eval import pointcloud_rollout as tro
from tpufoam_torch.models import pointnet as tpn
from tpufoam_torch.train import pointcloud as ttr

N_PTS, BATCH = 32, 2
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_h5(tmp_path_factory):
    """2 sims of 4 frames, 20 to 45 cells a frame (some clouds padded to
    N_PTS, some truncated)."""
    rng = np.random.default_rng(0)
    sims = []
    for s in range(2):
        frames = []
        for t in range(4):
            n = 20 + 8 * t + 5 * s
            cells = rng.standard_normal((n, len(CH_DELTAS))).astype(
                np.float32)
            cells[:, 3] = rng.uniform(0, 4, n)
            cells[:, 4] = rng.uniform(0, 1, n)
            frames.append(dict(
                cells=cells, top=rng.uniform(0, 4, (50, 2)).astype(np.float32),
                obst=rng.uniform(1, 2, (30, 2)).astype(np.float32)))
        sims.append(frames)
    path = str(tmp_path_factory.mktemp("pc") / "tiny.h5")
    write_dataset(path, sims, channels=CH_DELTAS)
    return path


@pytest.fixture(scope="module")
def carried(tiny_h5):
    """The dataset in both packages, flax variables of the tree JAX's
    `init` produces (its structure from jax.eval_shape, the leaves drawn
    with numpy: kernels of std 1/sqrt(fan_in), biases and LayerNorm
    scales off their initial values, the T-nets' transforms off the
    identity, nonzero carried penalties) and their port state dict."""
    jds = jtr.build_pointcloud_dataset(tiny_h5, n_pts=N_PTS)
    shapes = jax.eval_shape(jpn.PointNetUNet().init, jax.random.PRNGKey(0),
                            jnp.asarray(jds.fields[:BATCH]),
                            jnp.asarray(jds.coords[:BATCH]))
    rng = np.random.default_rng(1)

    def draw(path, s):
        keys = [p.key for p in path if hasattr(p, "key")]
        if keys[-1] == "kernel":
            std = (0.01 if keys[-3:-1] in (["TNet_0", "Dense_0"],
                                           ["TNet_1", "Dense_0"])
                   else 1.0 / np.sqrt(np.prod(s.shape[:-1])))
            return rng.normal(0, std, s.shape).astype(np.float32)
        if keys[-1] == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    for t in ("TNet_0", "TNet_1"):
        k = int(np.sqrt(v["params"][t]["Dense_0"]["bias"].size))
        v["params"][t]["Dense_0"]["bias"] += np.eye(k, dtype=np.float32
                                                    ).reshape(-1)
    state = tpn.pointnet_state_from_flax(v)
    model = tpn.PointNetUNet()
    model.load_state_dict(state)
    return jds, v, state, model


# the JAX model's apply and loss, jitted (eager flax compiles op by op,
# ~14 s a shape on the CPU); the same computation
APPLY = jax.jit(jpn.PointNetUNet().apply, static_argnames="mutable")
JLOSS = jax.jit(lambda v, f, c, y: jpn.pointnet_loss(jpn.PointNetUNet(), v,
                                                     f, c, y))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_dataset_matches_jax(tiny_h5, carried):
    jds = carried[0]
    for kw in (dict(), dict(n_sims=1, first_t=1, last_t=3,
                            scale_stats=(jds.mins, jds.maxs))):
        ref = jtr.build_pointcloud_dataset(tiny_h5, n_pts=N_PTS, **kw)
        got = ttr.build_pointcloud_dataset(tiny_h5, n_pts=N_PTS, **kw)
        for k in ("fields", "targets", "coords", "mins", "maxs", "sim_ids"):
            a, b = getattr(got, k), getattr(ref, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b)
    assert jds.fields.shape == (6, N_PTS, 3)
    assert (jds.fields[0, 20:] == tpn.PAD).all()


def test_forward_penalty_and_loss_match_flax(carried):
    jds, v, state, model = carried
    f, c, y = (jds.fields[:BATCH], jds.coords[:BATCH], jds.targets[:BATCH])
    ref, aux = APPLY(v, jnp.asarray(f), jnp.asarray(c), mutable=("losses",))
    ref = np.asarray(ref)
    ref_ortho = sum(float(jnp.sum(x)) for x in jax.tree.leaves(aux))
    with torch.no_grad():
        out, ortho = model(torch.tensor(f), torch.tensor(c))
    assert out.shape == (BATCH, N_PTS, 3)
    assert _rel(out.numpy(), ref) <= TOL
    assert abs(float(ortho) - ref_ortho) <= TOL * abs(ref_ortho)
    carried_ortho = sum(float(v["losses"][t]["ortho"][0])
                        for t in ("TNet_0", "TNet_1"))
    assert abs(ref_ortho - carried_ortho) > 1e-3
    mse = float(tpn.masked_mse(out, torch.tensor(y)))
    ref_mse = float(jpn.masked_mse(jnp.asarray(ref), jnp.asarray(y)))
    assert abs(mse - ref_mse) <= TOL * abs(ref_mse)
    ref_loss = float(JLOSS(v, jnp.asarray(f), jnp.asarray(c),
                           jnp.asarray(y)))
    for params in (state, None):
        with torch.no_grad():
            loss = float(tpn.pointnet_loss(model, params, torch.tensor(f),
                                           torch.tensor(c), torch.tensor(y)))
        assert abs(loss - ref_loss) <= TOL * abs(ref_loss)


def test_converter_is_exact_and_leaves_nothing_over(carried):
    _, v, state, model = carried
    back = tpn.pointnet_state_to_flax(state)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        assert np.asarray(a).dtype == np.asarray(b).dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert sorted(state) == sorted(model.state_dict())
    assert sum(t.numel() for t in state.values()) \
        == sum(np.asarray(x).size for x in jax.tree.leaves(v))
    extra = jax.tree.map(lambda a: a, v)
    extra["params"]["Conv_9"] = {"kernel": np.zeros((1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="no port tensor"):
        tpn.pointnet_state_from_flax(extra)
    short = jax.tree.map(lambda a: a, v)
    del short["params"]["DenseBN_1"]
    with pytest.raises(KeyError):
        tpn.pointnet_state_from_flax(short)


def test_init_is_flax_like():
    m = tpn.PointNetUNet(generator=torch.Generator().manual_seed(0))
    for t in m.tnet:
        assert float(t.dense.weight.detach().abs().max()) == 0.0
        assert torch.equal(t.dense.bias, torch.eye(t.num_features).reshape(-1))
        assert float(t.carried_ortho.detach()) == 0.0
    w = m.inception[12].convs[0].weight.detach()      # fan_in 128
    assert 0.7 < float(w.std()) * np.sqrt(128) < 1.3
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / 128) / 0.8796 + 1e-6
    assert all(float(mod.bias.detach().abs().max()) == 0.0
               for mod in m.modules()
               if isinstance(mod, torch.nn.Conv1d))
    m2 = tpn.PointNetUNet(generator=torch.Generator().manual_seed(0))
    for a, b in zip(m.state_dict().values(), m2.state_dict().values()):
        assert torch.equal(a, b)


def test_dropout_acts_only_in_training(carried):
    jds, _, state, model = carried
    f, c = torch.tensor(jds.fields[:BATCH]), torch.tensor(jds.coords[:BATCH])
    with torch.no_grad():
        a = model(f, c)[0]
        b = model(f, c, train=True, rng=torch.Generator().manual_seed(1))[0]
        b2 = model(f, c, train=True, rng=torch.Generator().manual_seed(1))[0]
    assert not torch.equal(a, b) and torch.equal(b, b2)
    with pytest.raises(ValueError):
        model(f, c, train=True)


def test_rollout_matches_jax(carried):
    jds, v, state, model = carried
    f0, c = jds.fields[3], jds.coords[3]
    ref = jro.rollout(types.SimpleNamespace(apply=APPLY), v, f0, c, 3)
    got = tro.rollout(model, None, f0, c, 3)
    assert got.shape == ref.shape == (3, N_PTS, 3)
    assert _rel(got, ref) <= TOL
    pad = c[:, 0] == tpn.PAD
    assert pad.any() and (got[:, pad] == tpn.PAD).all()
    np.testing.assert_array_equal(tro.rollout(model, state, f0, c, 3), got)
    true = jds.targets[3:6]
    for shape in ((8, 16), (5, 7)):
        np.testing.assert_array_equal(
            tro.rasterize(c, got[1][:, 2], shape),
            jro.rasterize(c, got[1][:, 2], shape))
    rt, rj = tro.rollout_report(got, true), jro.rollout_report(got, true)
    assert list(rt) == list(rj) == ["Ux", "Uy", "p"]
    for k in rj:
        for a, b in zip(rt[k], rj[k]):
            assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_training_lowers_the_loss(carried):
    jds = carried[0]
    model, params, history = ttr.train_pointcloud(jds, epochs=4,
                                                  batch_size=BATCH, lr=1e-3,
                                                  device="cpu")
    assert len(history) == 4 and np.isfinite(history).all()
    assert history[-1] < history[0]
    assert sorted(params) == sorted(model.state_dict())
    for k, t in model.state_dict().items():
        assert torch.equal(t, params[k])


@pytest.fixture(scope="module")
def jax_files(tiny_h5, carried, tmp_path_factory):
    """JAX's pointcloud_main train files (.pkl, .h5) holding the carried
    flax variables in place of trained ones."""
    d = tmp_path_factory.mktemp("jaxpc")
    v = carried[1]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jtr, "train_pointcloud",
                  lambda ds, **kw: (jpn.PointNetUNet(), v, [1.0]))
        for ext in ("pkl", "h5"):
            jcli.pointcloud_main(["train", "--dataset", tiny_h5, "--n-pts",
                                  str(N_PTS), "--out", str(d / f"j.{ext}"),
                                  "--platform", "cpu"])
    return d


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("ext", ["pkl", "h5"])
def test_cli_files_load_across_packages(ext, tiny_h5, carried, jax_files,
                                        tmp_path, capsys):
    ro = ["rollout", "--dataset", tiny_h5, "--sim", "1", "--steps", "2"]
    capsys.readouterr()
    jfile = str(jax_files / f"j.{ext}")
    jcli.pointcloud_main(ro + ["--params", jfile, "--platform", "cpu"])
    ref = _lines(capsys)
    tcli.pointcloud_main(ro + ["--params", jfile, "--platform", "cpu"])
    got = _lines(capsys)
    assert got[-1] == ref[-1] or json_close(got[-1], ref[-1])
    assert [s.split(" RMSE")[0] for s in got[:-1]] \
        == [s.split(" RMSE")[0] for s in ref[:-1]]

    tfile = str(tmp_path / f"t.{ext}")
    tcli.pointcloud_main(["train", "--dataset", tiny_h5, "--n-pts",
                          str(N_PTS), "--epochs", "2", "--out", tfile,
                          "--platform", "cpu"])
    capsys.readouterr()
    jcli.pointcloud_main(ro + ["--params", tfile, "--platform", "cpu"])
    ref = _lines(capsys)
    tcli.pointcloud_main(ro + ["--params", tfile, "--platform", "cpu"])
    got = _lines(capsys)
    assert json_close(got[-1], ref[-1])
    if ext == "pkl":
        with open(tfile, "rb") as f:
            blob = pickle.load(f)
        assert blob["n_pts"] == N_PTS and len(blob["history"]) == 2
        assert jax.tree.structure(blob["params"]) \
            == jax.tree.structure(carried[1])


def json_close(a, b):
    import json
    a, b = json.loads(a), json.loads(b)
    return a["steps"] == b["steps"] and abs(
        a["p_rmse_last"] - b["p_rmse_last"]) <= 1e-4 * abs(b["p_rmse_last"])
