"""The surrogate's training path in the PyTorch port against the JAX
package on the CPU: the PCA fits (`fit_pca_exact`, `StreamingPCA`,
`n_components_for_variance`), `init_model` and dropout, the trainer's
pieces (`normalize_pc_space`, `encode_dataset`,
`relative_change_early_stop`), Adam through `make_sharded_train_step`
(and `mlp_partition_specs`), checkpoints and resume, `SurrogateBundle.
save` in the JAX package's format, and a tiny `train_surrogate` in both
packages whose bundles cross-load.

Inputs are seeded with numpy. Tolerances:
- exact PCA: mean and variances 1e-5 of their largest, components 1e-4
  after sign alignment (float32 SVDs by two libraries);
- streaming PCA, on data with a clear spectral gap: explained-variance
  ratios within 1e-4, principal angles of the fitted subspace below 1e-3
  rad (the two packages draw different random starts, so only the
  subspace can agree);
- PCA codes: 1e-5 of their largest; the normalizations: 1e-6;
- three Adam steps of the train step, f32 compute: 1e-5 relative on the
  loss and on the parameters (max |diff| / max |JAX| per leaf). bf16
  compute: 1e-3 on the loss and 1e-2 on the parameters' relative L2
  norm over the whole tree (measured over four seeds: loss 2.3e-4,
  parameters 2.5e-3 against JAX, 1.5e-3 for the 2 x 2 mesh against the
  1 x 1 step). The bf16 products round in two libraries' orders, and
  Adam's first steps move each element by about +-lr whatever the size
  of its gradient, so a gradient near 0 whose sign flips moves its
  element by 2 lr: the biases, which start at 0, then differ by up to
  0.7 of their largest, and no per-leaf bound holds. The data-parallel
  2 x 2 mesh against the 1 x 1 step: the same bounds;
- dropout: keep rate within 0.01 of 1 - rate, mean within 1%;
- resume: bit for bit;
- predictions of each bundle by the two packages, the predicted change:
  1e-4 of its largest with float32 compute, PRED_TOL (2e-2,
  tests/test_torch_surrogate.py) with the bundles' bf16 compute.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.linalg
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.models import mlp as jmlp
from tpufoam.parallel import mesh as jmesh
from tpufoam.surrogate import pca as jpca
from tpufoam.surrogate import pipeline as jpipe
from tpufoam.train import dataset as jds
from tpufoam.train import trainer as jtr
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.models import mlp as tmlp
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.piso.engine import PisoConfig
from tpufoam_torch.surrogate import pca as tpca
from tpufoam_torch.surrogate import pipeline as tpipe
from tpufoam_torch.train import dataset as tds
from tpufoam_torch.train import trainer as ttr

EXACT_TOL, EXACT_COMP_TOL = 1e-5, 1e-4
STREAM_EVR_TOL, STREAM_ANGLE_TOL = 1e-4, 1e-3
CODE_TOL, NORM_TOL = 1e-5, 1e-6
TRAIN_STEP_F32_TOL = {"loss": 1e-5, "params": 1e-5}
TRAIN_STEP_BF16_TOL = {"loss": 1e-3, "params_l2": 1e-2}
PRED_F32_TOL, PRED_TOL = 1e-4, 2e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def gapped(n=2048, d=256, k=16, seed=0):
    """Low-rank data with a clear spectral gap after k, a nonzero mean."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((k, d))
    z = rng.standard_normal((n, k)) * np.linspace(10, 1, k)
    x = z @ basis + 0.01 * rng.standard_normal((n, d))
    return (x + rng.standard_normal(d)).astype(np.float32)


def max_angle(a, b):
    """The largest principal angle between the row spaces of a and b."""
    return float(np.max(scipy.linalg.subspace_angles(
        np.asarray(a, np.float64).T, np.asarray(b, np.float64).T)))


# ---- PCA ---------------------------------------------------------------------


def test_fit_pca_exact_matches_jax():
    x = gapped(n=300, d=64, k=12, seed=1)
    ref = jpca.fit_pca_exact(x, 12)
    got = tpca.fit_pca_exact(x, 12, device="cpu")
    for name in ("mean", "explained_variance", "explained_variance_ratio"):
        assert rel(getattr(got, name), getattr(ref, name)) <= EXACT_TOL, name
    gc, rc = got.components.numpy(), np.asarray(ref.components)
    signs = np.sign(np.sum(gc * rc, axis=1, keepdims=True))
    assert float(np.abs(gc * signs - rc).max()) <= EXACT_COMP_TOL
    # a tensor is fitted on its device, as an array is
    again = tpca.fit_pca_exact(torch.as_tensor(x), 12)
    assert torch.equal(again.components, got.components)


SPECTRA = {
    "crosses-at-4": [0.5, 0.3, 0.1, 0.06, 0.04],
    "first-alone": [0.97, 0.02, 0.01],
    "never": [0.2, 0.2, 0.2, 0.2, 0.1],
    "beyond-max": [0.1] * 9 + [0.05, 0.05],
    "at-max": [0.3, 0.3, 0.3, 0.06, 0.04],
}


@pytest.mark.parametrize("name", sorted(SPECTRA))
@pytest.mark.parametrize("max_num_pc", [4, 16])
def test_n_components_for_variance_matches_jax(name, max_num_pc):
    evr = np.asarray(SPECTRA[name], np.float32)
    z = np.zeros_like(evr)
    ref = jpca.PCAModel(mean=z, components=z[:, None], explained_variance=z,
                        explained_variance_ratio=jnp.asarray(evr))
    got = tpca.PCAModel(mean=T(z), components=T(z[:, None]),
                        explained_variance=T(z),
                        explained_variance_ratio=T(evr))
    for thr in (0.5, 0.9, 0.95):
        assert got.n_components_for_variance(thr, max_num_pc) \
            == ref.n_components_for_variance(thr, max_num_pc)


def test_streaming_pca_matches_jax_and_exact():
    x = gapped()
    k = 16

    def chunks():
        for i in range(0, len(x), 512):
            yield x[i:i + 512]

    ref = jpca.StreamingPCA(n_components=k, oversample=32,
                            power_iters=5).fit(chunks)
    got = tpca.StreamingPCA(n_components=k, oversample=32,
                            power_iters=5).fit(chunks, device="cpu")
    exact = tpca.fit_pca_exact(x, k, device="cpu")
    assert got.components.shape == (k, x.shape[1])
    assert rel(got.mean, ref.mean) <= EXACT_TOL
    for other in (np.asarray(ref.explained_variance_ratio),
                  exact.explained_variance_ratio.numpy()):
        assert float(np.abs(got.explained_variance_ratio.numpy()
                            - other).max()) <= STREAM_EVR_TOL
    assert max_angle(got.components, ref.components) <= STREAM_ANGLE_TOL
    assert max_angle(got.components, exact.components) <= STREAM_ANGLE_TOL
    # tensor chunks give the array chunks' fit
    tens = [torch.as_tensor(c) for c in chunks()]
    again = tpca.StreamingPCA(n_components=k, oversample=32,
                              power_iters=5).fit(lambda: iter(tens))
    assert torch.equal(again.components, got.components)
    with pytest.raises(ValueError, match="no data"):
        tpca.StreamingPCA(4).fit(lambda: iter([]), device="cpu")


def test_full_f32_restores_the_tf32_flag():
    was = torch.backends.cuda.matmul.allow_tf32
    with tpca.full_f32():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == was


# ---- the model: init and dropout ---------------------------------------------


@pytest.mark.parametrize("arch", ["MLP_small", "MLP_attention", "conv1D"])
def test_init_model_has_jax_tree_and_bounds(arch):
    jdef = jmlp.ModelDef.from_arch(arch, in_dim=12, out_dim=7)
    tdef = tmlp.ModelDef.from_arch(arch, in_dim=12, out_dim=7)
    ref = jmlp.init_model(jax.random.PRNGKey(0), jdef)
    got = tmlp.init_model(0, tdef, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = tmlp.tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, r), g in zip(jl, tl):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32, path
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or name.endswith("['bo']"):
            assert not g.any(), name
        elif name.endswith("['g']"):
            assert bool((g == 1).all()), name
        else:   # glorot-uniform: within the JAX package's limit
            lim = float(np.abs(np.asarray(r)).max())
            assert float(g.abs().max()) <= lim * 1.05 + 1e-6, name
    assert tmlp.count_params(got) == jmlp.count_params(ref)
    assert tmlp.treedef_str(got) == str(jax.tree_util.tree_structure(ref))
    same = tmlp.init_model(torch.Generator().manual_seed(0), tdef,
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tl, tmlp.tree_leaves(same)))


def test_dropout_keeps_its_rate_and_mean():
    rate, width = 0.3, 2048
    mdef = tmlp.ModelDef(kind="dense", widths=(width,), in_dim=1,
                         out_dim=width, dropout_rate=rate,
                         compute_dtype="float32")
    params = {"layers": [{"w": torch.ones(1, width),
                          "b": torch.zeros(width)}],
              "head": {"w": torch.eye(width), "b": torch.zeros(width)}}
    x = torch.ones(64, 1)
    out = tmlp.apply_model(params, mdef, x, dropout_key=7)
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) <= 0.01
    assert bool(torch.allclose(out[kept], torch.tensor(1 / (1 - rate))))
    assert abs(float(out.mean()) - 1.0) <= 0.01
    # the same seed, the same mask; another seed, another mask; no key,
    # no dropout (serving)
    assert torch.equal(out, tmlp.apply_model(params, mdef, x, dropout_key=7))
    assert not torch.equal(out, tmlp.apply_model(params, mdef, x,
                                                 dropout_key=8))
    assert torch.equal(tmlp.apply_model(params, mdef, x), torch.ones(64,
                                                                     width))
    # a generator draws a fresh mask per layer and per call
    two = dataclasses.replace(mdef, widths=(width, width))
    params2 = {"layers": [params["layers"][0],
                          {"w": torch.eye(width), "b": torch.zeros(width)}],
               "head": params["head"]}
    gen = torch.Generator().manual_seed(3)
    a = tmlp.apply_model(params2, two, x, dropout_key=gen)
    b = tmlp.apply_model(params2, two, x, dropout_key=gen)
    assert not torch.equal(a, b)
    keep2 = (1 - rate) ** 2
    assert abs(float((a != 0).float().mean()) - keep2) <= 0.01


# ---- the trainer's pieces ----------------------------------------------------


@pytest.mark.parametrize("method", ["std", "min_max", "max_abs"])
def test_normalize_pc_space_matches_jax(method):
    rng = np.random.default_rng(2)
    z_in = (rng.standard_normal((50, 6)) * 3 + 1).astype(np.float32)
    z_out = (rng.standard_normal((50, 9)) * 0.2).astype(np.float32)
    gx, gy, gn = ttr.normalize_pc_space(z_in, z_out, method)
    rx, ry, rn = jtr.normalize_pc_space(z_in, z_out, method)
    assert rel(gx, rx) <= NORM_TOL and rel(gy, ry) <= NORM_TOL
    assert sorted(gn) == sorted(rn)
    for k in rn:
        assert rel(gn[k], rn[k]) <= NORM_TOL, k
    with pytest.raises(ValueError):
        ttr.normalize_pc_space(z_in, z_out, "nope")


def test_encode_dataset_matches_jax():
    rng = np.random.default_rng(3)
    n, b = 70, 8
    ds = tds.BlockDataset(
        x=rng.standard_normal((n, b, b, 3)).astype(np.float32),
        y=rng.standard_normal((n, b, b, 1)).astype(np.float32),
        mask=np.ones((n, b, b), np.float32),
        maxs_in=np.array([2.0, 3.0, 1.5], np.float32),
        maxs_out=np.array([4.0], np.float32))
    jd = jds.BlockDataset(**dataclasses.asdict(ds))
    j_in = jpca.fit_pca_exact(jd.flat_normalized(slice(None), side=0), 10)
    j_out = jpca.fit_pca_exact(jd.flat_normalized(slice(None), side=1), 6)

    def port(p):
        return tpca.PCAModel(*(T(getattr(p, f.name))
                               for f in dataclasses.fields(p)))

    ref = jtr.encode_dataset(jd, j_in, j_out, 10, 5, chunk=32)
    got = ttr.encode_dataset(ds, port(j_in), port(j_out), 10, 5, chunk=32)
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray) and rel(g, r) <= CODE_TOL


@pytest.mark.parametrize("losses,patience,delta", [
    ([5.0, 4.0, 3.0], 2, 1e-4), ([1.0] * 8, 3, 1e-4),
    ([4, 3, 2, 1, 1, 1, 1, 1, 1], 3, 1e-2), (list(range(20, 0, -1)), 4, 0.5),
    ([2.0, 2.0, 1.0, 1.0], 2, 1e-3)])
def test_relative_change_early_stop_matches_jax(losses, patience, delta):
    assert ttr.relative_change_early_stop(losses, patience, delta) \
        == jtr.relative_change_early_stop(losses, patience, delta)


# ---- Adam and the train step over a mesh --------------------------------------


def test_mlp_partition_specs_match_jax():
    for arch in ("MLP_small", "MLP_big", "MLP_attention", "conv1D"):
        jdef = jmlp.ModelDef.from_arch(arch, in_dim=8, out_dim=4)
        ref = jmesh.mlp_partition_specs(jmlp.init_model(
            jax.random.PRNGKey(0), jdef))
        got = tmesh.mlp_partition_specs(tmlp.init_model(
            0, tmlp.ModelDef.from_arch(arch, in_dim=8, out_dim=4),
            device="cpu"))
        ref = jax.tree.map(tuple, ref,
                           is_leaf=lambda s: isinstance(s, jax.sharding.
                                                        PartitionSpec))
        assert got == ref, arch


def _step_problem(cdt, seed=0):
    jdef = jmlp.ModelDef.from_arch("MLP_small", in_dim=32, out_dim=16,
                                   compute_dtype=cdt)
    tdef = tmlp.ModelDef.from_arch("MLP_small", in_dim=32, out_dim=16,
                                   compute_dtype=cdt)
    params = jmlp.init_model(jax.random.PRNGKey(seed), jdef)
    rng = np.random.default_rng(seed)
    batches = [(rng.standard_normal((64, 32)).astype(np.float32),
                rng.standard_normal((64, 16)).astype(np.float32))
               for _ in range(3)]
    return jdef, tdef, params, batches


def rel_l2(got, ref):
    """||got - ref|| / ||ref|| over the leaves of two parameter trees."""
    num = den = 0.0
    for g, r in zip(got, ref):
        g = np.asarray(g, np.float64)
        r = np.asarray(r, np.float64)
        num += float(((g - r) ** 2).sum())
        den += float((r ** 2).sum())
    return (num / den) ** 0.5


def _params_within(got, ref, tol):
    got = [g.numpy() for g in got]
    if "params" in tol:
        return max(rel(g, r) for g, r in zip(got, ref)) <= tol["params"]
    return rel_l2(got, ref) <= tol["params_l2"]


def _port_steps(mesh, tdef, params, batches, lr=1e-3):
    """Three steps; the parameters and Adam's state come back whole
    (the step keeps them placed on the mesh)."""
    opt = ttr.Adam(lr)
    step, shard = tmesh.make_sharded_train_step(mesh, tdef, opt)
    p = tmlp.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    s = opt.init(p)
    losses = []
    for xb, yb in batches:
        p, s, xs, ys = shard(p, s, T(xb), T(yb))
        p, s, loss = step(p, s, xs, ys)
        losses.append(float(loss))
    return tmesh.unshard_params(p), tmesh.unshard_params(s), losses


@pytest.mark.parametrize("cdt,tol", [("float32", TRAIN_STEP_F32_TOL),
                                     ("bfloat16", TRAIN_STEP_BF16_TOL)])
def test_train_step_matches_jax(cdt, tol):
    """Three Adam steps on a one-device mesh in both packages, from the
    same parameters and batches; then the port's 2 x 2 mesh (two batch
    slices, the dense weights cut over 'model') against its 1 x 1 step
    (tests/test_torch_tensor_parallel.py holds the meshes to JAX's)."""
    jdef, tdef, params, batches = _step_problem(cdt)
    opt = optax.adam(1e-3)
    jm = jmesh.device_mesh(1)
    jstep, jshard = jmesh.make_sharded_train_step(jm, jdef, opt)
    jp, js = params, opt.init(params)
    jlosses = []
    with jm:
        for xb, yb in batches:
            jp, js, xs, ys = jshard(jp, js, jnp.asarray(xb), jnp.asarray(yb))
            jp, js, loss = jstep(jp, js, xs, ys)
            jlosses.append(float(loss))

    mesh1 = tmesh.device_mesh(1, devices=["cpu"])
    p1, s1, l1 = _port_steps(mesh1, tdef, params, batches)
    assert s1["count"] == 3
    assert max(abs(a - b) / abs(b) for a, b in zip(l1, jlosses)) \
        <= tol["loss"]
    assert _params_within(tmlp.tree_leaves(p1),
                          [np.asarray(r) for r in jax.tree.leaves(jp)], tol)
    if cdt == "float32":
        for name in ("mu", "nu"):
            for g, r in zip(tmlp.tree_leaves(s1[name]),
                            jax.tree.leaves(getattr(js[0], name))):
                assert rel(g, r) <= 1e-5, name

    mesh4 = tmesh.device_mesh(4, devices=["cpu"] * 4)
    p4, _, l4 = _port_steps(mesh4, tdef, params, batches)
    assert max(abs(a - b) / abs(b) for a, b in zip(l4, l1)) <= tol["loss"]
    assert _params_within(tmlp.tree_leaves(p4),
                          [g.numpy() for g in tmlp.tree_leaves(p1)], tol)
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_sharded_train_step(mesh4, tdef, ttr.Adam(1e-3))[1](
            p1, s1, torch.zeros(63, 32), torch.zeros(63, 16))


def test_adam_matches_optax_on_a_tree():
    rng = np.random.default_rng(4)
    tree = {"a": [rng.standard_normal((3, 4)).astype(np.float32)],
            "b": rng.standard_normal(5).astype(np.float32)}
    opt = optax.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-9)
    topt = ttr.Adam(3e-3, b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-9)
    jp, js = tree, opt.init(tree)
    tp = tmlp.params_from_numpy(tree, "cpu")
    ts = topt.init(tp)
    for i in range(4):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * 10.0**-i).astype(np.float32), tree)
        u, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = topt.update(tmlp.params_from_numpy(g, "cpu"), ts, tp)
        tp = ttr.apply_updates(tp, tu)
    for a, b in zip(tmlp.tree_leaves(tp), jax.tree.leaves(jp)):
        assert rel(a, b) <= 1e-6


# ---- checkpoints and the whole trainer ------------------------------------------


def _random_ds(n=256, b=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, b, b, 3)).astype(np.float32)
    y = (x[..., :1] * 0.5 + 0.05 * rng.standard_normal((n, b, b, 1))
         ).astype(np.float32)
    return tds.BlockDataset(x=x, y=y, mask=np.ones((n, b, b), np.float32),
                            maxs_in=np.abs(x).max((0, 1, 2)),
                            maxs_out=np.abs(y).max((0, 1, 2)))


@pytest.mark.parametrize("dropout,device_cache", [(None, False),
                                                  (0.1, True)])
def test_resumed_training_equals_uninterrupted(tmp_path, dropout,
                                               device_cache):
    ds = _random_ds()
    cfg = ttr.TrainConfig(arch="MLP_small", max_epochs=6, batch_size=64,
                          max_num_pc=12, best_after_epoch=1, lr=1e-3,
                          early_stop_patience=1000, dropout=dropout,
                          pca_device_cache=device_cache,
                          loss_weighting="variance")
    _, full = ttr.train_surrogate(ds, "deltaU_deltaP", cfg, device="cpu")
    ck = str(tmp_path / "ck.pt")
    ttr.train_surrogate(ds, "deltaU_deltaP",
                        dataclasses.replace(cfg, max_epochs=3),
                        checkpoint_path=ck, checkpoint_every=3,
                        device="cpu")
    saved = ttr.load_checkpoint(ck)
    assert saved["epoch"] == 2 and len(saved["history"]) == 3
    bundle, res = ttr.train_surrogate(ds, "deltaU_deltaP", cfg,
                                      checkpoint_path=ck, checkpoint_every=3,
                                      device="cpu")
    assert res.history == full.history
    assert res.val_history == full.val_history
    assert (res.best_val, res.best_epoch) == (full.best_val, full.best_epoch)
    for a, b in zip(tmlp.tree_leaves(res.params),
                    tmlp.tree_leaves(full.params)):
        assert torch.equal(a, b)
    assert bundle.params is res.params


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A dataset from the port's own rollout (32 x 128, 16-blocks), the
    same dataset trained by both packages for 20 epochs, and each
    bundle saved."""
    from tpufoam_torch.piso.engine import run_piso_eager
    torch.set_num_threads(1)
    delta = 2.0 / 32
    kw = dict(shape_name="cylinder", length=8.0, height=2.0,
              obstacle_size=0.5, nu=8e-3)
    tc = tcase.build_channel_case(channel_case_geometry(**kw), delta=delta,
                                  device="cpu")
    jc = jcase.build_channel_case(jax_geom(**kw), delta=delta)
    cfg = PisoConfig(max_co=0.5, max_dt=5e-3)
    flow = run_piso_eager(tc, tcase.initial_flow(tc, 1e-3), 10, cfg=cfg)
    frames = tds.frames_from_rollout(tc, flow, 8, 2, cfg=cfg)
    ds = tds.build_block_dataset(tc, frames, n_samples_per_frame=60,
                                 block_size=16, seed=0)
    kw = dict(arch="MLP_small", lr=1e-3, batch_size=128, max_epochs=20,
              max_num_pc=32, best_after_epoch=2)
    tb, ts = ttr.train_surrogate(ds, "deltaU_deltaP",
                                 ttr.TrainConfig(**kw), device="cpu")
    jb, js = jtr.train_surrogate(jds.BlockDataset(**dataclasses.asdict(ds)),
                                 "deltaU_deltaP", jtr.TrainConfig(**kw))
    root = tmp_path_factory.mktemp("bundles")
    tb.trimmed().save(str(root / "port"))
    jb.trimmed().save(str(root / "jax"))
    return dict(jc=jc, tc=tc, frames=frames, tb=tb, ts=ts, jb=jb, js=js,
                root=root)


def test_both_packages_train_the_same_dataset(tiny_run):
    ts, js, tb, jb = (tiny_run[k] for k in ("ts", "js", "tb", "jb"))
    for s in (ts, js):
        assert len(s.history) == 20 and np.isfinite(s.best_val)
        assert s.history[-1] < 0.5 * s.history[0]
    assert (tb.pc_in, tb.pc_out) == (jb.pc_in, jb.pc_out)
    assert tb.mdef == jmlp.ModelDef(**dataclasses.asdict(jb.mdef)) or \
        dataclasses.asdict(tb.mdef) == dataclasses.asdict(jb.mdef)


def test_saved_bundles_have_the_jax_format(tiny_run):
    root = tiny_run["root"]
    for name in ("port", "jax"):
        assert sorted(os.listdir(root / name)) == [
            "arrays.npz", "manifest.json", "params_tree.json"]
    for f in ("manifest.json", "params_tree.json"):
        with open(root / "port" / f) as a, open(root / "jax" / f) as b:
            assert json.load(a) == json.load(b), f
    with np.load(root / "port" / "arrays.npz") as a, \
            np.load(root / "jax" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    # the production bundle's keys, for the same model definition
    with np.load(os.path.join(os.path.dirname(__file__), "..", "artifacts",
                              "sm_ref512", "arrays.npz")) as ref, \
            np.load(root / "port" / "arrays.npz") as a:
        assert sorted(ref.files) == sorted(a.files)


@pytest.mark.parametrize("kind", ["attention", "conv1d"])
def test_save_writes_every_kind_in_jax_format(tmp_path, kind):
    """A bundle of each model kind: the port's files load in the JAX
    package with the same leaves, and its params_tree.json is JAX's."""
    arch = {"attention": "MLP_attention", "conv1d": "conv1D"}[kind]
    jdef = jmlp.ModelDef.from_arch(arch, in_dim=6, out_dim=5)
    from __graft_entry__ import _tiny_bundle
    jb = dataclasses.replace(_tiny_bundle(block_size=8), mdef=jdef,
                             params=jmlp.init_model(jax.random.PRNGKey(2),
                                                    jdef), pc_in=6, pc_out=5)
    jb.save(str(tmp_path / "jax"))
    tb = tpipe.SurrogateBundle.load(str(tmp_path / "jax"), device="cpu")
    tb.save(str(tmp_path / "port"))
    back = jpipe.SurrogateBundle.load(str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jb.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for f in ("manifest.json", "params_tree.json"):
        with open(tmp_path / "port" / f) as a, open(tmp_path / "jax" / f) as b:
            assert json.load(a) == json.load(b), f


def _predicted_change(pkg, bundle, case, frame, f32):
    if f32:
        bundle = dataclasses.replace(bundle, mdef=dataclasses.replace(
            bundle.mdef, compute_dtype="float32"))
    if pkg == "jax":
        pred = jpipe.make_predictor(bundle, stitch="lstsq")
        aux = {k: jnp.asarray(v) for k, v in frame.items()}
        return np.asarray(pred(case, aux["p_prev"], aux) - aux["p_prev"])
    pred = tpipe.make_predictor(bundle, stitch="lstsq")
    return (pred(case, frame["p_prev"], frame) - frame["p_prev"]).numpy()


@pytest.mark.parametrize("f32,tol", [(True, PRED_F32_TOL), (False, PRED_TOL)])
def test_bundles_cross_load_and_predict_alike(tiny_run, f32, tol):
    """Each package's bundle, loaded by both packages: the two predictors
    predict the same pressure change."""
    jc, tc, root = tiny_run["jc"], tiny_run["tc"], tiny_run["root"]
    frame = tiny_run["frames"][-1]
    np_frame = {k: v.numpy() for k, v in frame.items()}
    for name in ("port", "jax"):
        jb = jpipe.SurrogateBundle.load(str(root / name))
        tb = tpipe.SurrogateBundle.load(str(root / name), device="cpu")
        assert (tb.pc_in, tb.pc_out) == (jb.pc_in, jb.pc_out)
        ref = _predicted_change("jax", jb, jc, np_frame, f32)
        got = _predicted_change("port", tb, tc, frame, f32)
        assert np.isfinite(got).all() and np.abs(ref).max() > 0
        assert rel(got, ref) <= tol, name
