"""The reference's serving sidecars in tpufoam_torch
(surrogate/reference_io.py, models/keras_compat.py) on the CPU, across
both packages: sidecars written by the JAX package are imported by the
port, sidecars written by the port are imported by the JAX package, and
the imported bundles predict alike. These need h5py, which the card's
machine lacks: they run on the CPU only.

The bundles are tests/test_reference_io.py's tiny deltaU_deltaP-shaped
bundles (4 x 4 blocks, 48 -> 6 PCs -> a float32 dense MLP -> 4 PCs -> 16).
Tolerances:
- pickles and .h5 files: exact (float32 copies of the same arrays).
- a bundle's block prediction, port against JAX from the same files:
  1e-5 relative (float32 products in two frameworks, a dozen roundings
  deep).
- an exported then imported bundle against the original: 2e-4, the JAX
  package's own bound (the normalization folded into the dense layers
  rounds once more in float32).
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tpufoam.models import keras_compat as jkeras
from tpufoam.surrogate import reference_io as jref
from tpufoam_torch.models import keras_compat as tkeras
from tpufoam_torch.models.mlp import apply_model
from tpufoam_torch.surrogate import reference_io as tref
from test_reference_io import _pc_forward, _tiny_std_bundle
from test_torch_piso import bundle_to_torch

pytest.importorskip("h5py")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_forward(b, x):
    """The port's serving PC pipeline (as _pc_forward for JAX bundles)."""
    z = b.pca_in.transform(torch.as_tensor(x), b.pc_in)
    z = b.destandardize_out(apply_model(b.params, b.mdef,
                                        b.standardize_in(z)))
    return b.pca_out.inverse_transform(z).numpy()


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    sk = pytest.importorskip("sklearn.decomposition")
    d = tmp_path_factory.mktemp("pkl")
    rng = np.random.default_rng(0)
    out = {}
    for tag, dim, k in (("input", 48, 6), ("p", 16, 4)):
        x = rng.standard_normal((300, dim)).astype(np.float32)
        ip = sk.IncrementalPCA(n_components=k)
        ip.partial_fit(x[:150])
        ip.partial_fit(x[150:])
        path = str(d / f"ipca_{tag}.pkl")
        with open(path, "wb") as f:
            pickle.dump(ip, f)
        out[tag] = (path, ip, x)
    return out


def test_ipca_import_matches_jax_and_sklearn(pickles):
    for path, ip, x in pickles.values():
        got = tref.load_sklearn_ipca(path, device="cpu")
        ref = jref.load_sklearn_ipca(path)
        for name in ("mean", "components", "explained_variance",
                     "explained_variance_ratio"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        np.testing.assert_allclose(got.transform(torch.as_tensor(x[:7])
                                                 ).numpy(),
                                   ip.transform(x[:7]), rtol=1e-4, atol=1e-4)
        with open(path, "rb") as f:     # a file object as well as a path
            assert tref.load_sklearn_ipca(f, device="cpu").components.shape \
                == got.components.shape


def test_ipca_import_without_sklearn_or_dask(pickles, monkeypatch):
    hidden = [k for k in sys.modules
              if k.split(".")[0] in ("sklearn", "dask_ml")]
    for k in hidden:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "dask_ml", None)
    m = tref.load_sklearn_ipca(pickles["p"][0], device="cpu")
    assert tuple(m.components.shape) == (4, 16)
    np.testing.assert_array_equal(m.components.numpy(),
                                  pickles["p"][1].components_
                                  .astype(np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_keras_dense_h5_across_packages(tmp_path, writer):
    jb = _tiny_std_bundle(seed=2)
    path = str(tmp_path / "weights.h5")
    if writer == "jax":
        jkeras.save_keras_dense_h5(path, jb.params)
    else:
        tkeras.save_keras_dense_h5(path, bundle_to_torch(jb).params)
    tdef, tparams = tkeras.load_keras_dense_h5(path, device="cpu")
    jdef, jparams = jkeras.load_keras_dense_h5(path)
    assert (tdef.kind, tdef.widths, tdef.in_dim, tdef.out_dim,
            tdef.compute_dtype) == (jdef.kind, jdef.widths, jdef.in_dim,
                                    jdef.out_dim, jdef.compute_dtype)
    for t, j, o in zip([*tparams["layers"], tparams["head"]],
                       [*jparams["layers"], jparams["head"]],
                       [*jb.params["layers"], jb.params["head"]]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(o[k]))


def test_keras_load_refuses_a_file_without_dense_layers(tmp_path):
    import h5py
    path = str(tmp_path / "empty.h5")
    with h5py.File(path, "w") as f:
        f.create_group("model_weights")
    with pytest.raises(ValueError, match="no dense layers"):
        tkeras.load_keras_dense_h5(path, device="cpu")


@pytest.mark.parametrize("norm_method", ["std", "max_abs"])
def test_jax_sidecars_import_into_the_port(tmp_path, norm_method):
    jb = _tiny_std_bundle(norm_method=norm_method)
    d = str(tmp_path / "jax")
    jref.export_reference_sidecars(jb, d)
    got = tref.bundle_from_reference_sidecars(d, block_size=4,
                                              device="cpu")
    ref = jref.bundle_from_reference_sidecars(d, block_size=4)
    assert (got.family, got.pc_in, got.pc_out, got.norm_method,
            got.block_size, got.overlap_ratio) == \
        (ref.family, ref.pc_in, ref.pc_out, ref.norm_method,
         ref.block_size, ref.overlap_ratio)
    for name in ("maxs_in", "maxs_out"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for k, v in ref.norm.items():
        np.testing.assert_array_equal(got.norm[k].numpy(), np.asarray(v))
    x = np.random.default_rng(1).standard_normal((5, 48)).astype(np.float32)
    assert _rel(_port_forward(got, x), _pc_forward(ref, x)) <= 1e-5
    assert _rel(_port_forward(got, x), _pc_forward(jb, x)) <= 2e-4


@pytest.mark.parametrize("norm_method", ["std", "max_abs"])
def test_port_sidecars_import_into_jax(tmp_path, norm_method):
    jb = _tiny_std_bundle(seed=4, norm_method=norm_method)
    tb = bundle_to_torch(jb)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    scales = tref.export_reference_sidecars(tb, dt)
    assert scales == jref.export_reference_sidecars(jb, dj)
    for name in ("ipca_input_more.pkl", "ipca_p_more.pkl", "maxs",
                 "maxs_PCA", "weights.h5"):
        assert os.path.exists(os.path.join(dt, name)), name
    for name in ("maxs", "maxs_PCA"):
        np.testing.assert_array_equal(np.loadtxt(os.path.join(dt, name)),
                                      np.loadtxt(os.path.join(dj, name)))
    ref = jref.bundle_from_reference_sidecars(dt, block_size=4)
    same = jref.bundle_from_reference_sidecars(dj, block_size=4)
    x = np.random.default_rng(2).standard_normal((5, 48)).astype(np.float32)
    np.testing.assert_array_equal(_pc_forward(ref, x), _pc_forward(same, x))
    back = tref.bundle_from_reference_sidecars(dt, block_size=4,
                                               device="cpu")
    assert _rel(_port_forward(back, x), _pc_forward(ref, x)) <= 1e-5
    assert _rel(_port_forward(back, x), _port_forward(tb, x)) <= 2e-4


def test_export_without_sklearn_reads_back_without_it(tmp_path,
                                                      monkeypatch):
    tb = bundle_to_torch(_tiny_std_bundle(seed=5))
    hidden = [k for k in sys.modules if k.split(".")[0] == "sklearn"]
    for k in hidden:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    d = str(tmp_path / "bare")
    tref.export_reference_sidecars(tb, d)
    with open(os.path.join(d, "ipca_p_more.pkl"), "rb") as f:
        assert type(pickle.load(f)).__name__ == "ExportedIPCA"
    back = tref.bundle_from_reference_sidecars(d, block_size=4,
                                               device="cpu")
    ref = jref.bundle_from_reference_sidecars(d, block_size=4)
    x = np.random.default_rng(3).standard_normal((4, 48)).astype(np.float32)
    assert _rel(_port_forward(back, x), _port_forward(tb, x)) <= 2e-4
    assert _rel(_port_forward(back, x), _pc_forward(ref, x)) <= 1e-5


def test_export_refuses_a_non_dense_model():
    import dataclasses
    tb = bundle_to_torch(_tiny_std_bundle())
    tb = dataclasses.replace(tb, mdef=dataclasses.replace(tb.mdef,
                                                          kind="attention"))
    with pytest.raises(ValueError, match="plain dense"):
        tref.export_reference_sidecars(tb, "/nonexistent")


def test_import_needs_every_sidecar(tmp_path):
    jref.export_reference_sidecars(_tiny_std_bundle(), str(tmp_path))
    os.remove(tmp_path / "maxs_PCA")
    with pytest.raises(FileNotFoundError):
        tref.bundle_from_reference_sidecars(str(tmp_path), device="cpu")
