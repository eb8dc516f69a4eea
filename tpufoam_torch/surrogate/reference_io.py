"""The reference's loose serving sidecars, read into and written from a
SurrogateBundle.

The reference's embedded solver loads six files that must agree:

    ipca_input[_more].pkl   sklearn/dask_ml IncrementalPCA (input blocks)
    ipca_p[_more].pkl       IncrementalPCA (pressure blocks)
    maxs                    np.loadtxt -> per-channel max-abs scales
    maxs_PCA                np.loadtxt -> [max_abs_input_PCA, max_abs_p_PCA]
    weights.h5 / model .h5  Keras dense stack

`load_sklearn_ipca` reads the pickles without sklearn or dask_ml (a
tolerant unpickler maps their classes to attribute bags; the arrays
inside are plain numpy), and `bundle_from_reference_sidecars` assembles
the bundle. `export_reference_sidecars` writes a bundle as that set,
folding the bundle's PCA-space normalization into the first and last
dense layers, so that the reference's max-abs serving math (PC /
maxs_PCA[0] -> MLP -> * maxs_PCA[1]) gives the bundle's predictions in
exact arithmetic.

The Keras files need h5py (models.keras_compat), so these run where h5py
is installed; the bundle they give serves on any device.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..utils.metrics import _host
from .pca import PCAModel


class _StubEstimator:
    """Attribute bag standing in for an un-importable pickled class."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["__state__"] = state


class _TolerantUnpickler(pickle.Unpickler):
    """Resolve classes normally; fall back to _StubEstimator for modules
    that are not installed (sklearn, dask_ml, joblib internals). numpy
    must resolve for the arrays to load."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_StubEstimator,), {"__module__": module})


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32),
                           device=torch.device(device))


def load_sklearn_ipca(path_or_file, device=DEFAULT_DEVICE) -> PCAModel:
    """An `ipca_input.pkl` / `ipca_p.pkl` sidecar (a fitted sklearn
    (Incremental)PCA or the dask_ml subclass) as a PCAModel on `device`,
    with or without those libraries installed."""
    if hasattr(path_or_file, "read"):
        obj = _TolerantUnpickler(path_or_file).load()
    else:
        with open(path_or_file, "rb") as f:
            obj = _TolerantUnpickler(f).load()

    def attr(*names):
        for n in names:
            v = getattr(obj, n, None)
            if v is not None:
                return np.asarray(v)
        return None

    components = attr("components_")
    if components is None:
        raise ValueError(f"{path_or_file}: no components_ — not a fitted "
                         "(Incremental)PCA pickle")
    mean = attr("mean_")
    if mean is None:
        mean = np.zeros(components.shape[1], dtype=components.dtype)
    ev = attr("explained_variance_")
    if ev is None:
        sv = attr("singular_values_")
        n = attr("n_samples_seen_")
        ev = (sv**2 / max(float(n or 1) - 1.0, 1.0)) if sv is not None \
            else np.ones(components.shape[0])
    evr = attr("explained_variance_ratio_")
    if evr is None:
        evr = ev / max(ev.sum(), 1e-30)
    return PCAModel(mean=_f32(mean, device),
                    components=_f32(components, device),
                    explained_variance=_f32(ev, device),
                    explained_variance_ratio=_f32(evr, device))


def bundle_from_reference_sidecars(directory: str,
                                   family: str = "deltaU_deltaP",
                                   block_size: int = 128,
                                   overlap_ratio: float = 0.25,
                                   device=DEFAULT_DEVICE):
    """A SurrogateBundle on `device` from a reference sidecar directory:
    ipca_input[_more].pkl, ipca_p[_more].pkl, maxs, maxs_PCA and
    weights.h5 (or model.h5, or the first .h5). The PCA-space
    normalization is the reference's max-abs method (maxs_PCA)."""
    from ..models.keras_compat import load_keras_dense_h5
    from .pipeline import SurrogateBundle

    def find(*names):
        for n in names:
            p = os.path.join(directory, n)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"none of {names} in {directory}")

    pca_in = load_sklearn_ipca(find("ipca_input_more.pkl", "ipca_input.pkl"),
                               device)
    pca_out = load_sklearn_ipca(find("ipca_p_more.pkl", "ipca_p.pkl"),
                                device)
    maxs = np.atleast_1d(np.loadtxt(find("maxs")))
    maxs_pca = np.atleast_1d(np.loadtxt(find("maxs_PCA")))

    h5 = next((os.path.join(directory, c) for c in ("weights.h5", "model.h5")
               if os.path.exists(os.path.join(directory, c))), None)
    if h5 is None:
        h5s = sorted(f for f in os.listdir(directory) if f.endswith(".h5"))
        if not h5s:
            raise FileNotFoundError(f"no .h5 model in {directory}")
        h5 = os.path.join(directory, h5s[0])
    mdef, params = load_keras_dense_h5(h5, device=device)

    # the maxs layout: the input channels' scales, then the pressure's
    return SurrogateBundle(
        family=family, mdef=mdef, params=params,
        pca_in=pca_in, pca_out=pca_out, pc_in=int(mdef.in_dim),
        pc_out=int(mdef.out_dim), norm_method="max_abs",
        norm={"max_abs_in": _f32(maxs_pca[0], device),
              "max_abs_out": _f32(maxs_pca[-1], device)},
        maxs_in=_f32(maxs[:-1], device), maxs_out=_f32(maxs[-1:], device),
        block_size=block_size, overlap_ratio=overlap_ratio)


class ExportedIPCA:
    """A picklable stand-in for a fitted sklearn IncrementalPCA, written
    where sklearn is not importable: the same fitted attributes, so
    `load_sklearn_ipca` (and the JAX package's) reads it back."""


def _as_sklearn_ipca(pca: PCAModel, k: int):
    comps = _host(pca.components[:k], np.float64)
    ev = _host(pca.explained_variance[:k], np.float64)
    try:
        from sklearn.decomposition import IncrementalPCA
        ip = IncrementalPCA(n_components=k)
    except ImportError:
        ip = ExportedIPCA()
        ip.n_components = k
    # a nominal sample count consistent with singular_values_ = sqrt(ev*(n-1))
    n_seen = 4096
    ip.components_ = comps
    ip.mean_ = _host(pca.mean, np.float64)
    ip.explained_variance_ = ev
    ip.explained_variance_ratio_ = _host(pca.explained_variance_ratio[:k],
                                         np.float64)
    ip.singular_values_ = np.sqrt(np.maximum(ev, 0.0) * (n_seen - 1))
    ip.n_samples_seen_ = np.int64(n_seen)
    ip.n_components_ = k
    ip.n_features_in_ = comps.shape[1]
    ip.noise_variance_ = 0.0
    ip.whiten = False
    ip.batch_size_ = 5 * k
    return ip


def _norm_affines(bundle) -> tuple[np.ndarray, ...]:
    """The bundle's PCA-space normalization as elementwise affines:
    standardize_in(z) = a_in*z + c_in; destandardize_out(z) =
    a_out*z + c_out; float64."""
    n = {k: _host(v, np.float64) for k, v in bundle.norm.items()}
    if bundle.norm_method == "std":
        a_in, c_in = 1.0 / n["std_in"], -n["mean_in"] / n["std_in"]
        a_out, c_out = n["std_out"], n["mean_out"]
    elif bundle.norm_method == "min_max":
        span_in = n["max_in"] - n["min_in"]
        a_in, c_in = 1.0 / span_in, -n["min_in"] / span_in
        a_out, c_out = n["max_out"] - n["min_out"], n["min_out"]
    elif bundle.norm_method == "max_abs":
        a_in = 1.0 / n["max_abs_in"]
        c_in = np.zeros_like(a_in)
        a_out = n["max_abs_out"]
        c_out = np.zeros_like(a_out)
    else:
        raise ValueError(f"unknown norm_method {bundle.norm_method!r}")
    ones_in = np.ones(int(bundle.pc_in))
    ones_out = np.ones(int(bundle.pc_out))
    return (a_in * ones_in, c_in * ones_in, a_out * ones_out,
            c_out * ones_out)


def export_reference_sidecars(bundle, directory: str,
                              suffix: str = "_more") -> dict:
    """Write a SurrogateBundle as the reference's serving sidecar set:
    ipca_input{suffix}.pkl, ipca_p{suffix}.pkl, maxs, maxs_PCA and
    weights.h5 (needs h5py).

    The reference serves with max-abs PCA-space scales only, so the
    bundle's per-PC affine normalization is folded into the first dense
    layer (rows scaled by a_in*M_in, bias shifted by c_in @ W1) and the
    head (columns scaled by a_out/M_out, bias (b*a_out + c_out)/M_out),
    where M_in and M_out are the max-abs scales written to maxs_PCA. Only
    plain dense stacks export. Returns {"maxs_PCA": (M_in, M_out)}."""
    if bundle.mdef.kind != "dense":
        raise ValueError("reference serving only loads plain dense stacks; "
                         f"cannot export kind={bundle.mdef.kind!r}")
    from ..models.keras_compat import save_keras_dense_h5

    os.makedirs(directory, exist_ok=True)
    b = bundle.trimmed()
    a_in, c_in, a_out, c_out = _norm_affines(b)

    # representative max-abs PC scales: the inverse image of the
    # normalized range [-1, 1] (mean +- 4 sigma for std). Any positive
    # value is exact (it cancels against the folded layers); these keep
    # the reference pipeline's intermediate z of order 1.
    spread = 4.0 if b.norm_method == "std" else 1.0
    M_in = float(np.max(np.abs(c_in / np.maximum(np.abs(a_in), 1e-30))
                        + spread / np.maximum(np.abs(a_in), 1e-30)))
    M_out = float(np.max(np.abs(c_out) + spread * np.abs(a_out)))

    stack = [{k: _host(l[k], np.float64) for k in ("w", "b")}
             for l in [*b.params["layers"], b.params["head"]]]
    # fold the input affine (z = a_in*(M_in*z') + c_in) into the first layer
    first = stack[0]
    first["b"] = first["b"] + c_in @ first["w"]
    first["w"] = first["w"] * (a_in * M_in)[:, None]
    # fold the output affine (y = (a_out*h + c_out)/M_out) into the last
    last = stack[-1]
    last["w"] = last["w"] * (a_out / M_out)[None, :]
    last["b"] = (last["b"] * a_out + c_out) / M_out
    folded = [{k: v.astype(np.float32) for k, v in l.items()} for l in stack]
    save_keras_dense_h5(os.path.join(directory, "weights.h5"),
                        {"layers": folded[:-1], "head": folded[-1]})

    for tag, pca, k in (("input", b.pca_in, b.pc_in),
                        ("p", b.pca_out, b.pc_out)):
        with open(os.path.join(directory, f"ipca_{tag}{suffix}.pkl"),
                  "wb") as f:
            pickle.dump(_as_sklearn_ipca(pca, int(k)), f)

    # maxs: the input channels' scales, then the target's (last: pressure)
    np.savetxt(os.path.join(directory, "maxs"),
               np.concatenate([_host(b.maxs_in, np.float64).ravel(),
                               _host(b.maxs_out, np.float64).ravel()]))
    np.savetxt(os.path.join(directory, "maxs_PCA"), np.array([M_in, M_out]))
    return {"maxs_PCA": (M_in, M_out)}
