"""The reference's Keras .h5 weight layout for plain Dense stacks,
`model_weights/<layer>/<layer>/{kernel:0, bias:0}`: read a reference
model (full or weights-only) into the port's MLP parameters, and write
the port's dense parameters weights-only for the reference's serving
code. h5py is imported inside the two functions: the module imports
where h5py is missing.
"""

from __future__ import annotations

import numpy as np

from .. import DEFAULT_DEVICE
from ..utils.metrics import _host
from .mlp import ModelDef, params_from_numpy


def load_keras_dense_h5(path: str, compute_dtype: str = "float32",
                        device=DEFAULT_DEVICE) -> tuple[ModelDef, dict]:
    """(ModelDef, params) of a Keras Dense-stack .h5, the parameters as
    float32 tensors on `device`. Layers are taken in Keras's naming
    order (dense < dense_1 < ...)."""
    import h5py

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        names = []
        for k in root:
            g = root[k]
            if not isinstance(g, h5py.Group):
                continue
            sub = g.get(k)
            if isinstance(sub, h5py.Group) and "kernel:0" in sub:
                names.append(k)

        def order(n):
            parts = n.rsplit("_", 1)
            return int(parts[1]) if len(parts) == 2 and parts[1].isdigit() \
                else -1

        names.sort(key=order)
        layers = [{"w": np.asarray(root[n][n]["kernel:0"]),
                   "b": np.asarray(root[n][n]["bias:0"])} for n in names]

    if not layers:
        raise ValueError(f"no dense layers found in {path}")
    *hidden, head = params_from_numpy(layers, device)
    mdef = ModelDef(kind="dense",
                    widths=tuple(int(l["w"].shape[1]) for l in hidden),
                    in_dim=int(layers[0]["w"].shape[0]),
                    out_dim=int(head["w"].shape[1]),
                    compute_dtype=compute_dtype)
    return mdef, {"layers": hidden, "head": head}


def save_keras_dense_h5(path: str, params: dict) -> None:
    """Write a dense parameter tree (tensors or arrays) weights-only, in
    the reference layout (its serving code loads weights-only files)."""
    import h5py

    layers = list(params["layers"]) + [params["head"]]
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        names = ["dense" if i == 0 else f"dense_{i}"
                 for i in range(len(layers))]
        root.attrs["layer_names"] = np.array(
            [n.encode() for n in names], dtype="S")
        for n, lyr in zip(names, layers):
            g = root.create_group(n).create_group(n)
            g.create_dataset("kernel:0", data=_host(lyr["w"]))
            g.create_dataset("bias:0", data=_host(lyr["b"]))
