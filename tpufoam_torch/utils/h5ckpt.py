"""Generic tree <-> HDF5 checkpoints.

The reference saves every model as Keras .h5 (PINN_steady.py:419,561;
Chapter3 train.py). For plain dense stacks the port writes the actual
Keras layout (models/keras_compat.py); for arbitrary trees (PointNet
parameters in the flax layout, optimizer states) this module stores the
leaves keyed by their tree PATH in a plain h5 file: language-neutral,
mmap-able, and reconstructible without pickling.

The file is the JAX package's: the leaves in JAX's flattening order (dict
keys sorted, lists and tuples by index, None an empty subtree), each
with its path as JSON `[["d", key] | ["i", index], ...]`. So a file
written by either package loads in the other. h5py is imported inside
the functions: the module imports where h5py is missing.
"""

from __future__ import annotations

import json

import numpy as np

from .metrics import _host


def _flatten_with_path(tree, path=()):
    """(path, leaf) pairs in JAX's flattening order; a path is a tuple of
    ("d", key) and ("i", index) steps."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_path(tree[k], path + (("d", str(k)),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_path(v, path + (("i", i),))]
    return [(path, tree)]


def _path_key(path) -> str:
    return json.dumps([[kind, key] for kind, key in path])


def save_pytree_h5(path: str, tree, meta: dict | None = None) -> None:
    """Write a tree of arrays or tensors (nested dicts, lists, tuples)
    with optional meta."""
    import h5py

    flat = _flatten_with_path(tree)
    with h5py.File(path, "w") as f:
        g = f.create_group("leaves")
        for i, (p, leaf) in enumerate(flat):
            d = g.create_dataset(str(i), data=_host(leaf))
            d.attrs["path"] = _path_key(p)
        f.attrs["n_leaves"] = len(flat)
        if meta:
            f.attrs["meta"] = json.dumps(meta)


def load_pytree_h5(path: str):
    """Read back (tree, meta) of numpy arrays: dict/list nesting rebuilt
    from leaf paths (a tuple comes back as a list, as in the JAX
    package)."""
    import h5py

    items = []
    with h5py.File(path, "r") as f:
        n = int(f.attrs["n_leaves"])
        for i in range(n):
            d = f["leaves"][str(i)]
            items.append((json.loads(d.attrs["path"]), np.asarray(d)))
        meta = json.loads(f.attrs["meta"]) if "meta" in f.attrs else {}

    if not items:
        return {}, meta
    if not items[0][0]:                 # a bare leaf
        return items[0][1], meta

    def insert(container, parts, value):
        (kind, key), rest = parts[0], parts[1:]
        key = int(key) if kind == "i" else key
        if kind == "i" and isinstance(container, list):
            while len(container) <= key:
                container.append(None)
        if not rest:
            container[key] = value
            return
        nxt = container[key] if (
            (isinstance(container, dict) and key in container)
            or (isinstance(container, list) and container[key] is not None)
        ) else ([] if rest[0][0] == "i" else {})
        container[key] = nxt
        insert(nxt, rest, value)

    root = [] if items[0][0][0][0] == "i" else {}
    for parts, value in items:
        insert(root, parts, value)
    return root, meta
