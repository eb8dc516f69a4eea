"""The port's text and file writers against the JAX package's: OpenFOAM
case generation (`data/casegen.py`, `data/blockmesh.py`,
`casegen_main`), legacy VTK (`utils/vtk_io.py`) and tree checkpoints
(`utils/h5ckpt.py`). Every written file equals the JAX package's byte for
byte; every file one package writes reads back in the other to the same
values (exactly: no arithmetic).
"""

import os

import jax
import numpy as np
import pytest
import torch

from tpufoam import cli as jcli
from tpufoam.data import blockmesh as jbm
from tpufoam.data import casegen as jcg
from tpufoam.utils import h5ckpt as jck
from tpufoam.utils import vtk_io as jvtk
from tpufoam_torch import cli as tcli
from tpufoam_torch.data import blockmesh as tbm
from tpufoam_torch.data import casegen as tcg
from tpufoam_torch.utils import h5ckpt as tck
from tpufoam_torch.utils import vtk_io as tvtk


def _tree(d) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for k in ta:
        assert ta[k] == tb[k], k


SPEC_ARGS = {
    "cylinder": ((0.3, 1.0), dict(refinement=1.5, bl_grading=0.2)),
    "rectangle": ((4.0, 4.6, 0.3), dict(cell_scale=1.2, y_max=1.5)),
    "triangle": ((4.0, 4.5, 0.25), dict(y_max=1.0)),
    "ellipse": ((0.4, 0.2), dict(y_max=1.2, refinement=2.0)),
    "plate": ((5.0, 0.6, 0.05, 20.0), dict(cell_scale=1.0, y_max=2.0)),
}


@pytest.mark.parametrize("shape", list(jbm.SHAPE_SPECS))
def test_write_spec_matches_jax(shape, tmp_path):
    args, kw = SPEC_ARGS[shape]
    ref = jbm.SHAPE_SPECS[shape](*args, **kw)
    got = tbm.SHAPE_SPECS[shape](*args, **kw)
    assert tbm.emit_blockmesh(got) == jbm.emit_blockmesh(ref)
    jbm.write_spec(ref, str(tmp_path / "j"))
    tbm.write_spec(got, str(tmp_path / "t"))
    _same_tree(tmp_path / "j", tmp_path / "t")


@pytest.mark.parametrize("shape", list(jbm.SHAPE_SPECS))
def test_casegen_main_matches_jax(shape, tmp_path, capsys):
    args = ["--shape", shape, "--size", "0.35", "--refinement", "1.3"]
    jcli.casegen_main(args + ["--out", str(tmp_path / "j")])
    tcli.casegen_main(args + ["--out", str(tmp_path / "t")])
    _same_tree(tmp_path / "j", tmp_path / "t")
    out = capsys.readouterr().out.splitlines()
    assert out[1] == out[0].replace(str(tmp_path / "j"), str(tmp_path / "t"))


def test_casegen_sweep_matches_jax(tmp_path, capsys):
    args = ["--sweep", "3", "--seed", "5", "--bl-grading", "0.1"]
    jcli.casegen_main(args + ["--out", str(tmp_path / "j")])
    tcli.casegen_main(args + ["--out", str(tmp_path / "t")])
    _same_tree(tmp_path / "j", tmp_path / "t")
    assert sorted(os.listdir(tmp_path / "t")) == ["0", "1", "2"]


@pytest.mark.parametrize("kw,shape", [
    (dict(), "cylinder"),
    (dict(length=10.0, height=1.5, cx=3.0, cy=0.7, r=0.3, refinement=2,
          nu=1e-3, end_time=12.5, n_subdomains=8), "rectangle")])
def test_openfoam_case_and_mirror_dict_match_jax(kw, shape, tmp_path):
    jcg.write_openfoam_case(str(tmp_path / "j"), **kw)
    tcg.write_openfoam_case(str(tmp_path / "t"), **kw)
    for d in "jt":
        mod = jcg if d == "j" else tcg
        mod.write_mirror_mesh_dict(str(tmp_path / d / "system" /
                                       "mirrorMeshDict"), point=(1, 0, 0))
        mod.write_blockmesh_dict(str(tmp_path / d / "bmd"), shape=shape,
                                 **{k: v for k, v in kw.items()
                                    if k in ("length", "height", "cx", "cy",
                                             "r", "refinement")})
    _same_tree(tmp_path / "j", tmp_path / "t")


# ---- legacy VTK ------------------------------------------------------------

def _vtk_inputs():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((17, 3))
    return pts, {"p": rng.standard_normal(17),
                 "U": rng.standard_normal((17, 3))}


def test_vtk_write_matches_jax_and_reads_back_both_ways(tmp_path):
    pts, data = _vtk_inputs()
    jvtk.write_legacy_vtk(str(tmp_path / "j.vtk"), pts, data)
    tvtk.write_legacy_vtk(str(tmp_path / "t.vtk"), pts, data)
    assert open(tmp_path / "j.vtk", "rb").read() \
        == open(tmp_path / "t.vtk", "rb").read()
    for path in ("j.vtk", "t.vtk"):
        for reader in (jvtk, tvtk):
            got = reader.read_legacy_vtk(str(tmp_path / path))
            np.testing.assert_array_equal(got["points"], pts)
            for k, v in data.items():
                np.testing.assert_array_equal(got["point_data"][k], v)


def test_vtk_reader_matches_jax_on_cell_and_field_data(tmp_path):
    text = ("# vtk DataFile Version 2.0\nfoam\nASCII\n"
            "DATASET UNSTRUCTURED_GRID\nPOINTS 3 float\n0 0 0 1 0 0 0 1 0\n"
            "CELLS 1 4\n3 0 1 2\nCELL_TYPES 1\n5\n"
            "CELL_DATA 1\nSCALARS p float 1\nLOOKUP_TABLE default\n0.5\n"
            "FIELD attributes 2\nU 3 1 float\n1 2 3\nnut 1 1 float\n7e-5\n"
            "POINT_DATA 3\nVECTORS V double\n1 0 0 0 1 0 0 0 1\n")
    path = tmp_path / "c.vtk"
    path.write_text(text)
    ref, got = jvtk.read_legacy_vtk(str(path)), tvtk.read_legacy_vtk(str(path))
    np.testing.assert_array_equal(got["points"], ref["points"])
    for sec in ("point_data", "cell_data"):
        assert sorted(got[sec]) == sorted(ref[sec]) and ref[sec]
        for k in ref[sec]:
            np.testing.assert_array_equal(got[sec][k], ref[sec][k])


# ---- tree checkpoints ------------------------------------------------------

def _ckpt_tree():
    rng = np.random.default_rng(1)
    return {"params": {"b": rng.standard_normal(4).astype(np.float32),
                       "a": [rng.standard_normal((2, 3)).astype(np.float32),
                             {"k": np.arange(5, dtype=np.int32)}],
                       "Conv_10": {"kernel": np.ones((1, 2, 3), np.float32)},
                       "Conv_2": {"kernel": np.zeros((3,), np.float64)}},
            "losses": {"TNet_0": {"ortho": (np.float32(0.5),)}},
            "none": None}


def _leaves(path):
    import h5py
    with h5py.File(path) as f:
        n = int(f.attrs["n_leaves"])
        return [(f["leaves"][str(i)].attrs["path"],
                 np.asarray(f["leaves"][str(i)])) for i in range(n)]


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, (list, tuple))
                                  and isinstance(b, (list, tuple)))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_h5ckpt_files_match_and_load_across(tmp_path):
    tree, meta = _ckpt_tree(), {"n_pts": 32, "mins": [0.5, -1.0]}
    jck.save_pytree_h5(str(tmp_path / "j.h5"), tree, meta=meta)
    tck.save_pytree_h5(str(tmp_path / "t.h5"), tree, meta=meta)
    lj, lt = _leaves(tmp_path / "j.h5"), _leaves(tmp_path / "t.h5")
    assert [p for p, _ in lt] == [p for p, _ in lj] and len(lj) == 6
    for (_, a), (_, b) in zip(lj, lt):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ref = jck.load_pytree_h5(str(tmp_path / "j.h5"))
    for path in ("j.h5", "t.h5"):
        for loader in (jck, tck):
            got = loader.load_pytree_h5(str(tmp_path / path))
            assert got[1] == meta
            _same(got[0], ref[0])
    _same(ref[0], jax.tree.map(np.asarray, {k: v for k, v in tree.items()
                                            if k != "none"}))


def test_h5ckpt_writes_tensors_as_their_arrays(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "s": [torch.tensor(2.5)]}
    tck.save_pytree_h5(str(tmp_path / "t.h5"), tree)
    back, meta = jck.load_pytree_h5(str(tmp_path / "t.h5"))
    assert meta == {}
    np.testing.assert_array_equal(back["w"], tree["w"].numpy())
    np.testing.assert_array_equal(back["s"][0], np.float32(2.5))
