"""The port's command-line entry points (`tpufoam_torch/cli.py`) against
the JAX package's (`tpufoam/cli.py`), on the CPU.

- Flags: each of the eight entry points builds the same ArgumentParser
  as the JAX package's: the same option strings, defaults and choices,
  subcommand by subcommand. The smoother names map to each other ("xla"
  is "plain", "pallas" "kernel"). The listed differences: `--platform`
  takes cpu or cuda (JAX: cpu or tpu), and the bundle conversions take
  `--platform` too (they stage the bundle on a device).
- `piso_main` at --delta 0.0625 (32 x 128), 3 steps, both packages, the
  `--out` .npz and `--forces-out` CSV held at the tolerances that
  tests/test_torch_piso.py and tests/test_torch_turbulence.py use for
  the same paths (max |port - JAX| / max |JAX| per field): the hybrid
  with a tiny bundle (f32 multigrid) 1e-4; MGCG to rtol 1e-6 u, v 1e-4
  and p 1e-2 (each side stops its CG where its own residual falls below
  1e-6); the k-omega SST path with wall functions (MGCG) u, v, k, omega,
  nu_t 1e-4 (STEP_TOL) and p 1e-2; t exact. The per-step line, the
  .npz keys and the CSV rows are the JAX package's, Cd and Cl to 1e-4
  of |Cd|.
- `--state`: 2 steps, then 1 resumed from the state file, equal 3
  straight steps bit for bit.
"""

import argparse
import re

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam import cli as jcli
from tpufoam_torch import cli as tcli

SMOOTHER_NAMES = {"xla": "plain", "pallas": "kernel"}
ENTRY_POINTS = ("piso_main", "casegen_main", "datagen_main", "train_main",
                "pinn_main", "pointcloud_main", "eval_main", "bundle_main")
PISO = ["--platform", "cpu", "--delta", "0.0625"]
HYBRID_TOL = 1e-4
MGCG_TOL = {"p": 1e-2}
STEP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser(main, monkeypatch):
    def capture(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as e:
            main([])
    return e.value.parser


def _mapped(v):
    if isinstance(v, str):
        return SMOOTHER_NAMES.get(v, v)
    if isinstance(v, (list, tuple)):
        return sorted({_mapped(x) for x in v}, key=str)
    return v


def _flags(parser, prefix=""):
    """{(subcommand, option): (default, choices)}, subcommands walked."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out.update(_flags(sub, prefix + name + " "))
        elif not isinstance(a, argparse._HelpAction):
            for opt in a.option_strings or [a.dest]:
                out[prefix + opt] = (_mapped(a.default), _mapped(a.choices))
    return out


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_flags_match_the_jax_package(name, monkeypatch):
    port = _flags(_parser(getattr(tcli, name), monkeypatch))
    ref = _flags(_parser(getattr(jcli, name), monkeypatch))
    extra = {}
    if name == "bundle_main":
        extra = {k: port.pop(k) for k in list(port)
                 if k.endswith("--platform")}
        assert set(extra) == {"import-ref --platform",
                              "export-ref --platform"}
    plat = [k for k in port if k.endswith("--platform")]
    for k in plat:
        assert port.pop(k) == (None, ["cpu", "cuda"])
        assert ref.pop(k) == (None, ["cpu", "tpu"])
    for k in extra.values():
        assert k == (None, ["cpu", "cuda"])
    assert port == ref


def test_smoother_flags_take_both_names():
    p = tcli._backend("mg", smoother="pallas")[0]
    assert p.smoother == "kernel"
    assert tcli._backend("mgcg", smoother="xla")[0].smoother == "plain"


# ---- piso_main -----------------------------------------------------------

@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bundle") / "tiny")
    _tiny_bundle(block_size=16).save(d)
    return d


PATHS = {
    "hybrid": ["--backend", "hybrid", "--stitch", "lstsq"],
    "mgcg": [],
    "sst": ["--turbulence", "kOmegaSST", "--turb-wall-fn"],
}
TOLS = {"hybrid": {}, "mgcg": MGCG_TOL, "sst": MGCG_TOL}


def _run(main, tmp, tag, args, capsys):
    out, csv = str(tmp / f"{tag}.npz"), str(tmp / f"{tag}.csv")
    main(PISO + ["--steps", "3", "--out", out, "--forces-out", csv] + args)
    text = capsys.readouterr().out
    return dict(np.load(out)), open(csv).read(), text


@pytest.mark.parametrize("path", list(PATHS))
def test_piso_main_matches_jax(path, bundle_dir, tmp_path, capsys):
    args = PATHS[path] + (["--bundle", bundle_dir]
                          if path == "hybrid" else [])
    # the JAX package's smoother names on the port's command line
    port_args = args + ["--momentum-smoother", "pallas"] \
        if path == "hybrid" else args
    got, got_csv, got_txt = _run(tcli.piso_main, tmp_path, "out_port",
                                 port_args, capsys)
    ref, ref_csv, ref_txt = _run(jcli.piso_main, tmp_path, "out_ref", args,
                                 capsys)
    assert sorted(got) == sorted(ref)
    tol = HYBRID_TOL if path == "hybrid" else STEP_TOL
    for k in ref:
        err = float(np.abs(got[k] - ref[k]).max())
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        assert err <= (0.0 if k == "t" else TOLS[path].get(k, tol)) * scale, \
            f"{path} {k}: {err:.3e} / {scale:.3e}"
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape

    def lines(txt, tag):
        return [re.sub(r" Co=.*", "", s.replace(tag, "*"))
                for s in txt.splitlines() if s.startswith(("step ", "saved"))]

    assert lines(got_txt, "out_port") == lines(ref_txt, "out_ref")
    assert len(lines(got_txt, "out_port")) == 3
    assert got_csv.splitlines()[0] == ref_csv.splitlines()[0] == "t,Cd,Cl"
    g = np.loadtxt(got_csv.splitlines()[1:], delimiter=",", ndmin=2)
    r = np.loadtxt(ref_csv.splitlines()[1:], delimiter=",", ndmin=2)
    assert g.shape == r.shape and np.array_equal(g[:, 0], r[:, 0])
    assert np.abs(g[:, 1:] - r[:, 1:]).max() <= 1e-4 * np.abs(r[:, 1]).max()


def test_state_resume_equals_straight_steps(tmp_path, capsys):
    straight, state = str(tmp_path / "a.npz"), str(tmp_path / "s.npz")
    tcli.piso_main(PISO + ["--steps", "3", "--out", straight])
    tcli.piso_main(PISO + ["--steps", "2", "--state", state])
    resumed = str(tmp_path / "b.npz")
    tcli.piso_main(PISO + ["--steps", "1", "--state", state,
                           "--out", resumed])
    assert "resumed from" in capsys.readouterr().out
    a, b = np.load(straight), np.load(resumed)
    assert sorted(a.files) == sorted(b.files) == ["p", "t", "u", "v"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_piso_main_refuses_the_tpu_platform():
    with pytest.raises(SystemExit):
        tcli.piso_main(["--platform", "tpu", "--steps", "1"])
