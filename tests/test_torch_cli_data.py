"""The port's dataset, training, evaluation and bundle entry points
(`datagen_main`, `train_main`, `eval_main`, `bundle_main`) against the JAX
package's, on the CPU, on one tiny dataset.

- `datagen`: 1 sim of a 32 x 128 channel, 2 warm-up steps, 3 frames of 1
  step (MGCG to rtol 1e-6), the same seed: `sim_data` per channel to the
  MGCG tolerance of tests/test_torch_solvers.py, max |port - JAX| / max
  |JAX| <= 1e-4 (the records' deltas dU, dp to 1e-3: a difference of two
  fields that agree to 1e-4 of their own scale); `top_bound` and
  `obst_bound` exactly (host numpy).
- `train`: block size 16, 3 epochs (one full batch an epoch, lr 1e-3),
  on JAX's dataset. The random streams
  differ (block corners, init, batches), so the port trains on the
  block dataset JAX's run cached (`--cache`): equal `pc_in` and `pc_out`;
  and from the .h5 itself: the train loss falls. Each package's bundle
  loads in the other.
- `eval`: both on JAX's bundle, made float32-compute (its manifest's
  compute dtype; bf16 products round apart by bf16 ulps), and JAX's
  dataset: every printed normVal, BIAS, STDE and RMSE to rel 1e-4 of its
  tier's RMSE, or half the print's last digit; `--save-plots` writes the
  PNGs and the GIF.
- `bundle`: `export-ref` writes the same sidecar files (the same bytes,
  or for the pickles, the same arrays), `import-ref` the same bundle
  files, `info` the same output.
"""

import json
import os
import pickle
import re

import numpy as np
import pytest
import torch

from tpufoam import cli as jcli
from tpufoam_torch import cli as tcli

DELTA = ["--delta", "0.0625"]
GEN = ["--n-sims", "1", "--n-frames", "3", "--steps-per-frame", "1",
       "--warmup-steps", "2", "--seed", "3"] + DELTA
TRAIN = ["--family", "deltaU_deltaP", "--block-size", "16", "--n-samples",
         "200", "--epochs", "3", "--max-num-pc", "16",
         "--lr", "1e-3"] + DELTA
CPU = ["--platform", "cpu"]
MGCG_TOL = 1e-4
DELTA_TOL = 1e-3
EVAL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's dataset, the port's from the same seed, and JAX's bundle
    trained on JAX's dataset with its block cache."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("cli")
    jds, tds = str(d / "jax.h5"), str(d / "port.h5")
    jcli.datagen_main(GEN + CPU + ["--out", jds])
    tcli.datagen_main(GEN + CPU + ["--out", tds])
    jb, cache = str(d / "jax_bundle"), str(d / "blocks.npz")
    jcli.train_main(TRAIN + CPU + ["--dataset", jds, "--out", jb,
                                   "--cache", cache])
    return dict(dir=d, jds=jds, tds=tds, jb=jb, cache=cache)


def test_datagen_matches_jax(runs):
    import h5py
    with h5py.File(runs["jds"]) as fj, h5py.File(runs["tds"]) as ft:
        assert fj.attrs["channels"] == ft.attrs["channels"]
        channels = fj.attrs["channels"].split(",")
        for k in ("top_bound", "obst_bound"):
            np.testing.assert_array_equal(ft[k][()], fj[k][()])
        ref, got = fj["sim_data"][()], ft["sim_data"][()]
    assert got.shape == ref.shape == (1, 3, ref.shape[2], len(channels))
    np.testing.assert_array_equal(got == -100.0, ref == -100.0)
    for c, name in enumerate(channels):
        r, g = ref[..., c], got[..., c]
        tol = DELTA_TOL if name.startswith("d") else MGCG_TOL
        err = float(np.abs(g - r).max())
        assert err <= tol * float(np.abs(r[r != -100.0]).max()), \
            (name, err)


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_train_on_jax_blocks_gives_jax_pc_counts(runs, capsys):
    capsys.readouterr()
    jcli.train_main(TRAIN + CPU + ["--dataset", runs["jds"], "--out",
                                   str(runs["dir"] / "jb2"),
                                   "--cache", runs["cache"]])
    ref = _last_json(capsys.readouterr().out)
    tb = str(runs["dir"] / "port_bundle_cached")
    tcli.train_main(TRAIN + CPU + ["--dataset", runs["jds"], "--out", tb,
                                   "--cache", runs["cache"]])
    out = capsys.readouterr().out
    assert "loaded cached dataset" in out
    got = _last_json(out)
    assert (got["pc_in"], got["pc_out"]) == (ref["pc_in"], ref["pc_out"])
    assert got["epochs_run"] == ref["epochs_run"] == 3


def test_train_from_the_dataset_and_bundles_load_across(runs, capsys):
    from tpufoam.surrogate.pipeline import SurrogateBundle as JBundle
    from tpufoam_torch.surrogate.pipeline import SurrogateBundle as TBundle

    tb = str(runs["dir"] / "port_bundle")
    tcli.train_main(TRAIN + CPU + ["--dataset", runs["jds"], "--out", tb])
    got = _last_json(capsys.readouterr().out)
    loss = np.loadtxt(os.path.join(tb, "training_loss.txt"), ndmin=2)
    assert loss.shape == (3, 2) and loss[-1, 0] < loss[0, 0]
    assert os.path.exists(os.path.join(tb, "training_loss.png"))
    jb = JBundle.load(tb)
    assert (jb.pc_in, jb.pc_out) == (got["pc_in"], got["pc_out"])
    back = TBundle.load(runs["jb"], device="cpu")
    ref = JBundle.load(runs["jb"])
    assert (back.pc_in, back.pc_out) == (ref.pc_in, ref.pc_out)
    np.testing.assert_array_equal(back.pca_in.components.numpy(),
                                  np.asarray(ref.pca_in.components))


def _numbers(text):
    """[(tier, key, value)] of every `key = value%` line, in order."""
    out, tier = [], None
    for line in text.splitlines():
        if line.startswith("**"):
            tier = line
        m = re.match(r"(\w+) = ([-\d.e+]+)%?$", line.strip())
        if m:
            out.append((tier, m.group(1), float(m.group(2))))
    return out


def test_eval_matches_jax(runs, capsys, tmp_path):
    import shutil
    b32 = str(tmp_path / "b32")
    shutil.copytree(runs["jb"], b32)
    with open(os.path.join(b32, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["mdef"]["compute_dtype"] = "float32"
    with open(os.path.join(b32, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    args = ["--dataset", runs["jds"], "--bundle", b32] + DELTA + CPU
    capsys.readouterr()
    jcli.eval_main(args)
    ref = _numbers(capsys.readouterr().out)
    plots = str(tmp_path / "plots")
    tcli.eval_main(args + ["--save-plots", "--plots-dir", plots])
    got = _numbers(capsys.readouterr().out)
    assert [g[:2] for g in got] == [r[:2] for r in ref] and len(ref) >= 8
    rmse = {t: v for t, k, v in ref if k == "rmseNorm"}
    for (tier, key, g), (_, _, r) in zip(got, ref):
        scale = abs(r) if key == "normVal" else rmse[tier]
        assert abs(g - r) <= max(EVAL_TOL * scale, 5e-4), (tier, key, g, r)
    files = sorted(os.listdir(os.path.join(plots, "sim0")))
    assert files == ["p_movie.gif"] + [f"p_pred_t{t}.png" for t in range(3)]


def _files(d):
    return sorted(f for f in os.listdir(d))


def test_bundle_export_import_info_match_jax(runs, capsys, tmp_path):
    je, te = str(tmp_path / "je"), str(tmp_path / "te")
    jcli.bundle_main(["export-ref", "--bundle", runs["jb"], "--out", je])
    tcli.bundle_main(["export-ref", "--bundle", runs["jb"], "--out", te,
                      "--platform", "cpu"])
    ref_txt, got_txt = None, None
    out = capsys.readouterr().out.splitlines()
    ref_txt, got_txt = out[0], out[1]
    assert got_txt.replace(te, "*") == ref_txt.replace(je, "*")
    assert _files(te) == _files(je)
    for f in _files(je):
        a, b = open(os.path.join(je, f), "rb").read(), \
            open(os.path.join(te, f), "rb").read()
        if a == b:
            continue
        assert f.endswith(".pkl"), f
        with open(os.path.join(je, f), "rb") as fa, \
                open(os.path.join(te, f), "rb") as fb:
            pa, pb = pickle.load(fa), pickle.load(fb)
        for k in vars(pa):
            np.testing.assert_array_equal(np.asarray(getattr(pb, k)),
                                          np.asarray(getattr(pa, k)))

    ji, ti = str(tmp_path / "ji"), str(tmp_path / "ti")
    jcli.bundle_main(["import-ref", "--sidecars", je, "--out", ji,
                      "--block-size", "16"])
    tcli.bundle_main(["import-ref", "--sidecars", je, "--out", ti,
                      "--block-size", "16", "--platform", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].replace(ti, "*") == out[0].replace(ji, "*")
    assert _files(ti) == _files(ji)
    with open(os.path.join(ji, "manifest.json")) as f:
        mj = json.load(f)
    with open(os.path.join(ti, "manifest.json")) as f:
        assert json.load(f) == mj
    with np.load(os.path.join(ji, "arrays.npz")) as a, \
            np.load(os.path.join(ti, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])

    jcli.bundle_main(["info", "--bundle", ji])
    ref = capsys.readouterr().out
    tcli.bundle_main(["info", "--bundle", ji])
    assert capsys.readouterr().out == ref
