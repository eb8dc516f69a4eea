"""The port's `utils/plotting.py`, `utils/determinism.py` and
`utils/profiling.py`, on the CPU.

- plotting: the arrays that reach `plot_fields` from `save_eval_plots`
  in each package, on one float32-compute bundle, case and frames: the
  mask exact, the fields to rel 1e-5 (max |port - JAX| / max |JAX|: the
  predictor's float32 products and stitch in another order, as
  tests/test_torch_dataset.py holds `evaluate_bundle`); the PNGs, the GIF
  and the loss curve's text (byte for byte as JAX's) are written.
- determinism: every host generator and PyTorch's are seeded, the
  deterministic-algorithm request is on in warn-only mode (an op with no
  deterministic form still runs); the process state is restored after.
- profiling: StageTimer's totals and report, a torch.profiler trace file
  with an annotated region, and memory_report's host keys (no `device_i`
  without a card).
"""

import dataclasses
import glob
import json
import os
import random

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv import case as jcase
from tpufoam.utils import plotting as jplot
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.surrogate.pipeline import SurrogateBundle
from tpufoam_torch.utils import determinism, profiling
from tpufoam_torch.utils import plotting as tplot

PLOT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _eval_inputs(tmp_path):
    kw = dict(shape_name="cylinder", length=4.0, height=1.0,
              obstacle_size=0.25, nu=8e-3)
    jc = jcase.build_channel_case(jax_geom(**kw), delta=1 / 32)
    tc = tcase.build_channel_case(channel_case_geometry(**kw), delta=1 / 32,
                                  device="cpu")
    jb = _tiny_bundle(block_size=16)
    jb = dataclasses.replace(jb, mdef=dataclasses.replace(
        jb.mdef, compute_dtype="float32"))
    jb.save(str(tmp_path / "b"))
    tb = SurrogateBundle.load(str(tmp_path / "b"), device="cpu")
    rng = np.random.default_rng(0)
    frames = [{k: rng.standard_normal((32, 128)).astype(np.float32)
               for k in ("u", "v", "p", "u_prev", "v_prev", "p_prev")}
              for _ in range(2)]
    return jc, tc, jb, tb, frames


def test_eval_plots_match_jax(tmp_path, monkeypatch):
    jc, tc, jb, tb, frames = _eval_inputs(tmp_path)
    seen = {"j": [], "t": []}
    for mod, tag in ((jplot, "j"), (tplot, "t")):
        monkeypatch.setattr(
            mod, "plot_fields",
            lambda fields, mask, path, suptitle="", tag=tag: seen[tag].append(
                ({k: np.asarray(v) for k, v in fields.items()},
                 np.asarray(mask), os.path.relpath(path, tmp_path / tag),
                 suptitle)))
        monkeypatch.setattr(mod, "create_gif", lambda *a, **k: None)
    jplot.save_eval_plots(jc, jb, frames, str(tmp_path / "j"), sim=2)
    tplot.save_eval_plots(tc, tb, [{k: torch.tensor(v) for k, v in f.items()}
                                   for f in frames],
                          str(tmp_path / "t"), sim=2)
    assert len(seen["t"]) == len(seen["j"]) == 2
    for (tf, tm, tp_, ts), (jf, jm, jp_, js) in zip(seen["t"], seen["j"]):
        assert (tp_, ts) == (jp_, js) and list(tf) == list(jf)
        np.testing.assert_array_equal(tm, jm)
        for k in jf:
            err = np.abs(tf[k] - jf[k]).max()
            assert err <= PLOT_TOL * np.abs(jf[k]).max(), k
    monkeypatch.undo()
    out = str(tmp_path / "real")
    tplot.save_eval_plots(tc, tb, [{k: torch.tensor(v) for k, v in f.items()}
                                   for f in frames[:1]], out)
    assert sorted(os.listdir(os.path.join(out, "sim0"))) \
        == ["p_movie.gif", "p_pred_t0.png"]


def test_loss_history_and_block_panels(tmp_path):
    hist, val = [3.0, 2.0, 1.5], [4.0, 3.5, 3.0]
    tplot.plot_loss_history(hist, torch.tensor(val), str(tmp_path / "t"))
    jplot.plot_loss_history(hist, val, str(tmp_path / "j"))
    assert open(tmp_path / "t_loss.txt", "rb").read() \
        == open(tmp_path / "j_loss.txt", "rb").read()
    assert os.path.getsize(tmp_path / "t_loss.png") > 0
    rng = np.random.default_rng(1)
    blocks = torch.tensor(rng.standard_normal((12, 8, 8)), dtype=torch.float32)
    tplot.plot_random_blocks(blocks, blocks + 1, torch.ones(12, 8, 8),
                             str(tmp_path / "panels" / "b.png"))
    assert os.path.getsize(tmp_path / "panels" / "b.png") > 0


def test_enable_determinism_seeds_everything(monkeypatch):
    for k in ("PYTHONHASHSEED", "CUBLAS_WORKSPACE_CONFIG"):
        monkeypatch.delenv(k, raising=False)
    bench = torch.backends.cudnn.benchmark
    try:
        determinism.enable_determinism(11)
        assert os.environ["PYTHONHASHSEED"] == "11"
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        assert not torch.backends.cudnn.benchmark
        a = (random.random(), np.random.rand(), torch.rand(()).item())
        random.seed(11)
        np.random.seed(11)
        torch.manual_seed(11)
        assert a == (random.random(), np.random.rand(), torch.rand(()).item())
        x = torch.zeros(4).index_add_(0, torch.tensor([0, 0, 3]),
                                      torch.ones(3))
        assert x.tolist() == [2.0, 0.0, 0.0, 1.0]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = bench


def test_stage_timer_trace_and_memory_report(tmp_path):
    timer = profiling.StageTimer()
    x = torch.ones(64, 64)
    for _ in range(3):
        with timer("matmul", block_on={"y": [x @ x]}):
            x @ x
    with timer("other"):
        pass
    assert timer.counts == {"matmul": 3, "other": 1}
    assert timer.report().splitlines()[0].startswith("matmul")
    assert profiling._cuda_devices({"a": [x], "b": (x, 3)}) == set()
    timer.reset()
    assert not timer.totals

    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("my_region"):
            (x @ x).sum()
    files = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "my_region" in names

    rep = profiling.memory_report()
    assert rep["host_total_kb"] > 0 and rep["host_available_kb"] > 0
    assert not [k for k in rep if k.startswith("device_")]
