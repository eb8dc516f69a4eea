"""The port's in-program tracing (`utils/profiling.py`) on the CPU.

- `span` off is one shared null context: nothing recorded, no
  `record_function` entered, even inside a profiler session;
- on, `span_table` counts calls and takes host and self time from the
  stack of open spans;
- `host_read` and `host_upload` count every call, spans on or off;
- a traced lockstep writes the step's spans into a `profiling.trace`
  file;
- `_rescue_if_unconverged.cases` adds, per rescue solve, the cases it
  served;
- every host read and host upload of a lockstep goes through `host_read`
  or `host_upload` (tensor reads and uploads outside them counted by
  patching the tensor's read methods and `torch.as_tensor`).
"""

import dataclasses
import glob
import json
import sys

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_bundle
from test_torch_piso import bundle_to_torch
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv import case as tcase
from tpufoam_torch.fv.pressure import pressure_coeffs, pressure_matvec
from tpufoam_torch.piso import batched as tbat
from tpufoam_torch.piso import engine as teng
from tpufoam_torch.solvers.backends import MGBackend
from tpufoam_torch.surrogate import blocks as tblocks
from tpufoam_torch.surrogate.pipeline import make_predictor
from tpufoam_torch.utils import profiling

# the spans one hybrid lockstep with a rescue opens
STEP_SPANS = {"tpufoam_torch.piso.step", "tpufoam_torch.piso.dt",
              "tpufoam_torch.surrogate.predict",
              "tpufoam_torch.fv.momentum_assembly",
              "tpufoam_torch.fv.momentum_solve",
              "tpufoam_torch.fv.pressure_assembly",
              "tpufoam_torch.solvers.pressure",
              "tpufoam_torch.piso.safeguard", "tpufoam_torch.fv.correct",
              "tpufoam_torch.host_read"}
CFG = teng.PisoConfig(n_correctors=2, max_dt=2e-3,
                      momentum_smoother="kernel")


@pytest.fixture(autouse=True)
def _spans_left_off():
    torch.set_num_threads(1)
    profiling.reset_spans()
    yield
    profiling.enable_spans(False)
    profiling.reset_spans()


@pytest.fixture(scope="module")
def fleet():
    """Two stacked cases (cylinder, triangle) at 24 x 72 and their
    initial flows."""
    cases = [tcase.build_channel_case(channel_case_geometry(
        shape, length=3.0, height=1.0, obstacle_size=0.3), delta=1 / 24,
        device="cpu") for shape in ("cylinder", "triangle")]
    flows = [tcase.initial_flow(c, dt0=2e-3) for c in cases]
    return tbat.stack_cases(cases), tbat.stack_flows(flows)


class _FirstSolveFails:
    """MGBackend(cycles=2) whose first solve of each lockstep is NaN in
    the last case: the safeguard then rescues that case."""

    def __init__(self):
        self.mg, self.calls = MGBackend(cycles=2), 0

    def __call__(self, case, coef, rhs, p_prev, aux):
        self.calls += 1
        p = self.mg(case, coef, rhs, p_prev, aux)
        if self.calls == 1:
            p = p.clone()
            p[-1] = float("nan")
        return p


def _keep_pressure(case, p_prev, aux):
    return p_prev


def _lockstep(fleet, predict=_keep_pressure):
    case, flow = fleet
    return tbat.run_piso_batched_eager(case, flow, 1, cfg=CFG,
                                       backend=_FirstSolveFails(),
                                       sm_predict=predict)


def test_spans_off_record_nothing_and_open_no_profiler_range(fleet,
                                                             monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("tpufoam_torch.a") is profiling.span(
        "tpufoam_torch.b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _lockstep(fleet)
    assert profiling.span_table() == {}


def test_span_table_nests_counts_and_takes_self_time(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.enable_spans(True) is False
    for _ in range(2):
        with profiling.span("tpufoam_torch.outer"):
            x = torch.ones(64, 64)
            with profiling.span("tpufoam_torch.inner"):
                x = x @ x
                with profiling.span("tpufoam_torch.leaf"):
                    x.sum()
            with profiling.span("tpufoam_torch.inner"):
                x = x @ x
    t = profiling.span_table()
    assert {k: v["count"] for k, v in t.items()} == {
        "tpufoam_torch.outer": 2, "tpufoam_torch.inner": 4,
        "tpufoam_torch.leaf": 2}
    outer, inner, leaf = (t[f"tpufoam_torch.{n}"]
                          for n in ("outer", "inner", "leaf"))
    assert leaf["self_s"] == leaf["host_s"] > 0
    # a span's self time is its time less its children's
    assert inner["self_s"] == pytest.approx(
        inner["host_s"] - leaf["host_s"], abs=1e-9)
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert 0 < outer["self_s"] < outer["host_s"]
    profiling.reset_spans()
    assert profiling.span_table() == {}
    assert profiling.enable_spans(False) is True


def test_a_profiler_session_sees_the_spans_only_when_on():
    acts = [torch.profiler.ProfilerActivity.CPU]
    names = {}
    for on in (False, True):
        profiling.enable_spans(on)
        with torch.profiler.profile(activities=acts) as prof:
            with profiling.span("tpufoam_torch.region"):
                torch.ones(8).sum()
        names[on] = {e.name for e in prof.events()}
    assert "tpufoam_torch.region" not in names[False]
    assert "tpufoam_torch.region" in names[True]


@pytest.mark.parametrize("on", [False, True])
def test_host_read_and_host_upload_count_every_call(on):
    profiling.enable_spans(on)
    n0 = profiling.host_read.count
    flag = profiling.host_read(torch.tensor(True))
    total = profiling.host_read(torch.arange(5).sum())
    verdicts = profiling.host_read(torch.tensor([True, False]))
    index = profiling.host_upload(np.array([2, 0, 1]), "cpu")
    assert flag is True and total == 10 and isinstance(total, int)
    assert isinstance(verdicts, torch.Tensor) and verdicts.tolist() == [
        True, False]
    assert torch.equal(index, torch.tensor([2, 0, 1]))
    assert profiling.host_read.count == n0 + 4
    reads = profiling.span_table().get("tpufoam_torch.host_read")
    assert (reads["count"] if reads else 0) == (4 if on else 0)


def test_a_traced_lockstep_writes_the_program_spans(fleet, tmp_path):
    profiling.enable_spans(True)
    solves = teng._rescue_if_unconverged.solves
    with profiling.trace(str(tmp_path / "tr")):
        _lockstep(fleet)
    assert teng._rescue_if_unconverged.solves > solves
    table = profiling.span_table()
    assert set(table) == STEP_SPANS
    assert all(n.startswith(profiling.PREFIX) for n in table)
    assert table["tpufoam_torch.piso.step"]["count"] == 1
    assert table["tpufoam_torch.fv.pressure_assembly"]["count"] == 2
    # two correctors' solves and the rescue's
    assert table["tpufoam_torch.solvers.pressure"]["count"] == 2 + (
        teng._rescue_if_unconverged.solves - solves)
    files = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert STEP_SPANS <= names


class _NaNBackend:
    """A pressure backend whose every solve is NaN: no rescue clears the
    gate, so the safeguard runs all its solves."""

    calls = 0

    def __call__(self, case, coef, rhs, p_prev, aux):
        self.calls += 1
        return p_prev * float("nan")


@pytest.mark.parametrize("failing", [(1,), (0, 1)])
def test_rescue_cases_count_the_cases_each_solve_serves(fleet, failing):
    case, _ = fleet
    rng = np.random.default_rng(4)
    rau = torch.as_tensor(rng.uniform(0.5, 1.5, case.fluid.shape).astype(
        np.float32)) * 1e-4 * case.fluid
    pcoef = pressure_coeffs(case, rau)
    p_true = torch.as_tensor(rng.standard_normal(case.fluid.shape).astype(
        np.float32)) * case.fluid
    rhs = pressure_matvec(pcoef, p_true)
    cand = p_true.clone()
    cand[list(failing)] = float("nan")
    rescue = teng._rescue_if_unconverged
    solves, cases = rescue.solves, rescue.cases
    backend = _NaNBackend()
    rescue(case, pcoef, rhs, cand, torch.zeros_like(cand), backend, {},
           CFG)
    assert rescue.solves - solves == backend.calls == CFG.sm_safeguard_extra
    assert rescue.cases - cases == len(failing) * backend.calls
    # a healthy candidate: no solve, no case
    rescue(case, pcoef, rhs, p_true, torch.zeros_like(cand), backend, {},
           CFG)
    assert (rescue.solves - solves, rescue.cases - cases) == (
        CFG.sm_safeguard_extra, len(failing) * CFG.sm_safeguard_extra)


_READS = ("item", "cpu", "numpy", "tolist", "__bool__", "__float__",
          "__int__", "__index__")


def _count_raw_transfers(monkeypatch) -> list:
    """Patch the tensor's read methods and `torch.as_tensor` with a
    device: each call made from anywhere but utils.profiling's
    host_read / host_upload is appended to the returned list as
    (method, file, line)."""
    allowed = {profiling._host_value.__code__,
               profiling.host_upload.__code__}
    outside = []

    def note(name):
        f = sys._getframe(2)
        if f.f_code not in allowed:
            outside.append((name, f.f_code.co_filename, f.f_lineno))

    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def read(self, *a, _orig=orig, _name=name, **k):
            note(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, read)
    as_tensor = torch.as_tensor

    def upload(data, *a, **k):
        if "device" in k or len(a) > 1:
            note("as_tensor")
        return as_tensor(data, *a, **k)
    monkeypatch.setattr(torch, "as_tensor", upload)
    return outside


def test_every_host_read_of_a_forced_rescue_lockstep_is_counted(
        fleet, monkeypatch):
    rescue = teng._rescue_if_unconverged
    solves, n0 = rescue.solves, profiling.host_read.count
    outside = _count_raw_transfers(monkeypatch)
    _lockstep(fleet)
    monkeypatch.undo()
    n_solves = rescue.solves - solves
    assert n_solves >= 1
    assert outside == []
    # the gate's read, then one for each further round the rescue took
    # (a round that clears the gate reads and solves no more)
    expected = 1 + min(n_solves, CFG.sm_safeguard_extra - 1)
    assert profiling.host_read.count - n0 == expected


def test_the_predictors_host_transfers_are_counted(fleet, monkeypatch):
    """The lstsq predictor's uploads on a real bundle's blocks go through
    host_upload too, and are the block layout's constants: on a fresh
    layout the bind uploads its index arrays and the first lockstep the
    blend window and weights, once; a second lockstep uploads nothing."""
    case, _ = fleet
    for cache in (tblocks.layout_indices, tblocks.stitch_indices,
                  tblocks._blend_constants):
        cache.cache_clear()
    rescue = teng._rescue_if_unconverged
    n0 = profiling.host_read.count
    pred = make_predictor(bundle_to_torch(_tiny_bundle(block_size=16)),
                          stitch="lstsq").bind(case)
    layout = tblocks.build_block_layout(*case.fluid.shape[-2:], 16)
    idx = tblocks.stitch_indices(layout, case.device)
    # inv, order, ka and kb of each pair group, ia, ib, incidence
    assert profiling.host_read.count - n0 == 5 + 2 * len(idx["pairs"])
    outside = _count_raw_transfers(monkeypatch)
    uploads = []
    for _ in range(2):
        solves, n0 = rescue.solves, profiling.host_read.count
        _lockstep(fleet, pred)
        n_rescue = (0 if rescue.solves == solves else
                    min(rescue.solves - solves, CFG.sm_safeguard_extra - 1))
        # less the gate's read and the rescue's
        uploads.append(profiling.host_read.count - n0 - 1 - n_rescue)
    monkeypatch.undo()
    assert outside == []
    assert uploads == [2, 0]
    assert tblocks.stitch_indices(layout, case.device) is idx


def test_the_scan_stitch_reads_and_uploads_through_the_counter(
        fleet, monkeypatch):
    case, flow = fleet
    pred = make_predictor(bundle_to_torch(_tiny_bundle(block_size=16)),
                          stitch="scan").bind(case)
    aux = {f.name: getattr(flow, f.name) for f in dataclasses.fields(flow)}
    outside = _count_raw_transfers(monkeypatch)
    with torch.no_grad():
        p = pred(case, flow.p, aux)
    monkeypatch.undo()
    assert outside == [] and bool(torch.isfinite(p).all())


@pytest.mark.parametrize("shape", [(), (16,), (300,)])
def test_the_rescue_counts_a_verdict_in_one_reduction(shape):
    g = torch.Generator().manual_seed(sum(shape) + 1)
    mask = torch.rand(shape, generator=g) < 0.4
    n = teng._count(mask)
    assert int(n) == int(mask.sum())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        teng._count(mask)
    ops = [e.name for e in prof.events()]
    # below 256 cases no cast of the verdict before its sum
    assert ops.count("aten::sum") == 1
    assert ("aten::to" in ops) == (mask.numel() >= 256)


def test_spans_of_concurrent_threads_keep_their_own_stacks():
    """Threads (the bridge server steps one connection each) nest their
    spans apart: a leaf's self time stays its whole time and no update
    of the table is lost, under a short switch interval."""
    import threading

    profiling.enable_spans(True)
    n_threads, n_iter = 16, 300

    def work():
        for _ in range(n_iter):
            with profiling.span("tpufoam_torch.outer"):
                with profiling.span("tpufoam_torch.leaf"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    t = profiling.span_table()
    assert t["tpufoam_torch.outer"]["count"] == n_threads * n_iter
    assert t["tpufoam_torch.leaf"]["count"] == n_threads * n_iter
    assert t["tpufoam_torch.leaf"]["self_s"] == t["tpufoam_torch.leaf"][
        "host_s"]
    assert t["tpufoam_torch.outer"]["self_s"] == pytest.approx(
        t["tpufoam_torch.outer"]["host_s"] - t["tpufoam_torch.leaf"][
            "host_s"], abs=1e-6)
