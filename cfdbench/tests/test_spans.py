"""The reduction of the program's spans (`cfdbench/spans.py`) on made-up
events, the trace's own readings unmoved by them (`cfdbench/trace.py`),
the per-layer readers of spans and counters on made-up readings, and a
CPU rehearsal of `cfdbench/span_probe.py`: the program's counters are
read, and no device number is printed without a device.

    python -m pytest -p no:cacheprovider cfdbench/tests -q
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from cfdbench import run, span_probe, spans, trace

STEP = "tpufoam_torch.piso.step"
A = "tpufoam_torch.fv.momentum_assembly"
B = "tpufoam_torch.solvers.pressure"
READ = "tpufoam_torch.host_read"


def _events():
    """One thread's spans (step 0-100 holding A 10-40 and B 50-90, B
    holding a host read 60-70), a host range of the benchmark, and five
    launches (runtime calls with correlation ids 1-5): at 5 (the step's
    own), 20 (A), 55 (B), 95 (the step's own) and 150 (no span)."""
    cpu = [(0, 100, STEP, 7, 0, 0), (10, 40, A, 7, 0, 0),
           (50, 90, B, 7, 0, 0), (60, 70, READ, 7, 0, 0),
           (0, 200, "cfdbench.entry", 7, 0, 0)]
    cpu += [(t, t + 1, "cudaLaunchKernel", 7, c, 0)
            for c, t in ((1, 5), (2, 20), (3, 55), (4, 95), (5, 150))]
    # device intervals: 1000-1010, 1010-1030, 1100-1150 (a gap of 70
    # before it), 1150-1160, 1300-1400 (a gap of 140 before it)
    kernels = [(1000, 1010, "k1", 1, 0), (1010, 1030, "k2", 2, 0),
               (1100, 1150, "k3", 3, 0), (1150, 1160, "k4", 4, 0),
               (1300, 1400, "k5", 5, 0)]
    return cpu, kernels


def test_span_device_time_is_inclusive_and_self():
    out = spans.reduce(*_events())
    s = out["spans"]
    assert s[STEP] == {"launches": 4, "device_s": 90e-9, "self_s": 20e-9}
    assert s[A] == {"launches": 1, "device_s": 20e-9, "self_s": 20e-9}
    assert s[B] == {"launches": 1, "device_s": 50e-9, "self_s": 50e-9}
    assert READ not in s
    assert out["outside"] == {"launches": 1, "device_s": 100e-9}
    assert spans.launched_in(*_events(), "cfdbench.entry") == (5, 5)
    assert spans.launched_in(*_events(), STEP) == (4, 5)


def test_idle_gaps_are_named_by_the_innermost_span_at_their_middle():
    cpu, kernels = _events()
    # the gap 1030-1100 has its middle at 1065; put the host's clock there
    # inside the host read (60-70) by shifting the device intervals
    shifted = [(s - 1000, e - 1000, n, c, l) for s, e, n, c, l in kernels]
    out = spans.reduce(cpu, shifted)
    # gaps: 30-100 (middle 65: the host read), 160-300 (middle 230: none)
    assert out["idle_gaps_by_span"] == [["none", 140e-9], [READ, 70e-9]]


def test_without_program_spans_every_launch_is_outside():
    cpu, kernels = _events()
    cpu = [c for c in cpu if not c[2].startswith("tpufoam_torch.")]
    out = spans.reduce(cpu, kernels)
    assert out["spans"] == {}
    assert out["outside"]["launches"] == 5


def test_a_cpu_rehearsal_reads_the_counters_and_no_device_time(capsys):
    assert span_probe.main(["--workload", "cyl512_hybrid.fleet16",
                            "--seed", "2147483659", "--device", "cpu",
                            "--rehearse", "--rounds", "2",
                            "--steps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    m = out["metrics"]
    assert m["host_reads_per_step"] > 0
    assert 0 < m["host_busy_share"] <= 100
    assert "fv_device_ms_per_step" not in m
    assert "safeguard_device_ms_per_step" not in m
    assert "sync" not in out
    table = out["overhead"]["span_table_per_step"]
    assert {"piso.step", "piso.dt", "surrogate.predict",
            "fv.momentum_assembly", "fv.momentum_solve",
            "fv.pressure_assembly", "solvers.pressure", "fv.correct",
            "host_read"} <= set(table)
    assert table["piso.step"]["count"] == 1
    assert out["traced"]["launches_per_step"] == 0
    assert out["cycles_check"]["v_cycles_per_step"] == (
        out["cycles_check"]["backend_cycles"]
        * (out["cycles_check"]["n_correctors"]
           + out["cycles_check"]["rescue_solves_per_step"]))


class _Event:
    """A kineto event as `spans.events` reads it."""

    def __init__(self, device, s, e, name, tid=7, corr=0, linked=0):
        self.row = (device, s, e, name, tid, corr, linked)

    def device_type(self):
        return self.row[0]

    def start_ns(self):
        return self.row[1]

    def end_ns(self):
        return self.row[2]

    def name(self):
        return self.row[3]

    def start_thread_id(self):
        return self.row[4]

    def correlation_id(self):
        return self.row[5]

    def linked_correlation_id(self):
        return self.row[6]


def _profile(cpu, kernels, annotations=()):
    """A finished profile of the host events, the kernels and the user
    annotations (name, start, end) that ranges put on the device side."""
    cpu_t, cuda_t = (torch.autograd.DeviceType.CPU,
                     torch.autograd.DeviceType.CUDA)
    evs = [_Event(cpu_t, *c) for c in cpu]
    evs += [_Event(cuda_t, s, e, n, 0, c, l) for s, e, n, c, l in kernels]
    evs += [_Event(cuda_t, s, e, n) for n, s, e in annotations]
    results = SimpleNamespace(events=lambda: evs)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_the_programs_spans_move_none_of_the_traces_own_readings():
    cpu, kernels = _events()
    # a host operation inside the host read, where the gap's middle falls
    cpu = cpu + [(62, 68, "aten::item", 7, 9, 0)]
    kernels = [(s - 1000, e - 1000, n, c, l) for s, e, n, c, l in kernels]
    # the device side of each range: a user annotation, no kernel
    notes = [(c[2], c[0] + 2000, c[1] + 2000) for c in cpu
             if c[2].startswith(("tpufoam_torch.", "cfdbench."))]
    on = trace.read(_profile(cpu, kernels, notes))
    off = trace.read(_profile(
        [c for c in cpu if not c[2].startswith("tpufoam_torch.")], kernels,
        [n for n in notes if n[0].startswith("cfdbench.")]))
    for k in ("launches", "busy_s", "range_s", "device_ops", "idle_gaps"):
        assert on[k] == off[k], k
    assert on["launches"] == 5
    assert on["idle_gaps"] == [["none", 140e-9], ["aten::item", 70e-9]]
    assert on["spans"][STEP]["device_s"] == 90e-9 and off["spans"] == {}
    assert on["idle_gaps_by_span"] == [["none", 140e-9], [READ, 70e-9]]


def test_the_span_and_counter_readers_on_made_up_readings():
    p = "tpufoam_torch."
    # two steps: dt 2-8, momentum assembly 10-40, the safeguard 50-90
    # (a host read 60-70 in it), the correction 92-99; launches in each
    # (10, 20, 50 and 10 ns of device time) and one outside (100 ns)
    cpu = [(0, 100, STEP, 7, 0, 0), (2, 8, p + "piso.dt", 7, 0, 0),
           (10, 40, A, 7, 0, 0), (50, 90, p + "piso.safeguard", 7, 0, 0),
           (60, 70, READ, 7, 0, 0), (92, 99, p + "fv.correct", 7, 0, 0)]
    cpu += [(t, t + 1, "cudaLaunchKernel", 7, c, 0)
            for c, t in ((1, 5), (2, 20), (3, 55), (4, 95), (5, 150))]
    kernels = [(1000, 1010, "k1", 1, 0), (1010, 1030, "k2", 2, 0),
               (1100, 1150, "k3", 3, 0), (1150, 1160, "k4", 4, 0),
               (1300, 1400, "k5", 5, 0)]
    d = {"steps": 2, "cases": 4,
         "spans": spans.reduce(cpu, kernels)["spans"],
         "counters": {"steps": 5, "host_reads": 15, "rescue_solves": 3,
                      "rescue_cases": 6, "predictor_calls": 5,
                      "graph_replays": 20},
         "span_host": {"steps": 2, "step_s": 0.25, "spans": {
             STEP: {"count": 2, "host_s": 0.4, "self_s": 0.1},
             READ: {"count": 6, "host_s": 0.1, "self_s": 0.1}}}}
    names = ("fv_device_ms_per_step", "safeguard_device_ms_per_step",
             "rescue_useful_share", "host_reads_per_step",
             "host_busy_share", "graph_replay_share")
    got = {n: r(d) for n, r in run._readers(list(names)).items()}
    assert got == pytest.approx({
        "fv_device_ms_per_step": 40e-9 * 1e3 / 2,
        "safeguard_device_ms_per_step": 50e-9 * 1e3 / 2,
        "rescue_useful_share": 100.0 * 6 / (3 * 4),
        "host_reads_per_step": 3.0,
        "host_busy_share": 100.0 * (0.4 - 0.1) / 2 / 0.25,
        "graph_replay_share": 100.0})
    # no rescue: none wasted; no kernels in the step: no device readings
    d["counters"]["rescue_solves"] = d["counters"]["rescue_cases"] = 0
    d["spans"] = {}
    got = {n: r(d) for n, r in run._readers(list(names)).items()}
    assert got["rescue_useful_share"] == 100.0
    assert got["fv_device_ms_per_step"] is None
    assert got["safeguard_device_ms_per_step"] is None
