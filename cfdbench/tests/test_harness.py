"""The benchmark harness on the CPU: what it imports, that the manifest
resolves to files, that the work count is the kernel bounds' one, a
rehearsal run at a small grid, and that `correct` comes out false under
the control and under each fault the cells can have.

    python -m pytest -p no:cacheprovider cfdbench/tests -q
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from cfdbench import check, run, spec, traffic, work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "tpufoam"}


def _imports(path: str) -> set[str]:
    """Top-level names of the absolute imports of a source file."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = "") -> list[str]:
    out = []
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(
    p, HERE))
def test_nothing_imports_jax_or_the_jax_package(path):
    # whole top-level names: tpufoam_torch begins with tpufoam
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=lambda p: os.path.basename(p))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "tpufoam_torch" not in _imports(path)
    assert "cfdbench" not in _imports(path)


def test_every_cell_and_metric_resolves_to_its_files():
    m = spec.manifest()
    for c in m["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in m["workloads"]:
        entry, conf, config, params = spec.cell(w["name"])
        assert conf["name"] == w["config"] == config["name"]
        assert set(params["limits"]) == set(check.LIMITED)
        for kind in ("end_to_end", "per_layer"):
            assert spec.metrics_of(w["name"], kind)
    for x in m["per_layer"]:
        path = os.path.join(HERE, "metrics", f"{x['name']}.py")
        s = importlib.util.spec_from_file_location("metric", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        assert callable(mod.read)


def test_work_gives_the_kernel_bounds_bytes_at_512_x_2048():
    from tpufoam_torch.tools import kernel_bounds as kb
    ny, nx = 512, 2048
    assert work.level_shapes(ny, nx) == kb.level_shapes(ny, nx)
    for name in work.KERNELS:
        for dt, sweeps in kb.KERNELS[name][4].items():
            for shape in kb.level_shapes(ny, nx):
                want = kb.bound(name, shape, dt)
                n_bytes, ops = work.kernel_work(name, shape[0] * shape[1],
                                                dt, sweeps)
                assert n_bytes == want["bytes"]
                t = work.least_seconds(n_bytes, ops)
                assert t * 1e6 == pytest.approx(want["bound_us"], rel=1e-12)


def test_block_count_is_the_surrogate_layout():
    from cfdbench.reference.blocks import build_block_layout
    for ny, nx in ((128, 512), (512, 2048), (2048, 8192), (300, 700)):
        assert work.block_count(ny, nx, 128, 0.25) == len(
            build_block_layout(ny, nx, 128, 0.25).y0s)


def test_traffic_draws_each_class_from_its_list():
    wl = spec.cell("cyl512_hybrid.fleet16")[3]
    for seed in (0, 7, 2**31 + 11, 10**12 + 3):
        members = traffic.cases(wl, seed)
        assert members == traffic.cases(wl, seed)
        for shape in wl["classes"]:
            got = [size for c, size in members if c == shape]
            assert len(got) == wl["per_class"] == len(set(got))
            assert set(got) <= set(wl["sizes"][shape])


def test_an_unknown_backend_kind_is_refused():
    from cfdbench.reference import backends
    with pytest.raises(SystemExit):
        spec.backend(backends, {"kind": "CGBackend"})
    assert isinstance(spec.backend(backends, {"kind": "MGBackend",
                                              "cycles": 2}),
                      backends.MGBackend)


def _rehearse(**kw):
    torch.set_num_threads(1)
    return run.run_cell("cyl512_hybrid.fleet16", 7, 0.0, False, "cpu",
                        rehearse=True, **kw)


@pytest.fixture(scope="module")
def sound():
    return _rehearse()


def test_a_rehearsal_run_is_correct_and_well_formed(sound):
    assert sound["correct"] and sound["failed"] == 0
    assert sound["attempted"] % 4 == 0
    assert sound["attempted"] >= 4 * run.REHEARSAL["mix"]["min_steps"]
    assert list(sound)[:5] == ["correct", "attempted", "failed", "metrics",
                               "device"]
    assert set(sound["metrics"]) == {"cell_steps_per_s", "step_ms_p90",
                                     "peak_mem_GiB", "setup_s"}
    assert list(sound)[-2] == "checks"
    assert all(v == 0.0 for k, (v, _) in sound["checks"].items()
               if k.endswith("_gap"))


def test_a_traced_rehearsal_run_is_correct_and_well_formed():
    out = run.run_cell("cyl512_hybrid.fleet16", 8, 0.0, True, "cpu",
                       rehearse=True)
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] == 4 * run.REHEARSAL["mix"]["trace_steps"]
    names = {m["name"] for m in spec.metrics_of("cyl512_hybrid.fleet16",
                                                "per_layer")}
    # the CPU has no device kernels: the readers of device time are silent;
    # those of the program's counters and its spans' host times read
    assert set(out["metrics"]) <= names
    assert {"v_cycles_per_step", "rescue_useful_share",
            "host_reads_per_step", "host_busy_share",
            "graph_replay_share"} <= set(out["metrics"])
    assert not {"fv_device_ms_per_step", "safeguard_device_ms_per_step",
                "launches_per_step"} & set(out["metrics"])


def test_the_control_is_not_correct():
    # the reference with its state stored in bfloat16 in the program's
    # place
    out = _rehearse(control=True)
    assert not out["correct"]


def _break(fault):
    def hook(prog):
        step = prog.step

        def broken(flow, backend=None, predict=None):
            new = step(flow, backend, predict)
            return fault(flow, new)
        prog.step = broken
    return hook


def _half(old, new):
    """Half of the batch left out: its cases keep their state."""
    b = new.u.shape[0] // 2
    return dataclasses.replace(new, **{
        f.name: torch.cat([getattr(new, f.name)[:b],
                           getattr(old, f.name)[b:]])
        for f in dataclasses.fields(new)})


FAULTS = {
    "state_unchanged": lambda old, new: old,
    "half_the_batch_left_out": _half,
    "answer_altered": lambda old, new: dataclasses.replace(
        new, u=new.u * (1.0 + 1e-3)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(fault):
    assert not _rehearse(hooks=_break(FAULTS[fault]))["correct"]


def test_the_gates_catch_each_broken_guarantee():
    ny, nx = 4, 6
    fluid = torch.ones(2, ny, nx)
    gates = check.Gates(fluid, fluid, 0.1, 0.1)

    @dataclasses.dataclass
    class F:
        u: torch.Tensor
        v: torch.Tensor
        p: torch.Tensor
        phi_x: torch.Tensor
        phi_y: torch.Tensor
        dt: torch.Tensor
        t: torch.Tensor

    def flow(t, dt=0.01, nan=False, div=0.0):
        z = torch.zeros(2, ny, nx)
        phi_x = torch.full((2, ny, nx + 1), 0.1)
        phi_x[..., -1] += div
        u = z.clone()
        if nan:
            u[1, 0, 0] = float("nan")
        return F(u, z, z, phi_x, torch.zeros(2, ny + 1, nx),
                 torch.full((2,), dt), torch.full((2,), t))

    config = {"guarantees": {"max_co": 0.5}}
    ok = gates(flow(0.0), flow(0.01))
    assert check.gate_failures(ok[None], config)[0] == 0
    # a divergence is read beside the gates and fails none
    assert check.gate_failures(gates(flow(0.0), flow(0.01, div=1.0))[None],
                               config)[0] == 0
    # a NaN in the second case; in every case a Courant number of 10, or
    # time standing still
    for bad, n in ((flow(0.01, nan=True), 1), (flow(0.01, dt=1.0), 2),
                   (flow(0.0), 2)):
        assert check.gate_failures(gates(flow(0.0), bad)[None],
                                   config)[0] == n
