"""A configuration's own reference package and options, on the CPU: the
package it names is the one the check uses, its `surrogate` and
`geometry` keys reach both sides whole, a key either side does not take
fails the build, a package that loads the program is refused, and a
single-case cell rehearses end to end.

    python -m pytest -p no:cacheprovider cfdbench/tests -q
"""

from __future__ import annotations

import copy
import sys

import pytest
import torch

from cfdbench import check, run, spec, traffic
from cfdbench.tests.reference_recording import geometry as rec_geometry
from cfdbench.tests.reference_recording import pipeline as rec_pipeline

CELL = "cyl512_hybrid.fleet16"


def _cell(**config_keys):
    """The cell's files, with `config_keys` over its configuration."""
    entry, conf, config, wl = spec.cell(CELL)
    config = copy.deepcopy(config)
    for k, v in config_keys.items():
        if isinstance(v, dict) and isinstance(config.get(k), dict):
            config[k] = {**config[k], **v}
        else:
            config[k] = v
    return entry, conf, config, wl


def _rehearse(monkeypatch, files, seed=7, traced=False):
    monkeypatch.setattr(spec, "cell", lambda name: files)
    torch.set_num_threads(1)
    return run.run_cell(CELL, seed, 0.0, traced, "cpu", rehearse=True)


def test_a_named_package_is_the_reference_and_the_options_reach_it(
        monkeypatch):
    # the frozen reference re-exported, its predictor and geometry
    # factories recording; the options' values are the defaults, so the
    # gaps are those of the frozen reference (all nought on the CPU)
    rec_pipeline.calls.clear()
    rec_geometry.calls.clear()
    files = _cell(reference="tests.reference_recording",
                  surrogate={"near_wall_dist": 0.05},
                  geometry={"cy": 1.0, "u_mean": 1.0})
    out = _rehearse(monkeypatch, files)
    assert out["correct"]
    assert all(v == 0.0 for k, (v, _) in out["checks"].items()
               if k.endswith("_gap"))
    assert rec_pipeline.calls and all(
        c == {"stitch": "lstsq", "precision": "f32", "near_wall_dist": 0.05}
        for c in rec_pipeline.calls)
    assert rec_geometry.calls and all(
        c["cy"] == 1.0 and c["u_mean"] == 1.0 for c in rec_geometry.calls)


def test_without_a_reference_key_the_frozen_reference_is_used():
    ref = spec.reference(spec.cell(CELL)[2])
    assert ref.pipeline.__name__ == "cfdbench.reference.pipeline"
    assert ref.engine.__name__ == "cfdbench.reference.engine"


def _members(config):
    wl = {**spec.cell(CELL)[3], **run.REHEARSAL["mix"]}
    return wl, traffic.cases(wl, 3)[:1]


def _rehearsal_config(**keys):
    config = _cell(**keys)[2]
    config["grid"] = {**config["grid"], **run.REHEARSAL["grid"]}
    return config


def test_the_options_reach_the_program():
    config = _rehearsal_config(surrogate={"near_wall_dist": 0.2},
                               geometry={"cy": 0.9})
    wl, members = _members(config)
    prog = run.Program(config, wl, members, "cpu")
    assert prog.predictor.near_wall_dist == 0.2
    # the obstacle's centre row: 0.9 up the channel of height 2
    ny = config["grid"]["ny"]
    rows = torch.nonzero(prog.case.fluid[0] == 0)[:, 0].float()
    assert abs(float(rows.mean()) + 0.5 - 0.9 / 2.0 * ny) < 1.0


@pytest.mark.parametrize("key", ["surrogate", "geometry"])
def test_an_unknown_key_fails_the_build_on_both_sides(key):
    config = _rehearsal_config(**{key: {"no_such_option": 1}})
    wl, members = _members(config)
    with pytest.raises(TypeError, match="no_such_option"):
        run.Program(config, wl, members, "cpu")
    ref = spec.reference(config)
    bundle = ref.pipeline.SurrogateBundle.load(
        f"{spec.ROOT}/{config['surrogate']['bundle']}", device="cpu")
    with pytest.raises(TypeError, match="no_such_option"):
        check._Reference(config, ref, *members[0], "cpu", bundle, False)


def test_a_reference_that_loads_the_program_is_refused():
    before = set(sys.modules)
    with pytest.raises(SystemExit, match="tpufoam_torch"):
        spec.reference({"reference": "tests.reference_loads_program"})
    assert "cfdbench.tests.reference_loads_program" not in (
        set(sys.modules) - before)
    for bad in ("no_such_package", "../reference", "reference;x"):
        with pytest.raises(SystemExit):
            spec.reference({"reference": bad})


def test_a_single_case_cell_rehearses_end_to_end(monkeypatch):
    entry, conf, config, wl = spec.cell(CELL)
    wl = {**wl, "entry": "single", "classes": ["cylinder"],
          "check_cases_per_class": 1}
    out = _rehearse(monkeypatch, (entry, conf, config, wl), seed=11,
                    traced=True)
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] == run.REHEARSAL["mix"]["trace_steps"]
    m = out["metrics"]
    assert m["host_reads_per_step"]["value"] > 0
    assert 0 < m["host_busy_share"]["value"] <= 100
    assert 0 <= m["rescue_useful_share"]["value"] <= 100
    assert m["graph_replay_share"]["value"] == 0.0   # no CUDA graphs
