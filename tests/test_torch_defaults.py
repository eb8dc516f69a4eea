"""Every default of the port equals the JAX package's.

For each public function and dataclass of `tpufoam_torch` whose
counterpart of the same module path and name in `tpufoam` has a
parameter (or field) of the same name, and where both give it a default,
the two defaults are equal. The port names the JAX package's smoother
values differently, so "xla", "pallas" and "pallas-fused" compare equal to
"plain", "kernel" and "kernel-fused". A default that is itself a
dataclass instance (a config, a backend) compares by its class name and by
the defaults of the fields both classes have.
"""

import dataclasses
import importlib
import inspect
import pkgutil

import pytest

import tpufoam_torch

SMOOTHER_NAMES = {"xla": "plain", "pallas": "kernel",
                  "pallas-fused": "kernel-fused"}


def _defaults(obj) -> dict:
    if inspect.isclass(obj) and dataclasses.is_dataclass(obj):
        return {f.name: f.default for f in dataclasses.fields(obj)
                if f.default is not dataclasses.MISSING}
    try:
        params = inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return {}
    return {k: p.default for k, p in params.items()
            if p.default is not inspect.Parameter.empty}


def _same(port, ref) -> bool:
    if isinstance(ref, str):
        return port == SMOOTHER_NAMES.get(ref, ref)
    if dataclasses.is_dataclass(ref) and not isinstance(ref, type):
        if type(port).__name__ != type(ref).__name__:
            return False
        names = ({f.name for f in dataclasses.fields(port)}
                 & {f.name for f in dataclasses.fields(ref)})
        return all(_same(getattr(port, n), getattr(ref, n)) for n in names)
    return type(port) is type(ref) and port == ref


def _pairs():
    """(qualified name, port object, JAX object) of every public function
    and class of the port with a JAX counterpart."""
    for info in pkgutil.walk_packages(tpufoam_torch.__path__,
                                      "tpufoam_torch."):
        mod = importlib.import_module(info.name)
        try:
            jmod = importlib.import_module(
                "tpufoam" + info.name[len("tpufoam_torch"):])
        except ImportError:
            continue
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("_") or not (inspect.isfunction(obj)
                                            or inspect.isclass(obj)):
                continue
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            ref = getattr(jmod, name, None)
            if ref is not None:
                yield f"{info.name}.{name}", obj, \
                    getattr(ref, "__wrapped__", ref)


PAIRS = list(_pairs())


def test_the_walk_finds_the_entry_points():
    names = {n for n, _, _ in PAIRS}
    for entry in ("piso.engine.piso_step", "piso.engine.run_piso_eager",
                  "piso.engine.PisoConfig", "piso.batched.run_piso_batched",
                  "piso.batched.run_piso_batched_eager",
                  "fv.momentum.jacobi_momentum",
                  "fv.momentum.momentum_coeffs",
                  "piso.engine.run_piso_chunked",
                  "fv.case.save_flow", "fv.case.load_flow",
                  "fv.forces.obstacle_force",
                  "eval.benchmark.schafer_turek_case",
                  "eval.benchmark.run_force_series",
                  "eval.benchmark.load_run_state",
                  "eval.benchmark.summarize_2d3",
                  "surrogate.pipeline.make_predictor",
                  "solvers.backends.MGBackend",
                  "solvers.backends.AutoBackend"):
        assert f"tpufoam_torch.{entry}" in names, entry


def test_piso_config_has_the_ported_fields_only():
    """The fields of the Schaefer-Turek path and the sharded step's mesh
    are there, so the walk above compares their defaults; the options
    that are not ported have no field, so setting one raises instead of
    being ignored."""
    from tpufoam.piso.engine import PisoConfig as JaxConfig
    from tpufoam_torch.piso.engine import PisoConfig
    port = {f.name for f in dataclasses.fields(PisoConfig)}
    ref = {f.name for f in dataclasses.fields(JaxConfig)}
    assert {"adjust_dt", "convection", "convection_blend", "ddt",
            "inlet_scale_fn", "t_stop", "sm_trust", "shard_mesh"} <= port
    assert ref - port == {"sm_before_predictor", "turb_wall_fn", "ddt_corr",
                          "wall_order", "wall_link"}
    with pytest.raises(TypeError):
        PisoConfig(ddt_corr=True)


@pytest.mark.parametrize("name,port,ref", PAIRS, ids=[p[0] for p in PAIRS])
def test_defaults_equal_the_jax_packages(name, port, ref):
    pd, rd = _defaults(port), _defaults(ref)
    differ = {k: (pd[k], rd[k]) for k in pd.keys() & rd.keys()
              if not _same(pd[k], rd[k])}
    assert not differ, f"{name}: (port, JAX) defaults differ: {differ}"
