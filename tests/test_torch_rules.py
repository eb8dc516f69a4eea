"""Guards of the PyTorch port's boundary.

`tpufoam_torch/` and `chip_smoke.py` run on a machine that has no JAX:
they must import nothing of jax (or its libraries), of the JAX package
`tpufoam`, of `tests` or of `__graft_entry__`. And every entry point that
creates tensors defaults to the CUDA device.
"""

import ast
import importlib
import inspect
import pathlib
import pkgutil

import pytest
import torch

import tpufoam_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpufoam", "tests",
             "__graft_entry__"}
SOURCES = sorted((ROOT / "tpufoam_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", None)) in (
                                "import_module", "__import__"):
            yield node.lineno, node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_side_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom tpufoam.fv import case\n"
                 "importlib.import_module('jax.numpy')\n")
    assert [m for _, m in _imported_roots(f)] == ["os", "tpufoam", "jax"]


def _device_defaults():
    """(qualified name, default) of every `device=` parameter with a
    default in the package's functions and methods."""
    for info in pkgutil.walk_packages(tpufoam_torch.__path__,
                                      "tpufoam_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [obj] if inspect.isfunction(obj) else \
                [m for m in vars(obj).values()
                 if isinstance(m, (staticmethod, classmethod))
                 or inspect.isfunction(m)] if inspect.isclass(obj) else []
            for fn in fns:
                fn = getattr(fn, "__func__", fn)
                p = inspect.signature(fn).parameters.get("device")
                if p is not None and p.default is not inspect.Parameter.empty:
                    yield f"{info.name}.{name}.{fn.__name__}", p.default


def test_entry_points_default_to_cuda():
    found = dict(_device_defaults())
    for entry in ("tpufoam_torch.fv.case.build_channel_case",
                  "tpufoam_torch.surrogate.pipeline.SurrogateBundle.load",
                  "tpufoam_torch.models.mlp.params_from_numpy"):
        assert any(k.startswith(entry) for k in found), entry
    for name, default in found.items():
        assert torch.device(default).type == "cuda", (name, default)
