"""Find a cell's files by the names in BENCHMARK.json, and the reference
package and options that its configuration names."""

from __future__ import annotations

import ast
import importlib
import json
import os
import re
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the modules the check takes from a configuration's reference package
REFERENCE_MODULES = ("backends", "case", "engine", "geometry", "pipeline",
                     "pressure")
# what no reference may load: JAX, the JAX package, the program
NOT_IN_REFERENCE = ("jax", "jaxlib", "flax", "tpufoam", "tpufoam_torch")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(the manifest's cell entry, its config entry, the config file, the
    cell's parameters) for the cell `name`. The parameters are its
    traffic mix, mixes/<traffic>.json, with the cell's own file,
    workloads/<name>.json (its check's limits), over them."""
    m = manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"cfdbench: no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    mix = _load(os.path.join("cfdbench", "mixes",
                             f"{entry['traffic']}.json"))
    own = _load(os.path.join("cfdbench", "workloads", f"{name}.json"))
    return entry, conf, _load(conf["file"]), {**mix, **own}


def metrics_of(name: str, kind: str) -> list[dict]:
    """The manifest's `kind` ("end_to_end" or "per_layer") metrics that
    the cell `name` reports."""
    return [x for x in manifest()[kind]
            if "workloads" not in x or name in x["workloads"]]


def backend(module, conf: dict):
    """The pressure backend that a configuration's `backend` entry names
    by `kind`, built from `module` (the program's backends, or the
    reference's) with the entry's other settings."""
    kind = conf["kind"]
    cls = getattr(module, kind, None)
    if cls is None:
        raise SystemExit(f"cfdbench: no pressure backend {kind!r} in "
                         f"{module.__name__}")
    return cls(**{k: v for k, v in conf.items() if k != "kind"})


def check_family(bundle_family: str, conf: dict):
    """A configuration's surrogate `family` is its bundle's."""
    if bundle_family != conf["family"]:
        raise SystemExit(f"cfdbench: the bundle {conf['bundle']} is of the "
                         f"family {bundle_family!r}, the configuration "
                         f"states {conf['family']!r}")


def obstacle_x(config: dict, size: float) -> float:
    """The obstacle's centre: its leading edge `obstacle_front` from the
    inlet, for an obstacle `size` wide."""
    return config["grid"]["obstacle_front"] + size / 2


def surrogate_options(config: dict) -> dict:
    """The keyword arguments of both sides' `make_predictor`: every key of
    the configuration's `surrogate` but the bundle's path and its family
    (which the bundle states)."""
    return {k: v for k, v in config["surrogate"].items()
            if k not in ("bundle", "family")}


def geometry_options(config: dict) -> dict:
    """The keyword arguments that the configuration's optional `geometry`
    adds to both sides' `channel_case_geometry` (`cy`, `u_mean`, ...)."""
    return dict(config.get("geometry", {}))


def _may_load(module: str, package: str) -> bool:
    """Whether the reference `package` may load `module` (a dotted name):
    nothing of JAX, the JAX package or the program, and of the harness
    only its reference packages and the package's own modules."""
    parts = module.split(".")
    if parts[0] in NOT_IN_REFERENCE:
        return False
    return parts[0] != "cfdbench" or module == package or (
        module.startswith(package + ".")) or (
        len(parts) > 1 and parts[1].startswith("reference"))


def _refused_imports(paths: list[str], package: str) -> list[str]:
    """The imports in the source files `paths` that the reference
    `package` may not make (`_may_load`), relative ones resolved against
    the package each file lies in."""
    out = []
    for path in paths:
        here = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = ".".join(here[:len(here) + 1 - node.level])
                names = ([f"{base}.{a.name}" for a in node.names]
                         if node.module is None else
                         [f"{base}.{node.module}" if node.level
                          else node.module])
            else:
                continue
            out += [f"{os.path.relpath(path, ROOT)}:{node.lineno} imports "
                    f"{n}" for n in names if not _may_load(n, package)]
    return out


def reference(config: dict) -> types.SimpleNamespace:
    """The reference package that the configuration's optional
    `reference` names (a dotted package under `cfdbench`; by default the
    frozen `cfdbench.reference`), as a namespace of its modules
    REFERENCE_MODULES. A package may re-export the frozen modules (in its
    `__init__`) and bring as files of its own only those it changes. A
    package whose sources, or the sources of the modules it hands over,
    import anything of JAX, the JAX package, the program or the harness
    outside its reference packages fails the run: its own sources are
    read before it is imported."""
    name = config.get("reference", "reference")
    if not re.fullmatch(r"[A-Za-z_]\w*(\.[A-Za-z_]\w*)*", name):
        raise SystemExit(f"cfdbench: {name!r} names no package")
    package = f"cfdbench.{name}"
    pkg_dir = os.path.join(HERE, *name.split("."))
    if not os.path.isfile(os.path.join(pkg_dir, "__init__.py")):
        raise SystemExit(f"cfdbench: no reference package {package}")

    def refuse(paths):
        bad = _refused_imports(paths, package)
        if bad:
            raise SystemExit(f"cfdbench: the reference {package} may not "
                             f"load JAX, the JAX package, the program or "
                             f"the harness: " + "; ".join(bad))

    refuse([os.path.join(d, f) for d, _, files in os.walk(pkg_dir)
            for f in sorted(files) if f.endswith(".py")])
    pkg = importlib.import_module(package)
    mods = {}
    for m in REFERENCE_MODULES:
        mod = getattr(pkg, m, None)
        if not isinstance(mod, types.ModuleType):
            mod = importlib.import_module(f"{package}.{m}")
        mods[m] = mod
    refuse([mod.__file__ for mod in mods.values()])
    return types.SimpleNamespace(**mods)
