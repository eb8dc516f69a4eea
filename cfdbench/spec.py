"""Find a cell's files by the names in BENCHMARK.json."""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


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
