"""Minimal legacy-VTK reader/writer for dataset extraction.

The reference extracts training data by running foamToVTK and reading the
per-timestep VTK files with pyvista
(Chapter4/MLP/M_u/DataGen+Training/data_generation/data_generation.py:35-107,
sim_cmd.sh:13-27). pyvista is not a dependency, so this module implements
the small subset of the legacy ASCII VTK format those files use: POINTS,
(POLYGONS/CELLS ignored), and POINT_DATA / CELL_DATA SCALARS + VECTORS
arrays — enough to turn foamToVTK output into the HDF5 schema via
`utils.hdf5_io`. The port's copy of the JAX package's reader and writer
(numpy only): each writes and reads the same bytes.
"""

from __future__ import annotations

import numpy as np


def read_legacy_vtk(path: str) -> dict:
    """Parse an ASCII legacy .vtk file -> dict with 'points' (n, 3) and
    per-array entries under 'point_data' / 'cell_data'."""
    with open(path) as f:
        tokens = f.read().split()

    out = {"points": None, "point_data": {}, "cell_data": {}}
    counts = {}
    i = 0
    section = None
    n = len(tokens)

    def take_floats(count):
        nonlocal i
        vals = np.array(tokens[i:i + count], dtype=np.float64)
        i += count
        return vals

    while i < n:
        t = tokens[i]
        up = t.upper()
        if up == "POINTS":
            npts = int(tokens[i + 1])
            i += 3  # POINTS n dtype
            out["points"] = take_floats(npts * 3).reshape(npts, 3)
        elif up == "POINT_DATA":
            section = "point_data"
            counts[section] = int(tokens[i + 1])
            i += 2
        elif up == "CELL_DATA":
            section = "cell_data"
            counts[section] = int(tokens[i + 1])
            i += 2
        elif up == "SCALARS" and section:
            name = tokens[i + 1]
            i += 3  # SCALARS name dtype [numComp]
            if tokens[i].isdigit():
                i += 1
            if tokens[i].upper() == "LOOKUP_TABLE":
                i += 2
            out[section][name] = take_floats(counts[section])
        elif up == "VECTORS" and section:
            name = tokens[i + 1]
            i += 3
            count = counts[section]
            out[section][name] = take_floats(count * 3).reshape(count, 3)
        elif up == "FIELD" and section:
            n_arrays = int(tokens[i + 2])
            i += 3
            for _ in range(n_arrays):
                name = tokens[i]
                ncomp, ntup = int(tokens[i + 1]), int(tokens[i + 2])
                i += 4  # name ncomp ntuples dtype
                arr = take_floats(ncomp * ntup)
                out[section][name] = (arr.reshape(ntup, ncomp)
                                      if ncomp > 1 else arr)
        else:
            i += 1
    return out


def write_legacy_vtk(path: str, points: np.ndarray,
                     point_data: dict | None = None) -> None:
    """Write points + point arrays (test fixture / export helper)."""
    points = np.asarray(points, dtype=np.float64)
    npts = len(points)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 2.0\ntpufoam export\nASCII\n"
                "DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {npts} double\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        if point_data:
            f.write(f"POINT_DATA {npts}\n")
            for name, arr in point_data.items():
                arr = np.asarray(arr)
                if arr.ndim == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    for v in arr:
                        f.write(f"{v}\n")
                else:
                    f.write(f"VECTORS {name} double\n")
                    for v in arr:
                        f.write(f"{v[0]} {v[1]} {v[2]}\n")
