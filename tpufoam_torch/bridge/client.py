"""The repo's C client library (bridge/tpufoam_bridge.{h,cpp}) built with
its Makefile and bound with ctypes: the C API an embedded solver calls
(`tb_init`, `tb_init_rank`, `tb_step_out`, `tb_last_step_ms`, `tb_close`),
callable from Python to drive a server as a solver would. A ctypes call
releases the GIL, so ranks of one world may call from threads of one
process (each rank's arena has its own shared-memory name)."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

BRIDGE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "bridge")
SOURCES = ("tpufoam_bridge.h", "tpufoam_bridge.cpp", "Makefile")


def build_library(build_dir: str, targets=("libtpufoam_bridge.so",)) -> str:
    """Copy the bridge's sources into `build_dir` and run `make` there for
    `targets` (the Makefile's; the demo solvers too if named). Returns the
    shared library's path; raises if make fails."""
    os.makedirs(build_dir, exist_ok=True)
    names = set(SOURCES) | {f"{t}.cpp" for t in targets
                            if not t.endswith(".so")}
    for name in names:
        shutil.copy(os.path.join(BRIDGE_DIR, name), build_dir)
    subprocess.run(["make", "-C", build_dir, *targets], check=True,
                   capture_output=True, text=True)
    return os.path.join(build_dir, "libtpufoam_bridge.so")


def load_library(path: str) -> ctypes.CDLL:
    """The library with the C API's signatures declared."""
    lib = ctypes.CDLL(path)
    dp = ctypes.POINTER(ctypes.c_double)
    sz = ctypes.c_size_t
    lib.tb_init.argtypes = [ctypes.c_char_p, dp, sz, dp, sz, dp, sz]
    lib.tb_init.restype = ctypes.c_void_p
    lib.tb_init_rank.argtypes = [ctypes.c_char_p, dp, sz, dp, sz, dp, sz,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tb_init_rank.restype = ctypes.c_void_p
    lib.tb_step_out.argtypes = [ctypes.c_void_p, dp, dp, dp]
    lib.tb_step_out.restype = ctypes.c_int
    lib.tb_last_step_ms.argtypes = [ctypes.c_void_p]
    lib.tb_last_step_ms.restype = ctypes.c_double
    lib.tb_close.argtypes = [ctypes.c_void_p]
    lib.tb_close.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


class Client:
    """One solver (rank) connected to a server: `cells` (n, 5) [Ux, Uy,
    Cx, Cy, p], `top` and `obst` (m, 2) boundary points. With `rank` it
    joins world `world_id` of `n_ranks` ranks through tb_init_rank, and
    blocks until every rank has joined."""

    def __init__(self, lib: ctypes.CDLL, socket_path: str, cells, top, obst,
                 rank: int | None = None, n_ranks: int = 1,
                 world_id: int = 0):
        self.lib = lib
        cells, top, obst = _f64(cells), _f64(top), _f64(obst)
        for name, a, width in (("cells", cells, 5), ("top", top, 2),
                               ("obst", obst, 2)):
            if a.ndim != 2 or a.shape[1] != width:
                raise ValueError(f"{name}: shape {a.shape}, not (n, {width})")
        self.n = len(cells)
        args = (socket_path.encode(), _ptr(cells), self.n, _ptr(top),
                len(top), _ptr(obst), len(obst))
        self.h = (lib.tb_init(*args) if rank is None
                  else lib.tb_init_rank(*args, rank, n_ranks, world_id))
        if not self.h:
            raise RuntimeError(f"tb_init failed ({socket_path})")

    def step(self, cells) -> tuple[np.ndarray, np.ndarray]:
        """(p, the model's raw output) for the current cells."""
        cells = _f64(cells)
        if cells.shape != (self.n, 5):
            raise ValueError(f"cells: shape {cells.shape}, not ({self.n}, 5)")
        p, out = np.empty(self.n), np.empty(self.n)
        if self.lib.tb_step_out(self.h, _ptr(cells), _ptr(p), _ptr(out)):
            raise RuntimeError("tb_step_out failed")
        return p, out

    @property
    def last_step_ms(self) -> float:
        return self.lib.tb_last_step_ms(self.h)

    def close(self):
        if self.h:
            self.lib.tb_close(self.h)
            self.h = None
