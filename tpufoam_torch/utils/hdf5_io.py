"""The reference's HDF5 dataset schema: simulations stored as padded
dense tensors,

  sim_data   [n_sims, n_t, max_cells, C]   cell-wise fields, ragged rows
                                           padded with -100.0
  top_bound  [n_sims, n_t, max_pts, 2]     outer-wall boundary coordinates
  obst_bound [n_sims, n_t, max_pts, 2]     obstacle boundary coordinates

with the channel layouts

  M_u / M_fU (6ch):  [Ux, Uy, p, Cx, Cy, f_U]
  deltas (11ch):     [Ux, Uy, p, Cx, Cy, dUx, dUy, dp, dUx_prev,
                      dUy_prev, dp_prev]

Reading and writing need h5py, which is imported inside the functions
that touch a file, so the module imports where h5py is missing (records
are built, padded and resampled without it). `rollout_to_records` turns
the port's PISO frames into the cell-record schema.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .metrics import _host

PAD = -100.0

CH_MU = ("Ux", "Uy", "p", "Cx", "Cy", "f_U")
CH_DELTAS = ("Ux", "Uy", "p", "Cx", "Cy", "dUx", "dUy", "dp",
             "dUx_prev", "dUy_prev", "dp_prev")


def pad_ragged(arrays: list[np.ndarray], max_rows: int,
               pad_value: float = PAD) -> np.ndarray:
    """Pad a list of (n_i, C) arrays to (len, max_rows, C) float32 with
    the -100 sentinel."""
    c = arrays[0].shape[1]
    out = np.full((len(arrays), max_rows, c), pad_value, dtype=np.float32)
    for i, a in enumerate(arrays):
        n = min(len(a), max_rows)
        out[i, :n] = a[:n]
    return out


def first_pad_index(arr: np.ndarray, pad_value: float = PAD) -> int:
    """Length of the valid prefix: the index of the first sentinel."""
    hits = np.flatnonzero(arr == pad_value)
    return int(hits[0]) if len(hits) else len(arr)


@dataclasses.dataclass
class SimFrame:
    """One (sim, t) record with padding stripped."""
    data: np.ndarray        # (n_cells, C)
    top: np.ndarray         # (n_top, 2)
    obst: np.ndarray        # (n_obst, 2)
    channels: tuple


def write_dataset(path: str, sims: list[list[dict]],
                  channels: tuple = CH_DELTAS,
                  max_cells: int | None = None,
                  max_bound: int = 20000) -> None:
    """sims[s][t] is a dict with 'cells' (n, C), 'top' (m, 2) and 'obst'
    (k, 2) arrays."""
    import h5py
    n_sims = len(sims)
    n_t = max(len(s) for s in sims)
    if max_cells is None:
        max_cells = max(len(fr["cells"]) for s in sims for fr in s)

    with h5py.File(path, "w") as f:
        d = f.create_dataset("sim_data",
                             (n_sims, n_t, max_cells, len(channels)),
                             dtype="f4", fillvalue=PAD)
        tb = f.create_dataset("top_bound", (n_sims, n_t, max_bound, 2),
                              dtype="f4", fillvalue=PAD)
        ob = f.create_dataset("obst_bound", (n_sims, n_t, max_bound, 2),
                              dtype="f4", fillvalue=PAD)
        for s, frames in enumerate(sims):
            for t, fr in enumerate(frames):
                d[s, t] = pad_ragged([fr["cells"]], max_cells)[0]
                tb[s, t] = pad_ragged([fr["top"]], max_bound)[0]
                ob[s, t] = pad_ragged([fr["obst"]], max_bound)[0]
        f.attrs["channels"] = ",".join(channels)


def read_frame(path: str, sim: int, t: int) -> SimFrame:
    """Record (sim, t) of a dataset, its sentinel padding stripped."""
    import h5py
    with h5py.File(path, "r") as f:
        data = np.asarray(f["sim_data"][sim, t])
        top = np.asarray(f["top_bound"][sim, t])
        obst = np.asarray(f["obst_bound"][sim, t])
        channels = tuple(f.attrs.get("channels",
                                     ",".join(CH_DELTAS)).split(","))
    return SimFrame(
        data=data[:first_pad_index(data[:, 0])],
        top=top[:first_pad_index(top[:, 0])],
        obst=obst[:first_pad_index(obst[:, 0])],
        channels=channels,
    )


def dataset_shape(path: str) -> tuple[int, int]:
    """(n_sims, n_t) of a dataset."""
    import h5py
    with h5py.File(path, "r") as f:
        s = f["sim_data"].shape
    return s[0], s[1]


def rollout_to_records(case, frames: list[dict]) -> list[np.ndarray]:
    """PISO frames (dicts of u, v, p and u_prev, v_prev, p_prev, arrays or
    tensors) as (n_fluid, 11) float32 cell records in the deltas layout,
    one per frame: the fluid cells only, at the grid's cell centres (the
    reference exports its mesh's cells). The first frame's previous
    deltas are its own."""
    pts = case.grid.cell_centers_flat()
    fluid = _host(case.fluid).reshape(-1) > 0
    cx, cy = pts[fluid, 0], pts[fluid, 1]

    def cells(a):
        return _host(a).reshape(-1)[fluid]

    records = []
    prev = None
    for fr in frames:
        u, v, p = cells(fr["u"]), cells(fr["v"]), cells(fr["p"])
        du = u - cells(fr["u_prev"])
        dv = v - cells(fr["v_prev"])
        dp = p - cells(fr["p_prev"])
        du_p, dv_p, dp_p = (du, dv, dp) if prev is None else prev
        records.append(np.stack([u, v, p, cx, cy, du, dv, dp, du_p, dv_p,
                                 dp_p], axis=-1).astype(np.float32))
        prev = (du, dv, dp)
    return records
