"""Training for the point-cloud next-step model (Chapter 3).

Covers the reference's Chapter3/Data-driven/External_flow/train/train.py
training script (:14-99 read_dataset, :431+ training loop): build (state_t ->
state_{t+1}) pairs of [Ux, Uy, p] at the mesh points from the HDF5 schema,
min-max scale fields to [0, 1] (the model's sigmoid output range), train
with the padding-masked MSE + T-net orthogonality penalty (Adam, the
port's functional optax.adam over the model's state dict).

The dataset is host numpy; training runs on `device`. A batch's loss
stays on the device, summed there, and the host reads one number an
epoch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..models.pointnet import PAD, PointNetUNet, pointnet_loss
from ..utils.hdf5_io import first_pad_index
from .trainer import Adam, apply_updates, value_and_grad


@dataclasses.dataclass
class PointCloudDataset:
    fields: np.ndarray    # (n_pairs, n_pts, 3) inputs at t, PAD-padded
    targets: np.ndarray   # (n_pairs, n_pts, 3) at t+1
    coords: np.ndarray    # (n_pairs, n_pts, 2)
    mins: np.ndarray      # (3,) scaling constants
    maxs: np.ndarray
    sim_ids: np.ndarray | None = None   # (n_pairs,) source sim per pair


def build_pointcloud_dataset(path: str, n_pts: int = 4096,
                             n_sims: int | None = None,
                             first_t: int = 0,
                             last_t: int | None = None,
                             scale_stats: tuple | None = None) -> PointCloudDataset:
    """HDF5 -> next-step pairs. n_pts must be divisible by 16 (U-Net
    pooling); clouds are truncated/padded to it. `scale_stats=(mins, maxs)`
    reuses TRAINING normalization constants instead of recomputing them —
    required at inference time (the sigmoid-output model is tied to the
    training [0,1] mapping)."""
    import h5py

    with h5py.File(path, "r") as f:
        data = np.asarray(f["sim_data"])
    return _pairs_from_array(data, n_pts, n_sims, first_t, last_t,
                             scale_stats)


def _pairs_from_array(data: np.ndarray, n_pts: int = 4096,
                      n_sims: int | None = None, first_t: int = 0,
                      last_t: int | None = None,
                      scale_stats: tuple | None = None) -> PointCloudDataset:
    """build_pointcloud_dataset's body on the (n_sims, n_t, max_cells, C)
    `sim_data` array (records of [Ux, Uy, p, Cx, Cy, ...], PAD-padded)."""
    n_sims = min(n_sims or data.shape[0], data.shape[0])
    last_t = min(last_t or data.shape[1], data.shape[1])

    xs, ys, cs, sids = [], [], [], []
    for s in range(n_sims):
        for t in range(first_t, last_t - 1):
            rec = data[s, t]
            rec1 = data[s, t + 1]
            n = first_pad_index(rec[:, 0])
            if n == 0:
                continue
            n_use = min(n, n_pts)

            def pad_rows(a):
                out = np.full((n_pts, a.shape[1]), PAD, np.float32)
                out[:n_use] = a[:n_use]
                return out

            xs.append(pad_rows(rec[:, 0:3]))
            ys.append(pad_rows(rec1[:, 0:3]))
            cs.append(pad_rows(rec[:, 3:5]))
            sids.append(s)

    x = np.stack(xs)
    y = np.stack(ys)
    c = np.stack(cs)
    if scale_stats is not None:
        mins, maxs = (np.asarray(a, np.float32) for a in scale_stats)
    else:
        valid = x[..., 0] != PAD
        mins = np.array([x[..., k][valid].min() for k in range(3)], np.float32)
        maxs = np.array([x[..., k][valid].max() for k in range(3)], np.float32)

    def scale(a):
        v = a[..., 0:1] != PAD
        scaled = (a - mins) / np.maximum(maxs - mins, 1e-12)
        return np.where(v, scaled, PAD).astype(np.float32)

    return PointCloudDataset(fields=scale(x), targets=scale(y), coords=c,
                             mins=mins, maxs=maxs,
                             sim_ids=np.asarray(sids, np.int32))


def train_pointcloud(ds: PointCloudDataset, epochs: int = 50,
                     batch_size: int = 2, lr: float = 1e-3, seed: int = 0,
                     verbose: bool = False, device=DEFAULT_DEVICE):
    """Adam training with the masked loss on `device`; returns (model,
    params: its state dict, history: the mean batch loss an epoch). The
    weights are drawn from a CPU generator seeded with `seed` (the same
    on every device), the dropout masks from a generator on `device`, the
    batch order from numpy's default_rng(seed), as in the JAX package."""
    device = torch.device(device)
    model = PointNetUNet(generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    opt = Adam(lr)
    opt_state = opt.init(params)
    drop = torch.Generator(device).manual_seed(seed)

    def loss_fn(p, xb, cb, yb):
        return pointnet_loss(model, p, xb, cb, yb, rngs=drop, train=True)

    def on(a):
        return torch.as_tensor(a, device=device)

    n = len(ds.fields)
    history = []
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = rng.permutation(n)
        tot = torch.zeros((), device=device)
        nb = 0
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            loss, g = value_and_grad(loss_fn, params, on(ds.fields[idx]),
                                     on(ds.coords[idx]), on(ds.targets[idx]))
            updates, opt_state = opt.update(g, opt_state, params)
            params = apply_updates(params, updates)
            tot = tot + loss
            nb += 1
        history.append(float(tot) / max(nb, 1))
        if verbose and epoch % 5 == 0:
            print(f"epoch {epoch}: {history[-1]:.4f}", flush=True)
    model.load_state_dict(params)
    return model, params, history
