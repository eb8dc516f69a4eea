"""Autoregressive rollout + visualization for the point-cloud model.

The Chapter-3 test harness (Chapter3/Data-driven/External_flow/
test_and_plot/plot.py:297-377): load weights, predict frames
autoregressively from an initial state, rasterize the point cloud onto a
pixel grid, and report %-of-range error maps against ground truth.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.pointnet import PAD, PointNetUNet
from ..utils.metrics import ErrorReport, error_metrics


def rollout(model: PointNetUNet, params, fields0: np.ndarray,
            coords: np.ndarray, n_steps: int) -> np.ndarray:
    """Feed predictions back as inputs for n_steps, on the model's device.

    params: a state dict to run the model with, or None for its own.
    fields0: (n_pts, 3) initial [Ux, Uy, p]; coords: (n_pts, 2).
    Returns (n_steps, n_pts, 3)."""
    dev = next(model.parameters()).device
    f = torch.as_tensor(np.asarray(fields0, np.float32), device=dev)[None]
    c = torch.as_tensor(np.asarray(coords, np.float32), device=dev)[None]
    # padded rows (PAD sentinel coords) must STAY at PAD through the
    # rollout: the model was trained with PAD inputs at those rows (only
    # the loss masks them, models/pointnet.py), so feeding its in-[0,1]
    # outputs back there would put every step >= 2 out of distribution
    # and corrupt the global max-pool features
    pad_rows = (c[..., :1] == PAD)
    frames = []
    with torch.no_grad():
        for _ in range(n_steps):
            out = (model(f, c) if params is None else
                   torch.func.functional_call(model, params, (f, c)))[0]
            f = torch.where(pad_rows, PAD, out)
            frames.append(f[0].cpu().numpy())
    return np.stack(frames)


def rasterize(points: np.ndarray, values: np.ndarray,
              shape: tuple[int, int],
              bounds: tuple[float, float, float, float] | None = None) -> np.ndarray:
    """Nearest-cell rasterization of point values to an image; empty cells
    NaN (plot.py's scatter->imshow role, vectorized)."""
    points = np.asarray(points)
    values = np.asarray(values)
    # filter on the COORDINATES too: model predictions carry arbitrary
    # non-PAD values at padded rows, whose (-100,-100) coords would
    # otherwise stretch the auto bounds and collapse the image
    valid = (values != PAD) & (points[:, 0] != PAD)
    points, values = points[valid], values[valid]
    if bounds is None:
        bounds = (points[:, 0].min(), points[:, 0].max(),
                  points[:, 1].min(), points[:, 1].max())
    x0, x1, y0, y1 = bounds
    ny, nx = shape
    j = np.clip(((points[:, 0] - x0) / max(x1 - x0, 1e-12) * nx).astype(int),
                0, nx - 1)
    i = np.clip(((points[:, 1] - y0) / max(y1 - y0, 1e-12) * ny).astype(int),
                0, ny - 1)
    img = np.full(shape, np.nan)
    cnt = np.zeros(shape)
    np.add.at(cnt, (i, j), 1)
    acc = np.zeros(shape)
    np.add.at(acc, (i, j), values)
    mask = cnt > 0
    img[mask] = acc[mask] / cnt[mask]
    return img


def rollout_report(pred_frames: np.ndarray, true_frames: np.ndarray,
                   channel_names=("Ux", "Uy", "p")) -> dict[str, list[ErrorReport]]:
    """Per-frame, per-channel BIAS/STDE/RMSE (% of range)."""
    out = {name: [] for name in channel_names}
    for t in range(len(pred_frames)):
        valid = true_frames[t][:, 0] != PAD
        for c, name in enumerate(channel_names):
            out[name].append(error_metrics(pred_frames[t][valid, c],
                                           true_frames[t][valid, c]))
    return out
