"""Unstructured-mesh <-> uniform-grid resampling.

The Delaunay triangulation, the barycentric weights and the
inverse-distance fallback of points outside the source hull (the 3
nearest neighbours) are computed once per mesh on the host, in scipy and
float64, as in the JAX package and the reference. What is left per
timestep is a gather of 3 source values per target point and their
weighted sum, on the operator's device, in both directions (mesh -> grid
and grid -> mesh).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class ResampleOp:
    """Resampling operator: target n = sum_j weights[n, j] *
    src[vertices[n, j]]. `valid` marks target points inside the source
    hull (barycentric weights) against the IDW fallback; all three live
    on one device."""

    vertices: torch.Tensor  # (n_target, 3) int64 indices of source points
    weights: torch.Tensor   # (n_target, 3) float32 barycentric / IDW
    valid: torch.Tensor     # (n_target,) bool

    def __call__(self, values, fill_value: float = 0.0) -> torch.Tensor:
        return apply_resample(self, values, fill_value)


def build_resample(src_pts: np.ndarray, dst_pts: np.ndarray,
                   device=DEFAULT_DEVICE) -> ResampleOp:
    """The one-time set-up on the host: Delaunay barycentric weights of
    every target point in its source simplex, inverse-distance weights
    over the 3 nearest source points where it has none; the operator's
    tensors on `device`."""
    from scipy.spatial import Delaunay, cKDTree

    src_pts = np.ascontiguousarray(src_pts, dtype=np.float64)
    dst_pts = np.ascontiguousarray(dst_pts, dtype=np.float64)

    tri = Delaunay(src_pts)
    simplex = tri.find_simplex(dst_pts)
    valid = simplex >= 0
    safe_simplex = np.where(valid, simplex, 0)

    vertices = np.take(tri.simplices, safe_simplex, axis=0)
    temp = np.take(tri.transform, safe_simplex, axis=0)
    delta = dst_pts - temp[:, 2]
    bary = np.einsum("njk,nk->nj", temp[:, :2, :], delta)
    weights = np.hstack([bary, 1.0 - bary.sum(axis=1, keepdims=True)])

    if (~valid).any():
        tree = cKDTree(src_pts)
        nndist, nni = tree.query(dst_pts[~valid], k=3)
        inv = 1.0 / np.maximum(nndist**2, 1e-6)
        vertices[~valid] = nni
        weights[~valid] = inv / inv.sum(axis=-1, keepdims=True)

    device = torch.device(device)
    return ResampleOp(
        vertices=torch.as_tensor(vertices, dtype=torch.int64, device=device),
        weights=torch.as_tensor(weights.astype(np.float32), device=device),
        valid=torch.as_tensor(valid, device=device))


def apply_resample(op: ResampleOp, values,
                   fill_value: float = 0.0) -> torch.Tensor:
    """Interpolate per-point `values` (n_src,) to the target points, in
    float32 on the operator's device. Points with any negative weight
    (outside the hull but inside a sliver, the reference's `wts < 0`
    fill) get `fill_value`."""
    values = torch.as_tensor(values, device=op.weights.device).reshape(
        -1).to(torch.float32)
    g = values[op.vertices] * op.weights
    out = (g[:, 0] + g[:, 1]) + g[:, 2]
    bad = (op.weights < 0.0).any(dim=1)
    return torch.where(bad, torch.as_tensor(fill_value, dtype=out.dtype,
                                            device=out.device), out)
