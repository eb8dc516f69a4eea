"""Wall-distance feature, computed on the device.

The min distance from every query point to a boundary point set, as a
chunked ``|x|^2 + |p|^2 - 2 x.p`` matrix product, so the full
(n_query x n_boundary) distance matrix is never held at once.
"""

from __future__ import annotations

import torch


def sdf_min_distance(query: torch.Tensor, boundary: torch.Tensor,
                     chunk: int = 65536) -> torch.Tensor:
    """Min Euclidean distance from each query point to the boundary set.

    query: (n, 2), boundary: (b, 2), both on one device -> (n,) float32.
    """
    query = query.to(torch.float32)
    boundary = boundary.to(torch.float32)
    b_sq = torch.sum(boundary * boundary, dim=1)
    out = torch.empty(query.shape[0], dtype=torch.float32,
                      device=query.device)
    for s in range(0, query.shape[0], chunk):
        qc = query[s:s + chunk]
        d2 = (torch.sum(qc * qc, dim=1, keepdim=True) + b_sq[None, :]
              - 2.0 * (qc @ boundary.T))
        out[s:s + chunk] = torch.sqrt(torch.clamp(d2.min(dim=1).values,
                                                  min=0.0))
    return out
