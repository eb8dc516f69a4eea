"""Wall-distance feature, computed on the device.

The min distance from every query point to a boundary point set, as a
chunked ``|x|^2 + |p|^2 - 2 x.p`` expression, so the full
(n_query x n_boundary) distance matrix is never held at once.

The expression cancels, so its last bits depend on how each sum is
rounded, and the surrogate's near-wall guard (``sdf < 0.05``) compares
cells that sit 0.05 from a wall with it. It is rounded as XLA rounds the
JAX package's expression on the CPU: the two-term sums ``x.x`` and
``x.p`` as fused multiply-adds, the rest in float32, the square root
correctly rounded. Every step is an elementwise operation, so the result
is the same bit for bit on the CPU and on the card.
"""

from __future__ import annotations

import torch



def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 operands with one rounding: the product is
    exact in float64, the sum is rounded to float64 and then to float32
    (which differs from a fused multiply-add only where float64's rounding
    lands on a float32 tie)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def sdf_min_distance(query: torch.Tensor, boundary: torch.Tensor,
                     chunk: int = 65536) -> torch.Tensor:
    """Min Euclidean distance from each query point to the boundary set.

    query: (n, 2), boundary: (b, 2), both on one device -> (n,) float32.
    """
    query = query.to(torch.float32)
    boundary = boundary.to(torch.float32)
    bx, by = boundary[None, :, 0], boundary[None, :, 1]
    by64 = by.double()
    b_sq = _fma(by, by, bx * bx)
    out = torch.empty(query.shape[0], dtype=torch.float32,
                      device=query.device)
    for s in range(0, query.shape[0], chunk):
        qx, qy = query[s:s + chunk, 0:1], query[s:s + chunk, 1:2]
        # 2 x.p as fma(2 qy, py, 2 qx px): scaling by 2 is exact, and the
        # float64 product of two float32 numbers is exact
        xp2 = ((2.0 * qx) * bx).double().addcmul_(2.0 * qy.double(), by64)
        d2 = (_fma(qy, qy, qx * qx) + b_sq).sub_(xp2.to(torch.float32))
        d2_min = torch.clamp(d2.min(dim=1).values, min=0.0)
        out[s:s + chunk] = torch.sqrt(d2_min.double()).to(torch.float32)
    return out


