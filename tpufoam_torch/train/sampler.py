"""Latin-hypercube block sampling for surrogate training.

The reference's per-frame sampler: N block centres from a 2-D LHS over
the admissible region, rounded to grid indices and de-duplicated. The
JAX package's keys become torch.Generators (CPU generators: the corners
are host data, and the same seed gives the same corners on every
device); the gather runs on the frame's device.
"""

from __future__ import annotations

import numpy as np
import torch


def lhs_sample(key: torch.Generator, n: int, d: int = 2) -> torch.Tensor:
    """Latin hypercube in [0,1]^d: one point per stratum, shuffled per dim
    (pyDOE.lhs's 'classic' behaviour), drawn from `key`."""
    cols = []
    for _ in range(d):
        u = torch.rand(n, generator=key, dtype=torch.float64)
        strata = (torch.arange(n, dtype=torch.float64) + u) / n
        cols.append(strata[torch.randperm(n, generator=key)])
    return torch.stack(cols, dim=-1)


def sample_block_corners(key: torch.Generator, n: int, ny: int, nx: int,
                         block: int) -> np.ndarray:
    """(m, 2) unique top-left block corners (i, j) from an LHS over block
    centres, m <= n after dedup, sorted as np.unique sorts."""
    if ny < block or nx < block:
        # negative corners would wrap in a gather, mixing opposite-edge
        # rows into training blocks
        raise ValueError(f"grid {ny}x{nx} smaller than block size {block}; "
                         f"pass a smaller --block-size")
    pts = lhs_sample(key, n).numpy()
    ii = np.round(pts[:, 0] * (ny - block)).astype(np.int64)
    jj = np.round(pts[:, 1] * (nx - block)).astype(np.int64)
    return np.unique(np.stack([ii, jj], axis=-1), axis=0)


def gather_training_blocks(grid: torch.Tensor, corners: np.ndarray,
                           block: int) -> torch.Tensor:
    """Gather (m, B, B, C) blocks from a (ny, nx, C) frame, on its
    device."""
    c = torch.as_tensor(np.asarray(corners), device=grid.device)
    ar = torch.arange(block, device=grid.device)
    rows = c[:, 0:1, None] + ar[None, :, None]
    cols = c[:, 1:2, None] + ar[None, None, :]
    return grid[rows, cols]
