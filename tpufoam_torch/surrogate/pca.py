"""PCA models for patch compression (serving side only).

sklearn-compatible: code = (x - mean) @ components.T;
reconstruction = code @ components + mean.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PCAModel:
    mean: torch.Tensor                      # (D,)
    components: torch.Tensor                # (K, D) rows are PCs
    explained_variance: torch.Tensor        # (K,)
    explained_variance_ratio: torch.Tensor  # (K,)

    def transform(self, x: torch.Tensor, k: int | None = None) -> torch.Tensor:
        comp = self.components if k is None else self.components[:k]
        return (x - self.mean) @ comp.T

    def inverse_transform(self, code: torch.Tensor) -> torch.Tensor:
        k = code.shape[-1]
        return code @ self.components[:k] + self.mean
