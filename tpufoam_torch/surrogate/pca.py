"""PCA models for patch compression (serving side only).

sklearn-compatible: code = (x - mean) @ components.T;
reconstruction = code @ components + mean. With `dtype` (bfloat16) the
products take operands rounded to that dtype and sum in float32, with a
float32 result that is not rounded again (the JAX package's
`preferred_element_type=float32`): on the card a bf16 GEMM with a float32
output, on the CPU the float32 product of the rounded operands.
"""

from __future__ import annotations

import dataclasses

import torch


def mm_f32_out(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b of 2-D operands rounded to `dtype`, summed in float32, with a
    float32 result: a bf16 GEMM with a float32 output on the card, the
    float32 product of the rounded operands on the CPU."""
    a, b = a.to(dtype), b.to(dtype)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


@dataclasses.dataclass
class PCAModel:
    mean: torch.Tensor                      # (D,)
    components: torch.Tensor                # (K, D) rows are PCs
    explained_variance: torch.Tensor        # (K,)
    explained_variance_ratio: torch.Tensor  # (K,)

    def transform(self, x: torch.Tensor, k: int | None = None,
                  dtype=None) -> torch.Tensor:
        """Encode; `dtype` (e.g. torch.bfloat16) rounds the operands to it
        and keeps a float32 sum and result."""
        comp = self.components if k is None else self.components[:k]
        xc = x - self.mean
        if dtype is not None:
            return mm_f32_out(xc, comp.T, dtype)
        return xc @ comp.T

    def inverse_transform(self, code: torch.Tensor,
                          dtype=None) -> torch.Tensor:
        k = code.shape[-1]
        if dtype is not None:
            return mm_f32_out(code, self.components[:k], dtype) + self.mean
        return code @ self.components[:k] + self.mean
