"""PCA models for patch compression: the fitted model and its fits.

sklearn-compatible: code = (x - mean) @ components.T;
reconstruction = code @ components + mean. With `dtype` (bfloat16) the
products take operands rounded to that dtype and sum in float32, with a
float32 result that is not rounded again (the JAX package's
`preferred_element_type=float32`): on the card a bf16 GEMM with a float32
output, on the CPU the float32 product of the rounded operands.

`StreamingPCA` fits a model by randomized subspace iteration over a
re-iterable source of (n_chunk, D) chunks, so that no D x D covariance is
formed (at D = 49,152 it would take 9.7 GB): with A the centred data,
C = A^T A / N, `power_iters` rounds of Q <- orth(C Q), then the
Rayleigh-Ritz projection B = Q^T C Q and eigh(B); the components are Q W.
Every pass is a pair of (chunk x D) @ (D x L) products on the chunk's
device, in float32 with TF32 off. `fit_pca_exact` is the SVD fit for
small problems.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

from .. import DEFAULT_DEVICE


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

    def n_components_for_variance(self, var_threshold: float,
                                  max_num_pc: int) -> int:
        """The smallest K whose cumulative explained-variance ratio
        exceeds the threshold (the crossing component counted: index + 1),
        clamped to (1, max_num_pc]; max_num_pc when no K crosses."""
        csum = np.cumsum(self.explained_variance_ratio.cpu().numpy())
        if not (csum > var_threshold).any():
            return max_num_pc
        k = int(np.argmax(csum > var_threshold)) + 1
        if k > 1 and k <= max_num_pc:
            return k
        return max_num_pc


@contextlib.contextmanager
def full_f32():
    """float32 matrix products in full float32 (TF32 off) inside."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _orth(q: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(q)[0]


def _as_f32(c, device) -> torch.Tensor:
    """A chunk as a float32 tensor: a tensor on its own device, an array
    on `device`."""
    if isinstance(c, torch.Tensor):
        return c.float()
    return torch.as_tensor(np.asarray(c, dtype=np.float32), device=device)


@dataclasses.dataclass
class StreamingPCA:
    """Multi-pass randomized PCA over a re-iterable chunk source.

    `chunks()` must yield (n_chunk, D) arrays or tensors; it is consumed
    power_iters + 2 times. Tensors are used on their device, arrays are
    placed on `fit`'s `device`. The start matrix is drawn from
    torch.Generator(device).manual_seed(seed): not the JAX package's
    draws, so two fits agree on the fitted subspace, not on its bits."""

    n_components: int
    oversample: int = 64
    power_iters: int = 4
    seed: int = 0

    def fit(self, chunks: Callable[[], Iterable], device=DEFAULT_DEVICE
            ) -> PCAModel:
        with full_f32():
            return self._fit(chunks, torch.device(device))

    def _fit(self, chunks, device) -> PCAModel:
        # ---- pass 1: mean + total variance ----
        n_total, s, ssq, d = 0, None, 0.0, None
        for c in chunks():
            c = _as_f32(c, device)
            d, device = c.shape[1], c.device
            s = c.sum(dim=0) if s is None else s + c.sum(dim=0)
            ssq = ssq + torch.sum(c * c)
            n_total += c.shape[0]
        if n_total == 0:
            raise ValueError("no data")
        mean = s / n_total
        total_var = ssq / n_total - torch.sum(mean * mean)

        k = min(self.n_components, d, n_total)
        ell = min(k + self.oversample, d, n_total)
        gen = torch.Generator(device).manual_seed(self.seed)
        q = _orth(torch.randn((d, ell), generator=gen, device=device))

        # ---- power iterations: Q <- orth(C Q) ----
        for _ in range(self.power_iters):
            acc = torch.zeros((d, ell), device=device)
            for c in chunks():
                xc = _as_f32(c, device) - mean
                acc = acc + xc.T @ (xc @ q)
            q = _orth(acc / n_total)

        # ---- Rayleigh-Ritz: B = Q^T C Q ----
        b = torch.zeros((ell, ell), device=device)
        for c in chunks():
            y = (_as_f32(c, device) - mean) @ q
            b = b + y.T @ y
        b = b / n_total

        evals, evecs = torch.linalg.eigh(b)
        order = torch.argsort(evals, descending=True)[:k]
        evals = torch.clamp(evals[order], min=0.0)
        components = (q @ evecs[:, order]).T  # (k, D)
        return PCAModel(
            mean=mean, components=components, explained_variance=evals,
            explained_variance_ratio=evals / torch.clamp(total_var,
                                                         min=1e-30))


def fit_pca_exact(x, n_components: int, device=DEFAULT_DEVICE) -> PCAModel:
    """Exact PCA by SVD, for small problems and as a reference. A tensor
    is fitted on its device, an array on `device`. On the card the SVD is
    cuSOLVER's gesvd: PyTorch's default there, the Jacobi gesvdj, put the
    leading singular vector of a (1024, 49,152) block matrix 1.5e-2 rad
    from a float64 reference, gesvd 2.6e-4."""
    with full_f32():
        x = _as_f32(x, torch.device(device))
        mean = x.mean(dim=0)
        xc = x - mean
        _, sv, vt = torch.linalg.svd(
            xc, full_matrices=False,
            driver="gesvd" if xc.device.type == "cuda" else None)
        var = sv**2 / x.shape[0]
        total = torch.sum(xc * xc) / x.shape[0]
        k = n_components
        return PCAModel(mean=mean, components=vt[:k],
                        explained_variance=var[:k],
                        explained_variance_ratio=var[:k]
                        / torch.clamp(total, min=1e-30))
