"""Accuracy metrics: BIAS / STDE / RMSE as % of the true-field range.

The reference's acceptance criterion for every surrogate variant: errors
normalized by (max - min) of the masked true field, in percent, STDE as
sqrt(RMSE^2 - BIAS^2). Computed on the host in float64, from arrays or
tensors on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ErrorReport:
    bias_pct: float
    stde_pct: float
    rmse_pct: float
    norm: float

    def __str__(self):
        return (f"normVal = {self.norm:.6g}\n"
                f"biasNorm = {self.bias_pct:.3f}%\n"
                f"stdeNorm = {self.stde_pct:.3f}%\n"
                f"rmseNorm = {self.rmse_pct:.3f}%")


def _host(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def error_metrics(pred, true, mask=None) -> ErrorReport:
    pred = _host(pred, np.float64)
    true = _host(true, np.float64)
    if mask is not None:
        m = _host(mask) != 0
        pred, true = pred[m], true[m]
    ok = np.isfinite(pred - true)
    diff = (pred - true)[ok]
    norm = float(true.max() - true.min())
    norm = norm if norm > 0 else 1.0
    bias = float(diff.mean()) / norm * 100.0
    rmse = float(np.sqrt((diff**2).mean())) / norm * 100.0
    stde = float(np.sqrt(max(rmse**2 - bias**2, 0.0)))
    return ErrorReport(bias_pct=bias, stde_pct=stde, rmse_pct=rmse, norm=norm)
