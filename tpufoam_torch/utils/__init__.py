"""Utilities (the counterpart of tpufoam/utils): accuracy metrics."""

from .metrics import error_metrics, ErrorReport

__all__ = ["ErrorReport", "error_metrics"]
