"""Utilities (the counterpart of tpufoam/utils): accuracy metrics and the
reference's HDF5 dataset schema (`hdf5_io`)."""

from .metrics import error_metrics, ErrorReport

__all__ = ["ErrorReport", "error_metrics"]
