"""Hand-written CUDA kernels, their plain versions and their build.

  momentum.momentum_multisweep  coupled momentum Jacobi sweeps
  stencil.stencil_matvec        the pressure operator A x
  stencil.jacobi_sweep          damped-Jacobi pressure sweeps, one a launch
  stencil.jacobi_multisweep     damped-Jacobi pressure sweeps
  stencil.smooth_residual       V-cycle down leg (sweeps + residual)
  stencil.corr_smooth           V-cycle up leg (correction + sweeps)
"""

from .momentum import momentum_multisweep, momentum_multisweep_plain
from .stencil import (corr_smooth, corr_smooth_plain, jacobi_multisweep,
                      jacobi_multisweep_plain, jacobi_sweep,
                      jacobi_sweep_plain, kernel_available_for,
                      smooth_residual, smooth_residual_plain, stencil_matvec,
                      stencil_matvec_plain)

__all__ = ["corr_smooth", "corr_smooth_plain", "jacobi_multisweep",
           "jacobi_multisweep_plain", "jacobi_sweep", "jacobi_sweep_plain",
           "kernel_available_for", "momentum_multisweep",
           "momentum_multisweep_plain", "smooth_residual",
           "smooth_residual_plain", "stencil_matvec", "stencil_matvec_plain"]
