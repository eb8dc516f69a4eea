"""Hand-written CUDA kernels, their plain versions and their build.

  momentum.momentum_multisweep  coupled momentum Jacobi sweeps
  stencil.stencil_matvec        the pressure operator A x (differentiable:
                                its backward is stencil.stencil_matvec_grad,
                                csrc/stencil_grad.cu)
  stencil.jacobi_sweep          damped-Jacobi pressure sweeps, one a launch
  stencil.jacobi_multisweep     damped-Jacobi pressure sweeps
  stencil.smooth_residual       V-cycle down leg (sweeps + residual)
  stencil.corr_smooth           V-cycle up leg (correction + sweeps)
  sharded.momentum_multisweep_sharded, sharded.jacobi_multisweep_sharded
                                the two multisweeps over a mesh of devices:
                                one window launch for the operands' card's
                                blocks (halos read in place), per card or
                                block on exchanged haloed blocks elsewhere
"""

from .momentum import momentum_multisweep, momentum_multisweep_plain
from .stencil import (corr_smooth, corr_smooth_plain, jacobi_multisweep,
                      jacobi_multisweep_plain, jacobi_sweep,
                      jacobi_sweep_plain, kernel_available_for,
                      smooth_residual, smooth_residual_plain, stencil_matvec,
                      stencil_matvec_grad, stencil_matvec_grad_plain,
                      stencil_matvec_plain)

__all__ = ["corr_smooth", "corr_smooth_plain", "jacobi_multisweep",
           "jacobi_multisweep_plain", "jacobi_sweep", "jacobi_sweep_plain",
           "kernel_available_for", "momentum_multisweep",
           "momentum_multisweep_plain", "smooth_residual",
           "smooth_residual_plain", "stencil_matvec", "stencil_matvec_grad",
           "stencil_matvec_grad_plain", "stencil_matvec_plain"]
