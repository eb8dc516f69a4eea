"""tpufoam_torch — the PyTorch/CUDA port of tpufoam.

The same layout as the JAX package (``core``, ``fv``, ``solvers``,
``piso``, ``surrogate``, ``models``, ``ops``, ``bridge``) with the same
module and function names. Fields are (ny, nx) float32 tensors; every
entry point that creates tensors takes ``device=`` and defaults to CUDA,
so the CPU is used only when the caller asks for it.

``ops`` holds the hand-written Hopper kernels. Each wrapper launches its
kernel on a CUDA tensor and runs its plain PyTorch version on a CPU tensor.
"""

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"
