"""Reproducibility controls.

The reference pins PYTHONHASHSEED / TF_DETERMINISTIC_OPS / thread counts
and seeds initializers (pressureSM_Poisson/train.py:2-34,255-260). The
port draws its own randomness from explicit torch.Generators; what
remains is the host RNGs used in dataset assembly, PyTorch's global
generator, and the CUDA library paths that may pick a non-deterministic
algorithm (cuBLAS workspaces, cuDNN autotuning, atomics).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def enable_determinism(seed: int = 0) -> None:
    """Seed every host RNG and PyTorch's global generator, and ask for
    deterministic algorithms.

    `CUBLAS_WORKSPACE_CONFIG` is read when cuBLAS creates its handle, so
    call this before the first matrix product on the card. The request
    is `warn_only`: ops with no deterministic CUDA form (`index_add_`,
    `scatter_add_` on floats) warn and still run, so the main path keeps
    running on the card."""
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
