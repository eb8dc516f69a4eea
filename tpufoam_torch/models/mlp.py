"""Neural networks operating on PCA coefficients.

Only the dense MLP (relu hidden layers, linear head) is ported. Parameters
are a plain dictionary in the JAX package's layout:
``{"layers": [{"w": (fan_in, fan_out), "b": (fan_out,)}, ...],
"head": {"w", "b"}}``. Matmuls run in `compute_dtype` (bf16 by default)
with float32 parameters and bias adds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelDef:
    kind: str                  # only 'dense' is ported
    widths: tuple
    in_dim: int
    out_dim: int
    dropout_rate: float | None = None
    l2: float | None = None
    num_heads: int = 8
    key_dim: int = 64
    kernel_size: int = 3
    compute_dtype: str = "bfloat16"


def params_from_numpy(tree, device=DEFAULT_DEVICE):
    """A parameter tree of numpy arrays (nested dicts and lists, e.g. a JAX
    parameter pytree mapped through np.asarray) as float32 tensors on
    `device`, same structure."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, dtype=np.float32),
                        device=torch.device(device))


def apply_model(params: dict, mdef: ModelDef,
                x: torch.Tensor) -> torch.Tensor:
    """Forward pass, (batch, PC_in) -> (batch, PC_out)."""
    if mdef.kind != "dense":
        raise NotImplementedError(f"model kind {mdef.kind!r} is not ported")
    cdt = _DTYPES[mdef.compute_dtype]

    def dense(p, h):
        return (h.to(cdt) @ p["w"].to(cdt)).float() + p["b"]

    h = x
    for p in params["layers"]:
        h = torch.relu(dense(p, h))
    return dense(params["head"], h)
