"""The surrogate's network on PCA coefficients: the dense MLP (relu
layers, a linear head) of the JAX package, with its parameters as plain
dictionaries in that package's layout,

  {"layers": [{"w": (fan_in, fan_out), "b": (fan_out,)}, ...],
   "head": {"w", "b"}},

loaded from a bundle's leaves in JAX's flattening order. Products run in
`compute_dtype` (bf16 by default) with float32 parameters and bias adds,
and round their result to the compute dtype, as JAX's `@` does. Other
model kinds raise ValueError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelDef:
    kind: str                  # 'dense' (the only kind served here)
    widths: tuple
    in_dim: int
    out_dim: int
    dropout_rate: float | None = None
    l2: float | None = None
    num_heads: int = 8
    key_dim: int = 64
    kernel_size: int = 3
    compute_dtype: str = "bfloat16"


def params_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a float32 tensor on `device`."""
    return torch.tensor(np.asarray(a, dtype=np.float32),
                        device=torch.device(device))


def unflatten_params(mdef: ModelDef, flat: list) -> dict:
    """The dense tree of `mdef` from its leaves in JAX's flattening order
    (dict keys sorted: "head" before "layers", "b" before "w")."""
    if mdef.kind != "dense":
        raise ValueError(f"model kind {mdef.kind!r}: the reference serves "
                         f"the dense MLP only")
    n = 2 * (1 + len(mdef.widths))
    if len(flat) != n:
        raise ValueError(f"expected {n} dense parameters, found "
                         f"{len(flat)}")
    pairs = [{"b": flat[i], "w": flat[i + 1]} for i in range(0, n, 2)]
    return {"head": pairs[0], "layers": pairs[1:]}


def apply_model(params: dict, mdef: ModelDef,
                x: torch.Tensor) -> torch.Tensor:
    """Forward pass, (batch, PC_in) -> (batch, PC_out), no dropout."""
    cdt = _DTYPES[mdef.compute_dtype]

    def dense(p, h):
        return (h.to(cdt) @ p["w"].to(cdt)).float() + p["b"]

    h = x
    for p in params["layers"]:
        h = torch.relu(dense(p, h))
    return dense(params["head"], h)
