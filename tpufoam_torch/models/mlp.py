"""Neural networks operating on PCA coefficients.

The architecture family of the JAX package, with its width table:
`dense` (relu MLP, linear head), `attention` (a dense layer, then an
8-head key_dim-64 self-attention block over a sequence of length 1 with a
LayerNorm, then residual dense + LayerNorm layers) and `conv1d` (same-
padded 1D convolutions over the PC axis, a dense head). Parameters are
plain dictionaries in the JAX package's layout:

  dense      {"layers": [{"w": (fan_in, fan_out), "b": (fan_out,)}, ...],
              "head": {"w", "b"}}
  attention  the same, plus "attn": {"wq", "wk", "wv": (d, h, k),
             "wo": (h, k, d), "bo": (d,)} and "ln": [{"g", "b"}, ...]
  conv1d     "layers": [{"w": (kernel, c_in, c_out), "b": (c_out,)}, ...]
             and a dense "head" over the flattened (PC, channel) axes

`init_model` draws a tree from a torch.Generator (glorot-uniform
weights, zero biases, the JAX package's shapes and order of draws; not
its bits). `apply_model` takes a dropout generator in training.

Products run in `compute_dtype` (bf16 by default) with float32
parameters and bias adds. The dense and attention products round their
result to the compute dtype, as JAX's `@` and `einsum` do; the
convolutions, like JAX's (`preferred_element_type=float32`), sum the
products of the rounded operands in float32 and round nothing after.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import DEFAULT_DEVICE

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

ARCH_TABLE = {
    # name: widths
    "MLP_small": [512] * 3,
    "MLP_big": [256] + [512] * 5 + [256],
    "MLP_huge": [256] + [512] * 10 + [256],
    "MLP_huger": [256] + [512] * 18 + [256],
    "MLP_small_unet": [512, 256, 128, 64, 32, 64, 128, 256, 512],
    "conv1D": [128, 64, 32, 16, 32, 64, 128],
    "MLP_attention": [512] * 3,
}


def define_model_arch(name: str) -> tuple[int, list[int]]:
    """(n_layers, widths) of a named architecture."""
    if name not in ARCH_TABLE:
        raise ValueError(f"Invalid NN model type {name!r}")
    w = ARCH_TABLE[name]
    return len(w), list(w)


@dataclasses.dataclass(frozen=True)
class ModelDef:
    kind: str                  # 'dense' | 'attention' | 'conv1d'
    widths: tuple
    in_dim: int
    out_dim: int
    dropout_rate: float | None = None
    l2: float | None = None
    num_heads: int = 8
    key_dim: int = 64
    kernel_size: int = 3
    compute_dtype: str = "bfloat16"

    @staticmethod
    def from_arch(name: str, in_dim: int, out_dim: int, **kw) -> "ModelDef":
        _, widths = define_model_arch(name)
        kind = {"conv1D": "conv1d", "MLP_attention": "attention"}.get(
            name, "dense")
        return ModelDef(kind=kind, widths=tuple(widths), in_dim=in_dim,
                        out_dim=out_dim, **kw)


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


def param_skeleton(mdef: ModelDef) -> dict:
    """The parameter tree of `mdef` with None leaves: its structure, for
    rebuilding a tree from its leaves in JAX's flattening order."""
    def dense():
        return {"w": None, "b": None}

    tree = {"layers": [dense() for _ in mdef.widths], "head": dense()}
    if mdef.kind == "attention":
        tree["attn"] = dict.fromkeys(("wq", "wk", "wv", "wo", "bo"))
        tree["ln"] = [{"g": None, "b": None}
                      for _ in range(1 + len(mdef.widths))]
    elif mdef.kind not in ("dense", "conv1d"):
        raise ValueError(mdef.kind)
    return tree


def tree_leaves(tree) -> list:
    """The leaves in JAX's flattening order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def treedef_str(tree) -> str:
    """The structure of a parameter tree as JAX prints its PyTreeDef
    (a bundle's `params_tree.json`)."""
    def s(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {s(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(s(v) for v in t) + "]"
        return "*"

    return f"PyTreeDef({s(tree)})"


def tree_unflatten(like, flat: list):
    """The tree of `like`'s structure with `flat` as its leaves, in
    tree_leaves order."""
    it = iter(flat)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [fill(v) for v in t]
        return next(it)

    return fill(like)


def unflatten_params(mdef: ModelDef, flat: list) -> dict:
    """The parameter tree of `mdef` from its leaves in JAX's flattening
    order (a bundle's `param_i` list)."""
    skel = param_skeleton(mdef)
    n = len(tree_leaves(skel))
    if len(flat) != n:
        raise ValueError(f"expected {n} {mdef.kind} parameters, found "
                         f"{len(flat)}")
    return tree_unflatten(skel, flat)


def _generator(key, on) -> torch.Generator:
    """`key` as a torch.Generator: a generator as it is, an int as a new
    generator on the device `on` seeded with it."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(on).manual_seed(int(key))


def _uniform(gen: torch.Generator, shape, lim: float) -> torch.Tensor:
    return torch.empty(shape, device=gen.device).uniform_(-lim, lim,
                                                          generator=gen)


def _dense_init(gen: torch.Generator, fan_in: int, fan_out: int) -> dict:
    """Glorot-uniform kernel, zero bias."""
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return {"w": _uniform(gen, (fan_in, fan_out), lim),
            "b": torch.zeros((fan_out,), device=gen.device)}


def init_model(key, mdef: ModelDef, device=DEFAULT_DEVICE) -> dict:
    """Initial parameters of `mdef` on `device`, drawn from `key` (a
    torch.Generator, or an int seed of a CPU generator): glorot-uniform
    kernels, zero biases, unit LayerNorm gains, in the JAX package's tree
    and order of draws (layers, head, then the attention weights)."""
    gen = _generator(key, "cpu")
    params = {"layers": []}
    if mdef.kind in ("dense", "attention"):
        dims = [mdef.in_dim, *mdef.widths]
        for i in range(len(mdef.widths)):
            params["layers"].append(_dense_init(gen, dims[i], dims[i + 1]))
        params["head"] = _dense_init(gen, mdef.widths[-1], mdef.out_dim)
        if mdef.kind == "attention":
            d, h, kd = mdef.widths[0], mdef.num_heads, mdef.key_dim
            lim = float(np.sqrt(6.0 / (d + h * kd)))
            params["attn"] = {n: _uniform(gen, (d, h, kd), lim)
                              for n in ("wq", "wk", "wv")}
            params["attn"]["wo"] = _uniform(gen, (h, kd, d), lim)
            params["attn"]["bo"] = torch.zeros((d,), device=gen.device)
            params["ln"] = [{"g": torch.ones((d,), device=gen.device),
                             "b": torch.zeros((d,), device=gen.device)}
                            for _ in range(1 + len(mdef.widths))]
    elif mdef.kind == "conv1d":
        c_in = 1
        for w in mdef.widths:
            lim = float(np.sqrt(6.0 / (mdef.kernel_size * c_in + w)))
            params["layers"].append({
                "w": _uniform(gen, (mdef.kernel_size, c_in, w), lim),
                "b": torch.zeros((w,), device=gen.device)})
            c_in = w
        params["head"] = _dense_init(gen, mdef.in_dim * mdef.widths[-1],
                                     mdef.out_dim)
    else:
        raise ValueError(mdef.kind)
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, *trees):
    """fn over the leaves of parameter trees of one structure (nested
    dicts and lists), the structure kept."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def _layernorm(x, g, b, eps=1e-3):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _conv_same(h: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """SAME-padded stride-1 cross-correlation of (B, W, C_in) with a
    (kernel, C_in, C_out) weight, JAX's NWC/WIO layout: the operands
    rounded to `cdt`, the products summed in float32 (TF32 off, so that the
    card keeps every bit of the float32 sum)."""
    x = h.to(cdt).float().transpose(1, 2)                # (B, C_in, W)
    k = w.to(cdt).float().permute(2, 1, 0)               # (C_out, C_in, K)
    ks = k.shape[-1]
    x = F.pad(x, ((ks - 1) // 2, ks // 2))
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    deterministic=True, allow_tf32=False):
        return F.conv1d(x, k).transpose(1, 2)            # (B, W, C_out)


def attention_res(params: dict, mdef: ModelDef,
                  h: torch.Tensor) -> torch.Tensor:
    """The attention kind's block after its first dense layer: the
    one-token multi-head attention of h (its activations, rounded to the
    compute dtype), its output dense, then the first LayerNorm."""
    cdt = _DTYPES[mdef.compute_dtype]
    h = h.to(cdt)
    a = params["attn"]
    q = torch.einsum("bd,dhk->bhk", h, a["wq"].to(cdt))
    k_ = torch.einsum("bd,dhk->bhk", h, a["wk"].to(cdt))
    v = torch.einsum("bd,dhk->bhk", h, a["wv"].to(cdt))
    # a sequence of length 1: the softmax over its one key is 1
    scale = torch.tensor(float(mdef.key_dim)).sqrt().to(cdt)
    scores = torch.sum(q * k_, dim=-1, keepdim=True) / scale
    attn = v * torch.softmax(scores, dim=-1)
    o = torch.einsum("bhk,hkd->bd", attn, a["wo"].to(cdt)).float() + a["bo"]
    return _layernorm(o, params["ln"][0]["g"], params["ln"][0]["b"])


def apply_model(params: dict, mdef: ModelDef, x: torch.Tensor,
                dropout_key=None) -> torch.Tensor:
    """Forward pass, (batch, PC_in) -> (batch, PC_out). Pass
    `dropout_key` (a torch.Generator on x's device, or an int seed of
    one) only in training: with `mdef.dropout_rate` set, each layer's
    activations then take a fresh mask drawn from it, kept with
    probability 1 - rate and scaled by 1 / (1 - rate). Without it, no
    dropout (the serving form)."""
    cdt = _DTYPES[mdef.compute_dtype]
    rate = mdef.dropout_rate
    gen = (_generator(dropout_key, x.device)
           if rate and dropout_key is not None else None)

    def dense(p, h):
        return (h.to(cdt) @ p["w"].to(cdt)).float() + p["b"]

    def maybe_dropout(h):
        if gen is None:
            return h
        keep = torch.rand(h.shape, generator=gen, device=h.device) \
            < 1.0 - rate
        return torch.where(keep, h / (1.0 - rate), 0.0)

    if mdef.kind == "dense":
        h = x
        for p in params["layers"]:
            h = maybe_dropout(torch.relu(dense(p, h)))
        return dense(params["head"], h)

    if mdef.kind == "attention":
        h = maybe_dropout(torch.relu(dense(params["layers"][0], x)))
        res = attention_res(params, mdef, h)
        for i, p in enumerate(params["layers"][1:], start=1):
            hh = maybe_dropout(torch.relu(dense(p, res)))
            res = _layernorm(hh + res, params["ln"][i]["g"],
                             params["ln"][i]["b"])
        return dense(params["head"], res)

    if mdef.kind == "conv1d":
        h = x[:, :, None]                                # (B, PC_in, 1)
        for p in params["layers"]:
            h = maybe_dropout(torch.relu(_conv_same(h, p["w"], cdt)
                                         + p["b"]))
        return dense(params["head"], h.reshape(h.shape[0], -1))

    raise ValueError(mdef.kind)


def l2_penalty(params: dict) -> torch.Tensor:
    """Sum of squared kernel weights (keras regularizers.l2 semantics)."""
    leaves = [p["w"] for p in params["layers"]] + [params["head"]["w"]]
    return sum(torch.sum(w.float() ** 2) for w in leaves)


def count_params(params) -> int:
    return sum(int(np.prod(t.shape)) for t in tree_leaves(params))
