"""Point-cloud next-step predictor — the Chapter-3 data-driven baseline.

Rebuilds Thesis_Work/Chapter3/Data-driven/External_flow/train/train.py
with torch.nn: field values [Ux, Uy, p] at N points + point coordinates
-> next-step [Ux, Uy, p]. Architecture parity:

  * feature branch: Conv1D stem -> inception-module U-Net over the point
    axis with skip concats and transposed-conv upsampling (:276-291
    inception_module, :293-352 keras_model1);
  * coordinate branch: PointNet — input/feature T-nets with
    identity-initialized transform and orthogonality penalty (:240-274),
    conv stack, global max-pool feature tiled to all points (:358-370);
  * fusion head: conv+dropout stack, sigmoid outputs (:373-381);
  * masked MSE * 1e6 ignoring the -100 padding (:402-426) — vectorized.

Deviation from the reference, as in the JAX package: BatchNorm ->
LayerNorm (channel-wise), which avoids mutable batch statistics.

Every module takes and returns (B, N, C), so that LayerNorm and Linear
act on the channel axis; the convolutions transpose to PyTorch's
(B, C, N) and back. Each module is the flax module of the JAX package's
`models/pointnet.py` of the same name, with its submodules in flax's
creation order (`Conv_i` is `conv[i]` / `convs[i]`, `Inception_i`
`inception[i]`, `ConvTranspose_i` `up[i]`, ...), and initialised as flax
initialises (lecun-normal kernels, zero biases, unit LayerNorm scales).
`pointnet_state_from_flax` / `pointnet_state_to_flax` carry a flax
variables tree across, exactly. flax's `init` returns the T-nets' sown
penalties (the "losses" collection) beside the parameters, and the JAX
package keeps them in its parameter tree: its apply appends the fresh
penalty to that carried one, its loss sums both, and its Adam trains
the carried value. Each port T-net holds it as the parameter
`carried_ortho` and adds it to its penalty, so losses and files are the
JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PAD = -100.0


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> torch.Tensor:
    """flax's default kernel init: a normal of variance 1/fan_in truncated
    at two standard deviations (the std corrected for the truncation)."""
    std = float(np.sqrt(1.0 / fan_in)) / 0.8796256610342398
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=gen)


def _channels_first(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A (B, C, N) convolution (or pool) applied to (B, N, C)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def _conv(in_features: int, features: int, kernel: int) -> nn.Conv1d:
    """flax `nn.Conv(features, (kernel,), padding="SAME")`, odd kernel."""
    return nn.Conv1d(in_features, features, kernel,
                     padding=(kernel - 1) // 2)


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 1):
        super().__init__()
        self.conv = _conv(in_features, features, kernel)
        self.norm = nn.LayerNorm(features, eps=1e-6)

    def forward(self, x):
        return torch.relu(self.norm(_channels_first(self.conv, x)))


class DenseBN(nn.Module):
    def __init__(self, in_features: int, features: int,
                 activation: str = "relu"):
        super().__init__()
        self.activation = activation
        self.dense = nn.Linear(in_features, features)
        self.norm = nn.LayerNorm(features, eps=1e-6)

    def forward(self, x):
        x = self.norm(self.dense(x))
        return torch.relu(x) if self.activation == "relu" \
            else torch.sigmoid(x)


class TNet(nn.Module):
    """Spatial/feature transform net with orthogonality penalty
    (train.py:240-274). Returns (transformed x, penalty + carried_ortho).
    """

    def __init__(self, num_features: int, l2reg: float = 1e-3):
        super().__init__()
        k = num_features
        self.num_features = k
        self.l2reg = l2reg
        self.convbn = nn.ModuleList([ConvBN(k, 32), ConvBN(32, 64),
                                     ConvBN(64, 512)])
        self.densebn = nn.ModuleList([DenseBN(512, 256), DenseBN(256, 128)])
        self.dense = nn.Linear(128, k * k)
        self.carried_ortho = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        h = x
        for m in self.convbn:
            h = m(h)
        h = h.amax(dim=1)                 # global max pool over points
        for m in self.densebn:
            h = m(h)
        k = self.num_features
        t = self.dense(h).reshape(-1, k, k)
        eye = torch.eye(k, dtype=t.dtype, device=t.device)
        ortho = torch.sum(self.l2reg * (t @ t.transpose(1, 2) - eye) ** 2)
        return torch.bmm(x, t), ortho + self.carried_ortho


class Inception(nn.Module):
    """4-tower inception module over the point axis (train.py:276-291);
    `convs` in flax's order: tower 0, tower 1 (1, 3), tower 2 (1, 5), the
    pool tower's 1."""

    def __init__(self, in_features: int, filters: int):
        super().__init__()
        f = filters
        self.convs = nn.ModuleList([
            _conv(in_features, f // 4, 1),
            _conv(in_features, f // 4, 1), _conv(f // 4, (f * 3) // 8, 3),
            _conv(in_features, f // 8, 1), _conv(f // 8, f // 8, 5),
            _conv(in_features, f // 4, 1)])

    def forward(self, x):
        c = self.convs
        x = x.transpose(1, 2)
        t0 = F.relu(c[0](x))
        t1 = F.relu(c[2](F.relu(c[1](x))))
        t2 = F.relu(c[4](F.relu(c[3](x))))
        t3 = F.relu(c[5](F.max_pool1d(x, 3, 1, padding=1)))
        return torch.cat([t0, t1, t2, t3], dim=1).transpose(1, 2)


def _down(x):
    return _channels_first(lambda h: F.max_pool1d(h, 2), x)


def _dropout(x: torch.Tensor, rate: float, gen: torch.Generator):
    """flax Dropout: keep with probability 1 - rate, scaled by 1/(1 -
    rate), the mask drawn from `gen`."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# (in, out) channels of the 27 inception modules in flax's creation
# order: c1 and its block, c2, c3, c4 with theirs, the bottleneck block,
# then each up level's block after its skip concat
_INCEPTIONS = ([(8, 16), (16, 16), (16, 16), (16, 32), (32, 32), (32, 32),
                (32, 64), (64, 64), (64, 64), (64, 128), (128, 128),
                (128, 128), (128, 256), (256, 256), (256, 256)]
               + [(c, f) for f in (128, 64, 32, 16)
                  for c in (2 * f, f, f)])


class PointNetUNet(nn.Module):
    """keras_model1 (train.py:293-389). Inputs: fields (B, N, 3),
    coords (B, N, 2); N must be divisible by 16. forward returns (out
    (B, N, out_channels), the T-nets' summed orthogonality penalty).
    Dropout acts only with train=True, its masks drawn from `rng` (a
    torch.Generator on the inputs' device). Weights are drawn from
    `generator` (a CPU torch.Generator, so that one seed gives the same
    weights on every device), or from PyTorch's global generator."""

    def __init__(self, out_channels: int = 3, dropout: float = 0.3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_channels = out_channels
        self.dropout = dropout
        self.conv = nn.ModuleList([_conv(3, 8, 3), _conv(8, 8, 3),
                                   _conv(16, out_channels, 1)])
        self.inception = nn.ModuleList([Inception(c, f)
                                        for c, f in _INCEPTIONS])
        self.up = nn.ModuleList([nn.ConvTranspose1d(2 * f, f, 2, stride=2)
                                 for f in (128, 64, 32, 16)])
        self.tnet = nn.ModuleList([TNet(2), TNet(32)])
        self.convbn = nn.ModuleList([
            ConvBN(2, 32), ConvBN(32, 32), ConvBN(32, 32), ConvBN(32, 64),
            ConvBN(64, 256), ConvBN(32 + 256 + out_channels, 128),
            ConvBN(128, 64), ConvBN(64, 32)])
        self.densebn = nn.ModuleList([
            DenseBN(32, 64), DenseBN(64, out_channels, activation="sigmoid")])
        self._flax_init(generator)

    def _flax_init(self, gen):
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                    k, = m.kernel_size
                    _lecun_normal_(m.weight, k * m.in_channels, gen)
                    m.bias.zero_()
                elif isinstance(m, nn.Linear):
                    _lecun_normal_(m.weight, m.in_features, gen)
                    m.bias.zero_()
            for t in self.tnet:
                k = t.num_features
                t.dense.weight.zero_()
                t.dense.bias.copy_(torch.eye(k).reshape(-1))

    def forward(self, fields, coords, train: bool = False,
                rng: torch.Generator | None = None):
        if train and self.dropout and rng is None:
            raise ValueError("PointNetUNet(train=True) needs a dropout "
                             "generator (rng)")
        x = torch.relu(_channels_first(self.conv[0], fields))
        x = torch.relu(_channels_first(self.conv[1], x))

        inc = iter(self.inception)

        def block(x, n):
            for _ in range(n):
                x = next(inc)(x)
            return x

        skips = []
        for _ in range(4):
            skips.append(block(x, 1))
            x = _down(block(skips[-1], 2))
        x = block(x, 3)
        for up, skip in zip(self.up, reversed(skips)):
            x = _channels_first(up, x)
            x = block(torch.cat([x, skip], dim=-1), 3)
        layer_var = torch.sigmoid(_channels_first(self.conv[2], x))

        # ---- coordinate branch (PointNet) ----
        cb = self.convbn
        y, ortho0 = self.tnet[0](coords)
        y = cb[1](cb[0](y))
        y, ortho1 = self.tnet[1](y)
        y1 = cb[2](y)
        y = cb[4](cb[3](y1))
        g = y.amax(dim=1, keepdim=True).expand(-1, y.shape[1], -1)
        z = torch.cat([y1, g, layer_var], dim=-1)

        z = cb[5](z)
        if train:
            z = _dropout(z, self.dropout, rng)
        z = cb[6](z)
        if train:
            z = _dropout(z, self.dropout, rng)
        z = cb[7](z)
        z = self.densebn[0](z)
        return self.densebn[1](z), ortho0 + ortho1


def masked_mse(pred: torch.Tensor, true: torch.Tensor,
               scale: float = 1e6) -> torch.Tensor:
    """MSE over valid (non-padded) points only (my_mse_loss, :402-426)."""
    valid = (true[..., 0:1] != PAD).to(pred.dtype)
    se = ((pred - true) ** 2 * valid).sum()
    return scale * se / torch.clamp(valid.sum() * true.shape[-1], min=1.0)


def pointnet_loss(model: PointNetUNet, params, fields, coords, targets,
                  rngs=None, train: bool = False):
    """masked_mse of the model's output plus its orthogonality penalty.
    `params`: a state dict (name -> tensor) to run the model with
    (torch.func.functional_call), or None for the model's own; `rngs`:
    the dropout generator."""
    kw = dict(train=train, rng=rngs)
    if params is None:
        out, ortho = model(fields, coords, **kw)
    else:
        out, ortho = torch.func.functional_call(model, params,
                                                (fields, coords), kw)
    return masked_mse(out, targets) + ortho


# ---- flax variables <-> state dict --------------------------------------

_FLAX_CLASS = {"conv": "Conv", "convs": "Conv", "up": "ConvTranspose",
               "inception": "Inception", "tnet": "TNet", "convbn": "ConvBN",
               "densebn": "DenseBN", "dense": "Dense", "norm": "LayerNorm"}


def _flax_path(key: str) -> tuple:
    """The flax path of a state-dict key: ("params", module names...,
    kernel|bias|scale), or ("losses", "TNet_i", "ortho") for a T-net's
    carried penalty."""
    parts = key.split(".")
    path, i = [], 0
    while i < len(parts) - 1:
        name = _FLAX_CLASS[parts[i]]
        if parts[i + 1].isdigit():
            path.append(f"{name}_{parts[i + 1]}")
            i += 2
        else:
            path.append(f"{name}_0")
            i += 1
    leaf = parts[-1]
    if leaf == "carried_ortho":
        return ("losses", *path, "ortho")
    owner = path[-1].rsplit("_", 1)[0]
    kind = {"weight": "scale" if owner == "LayerNorm" else "kernel",
            "bias": "bias"}[leaf]
    return ("params", *path, kind)


def _to_port(kind: str, a: np.ndarray) -> np.ndarray:
    """A flax kernel of module class `kind` as the port's weight."""
    if kind == "Conv":                 # (k, in, out) -> (out, in, k)
        return a.transpose(2, 1, 0)
    if kind == "ConvTranspose":        # flax does not flip: (in, out, k)
        return a[::-1].transpose(1, 2, 0)
    return a.T                         # Dense: (in, out) -> (out, in)


def _to_flax(kind: str, a: np.ndarray) -> np.ndarray:
    """The inverse of _to_port."""
    if kind == "Conv":
        return a.transpose(2, 1, 0)
    if kind == "ConvTranspose":
        return a.transpose(2, 0, 1)[::-1]
    return a.T


def _skeleton(out_channels: int) -> dict:
    with torch.device("meta"):
        model = PointNetUNet(out_channels)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def pointnet_state_from_flax(variables) -> dict:
    """A flax PointNetUNet variables tree of numpy arrays ({"params": ...,
    "losses": {"TNet_i": {"ortho": (x,)}}}, as `init` returns it and the
    JAX package saves it; tuples may be lists) as the port's state dict
    of float32 CPU tensors (its out_channels those of the tree's last
    Dense). Every leaf is consumed and every tensor filled, or it
    raises."""
    head = variables["params"]["DenseBN_1"]["Dense_0"]["kernel"]
    shapes = _skeleton(int(np.shape(head)[1]))
    state, used = {}, set()
    for key, shape in shapes.items():
        path = _flax_path(key)
        node = variables
        for p in path:
            node = node[p]
        if path[0] == "losses":
            (node,) = node
        a = np.asarray(node, np.float32)
        if path[-1] == "kernel":
            a = _to_port(path[-2].rsplit("_", 1)[0], a)
        if a.shape != shape:
            raise ValueError(f"{'/'.join(path)}: {a.shape} for {key} "
                             f"{shape}")
        state[key] = torch.from_numpy(np.array(a, order="C"))
        used.add(path)
    left = [p for p in _leaf_paths(variables) if p not in used]
    if left:
        raise ValueError(f"flax leaves with no port tensor: {left[:5]}")
    return state


def _leaf_paths(tree, path=()):
    """The paths of a tree's leaves, a one-leaf tuple or list under
    "ortho" counted as its node."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaf_paths(tree[k], path + (k,))]
    if path and path[-1] == "ortho":
        return [path]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_paths(v, path + (i,))]
    return [path]


def pointnet_state_to_flax(state: dict) -> dict:
    """The inverse of pointnet_state_from_flax: the flax variables tree
    of float32 numpy arrays (the carried penalties as one-element
    tuples), bit for bit."""
    tree: dict = {}
    for key, t in state.items():
        path = _flax_path(key)
        a = t.detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if path[0] == "losses":
            node[path[-1]] = (a,)
        elif path[-1] == "kernel":
            node[path[-1]] = np.array(
                _to_flax(path[-2].rsplit("_", 1)[0], a), order="C")
        else:
            node[path[-1]] = a
    return tree
