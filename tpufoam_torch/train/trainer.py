"""Surrogate training: PCA fit + MLP training + artifact bundling.

The reference's `apply_PCA` + `load_data_And_train` stages: PCA on
max-abs-scaled flattened blocks, the PC count by explained-variance
threshold, PCA-space standardization, Adam on the 1e6-scaled MSE,
relative-change early stopping and best-validation selection after a
burn-in.

An epoch draws a permutation of the training rows from the trainer's
generator and runs its batches eagerly; the batch losses are summed on
the device, so the host reads one pair of numbers (train and validation
loss) an epoch. With dropout every batch gets a fresh mask: the epoch
draws a seed from a CPU generator and each batch folds its index into
it. Checkpoints hold plain tensors and Python values (parameters, the
Adam state, both generators' states, the histories and the best
parameters), so a resumed run continues the same streams and equals an
uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..models.mlp import (ModelDef, apply_model, init_model, l2_penalty,
                          tree_leaves, tree_map, tree_unflatten)
from ..surrogate.pca import PCAModel, StreamingPCA, full_f32
from ..surrogate.pipeline import SurrogateBundle
from .dataset import BlockDataset


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    arch: str = "MLP_small"
    lr: float = 1e-4
    beta1: float = 0.9                # the reference's beta_1 flag
    batch_size: int = 1024
    max_epochs: int = 500
    var_in: float = 0.95
    var_out: float = 0.95
    max_num_pc: int = 512
    standardization: str = "std"
    dropout: float | None = None
    l2: float | None = None
    early_stop_patience: int = 100    # the relative-change rule
    early_stop_delta: float = 1e-4
    best_after_epoch: int = 20
    val_fraction: float = 0.1         # 90/10 split
    loss_scale: float = 1e6
    # 'variance': weight the PC-space MSE by std_out^2 (normalized to mean
    # 1) so that it equals the physical-space block MSE up to a constant
    # (the PCA basis is orthonormal); 'uniform': the plain MSE
    loss_weighting: str = "uniform"   # 'uniform' | 'variance'
    seed: int = 0
    pca_chunk: int = 2048
    # stage the normalized flat chunks on the device once, one side at a
    # time, for StreamingPCA's passes to re-read there
    pca_device_cache: bool = False


@dataclasses.dataclass
class TrainState:
    params: dict
    history: list
    val_history: list
    best_val: float
    best_epoch: int


def mse_loss_1e6(pred: torch.Tensor, target: torch.Tensor,
                 scale: float = 1e6) -> torch.Tensor:
    return scale * torch.mean((pred - target) ** 2)


# ---------------------------------------------------------------------------
# Adam, functional (optax.adam's contract and arithmetic)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam(lr, b1, b2, eps, eps_root): `init(params) -> state`,
    `update(grads, state, params) -> (updates, state)`, with
    `apply_updates(params, updates)`. The state is {"count": int, "mu":
    tree, "nu": tree}; nothing is updated in place."""
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params) -> dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state: dict, params=None):
        count = state["count"] + 1
        g = tree_leaves(grads)
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - self.b1),
                                torch._foreach_mul(tree_leaves(state["mu"]),
                                                   self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
            torch._foreach_mul(tree_leaves(state["nu"]), self.b2))
        # bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** count)
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(
            torch._foreach_div(nu, bc2), self.eps_root)), self.eps)
        upd = torch._foreach_mul(
            torch._foreach_div(torch._foreach_div(mu, bc1), den), -self.lr)
        return (tree_unflatten(grads, upd),
                {"count": count, "mu": tree_unflatten(grads, mu),
                 "nu": tree_unflatten(grads, nu)})


def apply_updates(params, updates):
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params),
                                                     tree_leaves(updates)))


def value_and_grad(loss_fn, params, *args):
    """(loss, grads) of loss_fn(params, *args), grads in params' tree."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


# ---------------------------------------------------------------------------
# PCA stage
# ---------------------------------------------------------------------------

def _stage_side(ds: BlockDataset, cfg: TrainConfig, side: int,
                device=DEFAULT_DEVICE) -> list:
    """The normalized flat chunks of ONE side (0 = inputs, 1 = targets) on
    `device`. The sides are staged one after the other, so the device
    holds max(x, y) bytes, not their sum."""
    return [torch.as_tensor(ds.flat_normalized(slice(i, i + cfg.pca_chunk),
                                               side=side),
                            device=torch.device(device))
            for i in range(0, ds.n, cfg.pca_chunk)]


def _fit_encode_staged(ds: BlockDataset, cfg: TrainConfig,
                       device=DEFAULT_DEVICE):
    """Device-cached PCA fit + encode, one side at a time:
    (pca_in, pca_out, pc_in, pc_out, z_in, z_out), the codes host
    numpy."""
    k_cap = min(cfg.max_num_pc, ds.n)
    zs, models, pcs = [], [], []
    for side, (seed, var) in enumerate(((cfg.seed, cfg.var_in),
                                        (cfg.seed + 1, cfg.var_out))):
        staged = _stage_side(ds, cfg, side, device)
        pca = StreamingPCA(k_cap, seed=seed).fit(lambda: iter(staged))
        pc = pca.n_components_for_variance(var, k_cap)
        with full_f32():
            z = torch.cat([pca.transform(c, pc) for c in staged])
        zs.append(z.cpu().numpy())
        staged.clear()
        models.append(pca)
        pcs.append(pc)
    return models[0], models[1], pcs[0], pcs[1], zs[0], zs[1]


def fit_pcas(ds: BlockDataset, cfg: TrainConfig, device=DEFAULT_DEVICE
             ) -> tuple[PCAModel, PCAModel, int, int]:
    """Both PCAs, the chunks streamed from the host each pass."""
    n = ds.n

    def chunks(side):
        def gen():
            for i in range(0, n, cfg.pca_chunk):
                yield ds.flat_normalized(slice(i, i + cfg.pca_chunk),
                                         side=side)
        return gen

    k_cap = min(cfg.max_num_pc, n)
    pca_in = StreamingPCA(k_cap, seed=cfg.seed).fit(chunks(0), device)
    pca_out = StreamingPCA(k_cap, seed=cfg.seed + 1).fit(chunks(1), device)
    pc_in = pca_in.n_components_for_variance(cfg.var_in, k_cap)
    pc_out = pca_out.n_components_for_variance(cfg.var_out, k_cap)
    return pca_in, pca_out, pc_in, pc_out


def encode_dataset(ds: BlockDataset, pca_in: PCAModel, pca_out: PCAModel,
                   pc_in: int, pc_out: int, chunk: int = 4096):
    """The dataset's codes (host numpy), encoded on the PCAs' device."""
    dev = pca_in.mean.device
    zs_in, zs_out = [], []
    with full_f32():
        for i in range(0, ds.n, chunk):
            xf, yf = ds.flat_normalized(slice(i, i + chunk))
            zs_in.append(pca_in.transform(torch.as_tensor(xf, device=dev),
                                          pc_in))
            zs_out.append(pca_out.transform(torch.as_tensor(yf, device=dev),
                                            pc_out))
    return torch.cat(zs_in).cpu().numpy(), torch.cat(zs_out).cpu().numpy()


def normalize_pc_space(z_in: np.ndarray, z_out: np.ndarray, method: str):
    """The reference's normalize_PCA_data -> (x, y, norm dict)."""
    if method == "std":
        norm = dict(mean_in=z_in.mean(0), std_in=z_in.std(0) + 1e-12,
                    mean_out=z_out.mean(0), std_out=z_out.std(0) + 1e-12)
        return ((z_in - norm["mean_in"]) / norm["std_in"],
                (z_out - norm["mean_out"]) / norm["std_out"], norm)
    if method == "min_max":
        norm = dict(min_in=z_in.min(0), max_in=z_in.max(0),
                    min_out=z_out.min(0), max_out=z_out.max(0))
        return ((z_in - norm["min_in"]) / (norm["max_in"] - norm["min_in"]),
                (z_out - norm["min_out"]) / (norm["max_out"] - norm["min_out"]),
                norm)
    if method == "max_abs":
        norm = dict(max_abs_in=np.array([np.abs(z_in).max()]),
                    max_abs_out=np.array([np.abs(z_out).max()]))
        return z_in / norm["max_abs_in"], z_out / norm["max_abs_out"], norm
    raise ValueError(method)


def relative_change_early_stop(losses: list, patience: int,
                               min_delta: float) -> bool:
    """The reference's Callback_EarlyStopping: stop when the mean of the
    last `patience` losses moved less than min_delta, relatively, from
    the mean of the `patience` before them."""
    if len(losses) // patience < 2:
        return False
    prev = float(np.mean(losses[::-1][patience:2 * patience]))
    recent = float(np.mean(losses[::-1][:patience]))
    return abs((recent - prev) / prev) < min_delta


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _cpu(tree):
    return tree_map(lambda t: t.detach().cpu()
                    if isinstance(t, torch.Tensor) else t, tree)


def save_checkpoint(path: str, params, opt_state, epoch: int,
                    history: list, val_history: list,
                    best_val: float, best_epoch: int, best_params,
                    rng_state: dict | None = None) -> None:
    """Epoch-level resume state: parameters, the optimizer state (which
    the reference does not keep), the histories, the best parameters and
    `rng_state` (the trainer's generator states), as plain tensors and
    Python values; written to a temporary file and moved into place."""
    tmp = path + ".tmp"
    torch.save(dict(params=_cpu(params), opt_state=_cpu(opt_state),
                    epoch=epoch, history=list(history),
                    val_history=list(val_history), best_val=float(best_val),
                    best_epoch=best_epoch, best_params=_cpu(best_params),
                    rng_state=rng_state), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """A checkpoint of save_checkpoint, its tensors on the CPU."""
    return torch.load(path, weights_only=True)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _fold_in(seed: int, i: int) -> int:
    """A seed for stream i of `seed` (the role of jax.random.fold_in)."""
    return (seed * 0x9E3779B97F4A7C15 + i + 1) % (1 << 63)


def train_surrogate(ds: BlockDataset, family: str,
                    cfg: TrainConfig = TrainConfig(),
                    block_size: int | None = None,
                    overlap_ratio: float = 0.25,
                    checkpoint_path: str | None = None,
                    checkpoint_every: int = 50,
                    verbose: bool = False,
                    precomputed=None,
                    device=DEFAULT_DEVICE) -> tuple[SurrogateBundle,
                                                    TrainState]:
    """The whole training pipeline on `device` -> (serving-ready
    SurrogateBundle, TrainState).

    If `checkpoint_path` exists, training resumes from it. `precomputed`
    = (pca_in, pca_out, pc_in, pc_out, z_in, z_out) skips the PCA fit and
    encode (the architecture-independent part)."""
    device = torch.device(device)
    t0 = time.perf_counter()
    if precomputed is not None:
        pca_in, pca_out, pc_in, pc_out, z_in, z_out = precomputed
    elif cfg.pca_device_cache:
        pca_in, pca_out, pc_in, pc_out, z_in, z_out = \
            _fit_encode_staged(ds, cfg, device)
    else:
        pca_in, pca_out, pc_in, pc_out = fit_pcas(ds, cfg, device)
        z_in, z_out = encode_dataset(ds, pca_in, pca_out, pc_in, pc_out)
    t_pca = time.perf_counter() - t0
    if verbose:
        d_in = ds.x.shape[1] * ds.x.shape[2] * ds.x.shape[3]
        print(f"PCA fit+encode: {ds.n} x {d_in} -> pc_in={pc_in} "
              f"pc_out={pc_out} in {t_pca:.1f}s "
              f"(device_cache={cfg.pca_device_cache})", flush=True)
    x, y, norm = normalize_pc_space(z_in, z_out, cfg.standardization)

    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_val = max(int(len(x) * cfg.val_fraction), 1)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)

    x_tr, y_tr = t(x[n_val:]), t(y[n_val:])
    x_va, y_va = t(x[:n_val]), t(y[:n_val])

    mdef = ModelDef.from_arch(cfg.arch, in_dim=pc_in, out_dim=pc_out,
                              dropout_rate=cfg.dropout, l2=cfg.l2)
    params = init_model(cfg.seed, mdef, device=device)
    opt = Adam(cfg.lr, b1=cfg.beta1)
    opt_state = opt.init(params)
    # the permutations, on the device; the epochs' dropout seeds, on the
    # host
    perm_gen = torch.Generator(device).manual_seed(cfg.seed)
    drop_gen = torch.Generator().manual_seed(cfg.seed)

    bs = min(cfg.batch_size, x_tr.shape[0])
    n_batches = x_tr.shape[0] // bs

    loss_w = None
    if cfg.loss_weighting == "variance":
        if cfg.standardization == "std":
            w = np.asarray(norm["std_out"]) ** 2
        elif cfg.standardization == "min_max":
            w = (np.asarray(norm["max_out"]) - np.asarray(norm["min_out"]))**2
        else:  # max_abs: one global scalar, already physically aligned
            w = np.ones(pc_out)
        loss_w = t(w / w.mean())

    def _mse(pred, target):
        err = (pred - target) ** 2
        if loss_w is not None:
            err = err * loss_w
        return cfg.loss_scale * torch.mean(err)

    def loss_fn(p, xb, yb, dk):
        loss = _mse(apply_model(p, mdef, xb, dropout_key=dk), yb)
        if cfg.l2:
            loss = loss + cfg.l2 * l2_penalty(p)
        return loss

    def epoch_step(params, opt_state):
        idx = torch.randperm(x_tr.shape[0], generator=perm_gen,
                             device=device)
        kdrop = int(torch.randint(1 << 62, (1,), generator=drop_gen))
        tot = torch.zeros((), device=device)
        for bi in range(n_batches):
            sel = idx[bi * bs:(bi + 1) * bs]
            # a fresh dropout mask for every batch
            dk = (torch.Generator(device).manual_seed(_fold_in(kdrop, bi))
                  if mdef.dropout_rate else None)
            loss, g = value_and_grad(loss_fn, params, x_tr[sel], y_tr[sel],
                                     dk)
            updates, opt_state = opt.update(g, opt_state, params)
            params = apply_updates(params, updates)
            tot = tot + loss
        return params, opt_state, tot / n_batches

    def val_loss(p):
        with torch.no_grad():
            return _mse(apply_model(p, mdef, x_va), y_va)

    def rng_state():
        return {"perm": perm_gen.get_state(), "drop": drop_gen.get_state()}

    history, val_history = [], []
    best_val, best_params, best_epoch = np.inf, params, -1
    start_epoch = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = load_checkpoint(checkpoint_path)

        def on(tree):
            return tree_map(lambda a: a.to(device)
                            if isinstance(a, torch.Tensor) else a, tree)

        params, opt_state = on(ck["params"]), on(ck["opt_state"])
        history, val_history = ck["history"], ck["val_history"]
        best_val, best_epoch = ck["best_val"], ck["best_epoch"]
        best_params = on(ck["best_params"])
        if ck["rng_state"] is not None:
            perm_gen.set_state(ck["rng_state"]["perm"])
            drop_gen.set_state(ck["rng_state"]["drop"])
        start_epoch = ck["epoch"] + 1
        if verbose:
            print(f"resumed from {checkpoint_path} at epoch {start_epoch}",
                  flush=True)

    t_train0 = time.perf_counter()
    epoch = start_epoch - 1
    for epoch in range(start_epoch, cfg.max_epochs):
        params, opt_state, tr = epoch_step(params, opt_state)
        tr_loss, vl = torch.stack([tr, val_loss(params)]).tolist()
        history.append(tr_loss)
        val_history.append(vl)
        if epoch >= cfg.best_after_epoch and vl < best_val:
            best_val, best_params, best_epoch = vl, params, epoch
        if verbose and epoch % 20 == 0:
            print(f"epoch {epoch}: train {tr_loss:.4f} val {vl:.4f}",
                  flush=True)
        if checkpoint_path and (epoch + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, opt_state, epoch,
                            history, val_history, best_val, best_epoch,
                            best_params, rng_state())
        if relative_change_early_stop(history, cfg.early_stop_patience,
                                      cfg.early_stop_delta):
            break

    n_epochs_run = epoch - start_epoch + 1
    t_train = time.perf_counter() - t_train0
    if verbose and n_epochs_run > 0 and t_train > 0:
        print(f"trained {n_epochs_run} epochs ({x_tr.shape[0]} rows, "
              f"batch {bs}) in {t_train:.1f}s = "
              f"{n_epochs_run / t_train:.2f} epochs/s, "
              f"{n_epochs_run * n_batches * bs / t_train / 1e3:.1f} krows/s",
              flush=True)

    if best_epoch < 0:
        best_params, best_val = params, float(val_loss(params))

    bundle = SurrogateBundle(
        family=family, mdef=mdef, params=best_params,
        pca_in=pca_in, pca_out=pca_out, pc_in=pc_in, pc_out=pc_out,
        norm_method=cfg.standardization,
        norm={k: t(v) for k, v in norm.items()},
        maxs_in=t(ds.maxs_in), maxs_out=t(ds.maxs_out),
        block_size=block_size or ds.x.shape[1],
        overlap_ratio=overlap_ratio,
    )
    state = TrainState(params=best_params, history=history,
                       val_history=val_history, best_val=float(best_val),
                       best_epoch=best_epoch)
    return bundle, state
