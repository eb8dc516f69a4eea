"""Physics-informed neural networks — the Chapter-3 PINN baselines.

Rebuilds the reference's four steady-2D-cylinder formulations
(Thesis_Work/Chapter3/Physics-informed/PINN{1..4}/beta*/PINN_steady.py)
in PyTorch, where the nested-GradientTape second derivatives (:231-275)
become batched autograd with `create_graph=True`: each point's outputs
depend only on its own input, so the gradient of a sum over the points
is every point's gradient.

  PINN1: outputs (psi, p); u = dpsi/dy, v = -dpsi/dx (continuity exact);
         NS momentum residuals                         (:212-275)
  PINN2: outputs (psi, p, s11, s22, t12); Cauchy momentum + constitutive
  PINN3: outputs (u, v, p); momentum + continuity residuals
  PINN4: outputs (u, v, p, s11, s22, t12); continuity + Cauchy + constitutive

Network: 7x50 tanh MLP on inputs normalized to [-1, 1] (:195-210).
Parameters are the JAX package's tree, {"layers": [{"w": (in, out),
"b": (out,)}, ...]}, as float32 tensors.
Loss: 1000 * (eq + beta * (wall + inlet + outlet)) — beta is the swept
hyperparameter that names the reference's run directories (:295).
Collocation: Latin hypercube minus the cylinder interior (:62-110);
parabolic inlet profile 1.5*U*(1 - (y/h)^2) (:278-281).
Training: Adam (the port's functional optax.adam, train.trainer.Adam),
then L-BFGS refinement (:431-549): torch.optim.LBFGS with memory 10 and
a strong-Wolfe line search of up to 20 evaluations (optax.lbfgs's zoom
search takes 20), one iteration per step, in place of optax.lbfgs (the
two searches are other algorithms, so they converge alike but not bit
for bit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..train.sampler import lhs_sample
from ..train.trainer import Adam, apply_updates, value_and_grad
from .mlp import _generator, tree_leaves, tree_map, tree_unflatten

N_OUTPUTS = {1: 2, 2: 5, 3: 3, 4: 6}
_LINESEARCH_STEPS = 20           # optax.lbfgs's zoom search's default


@dataclasses.dataclass(frozen=True)
class PinnConfig:
    formulation: int = 1          # 1..4
    beta: float = 1.0             # BC-loss weight (the beta* sweep)
    nu: float = 0.02              # PINN_steady.py:266
    width: int = 50
    depth: int = 7
    loss_scale: float = 1000.0
    u_mean: float = 1.0
    half_height: float = 0.5      # h in the inlet profile (:281)
    x_range: tuple = (0.0, 2.0)
    y_range: tuple = (-0.5, 0.5)
    cyl_center: tuple = (0.5, 0.0)
    cyl_radius: float = 0.1


def init_pinn(key, cfg: PinnConfig, device=DEFAULT_DEVICE) -> dict:
    """Glorot-uniform weights, zero biases, drawn from `key` (a
    torch.Generator, or an int seed of a CPU generator, so that one seed
    gives the same weights on every device), on `device`."""
    gen = _generator(key, "cpu")
    dims = [2] + [cfg.width] * cfg.depth + [N_OUTPUTS[cfg.formulation]]
    params = []
    for i in range(len(dims) - 1):
        lim = float(np.sqrt(6.0 / (dims[i] + dims[i + 1])))
        w = torch.empty((dims[i], dims[i + 1]), device=gen.device)
        params.append({"w": w.uniform_(-lim, lim, generator=gen),
                       "b": torch.zeros((dims[i + 1],), device=gen.device)})
    return tree_map(lambda t: t.to(device), {"layers": params})


def pinn_params_from_numpy(tree, device=DEFAULT_DEVICE) -> dict:
    """A PINN's parameters in the JAX package's layout (`{"layers": [{"w":
    (in, out), "b": (out,)}, ...]}` of numpy arrays, as its `.pkl` holds
    them) as float32 tensors on `device`; the layer widths must chain."""
    layers = tree["layers"]
    for a, b in zip(layers, layers[1:]):
        if np.shape(a["w"])[1] != np.shape(b["w"])[0]:
            raise ValueError("PINN layer widths do not chain: "
                             f"{np.shape(a['w'])} then {np.shape(b['w'])}")
    return {"layers": [
        {k: torch.tensor(np.asarray(lyr[k], dtype=np.float32),
                         device=torch.device(device)) for k in ("w", "b")}
        for lyr in layers]}


def pinn_params_to_numpy(params: dict) -> dict:
    """The inverse of pinn_params_from_numpy: float32 numpy arrays in the
    JAX package's layout, bit for bit."""
    return {"layers": [{k: lyr[k].detach().cpu().numpy() for k in ("w", "b")}
                       for lyr in params["layers"]]}


def _mlp(params: dict, cfg: PinnConfig, xy: torch.Tensor) -> torch.Tensor:
    """(n, 2) -> (n, n_out). Inputs normalized to [-1, 1]
    (Lambda(normalize_X))."""
    lo = torch.tensor([cfg.x_range[0], cfg.y_range[0]], dtype=xy.dtype,
                      device=xy.device)
    hi = torch.tensor([cfg.x_range[1], cfg.y_range[1]], dtype=xy.dtype,
                      device=xy.device)
    h = 2.0 * (xy - lo) / (hi - lo) - 1.0
    for lyr in params["layers"][:-1]:
        h = torch.tanh(h @ lyr["w"] + lyr["b"])
    last = params["layers"][-1]
    return h @ last["w"] + last["b"]


def _grad(y: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Each point's gradient (n, 2) of its value y (n,) with respect to
    its input, kept differentiable."""
    return torch.autograd.grad(y.sum(), xy, create_graph=True)[0]


def _uvp(params: dict, cfg: PinnConfig, xy: torch.Tensor):
    """((n, 3) u, v, p; (n, n_out) raw outputs) at inputs that require
    grad; for psi-formulations via stream-function derivatives (net_uv,
    :212-229)."""
    out = _mlp(params, cfg, xy)
    if cfg.formulation in (1, 2):
        grad_psi = _grad(out[:, 0], xy)
        return torch.stack([grad_psi[:, 1], -grad_psi[:, 0], out[:, 1]],
                           -1), out
    return out[:, :3], out


def uvp_fn(params: dict, cfg: PinnConfig):
    """(n, 2) points -> (n, 3) (u, v, p), differentiable in the
    parameters."""

    def f(xy):
        with torch.enable_grad():
            return _uvp(params, cfg, xy.detach().requires_grad_())[0]

    return f


def _residuals(params: dict, cfg: PinnConfig, xy: torch.Tensor) -> torch.Tensor:
    """(n, n_res) stacked PDE residuals at the collocation points."""
    nu = cfg.nu
    with torch.enable_grad():
        xy = xy.detach().requires_grad_()
        uvp, out = _uvp(params, cfg, xy)
        u, v, p = uvp.unbind(-1)
        du = _grad(u, xy)      # (u_x, u_y)
        dv = _grad(v, xy)
        dp = _grad(p, xy)

        if cfg.formulation in (1, 3):
            # Laplacians via second grads
            d2u = _grad(du[:, 0], xy)[:, 0] + _grad(du[:, 1], xy)[:, 1]
            d2v = _grad(dv[:, 0], xy)[:, 0] + _grad(dv[:, 1], xy)[:, 1]
            rx = u * du[:, 0] + v * du[:, 1] + dp[:, 0] - nu * d2u
            ry = u * dv[:, 0] + v * dv[:, 1] + dp[:, 1] - nu * d2v
            if cfg.formulation == 3:
                return torch.stack([rx, ry, du[:, 0] + dv[:, 1]], -1)
            return torch.stack([rx, ry], -1)

        # stress formulations (2, 4): outputs [..., s11, s22, t12]
        i11, i22, i12 = {2: (2, 3, 4), 4: (3, 4, 5)}[cfg.formulation]
        s11, s22, t12 = out[:, i11], out[:, i22], out[:, i12]
        ds11 = _grad(s11, xy)
        ds22 = _grad(s22, xy)
        dt12 = _grad(t12, xy)

        rx = u * du[:, 0] + v * du[:, 1] - (ds11[:, 0] + dt12[:, 1])
        ry = u * dv[:, 0] + v * dv[:, 1] - (dt12[:, 0] + ds22[:, 1])
        c11 = s11 - (-p + 2.0 * nu * du[:, 0])
        c22 = s22 - (-p + 2.0 * nu * dv[:, 1])
        c12 = t12 - nu * (du[:, 1] + dv[:, 0])
        res = [rx, ry, c11, c22, c12]
        if cfg.formulation == 4:
            res.append(du[:, 0] + dv[:, 1])
        return torch.stack(res, -1)


def pinn_loss(params: dict, cfg: PinnConfig, batch: dict) -> torch.Tensor:
    """1000 * (eq + beta*(wall + inlet + outlet)) (eq_loss_NS_2, :282-297),
    differentiable in the parameters."""
    uvp = uvp_fn(params, cfg)
    res = _residuals(params, cfg, batch["colloc"])
    loss_eq = torch.mean(res**2)

    u_i, v_i, _ = uvp(batch["inlet"]).T
    _, _, p_o = uvp(batch["outlet"]).T
    u_w, v_w, _ = uvp(batch["walls"]).T

    loss_inlet = torch.mean((u_i - batch["u_inlet_true"]) ** 2) \
        + torch.mean(v_i**2)
    loss_outlet = torch.mean(p_o**2)
    loss_wall = torch.mean(u_w**2) + torch.mean(v_w**2)

    return cfg.loss_scale * (loss_eq + cfg.beta
                             * (loss_wall + loss_inlet + loss_outlet))


def make_training_points(cfg: PinnConfig, n_colloc: int = 5000,
                         n_bc: int = 200, seed: int = 0,
                         device=DEFAULT_DEVICE) -> dict:
    """LHS collocation minus the cylinder interior (DelCylPT, :104-110) +
    boundary point sets with the parabolic inlet profile (:278-281), as
    float32 tensors on `device`. The hypercube is drawn from a CPU
    generator seeded with `seed`."""
    pts = lhs_sample(torch.Generator().manual_seed(seed), n_colloc).numpy()
    lo = np.array([cfg.x_range[0], cfg.y_range[0]])
    hi = np.array([cfg.x_range[1], cfg.y_range[1]])
    pts = lo + pts * (hi - lo)
    c = np.array(cfg.cyl_center)
    keep = ((pts - c) ** 2).sum(1) > cfg.cyl_radius**2
    colloc = pts[keep]

    y = np.linspace(cfg.y_range[0], cfg.y_range[1], n_bc)
    x = np.linspace(cfg.x_range[0], cfg.x_range[1], n_bc)
    inlet = np.stack([np.full_like(y, cfg.x_range[0]), y], -1)
    outlet = np.stack([np.full_like(y, cfg.x_range[1]), y], -1)
    t = np.linspace(0, 2 * np.pi, n_bc)
    walls = np.concatenate([
        np.stack([x, np.full_like(x, cfg.y_range[0])], -1),
        np.stack([x, np.full_like(x, cfg.y_range[1])], -1),
        # cylinder surface is a wall too
        c + cfg.cyl_radius * np.stack([np.cos(t), np.sin(t)], -1),
    ])
    u_inlet_true = 1.5 * cfg.u_mean * (1.0 - (y / cfg.half_height) ** 2)

    def j(a):
        return torch.tensor(np.asarray(a, dtype=np.float32),
                            device=torch.device(device))

    return dict(colloc=j(colloc), inlet=j(inlet), outlet=j(outlet),
                walls=j(walls), u_inlet_true=j(u_inlet_true))


def _adam_phase(params: dict, cfg: PinnConfig, batch: dict, steps: int,
                lr: float, history: list, verbose: bool = False) -> dict:
    """`steps` Adam steps from `params`; the loss before every 100th step
    appended to `history`."""
    opt = Adam(lr)
    opt_state = opt.init(params)
    for i in range(steps):
        loss, g = value_and_grad(lambda p: pinn_loss(p, cfg, batch), params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = apply_updates(params, updates)
        if i % 100 == 0:
            history.append(float(loss))
            if verbose:
                print(f"adam {i}: {float(loss):.4f}", flush=True)
    return params


def _lbfgs_phase(params: dict, cfg: PinnConfig, batch: dict, steps: int,
                 history: list, verbose: bool = False) -> dict:
    """`steps` L-BFGS iterations (memory 10, strong-Wolfe line search,
    unit initial step after the first); the loss before every 50th step
    appended to `history`. `max_eval` bounds the line search's
    evaluations (to max_eval - 1): its default, max_iter * 5 // 4, is 1
    here, which leaves the search none, so a first trial that raises the
    loss returns a zero step, and every later step repeats it."""
    leaves = [t.detach().clone().requires_grad_()
              for t in tree_leaves(params)]
    lbfgs = torch.optim.LBFGS(leaves, lr=1, history_size=10, max_iter=1,
                              max_eval=_LINESEARCH_STEPS + 1,
                              line_search_fn="strong_wolfe")

    def closure():
        lbfgs.zero_grad()
        loss = pinn_loss(tree_unflatten(params, leaves), cfg, batch)
        loss.backward()
        return loss

    for i in range(steps):
        loss = lbfgs.step(closure).detach()
        if i % 50 == 0:
            history.append(float(loss))
            if verbose:
                print(f"lbfgs {i}: {float(loss):.4f}", flush=True)
    return tree_unflatten(params, [t.detach() for t in leaves])


def train_pinn(cfg: PinnConfig, batch: dict, adam_steps: int = 1000,
               lbfgs_steps: int = 200, lr: float = 1e-3, seed: int = 0,
               verbose: bool = False) -> tuple[dict, list]:
    """Adam warm-up then L-BFGS refinement (PINN_steady.py:431-561), on
    the batch's device; weights from init_pinn(seed)."""
    params = init_pinn(seed, cfg, device=batch["colloc"].device)
    history = []
    params = _adam_phase(params, cfg, batch, adam_steps, lr, history,
                         verbose)
    if lbfgs_steps > 0:
        params = _lbfgs_phase(params, cfg, batch, lbfgs_steps, history,
                              verbose)
    history.append(float(pinn_loss(params, cfg, batch).detach()))
    return params, history


def save_pinn_h5(path: str, params: dict, cfg: PinnConfig,
                 history=None) -> None:
    """Keras-layout .h5 checkpoint — the reference's my_model_ref.h5 /
    my_model_ref_afterLFGS.h5 artifacts (PINN_steady.py:419,561). The
    dense stack maps onto the Keras `model_weights` layout via
    models.keras_compat; cfg/history ride as root attrs."""
    import json

    import h5py

    from .keras_compat import save_keras_dense_h5

    layers = params["layers"]
    save_keras_dense_h5(path, {"layers": layers[:-1], "head": layers[-1]})
    with h5py.File(path, "a") as f:
        f.attrs["tpufoam_pinn_cfg"] = json.dumps(
            {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in cfg.__dict__.items()})
        if history is not None:
            f.attrs["tpufoam_history"] = json.dumps(list(history))


def load_pinn_h5(path: str, device=DEFAULT_DEVICE
                 ) -> tuple[dict, PinnConfig, list]:
    """Read back (params on `device`, cfg, history) from a save_pinn_h5
    file — also accepts a plain reference-style Keras dense .h5 (cfg
    defaults)."""
    import json

    import h5py

    from .keras_compat import load_keras_dense_h5

    _, kp = load_keras_dense_h5(path, device=device)
    params = {"layers": list(kp["layers"]) + [kp["head"]]}
    cfg_kw, history = {}, []
    with h5py.File(path, "r") as f:
        if "tpufoam_pinn_cfg" in f.attrs:
            cfg_kw = json.loads(f.attrs["tpufoam_pinn_cfg"])
            cfg_kw = {k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in cfg_kw.items()}
        if "tpufoam_history" in f.attrs:
            history = json.loads(f.attrs["tpufoam_history"])
    return params, PinnConfig(**cfg_kw), history
