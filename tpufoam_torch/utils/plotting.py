"""Visualization: field comparisons, random block panels, GIF assembly.

Parity with the reference's matplotlib tooling: side-by-side SM vs CFD
block grids (utils.plot_random_blocks:145-208), field/error imshow panels
(SM_call.py:592-692), and the frame-GIF assembly (utils.createGIF:128-143,
imageio replaced by matplotlib's animation-free PNG stitching via PIL).
All functions are headless-safe (Agg backend); matplotlib is imported
inside them, so the module imports where matplotlib is missing. Arrays
may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .metrics import _host


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_fields(fields: dict, mask: np.ndarray | None, path: str,
                suptitle: str = "") -> None:
    """imshow panel per named field, solid cells masked out."""
    plt = _plt()
    n = len(fields)
    fig, axes = plt.subplots(n, 1, figsize=(14, 3 * n), squeeze=False)
    for ax, (name, f) in zip(axes[:, 0], fields.items()):
        f = _host(f)
        shown = np.ma.array(f, mask=(mask == 0) if mask is not None else None)
        im = ax.imshow(shown, cmap="viridis", origin="lower")
        ax.set_title(name)
        fig.colorbar(im, ax=ax, shrink=0.8)
    if suptitle:
        fig.suptitle(suptitle)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_random_blocks(pred_blocks, true_blocks, mask_blocks, path: str,
                       n_show: int = 9, seed: int = 0) -> None:
    """3x3 SM predictions vs 3x3 ground truth (utils.py:145-208)."""
    plt = _plt()
    pred_blocks = _host(pred_blocks)
    true_blocks = _host(true_blocks)
    mask_blocks = _host(mask_blocks)
    n = pred_blocks.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(n_show, n), replace=False)

    fig, axes = plt.subplots(3, 6, figsize=(18, 9))
    fig.text(0.25, 0.95, "SM Predictions", ha="center", fontsize=14,
             fontweight="bold")
    fig.text(0.75, 0.95, "CFD (Ground Truth)", ha="center", fontsize=14,
             fontweight="bold")
    for slot, k in enumerate(idx):
        r, c = slot // 3, slot % 3
        for ax, data in ((axes[r, c], pred_blocks[k]),
                         (axes[r, c + 3], true_blocks[k])):
            shown = np.ma.array(data, mask=mask_blocks[k] == 0)
            ax.imshow(shown, cmap="viridis", origin="lower")
            ax.set_title(f"Block {k}/{n}", fontsize=9)
            ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def create_gif(png_paths: list[str], out_path: str,
               duration_ms: int = 500) -> None:
    """Stitch saved frames into a GIF (utils.createGIF:128-143)."""
    from PIL import Image
    frames = [Image.open(p).convert("P") for p in png_paths if os.path.exists(p)]
    if not frames:
        return
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)


def plot_loss_history(history, val_history, out_prefix: str) -> None:
    """Loss curves as PNG + txt (train.py:622-631)."""
    np.savetxt(out_prefix + "_loss.txt",
               np.column_stack([_host(history), _host(val_history)]),
               header="train val")
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.semilogy(history, label="train")
    ax.semilogy(val_history, label="validation")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss (MSE x 1e6)")
    ax.legend()
    fig.savefig(out_prefix + "_loss.png", dpi=120, bbox_inches="tight")
    plt.close(fig)


def save_eval_plots(case, bundle, frames: list[dict], out_dir: str,
                    sim: int = 0, stitch: str = "scan") -> None:
    """Per-frame SM-vs-CFD field panels + GIF — the SM_call.py:592-692
    reporting surface. The predictor runs on the frames' device."""
    from ..surrogate.pipeline import make_predictor
    predictor = make_predictor(bundle, stitch=stitch)
    mask = _host(case.fluid)
    paths = []
    for t, fields in enumerate(frames):
        with torch.no_grad():
            p_hat = _host(predictor(case, fields["p_prev"], fields))
        p_true = _host(fields["p"])
        path = os.path.join(out_dir, f"sim{sim}", f"p_pred_t{t}.png")
        plot_fields({
            "SM p": p_hat, "CFD p": p_true,
            "error": p_hat - p_true,
        }, mask, path, suptitle=f"sim {sim} t {t}")
        paths.append(path)
    create_gif(paths, os.path.join(out_dir, f"sim{sim}", "p_movie.gif"))
