"""Probes of the training path at chip_smoke.py's training envelope.

    python -m tpufoam_torch.tools.train_probe [--svd] [--epochs 40,50,100,200]
        [--ny 256 --block 128] [--device cuda|cpu]

Builds what `chip_smoke.py`'s train-data phase builds: the cylinder
channel of scripts/train_ref_scale.py (obstacle 0.5, nu 8e-3) at
delta 2/ny (256 x 1024 by default), 20 warm-up steps and 12 frames of 2
steps (MGCG rtol 1e-6 with the kernel smoother, the momentum kernel),
120 samples a frame with the y-flip, then the block dataset. Prints JSON
lines (each with the card's name and power limit):

  data    the blocks and the seconds taken;
  loss    with --epochs: train_surrogate at the envelope's settings
          (MLP_small, batch 1024, lr 2e-4, max_num_pc 512, variance
          weighting) for the largest count given, the train loss at each
          count given as a ratio to the first epoch's;
  svd     with --svd (a card only): on the first 1,024 rows of the
          inputs' side, the largest principal angle (rad) of the top 1,
          2, 4 and 8 components against a float64 fit (eigh of the
          centred Gram matrix), for StreamingPCA, fit_pca_exact,
          torch.linalg.svd in float32 with each cuSOLVER driver (None is
          PyTorch's default), and the CPU's float32 SVD.

A smaller --ny and --block rehearse the envelope on the CPU
(--device cpu --ny 128 --block 64: a quarter of its grid).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def _angles(comp, ref, ks=(1, 2, 4, 8)) -> dict:
    out = {}
    for k in ks:
        sv = torch.linalg.svdvals(comp[:k].double().cpu()
                                  @ ref[:k].double().cpu().T)
        out[k] = float(torch.arccos(torch.clamp(sv.min(), max=1.0)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ny", type=int, default=256)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--epochs", default="")
    ap.add_argument("--svd", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_probe: no CUDA device (--device cpu asks "
                         "for the CPU)")
    if args.svd and dev.type != "cuda":
        raise SystemExit("train_probe: --svd compares cuSOLVER's drivers: "
                         "it needs a card")

    from ..core.geometry import channel_case_geometry
    from ..fv.case import build_channel_case, initial_flow
    from ..piso.engine import PisoConfig, run_piso_eager
    from ..solvers.backends import MGCGBackend
    from ..surrogate.pca import StreamingPCA, fit_pca_exact, full_f32
    from ..train.dataset import build_block_dataset, frames_from_rollout
    from ..train.trainer import TrainConfig, _fit_encode_staged, \
        train_surrogate

    card = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t = time.time()
    case = build_channel_case(channel_case_geometry(
        "cylinder", length=8.0, height=2.0, obstacle_size=0.5, nu=8e-3),
        delta=2.0 / args.ny, device=dev)
    cfg = PisoConfig(max_co=0.5, max_dt=5e-3, momentum_smoother="kernel")
    backend = MGCGBackend(rtol=1e-6, smoother="kernel")
    flow = run_piso_eager(case, initial_flow(case, 1e-3), 20, cfg=cfg,
                          backend=backend)
    frames = frames_from_rollout(case, flow, 12, 2, cfg=cfg,
                                 backend=backend)
    ds = build_block_dataset(case, frames, n_samples_per_frame=120,
                             block_size=args.block, seed=0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(json.dumps({"probe": "data", "device": str(dev), "card": card,
                      "shape": list(case.grid.shape), "blocks": ds.n,
                      "seconds": time.time() - t}), flush=True)

    if args.epochs:
        counts = sorted(int(e) for e in args.epochs.split(","))
        tcfg = TrainConfig(arch="MLP_small", lr=2e-4, batch_size=1024,
                           max_epochs=counts[-1], max_num_pc=512,
                           best_after_epoch=20, pca_device_cache=True,
                           loss_weighting="variance")
        pre = _fit_encode_staged(ds, tcfg, dev)
        _, state = train_surrogate(ds, "deltaU_deltaP", tcfg,
                                   precomputed=pre, device=dev)
        h = state.history
        print(json.dumps({"probe": "loss", "pc_in": pre[2],
                          "pc_out": pre[3], "first": h[0],
                          "ratio_at_epoch": {e: h[e - 1] / h[0]
                                             for e in counts}}), flush=True)

    if args.svd:
        sub = ds.flat_normalized(slice(0, 1024), side=0)
        x64 = torch.as_tensor(sub, device=dev, dtype=torch.float64)
        xc64 = x64 - x64.mean(0)
        _, u = torch.linalg.eigh(xc64 @ xc64.T)
        ref = u.flip(1)[:, :8].T @ xc64
        ref = ref / ref.norm(dim=1, keepdim=True)        # orthonormal rows
        x = torch.as_tensor(sub, device=dev)
        k = min(512, len(sub))
        res = {"streaming": _angles(StreamingPCA(k).fit(
                   lambda: iter([x])).components, ref),
               "fit_pca_exact": _angles(fit_pca_exact(x, 8).components,
                                        ref)}
        with full_f32():
            xc = x - x.mean(0)
            for driver in (None, "gesvd", "gesvdj", "gesvda"):
                vt = torch.linalg.svd(xc, full_matrices=False,
                                      driver=driver)[2]
                res[f"svd driver={driver}"] = _angles(vt, ref)
            res["cpu svd"] = _angles(torch.linalg.svd(
                xc.cpu(), full_matrices=False)[2], ref)
        print(json.dumps({"probe": "svd", "rows": len(sub),
                          "d": int(sub.shape[1]), "card": card,
                          "angles_rad": res}), flush=True)


if __name__ == "__main__":
    main()
