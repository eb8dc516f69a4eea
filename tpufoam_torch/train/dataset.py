"""Training-set construction: simulation frames -> sampled block arrays.

The reference's `process_sim` stage: per-frame nondimensionalization,
the stationarity skip, LHS block sampling with y-flip augmentation, the
discard of all-zero blocks, per-block zero-mean targets, the dataset's
max-abs constants (the `maxs` artifact) and duplicate removal.

Frames come from the port's own PISO rollout (`frames_from_rollout`,
`frames_from_sst_rollout`: dicts of tensors on the case's device) or from
anywhere else as dicts of (ny, nx) arrays or tensors. Inputs and targets
are built on the case's device and the blocks gathered there; the
dataset's arrays are host numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable

import numpy as np
import torch

from ..fv.case import Case
from ..surrogate.blocks import block_zero_mean
from ..surrogate.features import FAMILIES, FamilyConfig
from .sampler import gather_training_blocks, sample_block_corners


@dataclasses.dataclass
class BlockDataset:
    x: np.ndarray        # (N, B, B, C_in)  float32, NOT yet max-abs scaled
    y: np.ndarray        # (N, B, B, C_out) zero-mean where family demands
    mask: np.ndarray     # (N, B, B) SDF-derived flow mask
    maxs_in: np.ndarray  # (C_in,)  the 'maxs' artifact
    maxs_out: np.ndarray  # (C_out,)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def flat_normalized(self, idx: slice | np.ndarray,
                        side: int | None = None):
        """Max-abs-scaled flattened (inputs, targets) for the PCA and NN
        stages; `side` (0 = inputs, 1 = targets) scales only that one (a
        PCA chunk source reads one side several times a fit)."""
        if side == 0:
            xb = self.x[idx] / self.maxs_in
            return xb.reshape(xb.shape[0], -1)
        if side == 1:
            yb = self.y[idx] / self.maxs_out
            return yb.reshape(yb.shape[0], -1)
        xb = self.x[idx] / self.maxs_in
        yb = self.y[idx] / self.maxs_out
        return (xb.reshape(xb.shape[0], -1), yb.reshape(yb.shape[0], -1))


def frame_is_relevant(u, v, u_prev, v_prev, threshold: float = 1e-4) -> bool:
    """The stationarity check: False for a frame whose velocity change is
    below `threshold` of |U|max (or either is below 1e-6)."""
    u, v, u_prev, v_prev = (torch.as_tensor(a) for a in (u, v, u_prev,
                                                         v_prev))
    um, dum = torch.stack([
        torch.amax(torch.sqrt(u**2 + v**2)),
        torch.amax(torch.sqrt((u - u_prev)**2 + (v - v_prev)**2))]).tolist()
    return not (dum / max(um, 1e-12) < threshold or dum < 1e-6 or um < 1e-6)


def frame_on(frame: dict, device) -> dict:
    """A frame's arrays and tensors as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in frame.items()}


def build_block_dataset(case: Case, frames: Iterable[dict],
                        family: FamilyConfig | str = "deltaU_deltaP",
                        n_samples_per_frame: int = 200,
                        block_size: int = 128,
                        seed: int = 0,
                        augment_flip: bool = True,
                        dedup: bool = True) -> BlockDataset:
    """frames: iterable of field dicts (u, v, p, u_prev, v_prev, p_prev),
    arrays or tensors. Returns the sampled block dataset with its
    normalization constants. The corners of each frame and flip come, in
    turn, from one CPU generator seeded with `seed`."""
    if isinstance(family, str):
        family = FAMILIES[family]
    key = torch.Generator().manual_seed(seed)
    dev = case.device

    xs, ys, ms = [], [], []
    for frame in frames:
        frame = frame_on(frame, dev)
        if not frame_is_relevant(frame["u"], frame["v"],
                                 frame.get("u_prev", 0 * frame["u"]),
                                 frame.get("v_prev", 0 * frame["v"])):
            continue
        x_grid = family.build_inputs(case, frame)
        y_grid = family.build_targets(case, frame)
        m_grid = case.sdf

        variants = [(x_grid, y_grid, m_grid)]
        if augment_flip:  # the y-flip "rotation"
            variants.append((x_grid.flip(0), y_grid.flip(0),
                             m_grid.flip(0)))

        for xg, yg, mg in variants:
            corners = sample_block_corners(key, n_samples_per_frame,
                                           case.grid.ny, case.grid.nx,
                                           block_size)
            xb = gather_training_blocks(xg, corners, block_size)
            yb = gather_training_blocks(yg, corners, block_size)
            mb = gather_training_blocks(mg[..., None], corners,
                                        block_size)[..., 0]
            # discard blocks with all-zero inputs and targets
            keep = ~((xb[..., :-1].abs().amax(dim=(1, 2, 3)) == 0)
                     & (yb.abs().amax(dim=(1, 2, 3)) == 0))
            xb, yb, mb = xb[keep], yb[keep], mb[keep]
            if family.target_zero_mean:   # per block
                yb = torch.stack([block_zero_mean(yb[..., c], mb)
                                  for c in range(yb.shape[-1])], dim=-1)
            xs.append(xb.cpu().numpy())
            ys.append(yb.cpu().numpy())
            ms.append(mb.cpu().numpy())

    if not xs:
        raise ValueError("no relevant frames — simulation is stationary")

    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.float32)
    m = np.concatenate(ms).astype(np.float32)

    if dedup:  # exact duplicates, by a content digest
        seen = set()
        uniq = []
        for i in range(x.shape[0]):
            h = hashlib.blake2b(x[i].tobytes() + y[i].tobytes(),
                                digest_size=16).digest()
            if h in seen:
                continue
            seen.add(h)
            uniq.append(i)
        if len(uniq) < x.shape[0]:
            x, y, m = x[uniq], y[uniq], m[uniq]

    maxs_in = np.maximum(np.abs(x).max(axis=(0, 1, 2)),
                         1e-12).astype(np.float32)
    maxs_out = np.maximum(np.abs(y).max(axis=(0, 1, 2)),
                          1e-12).astype(np.float32)
    return BlockDataset(x=x, y=y, mask=m, maxs_in=maxs_in, maxs_out=maxs_out)


def save_block_dataset(path: str, ds: BlockDataset) -> None:
    """The stage cache, in the JAX package's npz keys (x in float16)."""
    np.savez_compressed(path, x=ds.x.astype(np.float16), y=ds.y, mask=ds.mask,
                        maxs_in=ds.maxs_in, maxs_out=ds.maxs_out)


def load_block_dataset(path: str) -> BlockDataset:
    d = np.load(path)
    return BlockDataset(x=d["x"].astype(np.float32), y=d["y"], mask=d["mask"],
                        maxs_in=d["maxs_in"], maxs_out=d["maxs_out"])


def _snapshot(flow) -> dict:
    return dict(u=flow.u, v=flow.v, p=flow.p, u_prev=flow.u_prev,
                v_prev=flow.v_prev, p_prev=flow.p_prev)


def frames_from_rollout(case: Case, flow0, n_frames: int, steps_per_frame: int,
                        cfg=None, backend=None) -> list[dict]:
    """Data production by the port's own PISO rollout: n_frames frames,
    each after steps_per_frame more steps, as dicts of the flow's tensors
    (on the case's device)."""
    from ..piso.engine import PisoConfig, run_piso_eager
    from ..solvers.backends import CGBackend
    cfg = cfg or PisoConfig()
    backend = backend or CGBackend(rtol=1e-6)

    frames = []
    flow = flow0
    for _ in range(n_frames):
        flow = run_piso_eager(case, flow, steps_per_frame, cfg=cfg,
                              backend=backend)
        frames.append(_snapshot(flow))
    return frames


def frames_from_sst_rollout(case: Case, flow0, turb0, n_frames: int,
                            steps_per_frame: int, cfg=None,
                            backend=None) -> tuple:
    """The k-omega SST rollout's frames (each also holds nu_t) and its
    final state: (frames, flow, turb)."""
    from ..piso.engine import PisoConfig, run_piso_sst_eager
    from ..solvers.backends import CGBackend
    cfg = cfg or PisoConfig()
    backend = backend or CGBackend(rtol=1e-6)

    frames = []
    flow, turb = flow0, turb0
    for _ in range(n_frames):
        flow, turb = run_piso_sst_eager(case, flow, turb, steps_per_frame,
                                        cfg=cfg, backend=backend)
        frames.append({**_snapshot(flow), "nu_t": turb.nu_t})
    return frames, flow, turb
