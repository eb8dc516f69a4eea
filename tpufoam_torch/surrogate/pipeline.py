"""End-to-end surrogate inference: grid -> blocks -> PCA -> MLP -> stitch.

`make_predictor` builds `predict(case, p_prev, aux) -> p` with the call
chain: feature grid -> max-abs rescale -> overlapping blocks -> PCA encode
-> standardize -> MLP -> de-standardize -> PCA decode -> per-block
zero-mean -> least-squares stitch -> outlet anchor -> redimensionalize by
max_abs_p * U_max^2 -> near-wall guard + non-finite fallback to the
previous pressure.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..fv.case import Case
from ..models.mlp import ModelDef, apply_model, params_from_numpy
from .blocks import (BlockLayout, assemble_lstsq, block_zero_mean,
                     build_block_layout, extract_blocks, stitch_solve_op)
from .features import FAMILIES, u_max_norm
from .pca import PCAModel


def _params_from_flat(flat: list, n_layers: int) -> dict:
    """Rebuild the dense-MLP parameter tree from the bundle's flat
    `param_i` list. The bundle writes the leaves in sorted-key order:
    head.b, head.w, then layers[0].b, layers[0].w, layers[1].b, ..."""
    if len(flat) != 2 + 2 * n_layers:
        raise ValueError(f"expected {2 + 2 * n_layers} dense parameters, "
                         f"found {len(flat)}")
    return {"head": {"b": flat[0], "w": flat[1]},
            "layers": [{"b": flat[2 + 2 * i], "w": flat[3 + 2 * i]}
                       for i in range(n_layers)]}


@dataclasses.dataclass
class SurrogateBundle:
    """The train <-> serve contract as one object."""

    family: str
    mdef: ModelDef
    params: dict
    pca_in: PCAModel
    pca_out: PCAModel
    pc_in: int
    pc_out: int
    norm_method: str                  # 'std' (the only method in use)
    norm: dict                        # mean_in, std_in, mean_out, std_out
    maxs_in: torch.Tensor             # per-input-channel max-abs
    maxs_out: torch.Tensor            # per-target-channel max-abs
    block_size: int = 128
    overlap_ratio: float = 0.25

    @staticmethod
    def load(path: str, device=DEFAULT_DEVICE) -> "SurrogateBundle":
        """Load `manifest.json` + `arrays.npz` (the JAX package's bundle
        format) onto `device`."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["norm_method"] != "std":
            raise ValueError(f"norm_method {manifest['norm_method']!r} is "
                             "not ported; bundles use 'std'")
        mdef = ModelDef(**{**manifest["mdef"],
                           "widths": tuple(manifest["mdef"]["widths"])})
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}

        def t(a):
            return params_from_numpy(a, device)

        n_params = sum(k.startswith("param_") for k in arrays)
        params = _params_from_flat(
            [t(arrays[f"param_{i}"]) for i in range(n_params)],
            len(mdef.widths))

        def pca(tag):
            return PCAModel(mean=t(arrays[f"pca_{tag}_mean"]),
                            components=t(arrays[f"pca_{tag}_components"]),
                            explained_variance=t(arrays[f"pca_{tag}_ev"]),
                            explained_variance_ratio=t(
                                arrays[f"pca_{tag}_evr"]))

        norm = {k[len("norm_"):]: t(v)
                for k, v in arrays.items() if k.startswith("norm_")}
        return SurrogateBundle(
            family=manifest["family"], mdef=mdef, params=params,
            pca_in=pca("in"), pca_out=pca("out"),
            pc_in=manifest["pc_in"], pc_out=manifest["pc_out"],
            norm_method=manifest["norm_method"], norm=norm,
            maxs_in=t(arrays["maxs_in"]), maxs_out=t(arrays["maxs_out"]),
            block_size=manifest["block_size"],
            overlap_ratio=manifest["overlap_ratio"],
        )

    # ---- normalization in PCA space --------------------------------------
    def standardize_in(self, z: torch.Tensor) -> torch.Tensor:
        return (z - self.norm["mean_in"]) / self.norm["std_in"]

    def destandardize_out(self, z: torch.Tensor) -> torch.Tensor:
        return z * self.norm["std_out"] + self.norm["mean_out"]


def surrogate_blocks_forward(bundle: SurrogateBundle, layout: BlockLayout,
                             input_grid: torch.Tensor,
                             mask_grid: torch.Tensor) -> torch.Tensor:
    """Blocks -> PCA -> MLP -> PCA^-1. Returns (N, S, S, n_out) zero-mean
    block predictions in nondimensional units."""
    n_out = FAMILIES[bundle.family].n_out
    scaled = input_grid / bundle.maxs_in

    xb = extract_blocks(layout, scaled)                     # (N, S, S, C)
    n = xb.shape[0]
    z_in = bundle.pca_in.transform(xb.reshape(n, -1), bundle.pc_in)
    z_in = bundle.standardize_in(z_in)
    z_out = apply_model(bundle.params, bundle.mdef, z_in)
    z_out = bundle.destandardize_out(z_out)
    y = bundle.pca_out.inverse_transform(z_out)
    y = y.reshape(n, layout.size, layout.size, n_out)

    if FAMILIES[bundle.family].target_zero_mean:
        mb = extract_blocks(layout, mask_grid)
        y = torch.stack([block_zero_mean(y[..., c], mb)
                         for c in range(n_out)], dim=-1)
    return y


class Predictor:
    """`predict(case, p_prev, aux) -> p` for the PISO engine (aux carries
    u, v, p and the previous-step fields).

    The least-squares stitch operator depends only on the case's masks, so
    it is inverted once per case on the host: `bind(case)` returns a
    closure that holds it. `calls` counts predictions."""

    NEAR_WALL_DIST = 0.05   # keep p_prev where the SDF is below this

    def __init__(self, bundle: SurrogateBundle):
        self.bundle = bundle
        self.family = FAMILIES[bundle.family]
        self.calls = 0
        self._ops: "OrderedDict[int, tuple]" = OrderedDict()

    def _predict(self, case: Case, p_prev: torch.Tensor, aux: dict,
                 solve_op: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        bundle, family = self.bundle, self.family
        layout = build_block_layout(case.grid.ny, case.grid.nx,
                                    bundle.block_size, bundle.overlap_ratio)
        fields = dict(aux)
        fields.setdefault("p", p_prev)
        um = u_max_norm(fields["u"], fields["v"])

        x_grid = family.build_inputs(case, fields)
        mask = case.sdf
        y_blocks = surrogate_blocks_forward(bundle, layout, x_grid, mask)
        field = assemble_lstsq(layout, y_blocks[..., 0],
                               extract_blocks(layout, mask),
                               solve_op=solve_op)

        # redimensionalize: p * max_abs_p * U_max^2
        field = field * bundle.maxs_out[0] * um**2
        p_new = p_prev + field if family.predicts_delta else field

        # near-wall guard + non-finite fallback
        guard = (case.sdf < self.NEAR_WALL_DIST) | (case.fluid == 0)
        p_new = torch.where(guard, p_prev, p_new)
        return torch.where(torch.isfinite(p_new), p_new, p_prev)

    def bind(self, case: Case):
        """The predictor for this case, with its stitch operator resolved;
        the same case gives the same operator."""
        key = id(case.sdf)
        hit = self._ops.get(key)
        if hit is None or hit[0] is not case.sdf:
            layout = build_block_layout(case.grid.ny, case.grid.nx,
                                        self.bundle.block_size,
                                        self.bundle.overlap_ratio)
            hit = (case.sdf, stitch_solve_op(
                layout, extract_blocks(layout, case.sdf)))
            self._ops[key] = hit
            while len(self._ops) > 8:
                self._ops.popitem(last=False)
        op = hit[1]

        def bound(case: Case, p_prev: torch.Tensor,
                  aux: dict) -> torch.Tensor:
            return self._predict(case, p_prev, aux, op)

        return bound

    def __call__(self, case: Case, p_prev: torch.Tensor,
                 aux: dict) -> torch.Tensor:
        return self.bind(case)(case, p_prev, aux)


def make_predictor(bundle: SurrogateBundle,
                   stitch: str = "lstsq") -> Predictor:
    """Build the surrogate pressure predictor. Only the least-squares
    stitch (stitch='lstsq') and the deltaU_deltaP family are ported."""
    if stitch != "lstsq":
        raise NotImplementedError(f"stitch={stitch!r} is not ported; "
                                  "use 'lstsq'")
    if bundle.family not in FAMILIES:
        raise NotImplementedError(f"family {bundle.family!r} is not ported")
    return Predictor(bundle)
