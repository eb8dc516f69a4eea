"""End-to-end surrogate inference of one case: grid -> blocks -> PCA ->
MLP -> stitch.

`make_predictor(bundle, ...).bind(case)` gives `predict(case, p_prev,
aux) -> p` with the call chain: feature grid (the bundle's family) ->
max-abs rescale -> overlapping blocks -> PCA encode -> standardize -> MLP
-> de-standardize -> PCA decode -> per-block zero-mean -> least-squares
stitch -> outlet anchor -> redimensionalize by max_abs_p * U_max^2 ->
near-wall guard + non-finite fallback to the previous pressure. The
least-squares stitch operator depends only on the case's masks: `bind`
inverts it once, on the host. Other stitches, norm methods, families and
model kinds raise.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .blocks import (BlockLayout, assemble_lstsq, block_zero_mean,
                     build_block_layout, extract_blocks, stitch_solve_op)
from .case import Case
from .features import FAMILIES, FamilyConfig, u_max_norm
from .mlp import ModelDef, apply_model, params_from_numpy, unflatten_params
from .pca import PCAModel

PRECISIONS = {"f32": None, "bf16": torch.bfloat16}


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
    norm: dict                        # mean/std tensors, _in and _out
    maxs_in: torch.Tensor             # per-input-channel max-abs
    maxs_out: torch.Tensor            # per-target-channel max-abs
    block_size: int = 128
    overlap_ratio: float = 0.25

    @staticmethod
    def load(path: str, device) -> "SurrogateBundle":
        """Load `manifest.json` + `arrays.npz` (the JAX package's bundle
        format, norm method 'std') onto `device`."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["norm_method"] != "std":
            raise ValueError(f"norm_method {manifest['norm_method']!r}: "
                             f"the reference serves 'std' only")
        mdef = ModelDef(**{**manifest["mdef"],
                           "widths": tuple(manifest["mdef"]["widths"])})
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}

        def t(a):
            return params_from_numpy(a, device)

        n_params = sum(k.startswith("param_") for k in arrays)
        params = unflatten_params(
            mdef, [t(arrays[f"param_{i}"]) for i in range(n_params)])

        def pca(tag):
            return PCAModel(mean=t(arrays[f"pca_{tag}_mean"]),
                            components=t(arrays[f"pca_{tag}_components"]))

        norm = {k[len("norm_"):]: t(v)
                for k, v in arrays.items() if k.startswith("norm_")}
        return SurrogateBundle(
            family=manifest["family"], mdef=mdef, params=params,
            pca_in=pca("in"), pca_out=pca("out"),
            pc_in=manifest["pc_in"], pc_out=manifest["pc_out"], norm=norm,
            maxs_in=t(arrays["maxs_in"]), maxs_out=t(arrays["maxs_out"]),
            block_size=manifest["block_size"],
            overlap_ratio=manifest["overlap_ratio"],
        )

    def standardize_in(self, z: torch.Tensor) -> torch.Tensor:
        return (z - self.norm["mean_in"]) / self.norm["std_in"]

    def destandardize_out(self, z: torch.Tensor) -> torch.Tensor:
        return z * self.norm["std_out"] + self.norm["mean_out"]


def surrogate_blocks_forward(bundle: SurrogateBundle, layout: BlockLayout,
                             input_grid: torch.Tensor,
                             mask_grid: torch.Tensor,
                             pca_dtype=None) -> torch.Tensor:
    """Blocks -> PCA -> MLP -> PCA^-1. Returns (N, S, S) zero-mean block
    predictions in nondimensional units. `pca_dtype` (bfloat16) rounds
    the PCA products' operands to it, with float32 sums and results."""
    scaled = input_grid / bundle.maxs_in
    xb = extract_blocks(layout, scaled)                     # (N, S, S, C)
    n = xb.shape[0]
    z_in = bundle.pca_in.transform(xb.reshape(n, -1), bundle.pc_in,
                                   dtype=pca_dtype)
    z_in = bundle.standardize_in(z_in)
    z_out = apply_model(bundle.params, bundle.mdef, z_in)
    z_out = bundle.destandardize_out(z_out)
    y = bundle.pca_out.inverse_transform(z_out, dtype=pca_dtype)
    y = y.reshape(n, layout.size, layout.size)
    if FAMILIES[bundle.family].target_zero_mean:
        y = block_zero_mean(y, extract_blocks(layout, mask_grid))
    return y


class Predictor:
    """The surrogate pressure predictor of one (ny, nx) case.

    `near_wall_dist`: keep p_prev where the SDF is below it.
    `precision` 'bf16': the PCA products on bf16 operands, float32 sums;
    the bundle's bases are cast to bf16 once, here."""

    def __init__(self, bundle: SurrogateBundle, family: FamilyConfig,
                 near_wall_dist: float = 0.05, precision: str = "f32"):
        self.pca_dtype = PRECISIONS[precision]
        if self.pca_dtype is not None:
            def cast(p: PCAModel) -> PCAModel:
                return dataclasses.replace(
                    p, components=p.components.to(self.pca_dtype))
            bundle = dataclasses.replace(bundle, pca_in=cast(bundle.pca_in),
                                         pca_out=cast(bundle.pca_out))
        self.bundle = bundle
        self.family = family
        self.near_wall_dist = near_wall_dist

    def _layout(self, case: Case) -> BlockLayout:
        return build_block_layout(case.grid.ny, case.grid.nx,
                                  self.bundle.block_size,
                                  self.bundle.overlap_ratio)

    def _predict(self, case: Case, p_prev: torch.Tensor, aux: dict,
                 solve_op: torch.Tensor) -> torch.Tensor:
        bundle, family = self.bundle, self.family
        layout = self._layout(case)
        fields = dict(aux)
        fields.setdefault("p", p_prev)
        um = u_max_norm(fields["u"], fields["v"])

        x_grid = family.build_inputs(case, fields)
        mask = case.sdf
        y_blocks = surrogate_blocks_forward(bundle, layout, x_grid, mask,
                                            pca_dtype=self.pca_dtype)
        field = assemble_lstsq(layout, y_blocks, extract_blocks(layout,
                                                                mask),
                               solve_op=solve_op)

        # redimensionalize: p * max_abs_p * U_max^2
        field = field * bundle.maxs_out[0] * um**2
        p_new = p_prev + field if family.predicts_delta else field

        # near-wall guard + non-finite fallback
        guard = (case.sdf < self.near_wall_dist) | (case.fluid == 0)
        p_new = torch.where(guard, p_prev, p_new)
        return torch.where(torch.isfinite(p_new), p_new, p_prev)

    def bind(self, case: Case):
        """The predictor for this case, with its stitch operator
        resolved."""
        layout = self._layout(case)
        op = stitch_solve_op(layout, extract_blocks(layout, case.sdf))

        def bound(case: Case, p_prev: torch.Tensor,
                  aux: dict) -> torch.Tensor:
            return self._predict(case, p_prev, aux, op)

        return bound


def make_predictor(bundle: SurrogateBundle, stitch: str = "lstsq",
                   near_wall_dist: float = 0.05,
                   precision: str = "f32") -> Predictor:
    """The surrogate pressure predictor of `bundle`, with its family's
    features. precision='bf16' runs the PCA encode and decode on bf16
    operands with float32 sums."""
    if stitch != "lstsq":
        raise ValueError(f"stitch={stitch!r}: the reference serves the "
                         f"least-squares stitch only")
    return Predictor(bundle, FAMILIES[bundle.family],
                     near_wall_dist=near_wall_dist, precision=precision)
