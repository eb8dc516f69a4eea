"""Offline evaluation of a surrogate bundle on grid frames: the
reference's `Evaluation` error tiers (raw blocks, the stitched delta-p
field, the weighted delta-p field, the reconstructed p), with the
irrelevant-timestep skip and the aggregates over the frames.

Frames are in-memory grid-space field dicts (arrays or tensors), such as
`train.dataset.frames_from_rollout` makes; each is evaluated on the
case's device. `UnstructuredCase` is the mesh prep of a reference HDF5
dataset (or of the cells an embedded solver sends, bridge.server): the
uniform grid over the cells' extents, the domain and SDF from the
boundary points, and the resampling operators in both directions, once
per case; then each cell-wise field is resampled onto the grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..core.grid import make_grid
from ..core.interp import ResampleOp, build_resample
from ..core.sdf import domain_and_sdf
from ..fv.case import Case, _assemble_masks
from ..fv.cutcell import binary_masks_from_fluid
from ..surrogate.blocks import (apply_deltaU_weighting, assemble_lstsq,
                                block_zero_mean, build_block_layout,
                                extract_blocks)
from ..surrogate.features import FAMILIES, u_max_norm
from ..surrogate.gradp_integrate import integrate_gradp
from ..surrogate.pipeline import (SurrogateBundle, make_predictor,
                                  surrogate_blocks_forward)
from ..train.dataset import frame_is_relevant, frame_on
from ..utils.hdf5_io import SimFrame, read_frame
from ..utils.metrics import ErrorReport, error_metrics


@dataclasses.dataclass
class UnstructuredCase:
    """Mesh prep for one simulation of a reference-format dataset: the
    case on the grid, the resampling operators mesh -> grid and grid ->
    mesh, the (i, j) indices of the grid's fluid cells and the record's
    channel names. Every tensor is on the case's device."""

    case: Case
    resample: ResampleOp        # mesh -> grid
    resample_back: ResampleOp   # grid -> mesh
    indices: np.ndarray         # (n_grid_cells_in_domain, 2)
    channels: tuple

    @staticmethod
    def from_hdf5(path: str, sim: int, delta: float, nu: float = 8e-3,
                  device=DEFAULT_DEVICE) -> "UnstructuredCase":
        """From record (sim, 0) of a dataset (needs h5py)."""
        return UnstructuredCase.from_frame(read_frame(path, sim, 0), delta,
                                           nu, device=device)

    @staticmethod
    def from_frame(fr: SimFrame, delta: float, nu: float = 8e-3,
                   device=DEFAULT_DEVICE) -> "UnstructuredCase":
        """From one record. The grid spans the cell centres' extents
        rounded to 2 decimals at spacing `delta` (so it can differ by a
        cell from the grid the records came from); the domain and SDF are
        `domain_and_sdf` of the record's boundary points, the masks the
        blank-mode ones of that domain, the inlet the parabola over the
        rounded height."""
        ci = fr.channels.index
        pts = fr.data[:, [ci("Cx"), ci("Cy")]].astype(np.float64)
        x_min, x_max = round(pts[:, 0].min(), 2), round(pts[:, 0].max(), 2)
        y_min, y_max = round(pts[:, 1].min(), 2), round(pts[:, 1].max(), 2)
        grid = make_grid(x_min, x_max, y_min, y_max, delta)
        gpts = grid.cell_centers_flat()

        domain, sdf = domain_and_sdf(gpts, fr.top, fr.obst, device=device)
        fluid = domain.cpu().numpy().reshape(grid.shape).astype(np.float32)
        sdf = sdf.reshape(grid.shape)

        op = build_resample(pts, gpts, device=device)
        op_back = build_resample(gpts, pts, device=device)

        y = grid.y0 + (np.arange(grid.ny) + 0.5) * grid.dy
        h = y_max - y_min
        inlet_u = (6.0 * (y - y_min) / h
                   * (1 - (y - y_min) / h)).astype(np.float32)

        case = _assemble_masks(
            grid, fluid, sdf * torch.as_tensor(fluid, device=sdf.device),
            inlet_u, nu, binary_masks_from_fluid(grid, fluid), cut=False,
            device=device)
        return UnstructuredCase(case=case, resample=op, resample_back=op_back,
                                indices=np.argwhere(fluid > 0),
                                channels=fr.channels)

    def to(self, device) -> "UnstructuredCase":
        """The same prepared mesh with every tensor on `device` (the
        Delaunay set-up is not run again)."""
        def move(obj):
            return dataclasses.replace(obj, **{
                f.name: getattr(obj, f.name).to(device)
                for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name), torch.Tensor)})

        return dataclasses.replace(self, case=move(self.case),
                                   resample=move(self.resample),
                                   resample_back=move(self.resample_back))

    def grid_field(self, cell_values) -> torch.Tensor:
        """One cell-wise field resampled onto the (ny, nx) grid (0 where
        the resampling fills or is not finite, and in solid cells)."""
        vals = self.resample(cell_values, fill_value=0.0)
        return torch.nan_to_num(vals).reshape(self.case.grid.shape) \
            * self.case.fluid

    def fields_from_frame(self, fr: SimFrame) -> dict:
        """A record's fields on the grid: u, v, p, the previous step's
        (from the deltas, or the same fields without them) and the
        previous deltas where the record has them."""
        ci = fr.channels.index
        d = fr.data

        def g(name):
            return self.grid_field(d[:, ci(name)])

        fields = dict(u=g("Ux"), v=g("Uy"), p=g("p"))
        if "dUx" in fr.channels:
            fields["u_prev"] = fields["u"] - g("dUx")
            fields["v_prev"] = fields["v"] - g("dUy")
            fields["p_prev"] = fields["p"] - g("dp")
        else:
            fields["u_prev"] = fields["u"]
            fields["v_prev"] = fields["v"]
            fields["p_prev"] = fields["p"]
        if "dUx_prev" in fr.channels:
            fields["du_prev"] = g("dUx_prev")
            fields["dv_prev"] = g("dUy_prev")
            fields["dp_prev"] = g("dp_prev")
        return fields


@dataclasses.dataclass
class EvalReport:
    """The reference's four error tiers: raw blocks, weighted delta_p
    (`field_weighted`), crude delta_p without weighting (`field`), and the
    reconstructed p. With weighting off `field_weighted` is None."""

    per_frame: list
    block: ErrorReport | None
    field: ErrorReport | None          # crude stitched delta_p
    p_field: ErrorReport | None
    field_weighted: ErrorReport | None = None
    field_label: str = "delta field"   # "gradP field" for the U_gradP family

    def summary(self) -> str:
        lines = []
        if self.block:
            lines.append(f"** Error in blocks **\n{self.block}")
        if self.field_weighted:
            lines.append(f"** Error in delta_p **\n{self.field_weighted}")
            lines.append(
                f"** Error in delta_p - no weighting **\n{self.field}")
        elif self.field:
            lines.append(f"** Error in {self.field_label} **\n{self.field}")
        if self.p_field:
            lines.append(f"** Error in p **\n{self.p_field}")
        return "\n\n".join(lines)


def _relevant(fields, threshold=1e-4) -> bool:
    # the dataset's own stationarity skip, so that evaluation scores
    # exactly the frames training would take
    return frame_is_relevant(fields["u"], fields["v"],
                             fields["u_prev"], fields["v_prev"],
                             threshold=threshold)


def _deltaU_weight_grids(fields: dict, prev_fields: dict | None):
    """(du-change weight grid, previous-step delta_p grid) for the
    deltaU-change weighting: from the frame's du_prev/dv_prev/dp_prev
    fields, else from the previous relevant frame; None without
    either."""
    if "du_prev" in fields:
        du_p, dv_p = fields["du_prev"], fields["dv_prev"]
        dp_p = fields["dp_prev"]
    elif prev_fields is not None:
        du_p = prev_fields["u"] - prev_fields["u_prev"]
        dv_p = prev_fields["v"] - prev_fields["v_prev"]
        dp_p = prev_fields["p"] - prev_fields["p_prev"]
    else:
        return None
    du = fields["u"] - fields["u_prev"]
    dv = fields["v"] - fields["v_prev"]
    change = torch.abs(du - du_p) + torch.abs(dv - dv_p)
    cmax = float(change.max())
    if cmax > 0:
        change = change / cmax
    return change, dp_p


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def evaluate_bundle(bundle: SurrogateBundle, case: Case, frames: list[dict],
                    stitch: str = "scan", apply_filter: bool = False,
                    weighted: bool = False) -> EvalReport:
    """Run the surrogate over evaluation frames and report the reference's
    error tiers. `weighted` turns on the deltaU-change blending and adds
    the weighted-delta_p tier; the reconstructed p then takes the
    weighted field. The U_gradP family's field tier scores the stitched
    nondimensional gradients, and its p is their line integral."""
    dev = case.device
    family = FAMILIES[bundle.family]
    if family.name == "U_gradP":
        weighted = False
    layout = build_block_layout(case.grid.ny, case.grid.nx,
                                bundle.block_size, bundle.overlap_ratio)
    predictor = (make_predictor(bundle, stitch=stitch,
                                apply_filter=apply_filter)
                 if family.n_out == 1 else None)
    mb = extract_blocks(layout, case.sdf)

    def frame_eval(fields):
        um = u_max_norm(fields["u"], fields["v"])
        x_grid = family.build_inputs(case, fields)
        y_grid = family.build_targets(case, fields)
        yb_pred = surrogate_blocks_forward(bundle, layout, x_grid, case.sdf)
        yb_true = extract_blocks(layout, y_grid)
        if family.target_zero_mean:
            yb_true = torch.stack(
                [block_zero_mean(yb_true[..., c], mb)
                 for c in range(yb_true.shape[-1])], dim=-1)
        if family.name == "U_gradP":
            # stitch each gradient component, then line-integrate to p
            lx = case.grid.nx * case.grid.dx
            ly = case.grid.ny * case.grid.dy
            mo = bundle.maxs_out
            gx_nd = assemble_lstsq(layout, yb_pred[..., 0], mb) * mo[0]
            gy_nd = assemble_lstsq(layout, yb_pred[..., 1], mb) * mo[1]
            p_hat = integrate_gradp(case, gx_nd * um**2 / lx,
                                    gy_nd * um**2 / ly)
            g_pair = (torch.stack([gx_nd, gy_nd], dim=-1), y_grid)
        else:
            p_hat = predictor(case, fields["p_prev"], fields)
            g_pair = None
        return yb_pred, yb_true, p_hat, um, g_pair

    per_frame = []
    blk_pred, blk_true = [], []
    fld_pred, fld_true = [], []
    fld_w_pred = []
    p_pred_all, p_true_all = [], []
    mask = _host(case.fluid) != 0
    prev_rel = None

    with torch.no_grad():
        for fields in frames:
            fields = frame_on(fields, dev)
            if not _relevant(fields):
                per_frame.append(None)     # the irrelevant-timestep skip
                continue
            yb_pred, yb_true, p_hat, um, g_pair = frame_eval(fields)
            um = float(um)

            # predicted blocks are in maxs_out-scaled nondim units, true
            # blocks in the family's nondim units: both to physical
            redim = float(bundle.maxs_out[0]) * um**2
            blk_pred.append(_host(yb_pred[..., 0]) * redim)
            blk_true.append(_host(yb_true[..., 0]) * um**2)

            p_hat = _host(p_hat)
            p_prev = _host(fields["p_prev"])
            p_true = _host(fields["p"])
            dp_crude = p_hat - p_prev

            dp_used = dp_crude
            if weighted:
                grids = _deltaU_weight_grids(fields, prev_rel)
                if grids is not None:
                    change, dp_prev_grid = grids
                    dp_used = _host(apply_deltaU_weighting(
                        torch.as_tensor(dp_crude, device=dev), dp_prev_grid,
                        change))
                fld_w_pred.append(dp_used[mask])
            prev_rel = fields

            if g_pair is not None:
                g_pred, g_true = _host(g_pair[0]), _host(g_pair[1])
                fld_pred.append(g_pred[mask].ravel())
                fld_true.append(g_true[mask].ravel())
                fld_frame = error_metrics(
                    g_pred, g_true,
                    np.broadcast_to(mask[..., None], g_pred.shape))
            else:
                fld_pred.append(dp_crude[mask])
                fld_true.append((p_true - p_prev)[mask])
                fld_frame = error_metrics(dp_crude, p_true - p_prev, mask)
            # p from the (possibly weighted) field
            p_rec = p_prev + dp_used
            p_pred_all.append(p_rec[mask])
            p_true_all.append(p_true[mask])

            per_frame.append(dict(field=fld_frame,
                                  p=error_metrics(p_rec, p_true, mask)))

    if not fld_pred:
        return EvalReport(per_frame=per_frame, block=None, field=None,
                          p_field=None)

    mask_blocks = _host(mb) != 0
    mb_all = np.concatenate([mask_blocks] * len(blk_pred))
    block_rep = error_metrics(np.concatenate(blk_pred),
                              np.concatenate(blk_true), mb_all)
    field_rep = error_metrics(np.concatenate(fld_pred),
                              np.concatenate(fld_true))
    field_w_rep = None
    if fld_w_pred:
        field_w_rep = error_metrics(np.concatenate(fld_w_pred),
                                    np.concatenate(fld_true))
    p_rep = error_metrics(np.concatenate(p_pred_all),
                          np.concatenate(p_true_all))
    return EvalReport(per_frame=per_frame, block=block_rep, field=field_rep,
                      p_field=p_rep, field_weighted=field_w_rep,
                      field_label=("gradP field" if family.name == "U_gradP"
                                   else "delta field"))
