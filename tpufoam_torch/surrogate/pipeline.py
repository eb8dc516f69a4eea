"""End-to-end surrogate inference: grid -> blocks -> PCA -> MLP -> stitch.

`make_predictor` builds `predict(case, p_prev, aux) -> p` with the call
chain: feature grid (the bundle's family, or the one given) -> max-abs
rescale -> overlapping blocks -> PCA encode -> standardize -> MLP ->
de-standardize -> PCA decode -> per-block zero-mean -> stitch (the
reference's sequential scan, or least squares) -> outlet anchor ->
optional Gaussian seam filter -> redimensionalize by max_abs_p * U_max^2
-> near-wall guard + non-finite fallback to the previous pressure. A
family with more than one output channel (U_gradP's pressure gradient)
is not a pressure guess and is refused; `surrogate_blocks_forward`,
`blocks.assemble_lstsq` and `gradp_integrate.integrate_gradp` evaluate it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..fv.case import Case, fleet_member
from ..models.mlp import (ModelDef, apply_model, params_from_numpy,
                          tree_leaves, treedef_str, unflatten_params)
from ..utils.profiling import span
from .blocks import (BlockLayout, _blend_constants, assemble_lstsq,
                     assemble_scan, block_zero_mean, build_block_layout,
                     extract_blocks, gaussian_filter2d, layout_indices,
                     stitch_indices, stitch_solve_op)
from .features import FAMILIES, FamilyConfig, u_max_norm
from .pca import PCAModel

STITCHES = ("scan", "lstsq")
PRECISIONS = {"f32": None, "bf16": torch.bfloat16}
NORM_METHODS = ("std", "min_max", "max_abs")


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
    norm_method: str                  # 'std' | 'min_max' | 'max_abs'
    norm: dict                        # tensors per method: mean/std,
                                      # min/max or max_abs, _in and _out
    maxs_in: torch.Tensor             # per-input-channel max-abs
    maxs_out: torch.Tensor            # per-target-channel max-abs
    block_size: int = 128
    overlap_ratio: float = 0.25

    def trimmed(self) -> "SurrogateBundle":
        """The bundle without the PCA components beyond its pc counts (a
        serving bundle needs no more of the fitted basis)."""
        def cut(pca: PCAModel, k: int) -> PCAModel:
            return PCAModel(mean=pca.mean, components=pca.components[:k],
                            explained_variance=pca.explained_variance[:k],
                            explained_variance_ratio=(
                                pca.explained_variance_ratio[:k]))

        return dataclasses.replace(self, pca_in=cut(self.pca_in, self.pc_in),
                                   pca_out=cut(self.pca_out, self.pc_out))

    def save(self, path: str) -> None:
        """Write the JAX package's bundle format: `manifest.json` (version
        1), `arrays.npz` (`param_i` in JAX's leaf order, the PCA, norm and
        max-abs arrays, float32) and `params_tree.json` (the tree's
        PyTreeDef as JAX prints it)."""
        os.makedirs(path, exist_ok=True)
        manifest = {
            "version": 1,
            "family": self.family,
            "mdef": dataclasses.asdict(self.mdef),
            "pc_in": self.pc_in,
            "pc_out": self.pc_out,
            "norm_method": self.norm_method,
            "block_size": self.block_size,
            "overlap_ratio": self.overlap_ratio,
        }
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        with open(os.path.join(path, "params_tree.json"), "w") as f:
            json.dump(treedef_str(self.params), f)

        def a(t):
            return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                              else t, dtype=np.float32)

        arrays = {f"param_{i}": a(x)
                  for i, x in enumerate(tree_leaves(self.params))}
        for tag, pca in (("in", self.pca_in), ("out", self.pca_out)):
            arrays[f"pca_{tag}_mean"] = a(pca.mean)
            arrays[f"pca_{tag}_components"] = a(pca.components)
            arrays[f"pca_{tag}_ev"] = a(pca.explained_variance)
            arrays[f"pca_{tag}_evr"] = a(pca.explained_variance_ratio)
        for k, v in self.norm.items():
            arrays[f"norm_{k}"] = a(v)
        arrays["maxs_in"] = a(self.maxs_in)
        arrays["maxs_out"] = a(self.maxs_out)
        np.savez(os.path.join(path, "arrays.npz"), **arrays)

    @staticmethod
    def load(path: str, device=DEFAULT_DEVICE) -> "SurrogateBundle":
        """Load `manifest.json` + `arrays.npz` (the JAX package's bundle
        format, any of its model kinds and norm methods) onto `device`."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["norm_method"] not in NORM_METHODS:
            raise ValueError(
                f"unknown norm_method {manifest['norm_method']!r}")
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
        n = self.norm
        if self.norm_method == "std":
            return (z - n["mean_in"]) / n["std_in"]
        if self.norm_method == "min_max":
            return (z - n["min_in"]) / (n["max_in"] - n["min_in"])
        return z / n["max_abs_in"]

    def destandardize_out(self, z: torch.Tensor) -> torch.Tensor:
        n = self.norm
        if self.norm_method == "std":
            return z * n["std_out"] + n["mean_out"]
        if self.norm_method == "min_max":
            return z * (n["max_out"] - n["min_out"]) + n["min_out"]
        return z * n["max_abs_out"]


def surrogate_blocks_forward(bundle: SurrogateBundle, layout: BlockLayout,
                             input_grid: torch.Tensor,
                             mask_grid: torch.Tensor,
                             pca_dtype=None) -> torch.Tensor:
    """Blocks -> PCA -> MLP -> PCA^-1. Returns (N, S, S, n_out) zero-mean
    block predictions in nondimensional units. `pca_dtype` (bfloat16)
    rounds the PCA products' operands to it, with float32 sums and
    results."""
    n_out = FAMILIES[bundle.family].n_out
    scaled = input_grid / bundle.maxs_in

    xb = extract_blocks(layout, scaled)                     # (N, S, S, C)
    n = xb.shape[0]
    z_in = bundle.pca_in.transform(xb.reshape(n, -1), bundle.pc_in,
                                   dtype=pca_dtype)
    z_in = bundle.standardize_in(z_in)
    z_out = apply_model(bundle.params, bundle.mdef, z_in)
    z_out = bundle.destandardize_out(z_out)
    y = bundle.pca_out.inverse_transform(z_out, dtype=pca_dtype)
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
    closure that holds it. The scan stitch has no operator.

    A stacked fleet case (piso.batched) is predicted case by case, each as
    if alone, so that every case's prediction equals its single-case
    prediction bit for bit: the hybrid step's bf16 multigrid turns a
    one-ulp change of the warm start into a percent-level change of the
    step, and B x N blocks through one matrix product (or one reduction)
    round differently from N. `calls` counts calls, one per lockstep.

    On a CUDA device with autograd off, the closure `bind` returns replays
    each case's prediction (lstsq stitch, no seam filter) as a CUDA graph
    (`_CaseGraphs`): the same kernels on the same operands, so the same
    bits, with no host work a kernel. The graphs are kept with the case's
    stitch operators, so every bind of the same case replays the same
    graphs. `graph_captures` counts the graphs captured and
    `graph_replays` the cases they predicted; a call they cannot serve,
    and every call of the predictor itself, runs eagerly.

    `near_wall_dist`: keep p_prev where the SDF is below it.
    `apply_filter`: the Gaussian seam filter (sigma 10) after the stitch.
    `precision` 'bf16': the PCA products on bf16 operands, float32 sums;
    the bundle's bases are cast to bf16 once, here."""

    def __init__(self, bundle: SurrogateBundle, family: FamilyConfig,
                 stitch: str = "scan", apply_filter: bool = False,
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
        self.stitch = stitch
        self.apply_filter = apply_filter
        self.near_wall_dist = near_wall_dist
        self.calls = 0
        self.graph_captures = 0
        self.graph_replays = 0
        self._ops: "OrderedDict[int, tuple]" = OrderedDict()

    def _layout(self, case: Case) -> BlockLayout:
        return build_block_layout(case.grid.ny, case.grid.nx,
                                  self.bundle.block_size,
                                  self.bundle.overlap_ratio)

    def _predict(self, case: Case, p_prev: torch.Tensor, aux: dict,
                 solve_ops: list) -> torch.Tensor:
        self.calls += 1
        if p_prev.dim() == 2:
            return self._predict_case(case, p_prev, aux, solve_ops[0])
        return torch.stack([
            self._predict_case(fleet_member(case, k), p_prev[k],
                               {n: a[k] for n, a in aux.items()},
                               solve_ops[k])
            for k in range(p_prev.shape[0])])

    def _predict_case(self, case: Case, p_prev: torch.Tensor, aux: dict,
                      solve_op: torch.Tensor | None) -> torch.Tensor:
        bundle, family = self.bundle, self.family
        layout = self._layout(case)
        fields = {n: aux[n] for n in family.reads}
        um = u_max_norm(fields["u"], fields["v"])

        x_grid = family.build_inputs(case, fields)
        mask = case.sdf
        y_blocks = surrogate_blocks_forward(bundle, layout, x_grid, mask,
                                            pca_dtype=self.pca_dtype)
        mb = extract_blocks(layout, mask)
        if self.stitch == "scan":
            field = assemble_scan(layout, y_blocks[..., 0], mb)
        else:
            field = assemble_lstsq(layout, y_blocks[..., 0], mb,
                                   solve_op=solve_op)
        if self.apply_filter:
            field = gaussian_filter2d(field, 10.0)

        # redimensionalize: p * max_abs_p * U_max^2
        field = field * bundle.maxs_out[0] * um**2
        p_new = p_prev + field if family.predicts_delta else field

        # near-wall guard + non-finite fallback
        guard = (case.sdf < self.near_wall_dist) | (case.fluid == 0)
        p_new = torch.where(guard, p_prev, p_new)
        return torch.where(torch.isfinite(p_new), p_new, p_prev)

    def _resolve(self, case: Case) -> tuple:
        """(stitch operators, graphs) of the case: one operator per case
        of a stacked fleet, and with the lstsq stitch and no seam filter
        its `_CaseGraphs`, kept for the last 8 cases, so the same case
        gives the same operators and graphs. A stretched (graded) grid
        raises ValueError before any block layout is built."""
        if case.grid.stretched:
            raise ValueError(
                "surrogate predictors require a uniform grid; this case "
                "uses a stretched (graded) Grid2D — run the pure solver "
                "backends there, or resample to a uniform grid")
        if self.stitch == "scan":
            return [None] * (1 if case.sdf.dim() == 2
                             else case.sdf.shape[0]), None
        key = id(case.sdf)
        hit = self._ops.get(key)
        if hit is None or hit[0] is not case.sdf:
            members = ([case] if case.sdf.dim() == 2 else
                       [fleet_member(case, k)
                        for k in range(case.sdf.shape[0])])
            layout = self._layout(case)
            ops = [stitch_solve_op(layout, extract_blocks(layout, m.sdf))
                   for m in members]
            hit = (case.sdf, ops, None if self.apply_filter
                   else _CaseGraphs(case, ops, self.family.reads))
            self._ops[key] = hit
            while len(self._ops) > 8:
                self._ops.popitem(last=False)
        return hit[1], hit[2]

    def bind(self, case: Case):
        """The predictor for a rollout of this case, with its stitch
        operator resolved (one per case of a stacked fleet) and, with the
        lstsq stitch and no seam filter, its CUDA graphs (`_CaseGraphs`),
        both shared with every other bind of the case. JAX's vmapped
        predictor solves the offset system in-graph instead: the same
        least-squares solution, up to rounding. A stretched (graded) grid
        raises ValueError before any block layout is built: the surrogate
        takes uniform blocks of a uniform grid, and graded grids are a
        capability of the pure solver, as in the JAX package."""
        ops, graphs = self._resolve(case)

        def bound(case: Case, p_prev: torch.Tensor,
                  aux: dict) -> torch.Tensor:
            p = None if graphs is None else graphs(self, case, p_prev, aux)
            if p is None:
                return self._predict(case, p_prev, aux, ops)
            self.calls += 1
            return p

        return bound

    def __call__(self, case: Case, p_prev: torch.Tensor,
                 aux: dict) -> torch.Tensor:
        """One prediction, eagerly: the path the graphs are held to."""
        return self._predict(case, p_prev, aux, self._resolve(case)[0])


def _case_key(case: Case) -> tuple:
    """Where the case's per-cell tensors live: what a graph reads in
    place."""
    return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                 for t in vars(case).values()
                 if isinstance(t, torch.Tensor)
                 and t.shape == case.fluid.shape)


class _CaseGraphs:
    """CUDA graphs of a bound prediction, one per case of the stack (one
    for a 2-D case), captured on the first call they can serve and
    replayed in capture order.

    Graph k reads case k's tensors (its SDF, masks, stitch operator) in
    place, and p_prev and the fields its family reads
    (`FamilyConfig.reads`) from one set of per-case static buffers that
    all graphs share: `copy_` fills them from case k's slices before
    graph k replays. Each graph ends by writing one
    shared output buffer, which is copied into row k of a result
    allocated on every call (callers keep results across calls). The
    graphs share one memory pool: they replay one at a time, in the order
    they were captured. Capture follows PyTorch's recipe: an eager
    warm-up call on a side stream, then `torch.cuda.graph` on it.

    A call is served on a CUDA device with autograd off, no input that
    requires grad, the bound case's per-cell tensors where they were
    (`_case_key`), every read field a tensor, and the inputs' shapes and
    dtypes those of the capture (their strides do not matter: the
    buffers take copies). Other shapes or dtypes recapture once, and
    after that the case stays eager. A call the graphs do not serve
    returns None."""

    def __init__(self, case: Case, ops: list, names: tuple):
        # the case is held, so its tensors keep the addresses the graphs
        # read
        self.ops, self.case, self.names = ops, case, names
        self.case_key = _case_key(case)
        self.key = None            # the inputs the graphs were captured for
        self.graphs: list = []
        self.buffers: list = []    # p_prev's and the read fields'
        self.out = None
        self.captures_left = 2     # the first capture and one recapture

    def __call__(self, pred: Predictor, case: Case, p_prev: torch.Tensor,
                 aux: dict) -> torch.Tensor | None:
        if not p_prev.is_cuda or torch.is_grad_enabled():
            return None
        inputs = [p_prev] + [aux[n] for n in self.names]
        if (not all(isinstance(t, torch.Tensor) and not t.requires_grad
                    and t.device == p_prev.device for t in inputs)
                or _case_key(case) != self.case_key):
            return None
        key = (torch.is_inference_mode_enabled(),
               tuple((t.shape, t.dtype) for t in inputs))
        if key != self.key:
            # drop the old graphs and their buffers first
            self.graphs, self.buffers, self.out, self.key = [], [], None, None
            if not self.captures_left:
                return None
            self.captures_left -= 1
            with span("tpufoam_torch.surrogate.capture"):
                self._capture(pred, case, inputs)
            self.key = key
        return self._replay(pred, inputs)

    def _fill(self, inputs: list, k: int | None):
        for buf, t in zip(self.buffers, inputs):
            buf.copy_(t if k is None else t[k])

    def _capture(self, pred: Predictor, case: Case, inputs: list):
        p_prev = inputs[0]
        dev = p_prev.device
        single = p_prev.dim() == 2
        members = ([case] if single else
                   [fleet_member(case, k) for k in range(p_prev.shape[0])])
        self.buffers = [torch.empty(t.shape if single else t.shape[1:],
                                    dtype=t.dtype, device=dev)
                        for t in inputs]
        p_in, fields = self.buffers[0], dict(zip(self.names,
                                                 self.buffers[1:]))

        def predict(k):
            return pred._predict_case(members[k], p_in, fields, self.ops[k])

        self._fill(inputs, None if single else 0)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = predict(0)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.out = torch.empty_like(warm)
        del warm
        # the cached constants the graphs read, kept alive with them
        layout = pred._layout(case)
        self.constants = (layout_indices(layout, dev),
                          stitch_indices(layout, dev),
                          _blend_constants(layout, dev))
        pool = torch.cuda.graph_pool_handle()
        for k in range(len(members)):
            g = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA calls (the bridge serves
            # a connection a thread) do not break this capture
            with torch.cuda.graph(g, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                self.out.copy_(predict(k))
            self.graphs.append(g)
            pred.graph_captures += 1

    def _replay(self, pred: Predictor, inputs: list) -> torch.Tensor:
        if inputs[0].dim() == 2:
            self._fill(inputs, None)
            self.graphs[0].replay()
            result = self.out.clone()
        else:
            result = torch.empty((len(self.graphs),) + self.out.shape,
                                 dtype=self.out.dtype, device=self.out.device)
            for k, g in enumerate(self.graphs):
                self._fill(inputs, k)
                g.replay()
                result[k].copy_(self.out)
        pred.graph_replays += len(self.graphs)
        return result


def make_predictor(bundle: SurrogateBundle,
                   family: FamilyConfig | None = None,
                   stitch: str = "scan", apply_filter: bool = False,
                   near_wall_dist: float = 0.05,
                   precision: str = "f32") -> Predictor:
    """Build the surrogate pressure predictor of `bundle`, with its own
    family's features unless `family` is given. stitch='scan' reproduces
    the reference's sequential corrector; 'lstsq' takes the least-squares
    offsets and blended placement. precision='bf16' runs the PCA encode
    and decode on bf16 operands with float32 sums (the bases cast once,
    here). A family with more than one output channel raises ValueError:
    it predicts no pressure."""
    family = FAMILIES[bundle.family] if family is None else family
    if family.n_out != 1:
        raise ValueError(
            f"family {family.name!r} predicts {family.n_out} output "
            f"channels; make_predictor serves single-channel pressure "
            f"families only (use tpufoam-eval for gradient bundles)")
    if stitch not in STITCHES:
        raise ValueError(f"stitch={stitch!r} not in {STITCHES}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r} not in "
                         f"{tuple(PRECISIONS)}")
    return Predictor(bundle, family, stitch=stitch,
                     apply_filter=apply_filter,
                     near_wall_dist=near_wall_dist, precision=precision)
