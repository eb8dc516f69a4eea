"""tpufoam_torch surrogate serving against the JAX package, on the CPU:
block layout and extraction, least-squares and scan stitching, PCA, the
dense MLP, the bundle loader, and the predictor with the real sm_ref512
bundle.

Tolerances (relative to the reference's max magnitude):
- layouts, extraction and masks: exact;
- float32 arithmetic (stitching, PCA, MLP in f32): 1e-5, or 1e-4 where a
  49152-long PCA dot product feeds it;
- the bf16 MLP: 1e-2. Both frameworks round the layer inputs and products
  to bf16, but an f32 input that differs in its last bit between them can
  round to neighbouring bf16 values (2^-8 = 3.9e-3 apart).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv.case import build_channel_case as jax_build
from tpufoam.fv.case import initial_flow as jax_initial_flow
from tpufoam.models import mlp as jmlp
from tpufoam.surrogate import blocks as jblk
from tpufoam.surrogate import pipeline as jpipe
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv.case import build_channel_case
from tpufoam_torch.models import mlp as tmlp
from tpufoam_torch.surrogate import blocks as tblk
from tpufoam_torch.surrogate import pipeline as tpipe
from tpufoam_torch.surrogate.pca import PCAModel

BUNDLE = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                      "sm_ref512")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, ref, rtol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert err <= rtol * scale, f"max err {err:.3e} > {rtol:g} * {scale:.3e}"


LAYOUTS = [(512, 2048, 128), (1024, 4096, 128), (128, 512, 128),
           (64, 256, 32), (300, 700, 128)]


@pytest.mark.parametrize("ny,nx,size", LAYOUTS)
def test_block_layout_and_plan_match(ny, nx, size):
    jl = jblk.build_block_layout(ny, nx, size, 0.25)
    tl = tblk.build_block_layout(ny, nx, size, 0.25)
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
    jp, tp = jblk._fast_groups(jl), tblk._fast_groups(tl)
    assert jp is not None and jp[3] == tp[3]
    np.testing.assert_array_equal(jp[1], tp[1])
    np.testing.assert_array_equal(jp[2], tp[2])
    assert tblk._neighbor_pairs(tl) == jblk._neighbor_pairs(jl)


@pytest.fixture(scope="module")
def stitch_problem():
    """Seeded zero-mean blocks and a masked field on a 300 x 700 grid
    (an extra clamped row and column) with 64-blocks."""
    ny, nx, s = 300, 700, 64
    jl = jblk.build_block_layout(ny, nx, s, 0.25)
    rng = np.random.default_rng(0)
    field = rng.standard_normal((ny, nx, 3)).astype(np.float32)
    mask = (rng.uniform(size=(ny, nx)) > 0.1).astype(np.float32) \
        * rng.uniform(0.1, 1.0, (ny, nx)).astype(np.float32)
    mask[100:140, 200:260] = 0.0
    blocks = rng.standard_normal((jl.n_blocks, s, s)).astype(np.float32)
    return jl, tblk.build_block_layout(ny, nx, s, 0.25), field, mask, blocks


def test_extract_blocks_and_zero_mean(stitch_problem):
    jl, tl, field, mask, blocks = stitch_problem
    np.testing.assert_array_equal(
        tblk.extract_blocks(tl, T(field)).numpy(),
        np.asarray(jblk.extract_blocks(jl, jnp.asarray(field))))
    mb = tblk.extract_blocks(tl, T(mask))
    np.testing.assert_array_equal(
        mb.numpy(), np.asarray(jblk.extract_blocks(jl, jnp.asarray(mask))))
    close(tblk.block_zero_mean(T(blocks), mb),
          jblk.block_zero_mean(jnp.asarray(blocks), jnp.asarray(mb.numpy())),
          1e-5)


@pytest.mark.parametrize("host_op", [True, False], ids=["solve_op", "solve"])
def test_assemble_lstsq(stitch_problem, host_op):
    jl, tl, _, mask, blocks = stitch_problem
    jmb = jblk.extract_blocks(jl, jnp.asarray(mask))
    tmb = tblk.extract_blocks(tl, T(mask))
    jop = jblk.stitch_solve_op(jl, jmb) if host_op else None
    top = tblk.stitch_solve_op(tl, tmb) if host_op else None
    if host_op:
        close(top, jop, 1e-5)
    ref = jblk.assemble_lstsq(jl, jnp.asarray(blocks), jmb, solve_op=jop)
    got = tblk.assemble_lstsq(tl, T(blocks), tmb, solve_op=top)
    close(got, ref, 1e-4)


def test_assemble_scan(stitch_problem):
    """The sequential raster corrector and overwrite placement: the same
    float32 subtractions in the same order on both sides, from strip
    means that may round apart (1e-5)."""
    jl, tl, _, mask, blocks = stitch_problem
    assert tl.has_extra_row and tl.izl != tl.overlap
    jmb = jblk.extract_blocks(jl, jnp.asarray(mask))
    tmb = tblk.extract_blocks(tl, T(mask))
    close(tblk.stitch_offsets_scan(tl, T(blocks), tmb),
          jblk.stitch_offsets_scan(jl, jnp.asarray(blocks), jmb), 1e-5)
    close(tblk.assemble_scan(tl, T(blocks), tmb),
          jblk.assemble_scan(jl, jnp.asarray(blocks), jmb), 1e-5)


def test_pca_round_trip():
    rng = np.random.default_rng(3)
    mean = rng.standard_normal(300).astype(np.float32)
    comp = rng.standard_normal((12, 300)).astype(np.float32)
    x = rng.standard_normal((7, 300)).astype(np.float32)
    from tpufoam.surrogate.pca import PCAModel as JPCA
    ev = np.ones(12, np.float32)
    jp = JPCA(mean=jnp.asarray(mean), components=jnp.asarray(comp),
              explained_variance=ev, explained_variance_ratio=ev)
    tp = PCAModel(T(mean), T(comp), T(ev), T(ev))
    close(tp.transform(T(x), 9), jp.transform(jnp.asarray(x), 9), 1e-5)
    z = rng.standard_normal((7, 9)).astype(np.float32)
    close(tp.inverse_transform(T(z)), jp.inverse_transform(jnp.asarray(z)),
          1e-5)


@pytest.mark.parametrize("cdt,rtol", [("float32", 1e-5),
                                      ("bfloat16", 1e-2)])
def test_dense_mlp(cdt, rtol):
    jdef = jmlp.ModelDef.from_arch("MLP_small", in_dim=13, out_dim=40,
                                   compute_dtype=cdt)
    params = jmlp.init_model(jax.random.PRNGKey(1), jdef)
    x = np.random.default_rng(2).standard_normal((16, 13)).astype(np.float32)
    ref = jmlp.apply_model(params, jdef, jnp.asarray(x))
    tdef = tmlp.ModelDef(**dataclasses.asdict(jdef))
    tparams = tmlp.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    close(tmlp.apply_model(tparams, tdef, T(x)), ref, rtol)


@pytest.fixture(scope="module")
def bundles():
    return (jpipe.SurrogateBundle.load(BUNDLE),
            tpipe.SurrogateBundle.load(BUNDLE, device="cpu"))


def test_bundle_loader_reproduces_the_parameter_tree(bundles):
    """The loader's param_i order is JAX's sorted-key flatten: head.b,
    head.w, layers[0].b, layers[0].w (13 x 512), ..."""
    jb, tb = bundles
    jflat = jax.tree_util.tree_leaves_with_path(jb.params)
    for path, leaf in jflat:
        node = tb.params
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tuple(tb.params["layers"][0]["w"].shape) == (13, 512)
    assert tb.mdef == tmlp.ModelDef(**dataclasses.asdict(jb.mdef))
    np.testing.assert_array_equal(tb.pca_out.components.numpy(),
                                  np.asarray(jb.pca_out.components))
    for k in jb.norm:
        np.testing.assert_array_equal(tb.norm[k].numpy(),
                                      np.asarray(jb.norm[k]))


@pytest.mark.parametrize("cdt,rtol", [("float32", 1e-4),
                                      ("bfloat16", 1e-2)])
def test_predictor_with_sm_ref512_on_128x512(bundles, cdt, rtol):
    jb, tb = bundles
    jb = dataclasses.replace(jb, mdef=dataclasses.replace(
        jb.mdef, compute_dtype=cdt))
    tb = dataclasses.replace(tb, mdef=dataclasses.replace(
        tb.mdef, compute_dtype=cdt))
    ny, nx = 128, 512
    delta = 2.0 / ny
    kw = dict(shape_name="cylinder", length=nx * delta, height=2.0,
              obstacle_size=0.5, nu=8e-3)
    jc = jax_build(jax_geom(**kw), delta=delta)
    tc = build_channel_case(channel_case_geometry(**kw), delta=delta,
                            device="cpu")
    rng = np.random.default_rng(11)
    fl = np.asarray(jc.fluid)
    u0 = np.asarray(jax_initial_flow(jc).u)
    f = {k: (a * fl).astype(np.float32) for k, a in dict(
        u=u0 + 0.05 * rng.standard_normal(fl.shape),
        v=0.05 * rng.standard_normal(fl.shape),
        p=rng.standard_normal(fl.shape),
        u_prev=u0, v_prev=np.zeros(fl.shape),
        p_prev=rng.standard_normal(fl.shape)).items()}
    ref = jpipe.make_predictor(jb, stitch="lstsq")(
        jc, jnp.asarray(f["p"]), {k: jnp.asarray(v) for k, v in f.items()})
    pred = tpipe.make_predictor(tb, stitch="lstsq")
    got = pred(tc, T(f["p"]), {k: T(v) for k, v in f.items()})
    assert pred.calls == 1
    # compare the predicted change, the part the surrogate computes
    close(got - T(f["p"]), np.asarray(ref) - f["p"], rtol)


@pytest.mark.parametrize("ny,nx,size", LAYOUTS)
def test_cached_layout_indices_equal_the_host_arrays(ny, nx, size):
    """The device copies `layout_indices` and `stitch_indices` keep equal,
    element for element, the arrays the extraction, the placement and the
    lstsq stitch uploaded on every call before."""
    tl = tblk.build_block_layout(ny, nx, size, 0.25)
    cpu = torch.device("cpu")
    lidx, sidx = tblk.layout_indices(tl, cpu), tblk.stitch_indices(tl, cpu)
    _, order, inv, _ = tblk._fast_groups(tl)
    groups, ia, ib = tblk._pair_groups(tl)
    got = {"inv": lidx[0], "order": lidx[1], "ia": sidx["ia"],
           "ib": sidx["ib"], "incidence": sidx["incidence"]}
    want = {"inv": inv, "order": order, "ia": ia, "ib": ib,
            "incidence": tblk._incidence(tl)}
    for name, a in want.items():
        assert got[name].dtype == torch.int64, name
        assert torch.equal(got[name], torch.as_tensor(a)), name
    assert len(sidx["pairs"]) == len(groups)
    for (sa, sb, ka, kb), (ta, tb, ka_t, kb_t) in zip(groups, sidx["pairs"]):
        assert (sa, sb) == (ta, tb)
        assert torch.equal(ka_t, torch.as_tensor(ka))
        assert torch.equal(kb_t, torch.as_tensor(kb))
    assert tblk.layout_indices(tl, cpu) is lidx
    assert tblk.stitch_indices(tl, cpu) is sidx


@pytest.mark.parametrize("stitch,reads", [("lstsq", 0), ("scan", 2)])
def test_a_second_prediction_uploads_no_constant(bundles, stitch, reads):
    """After the first prediction on a layout, a prediction makes no host
    transfer but the scan stitch's own (its strip means read and its
    offsets uploaded, per case) and adds no entry to the layout's caches,
    whose index tensors stay the same objects; a CPU call captures no
    CUDA graph."""
    from tpufoam_torch.fv.case import initial_flow
    from tpufoam_torch.piso.batched import stack_cases, stack_flows
    from tpufoam_torch.utils import profiling

    _, tb = bundles
    ny, nx = 128, 512
    cases = [build_channel_case(channel_case_geometry(
        shape, length=nx * 2.0 / ny, height=2.0, obstacle_size=0.5,
        nu=8e-3), delta=2.0 / ny, device="cpu")
        for shape in ("cylinder", "triangle")]
    case = stack_cases(cases)
    flow = stack_flows([initial_flow(c, 5e-4) for c in cases])
    aux = dict(u=flow.u, v=flow.v, p=flow.p, u_prev=flow.u_prev,
               v_prev=flow.v_prev, p_prev=flow.p_prev)
    pred = tpipe.make_predictor(tb, stitch=stitch)
    bound = pred.bind(case)
    layout, cpu = pred._layout(case), torch.device("cpu")
    caches = [tblk.layout_indices, tblk._blend_constants]
    if stitch == "lstsq":
        caches.append(tblk.stitch_indices)

    def cached():
        return [(c.cache_info().currsize, c.cache_info().misses)
                for c in caches]

    with torch.no_grad():
        first = bound(case, flow.p, aux)
        before = cached()
        idx = tblk.layout_indices(layout, cpu)
        n0 = profiling.host_read.count
        again = bound(case, flow.p, aux)
    assert profiling.host_read.count - n0 == reads * len(cases)
    assert cached() == before
    assert tblk.layout_indices(layout, cpu) is idx
    assert torch.equal(first, again)
    assert pred.calls == 2
    assert pred.graph_captures == 0 and pred.graph_replays == 0
