"""Card-only tests of tpufoam_torch: the hand-written CUDA kernels against
their plain versions, and the port's step and multigrid solve on the card
against the same on the CPU. They skip without a CUDA device.

Run them on a machine with a card (no JAX needed; --noconftest keeps the
JAX test configuration out):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from tpufoam_torch.fv.pressure import PressureCoeffs
from tpufoam_torch.ops import momentum as tmom
from tpufoam_torch.ops import stencil as ts

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(ny, nx, seed, device):
    """Random structured momentum operands: zero conductances on the
    domain edges, diagonally dominant, a few solid cells."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (ny, nx)).astype(
            np.float32), device=device)

    a_e, a_w, a_n, a_s = (f(0, 1) for _ in range(4))
    a_e[:, -1] = 0
    a_w[:, 0] = 0
    a_n[-1, :] = 0
    a_s[0, :] = 0
    fluid = (f(0, 1) > 0.05).float()
    ap_inv = fluid / (a_e + a_w + a_n + a_s + f(0.5, 2.0))
    return (a_e, a_w, a_n, a_s, ap_inv, f(-1, 1), f(-1, 1), f(-1, 1) * fluid,
            f(-1, 1) * fluid)


# Eight float32 sweeps summed in the same order; the kernel fuses
# multiply-adds, so the two agree to a few float32 roundings.
KERNEL_RTOL = 1e-5


@pytest.mark.parametrize("shape", [(512, 2048), (37, 70), (8, 8), (33, 65)])
@pytest.mark.parametrize("sweeps", [0, 1, 8])
def test_momentum_kernel_matches_plain(cuda, shape, sweeps):
    ops = _operands(*shape, seed=sum(shape) + sweeps, device=cuda)
    before = tmom.momentum_multisweep.launches
    got = tmom.momentum_multisweep(*ops, sweeps=sweeps)
    torch.cuda.synchronize()
    assert tmom.momentum_multisweep.launches == before + 1
    ref = tmom.momentum_multisweep_plain(*ops, sweeps=sweeps)
    for g, r in zip(got, ref):
        err = float((g - r).abs().max())
        assert err <= KERNEL_RTOL * float(r.abs().max()), err


def test_momentum_kernel_rejects_what_it_cannot_take(cuda):
    ops = list(_operands(16, 24, 0, cuda))
    with pytest.raises(ValueError):
        tmom.momentum_multisweep(*ops[:-1], ops[-1].double(), sweeps=2)
    with pytest.raises(ValueError):
        tmom.momentum_multisweep(*ops[:-1], ops[-1].t().contiguous().t(),
                                 sweeps=2)
    with pytest.raises(ValueError):
        tmom.momentum_multisweep(*ops[:-1], ops[-1].cpu(), sweeps=2)
    with pytest.raises(ValueError):
        tmom.momentum_multisweep(*ops[:-1], ops[-1][:, :-1].contiguous(),
                                 sweeps=2)


@pytest.mark.parametrize("shape", [(4, 512, 2048), (3, 37, 70)])
def test_batched_momentum_launch_equals_single_launches(cuda, shape):
    """One launch over B planes against B launches over one plane: the
    same per-cell arithmetic, so bit for bit."""
    b_sz = shape[0]
    per_case = [_operands(*shape[1:], seed=7 + k, device=cuda)
                for k in range(b_sz)]
    ops = [torch.stack(x) for x in zip(*per_case)]
    before = tmom.momentum_multisweep.launches
    got = tmom.momentum_multisweep(*ops, sweeps=8)
    torch.cuda.synchronize()
    assert tmom.momentum_multisweep.launches == before + 1
    for k in range(b_sz):
        ref = tmom.momentum_multisweep(*per_case[k], sweeps=8)
        for g, r in zip(got, ref):
            assert torch.equal(g[k], r), k
    ref = tmom.momentum_multisweep_plain(*ops, sweeps=8)
    for g, r in zip(got, ref):
        err = float((g - r).abs().max())
        assert err <= KERNEL_RTOL * float(r.abs().max()), err


def test_fleet_step_on_card(cuda):
    """Two locksteps of a two-case fleet at 128 x 512 with the momentum
    kernel and the sm_ref512 warm start: finite fields, one momentum
    launch and one prediction per lockstep."""
    import os

    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.piso.batched import (run_piso_batched_eager,
                                            stack_cases, stack_flows)
    from tpufoam_torch.piso.engine import PisoConfig
    from tpufoam_torch.solvers.backends import MGBackend
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)

    torch.backends.cuda.matmul.allow_tf32 = False
    ny, nx = 128, 512
    cases = [build_channel_case(channel_case_geometry(
        shape, length=nx * 2.0 / ny, height=2.0, obstacle_size=size,
        nu=8e-3), delta=2.0 / ny, device=cuda)
        for shape, size in (("cylinder", 0.5), ("ellipse", 0.6))]
    pred = make_predictor(SurrogateBundle.load(os.path.join(
        os.path.dirname(__file__), "..", "artifacts", "sm_ref512"),
        device=cuda), stitch="lstsq")
    before = tmom.momentum_multisweep.launches
    out = run_piso_batched_eager(
        stack_cases(cases), stack_flows([initial_flow(c, 5e-4)
                                         for c in cases]), 2,
        cfg=PisoConfig(max_co=0.5, max_dt=2e-3, momentum_smoother="kernel"),
        backend=MGBackend(cycles=2, precision="bf16"), sm_predict=pred)
    torch.cuda.synchronize()
    assert tmom.momentum_multisweep.launches == before + 2
    assert pred.calls == 2
    for name in ("u", "v", "p", "phi_x", "phi_y", "dt"):
        assert bool(torch.isfinite(getattr(out, name)).all()), name
    assert tuple(out.u.shape) == (2, ny, nx)


def test_fleet_prediction_repeats_the_single_ones_bit_for_bit(cuda):
    """The lstsq stitch adds each block's pair terms in a fixed order (no
    atomics), so a prediction repeats bit for bit, and a fleet's is each
    case's own."""
    import os

    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.piso.batched import stack_cases, stack_flows
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)

    ny, nx = 128, 512
    cases = [build_channel_case(channel_case_geometry(
        shape, length=nx * 2.0 / ny, height=2.0, obstacle_size=size,
        nu=8e-3), delta=2.0 / ny, device=cuda)
        for shape, size in (("cylinder", 0.5), ("triangle", 0.45))]
    pred = make_predictor(SurrogateBundle.load(os.path.join(
        os.path.dirname(__file__), "..", "artifacts", "sm_ref512"),
        device=cuda), stitch="lstsq")
    gen = torch.Generator(device=cuda).manual_seed(3)
    flows = []
    for c in cases:
        f = initial_flow(c, 5e-4)
        noise = torch.randn(c.fluid.shape, generator=gen, device=cuda)
        flows.append(type(f)(**{**vars(f), "u": f.u + 0.05 * noise * c.fluid,
                                "p": noise * c.fluid}))

    def aux(f):
        return dict(u=f.u, v=f.v, p=f.p, u_prev=f.u_prev, v_prev=f.v_prev,
                    p_prev=f.p_prev)

    singles = [pred(c, f.p, aux(f)) for c, f in zip(cases, flows)]
    again = [pred(c, f.p, aux(f)) for c, f in zip(cases, flows)]
    fb = stack_flows(flows)
    fleet = pred(stack_cases(cases), fb.p, aux(fb))
    for k, single in enumerate(singles):
        assert torch.equal(single, again[k]), k
        assert torch.equal(fleet[k], single), k


def test_hybrid_step_on_card_matches_cpu(cuda):
    """Three f32-multigrid steps of the 64 x 256 cylinder channel on the
    card (momentum kernel) and on the CPU (its plain version), with the
    sm_ref512 surrogate warm start at 128 x 512."""
    import os

    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.piso.engine import PisoConfig, run_piso_eager
    from tpufoam_torch.solvers.backends import MGBackend
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)

    torch.backends.cuda.matmul.allow_tf32 = False
    bundle_dir = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                              "sm_ref512")
    ny, nx = 128, 512
    geom = channel_case_geometry("cylinder", length=nx * 2.0 / ny,
                                 height=2.0, obstacle_size=0.5, nu=8e-3)
    cfg = PisoConfig(max_co=0.5, max_dt=2e-3, momentum_smoother="kernel")
    flows = {}
    for dev in ("cpu", cuda):
        case = build_channel_case(geom, delta=2.0 / ny, device=dev)
        pred = make_predictor(SurrogateBundle.load(bundle_dir, device=dev),
                              stitch="lstsq")
        flows[str(dev)] = run_piso_eager(case, initial_flow(case, 5e-4), 3,
                                         cfg=cfg, backend=MGBackend(cycles=2),
                                         sm_predict=pred)
    for name in ("u", "v", "p"):
        a = getattr(flows["cuda"], name).cpu()
        b = getattr(flows["cpu"], name)
        # f32 everywhere; differences are float32 rounding amplified by
        # the pressure equation's cancellation (see chip_smoke.py parity)
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


# ---- pressure-stencil kernels -------------------------------------------

# The kernels round at the same places as their plain versions (see
# csrc/pressure_stencil.cu), so they should agree bit for bit; the bounds
# allow a few float32 roundings, and one bf16 ulp (2^-8) of max |plain|.
STENCIL_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def _pressure_operands(ny, nx, dtype, seed, device):
    """Random SPD-like operands: conductances in [0, 1) (nonzero on the
    domain's edges too), diag above their sum, x, b and a correction."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (ny, nx)).astype(
            np.float32), device=device)

    c = [f(0, 1) for _ in range(4)]
    diag = c[0] + c[1] + c[2] + c[3] + f(0.1, 1.0)
    coef = PressureCoeffs(*(t.to(dtype) for t in c),
                          torch.zeros_like(diag, dtype=dtype),
                          diag.to(dtype))
    return coef, f(-1, 1).to(dtype), f(-1, 1).to(dtype), \
        f(-0.1, 0.1).to(dtype)


def _stencil_pair(kernel, coef, x, b, corr, iters):
    if kernel == "jacobi_multisweep":
        return ((ts.jacobi_multisweep(coef, x, b, iters),),
                (ts.jacobi_multisweep_plain(coef, x, b, iters),))
    if kernel == "smooth_residual":
        return (ts.smooth_residual(coef, x, b, iters),
                ts.smooth_residual_plain(coef, x, b, iters))
    return ((ts.corr_smooth(coef, x, corr, b, iters),),
            (ts.corr_smooth_plain(coef, x, corr, b, iters),))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(512, 2048), (37, 70), (1, 70),
                                   (70, 1)])
@pytest.mark.parametrize("kernel", ["jacobi_multisweep", "smooth_residual",
                                    "corr_smooth"])
def test_pressure_kernels_match_plain(cuda, kernel, shape, dtype):
    top = ts._halo_for(dtype) - (kernel == "smooth_residual")
    ops = _pressure_operands(*shape, dtype, seed=sum(shape), device=cuda)
    counter = getattr(ts, kernel)
    for iters in (0, 1, 2, top):
        before = counter.launches
        got, ref = _stencil_pair(kernel, *ops, iters)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        for g, r in zip(got, ref):
            assert g.dtype == dtype and g.is_cuda
            err = float((g.float() - r.float()).abs().max())
            scale = float(r.float().abs().max())
            assert err <= STENCIL_RTOL[dtype] * scale, (iters, err, scale)


def test_pressure_kernels_reject_what_they_cannot_take(cuda):
    coef, x, b, corr = _pressure_operands(16, 24, torch.float32, 0, cuda)
    with pytest.raises(ValueError):     # dtype the kernels do not take
        ts.jacobi_multisweep(coef, x.double(), b.double())
    with pytest.raises(ValueError):     # mixed dtypes
        ts.smooth_residual(coef, x, b.to(torch.bfloat16))
    with pytest.raises(ValueError):     # not contiguous
        ts.corr_smooth(coef, x, corr.t().contiguous().t(), b)
    with pytest.raises(ValueError):     # CPU and CUDA operands
        ts.jacobi_multisweep(coef, x, b.cpu())
    for kernel, top in (("jacobi_multisweep", 8), ("smooth_residual", 7),
                        ("corr_smooth", 8)):
        with pytest.raises(ValueError):  # iters beyond the halo
            _stencil_pair(kernel, coef, x, b, corr, top + 1)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_mg_solve_kernel_fused_on_card_matches_cpu(cuda, precision):
    """Two V-cycles with the fused legs on the card (the kernels) and on
    the CPU (their plain versions), on the 128 x 512 cylinder channel's
    pressure operator. Tolerances as in tests/test_torch_solvers.py: 1e-4
    in f32, 2e-2 in the bf16 correction form (the CPU and the card may
    round the bf16 transfers' sums differently)."""
    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case
    from tpufoam_torch.fv.pressure import pressure_coeffs
    from tpufoam_torch.solvers import multigrid as tmg

    ny, nx = 128, 512
    geom = channel_case_geometry("cylinder", length=nx * 2.0 / ny,
                                 height=2.0, obstacle_size=0.5, nu=8e-3)
    rng = np.random.default_rng(5)
    rau = torch.as_tensor(rng.uniform(0.5, 1.5, (ny, nx)).astype(
        np.float32)) * 1e-4
    b = torch.as_tensor(rng.standard_normal((ny, nx)).astype(np.float32))
    dtype = torch.bfloat16 if precision == "bf16" else None
    out = {}
    for dev in ("cpu", cuda):
        case = build_channel_case(geom, delta=2.0 / ny, device=dev)
        coef = pressure_coeffs(case, rau.to(dev) * case.fluid)
        bb = b.to(dev) * case.fluid
        n_levels = len(tmg.build_hierarchy(coef))
        before = (ts.smooth_residual.launches, ts.corr_smooth.launches)
        out[str(dev)] = tmg.mg_solve(coef, bb, torch.zeros_like(bb),
                                     cycles=2, dtype=dtype,
                                     smoother="kernel-fused")
        launched = (ts.smooth_residual.launches - before[0],
                    ts.corr_smooth.launches - before[1])
        expect = (0, 0) if dev == "cpu" else (2 * (n_levels - 1),) * 2
        assert launched == expect, (dev, launched)
    got, ref = out["cuda"].cpu(), out["cpu"]
    tol = 2e-2 if precision == "bf16" else 1e-4
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


# ---- the single-pass kernels: stencil_matvec, jacobi_sweep ---------------

def _edge_operands(shape, dtype, seed, device):
    """_pressure_operands with the conductances that point out of the
    domain set to 0, as on every real case."""
    coef, x, b, _ = _pressure_operands(*shape, dtype, seed, device)
    coef.c_e[:, -1] = 0
    coef.c_w[:, 0] = 0
    coef.c_n[-1, :] = 0
    coef.c_s[0, :] = 0
    return coef, x, b


def _planes(coef, x, b, k=3):
    """A (k, ny, nx) fleet: scaled coefficients, shifted x and b."""
    return (PressureCoeffs(*(torch.stack([t * (1 + 0.5 * j)
                                          for j in range(k)])
                             for t in (coef.c_e, coef.c_w, coef.c_n,
                                       coef.c_s, coef.c_out, coef.diag))),
            torch.stack([torch.roll(x, j, -1) for j in range(k)]),
            torch.stack([torch.roll(b, -j, -2) for j in range(k)]))


SINGLE_PASS_SHAPES = [(512, 2048), (256, 1375), (37, 70), (1, 70), (70, 1),
                      (8, 43)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SINGLE_PASS_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("edges", ["zero", "nonzero"])
def test_stencil_matvec_equals_plain_bit_for_bit(cuda, shape, dtype, edges):
    make = _edge_operands if edges == "zero" else \
        (lambda *a: _pressure_operands(*a[0], *a[1:])[:3])
    coef, x, b = make(shape, dtype, sum(shape), cuda)
    for c, xx in ((coef, x), _planes(coef, x, b)[:2]):
        before = ts.stencil_matvec.launches
        got = ts.stencil_matvec(c, xx)
        torch.cuda.synchronize()
        assert ts.stencil_matvec.launches == before + 1
        assert got.dtype == dtype and got.shape == xx.shape
        ref = ts.stencil_matvec_plain(c, xx)
        assert float((got.float() - ref.float()).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SINGLE_PASS_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jacobi_sweep_equals_plain_and_multisweep(cuda, shape, dtype):
    coef, x, b = _edge_operands(shape, dtype, sum(shape) + 1, cuda)
    for iters in (0, 1, 2, 8):
        before = ts.jacobi_sweep.launches
        got = ts.jacobi_sweep(coef, x, b, iters)
        torch.cuda.synchronize()
        assert ts.jacobi_sweep.launches == before + iters
        for ref in (ts.jacobi_sweep_plain(coef, x, b, iters),
                    ts.jacobi_multisweep(coef, x, b, iters)):
            assert float((got.float() - ref.float()).abs().max()) == 0.0
    cb, xb, bb = _planes(coef, x, b)
    got = ts.jacobi_sweep(cb, xb, bb, 3)
    ref = ts.jacobi_sweep_plain(cb, xb, bb, 3)
    assert float((got.float() - ref.float()).abs().max()) == 0.0


def test_single_pass_kernels_reject_what_they_cannot_take(cuda):
    coef, x, b = _edge_operands((16, 24), torch.float32, 0, cuda)
    with pytest.raises(ValueError):     # not contiguous
        ts.stencil_matvec(coef, x.t().contiguous().t())
    with pytest.raises(ValueError):     # mixed dtypes
        ts.jacobi_sweep(coef, x, b.to(torch.bfloat16), 1)
    with pytest.raises(ValueError):     # a coefficient broadcast on a fleet
        ts.stencil_matvec(coef, torch.stack([x, x]))
    with pytest.raises(ValueError):     # the kernels have no backward
        ts.stencil_matvec(coef, x.clone().requires_grad_())
    with torch.no_grad():
        ts.stencil_matvec(coef, x.clone().requires_grad_())


def test_pressure_matvec_launches_the_kernel(cuda):
    from tpufoam_torch.fv.pressure import pressure_matvec
    coef, x, _ = _edge_operands((64, 256), torch.float32, 3, cuda)
    before = ts.stencil_matvec.launches
    got = pressure_matvec(coef, x)
    assert ts.stencil_matvec.launches == before + 1
    assert torch.equal(got, ts.stencil_matvec_plain(coef, x))


def test_schafer_turek_hybrid_step_on_card_matches_cpu(cuda):
    """Three steps of the Schaefer-Turek hybrid path (BDF2, AutoBackend
    with an f32 polish, sm_st128, sm_trust 1.0) at 128 x 688 on the card
    (every kernel) and on the CPU (their plain versions); the two cases'
    SDFs are equal bit for bit. f32 everywhere; the bound is
    test_hybrid_step_on_card_matches_cpu's."""
    import os

    from tpufoam_torch.eval.benchmark import schafer_turek_case
    from tpufoam_torch.fv.case import initial_flow
    from tpufoam_torch.piso.engine import PisoConfig, run_piso_eager
    from tpufoam_torch.solvers.backends import AutoBackend
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)

    torch.backends.cuda.matmul.allow_tf32 = False
    bundle_dir = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                              "sm_st128")
    cfg = PisoConfig(max_co=0.4, max_dt=5e-3, ddt="backward",
                     momentum_smoother="kernel", sm_trust=1.0)
    sdf = {}
    flows = {}
    for dev in ("cpu", cuda):
        case, _ = schafer_turek_case("2D-2", delta=0.0032, device=dev)
        sdf[str(dev)] = case.sdf.cpu()
        pred = make_predictor(SurrogateBundle.load(bundle_dir, device=dev),
                              stitch="lstsq")
        before = ts.stencil_matvec.launches
        flows[str(dev)] = run_piso_eager(
            case, initial_flow(case, 2e-4), 3, cfg=cfg,
            backend=AutoBackend(cycles=2, tau=0.05, precision="f32"),
            sm_predict=pred)
        assert (ts.stencil_matvec.launches > before) == (dev != "cpu")
    assert torch.equal(sdf["cuda"], sdf["cpu"])
    for name in ("u", "v", "p"):
        a = getattr(flows["cuda"], name).cpu()
        b = getattr(flows["cpu"], name)
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


# ---- the sharded kernels (ops.sharded) -------------------------------------


def _card_mesh(shape, devices):
    from tpufoam_torch.parallel.mesh import device_mesh
    return device_mesh(shape[0] * shape[1], shape=shape, devices=devices)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2), (1, 4)])
@pytest.mark.parametrize("shape", [(512, 2048), (64, 96)])
def test_sharded_momentum_equals_the_single_kernel(cuda, shape, mesh_shape):
    """Four or eight blocks of one card in one launch, against one launch
    over the whole grid: bit for bit (each kept cell runs the same
    arithmetic on the same values)."""
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh(mesh_shape, [cuda] * (mesh_shape[0] * mesh_shape[1]))
    ops = _operands(*shape, seed=3, device=cuda)
    before = tsh.momentum_multisweep_sharded.launches
    got = tsh.momentum_multisweep_sharded(mesh, *ops, sweeps=8)
    torch.cuda.synchronize()
    assert tsh.momentum_multisweep_sharded.launches == before + 1
    ref = tmom.momentum_multisweep(*ops, sweeps=8)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2)])
def test_sharded_jacobi_equals_the_single_kernel(cuda, mesh_shape, dtype):
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh(mesh_shape, [cuda] * (mesh_shape[0] * mesh_shape[1]))
    coef, x, b, _ = _pressure_operands(512, 2048, dtype, 5, cuda)
    for iters in (1, 2, ts._halo_for(dtype)):
        before = tsh.jacobi_multisweep_sharded.launches
        got = tsh.jacobi_multisweep_sharded(mesh, coef, x, b, iters)
        torch.cuda.synchronize()
        assert tsh.jacobi_multisweep_sharded.launches == before + mesh.size
        assert torch.equal(got, ts.jacobi_multisweep(coef, x, b, iters))


def test_sharded_kernels_across_two_cards(cuda):
    """A (1, 2) mesh over cuda:0 and cuda:1: each launcher runs on its
    operands' card, the halos cross by peer copies, and the result equals
    the single kernel on cuda:0 bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh((1, 2), ["cuda:0", "cuda:1"])
    ops = _operands(256, 1024, seed=9, device=torch.device("cuda:0"))
    before = tsh.momentum_multisweep_sharded.launches
    got = tsh.momentum_multisweep_sharded(mesh, *ops, sweeps=8)
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert tsh.momentum_multisweep_sharded.launches == before + 2
    for g, r in zip(got, tmom.momentum_multisweep(*ops, sweeps=8)):
        assert torch.equal(g, r)
    for dtype in (torch.float32, torch.bfloat16):
        coef, x, b, _ = _pressure_operands(256, 1024, dtype, 4,
                                           torch.device("cuda:0"))
        got = tsh.jacobi_multisweep_sharded(mesh, coef, x, b, 2)
        assert torch.equal(got, ts.jacobi_multisweep(coef, x, b, 2))


# ---- the redesigned kernels: variants, offsets, stacks, the 2 x 2 mesh ----


def _offset_view(t, offset):
    """A contiguous copy of t whose data starts `offset` elements into a
    fresh buffer: 16-byte aligned only when offset * itemsize is."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous()
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(512, 2048), (256, 1375), (4, 272, 1040),
                                   (3, 8, 43), (2, 16, 64), (1024, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_stencil_matvec_variants_and_offsets(cuda, shape, dtype):
    """Large planes of a width that is a whole number of 16-byte runs
    take the vector variant from aligned operands; odd widths, small
    planes and operands one element off 16 bytes take the cell variant.
    Both equal the plain version bit for bit, and each launch is counted
    under its variant."""
    coef, x, _ = _edge_operands(shape[-2:], dtype, sum(shape), cuda)
    if len(shape) == 3:
        coef, x, _ = _planes(coef, x, x, shape[0])
    key = tuple(shape[-2:])
    prec = "f32" if dtype == torch.float32 else "bf16"
    ref = ts.stencil_matvec_plain(coef, x)
    for offset in (0, 1):
        c = PressureCoeffs(*(_offset_view(t, offset) for t in (
            coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.c_out, coef.diag)))
        xx = _offset_view(x, offset)
        variant = ts.pass_geometry(shape, dtype, aligned=offset == 0).variant
        if offset:
            assert variant == "cell"
        before = ts.stencil_matvec.by_shape[variant, prec, key]
        got = ts.stencil_matvec(c, xx)
        torch.cuda.synchronize()
        assert ts.stencil_matvec.by_shape[variant, prec, key] == before + 1
        assert torch.equal(got, ref), (offset, variant)


def test_main_path_levels_take_their_variant(cuda):
    """Each level of the 512 x 2048 hierarchy in both dtypes: the finest
    in the vector variant, the coarser ones in the cell variant; bit for
    bit against the plain version."""
    for dtype, prec in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ny, nx = 512, 2048
        while min(ny, nx) >= 8:
            coef, x, _ = _edge_operands((ny, nx), dtype, ny, cuda)
            variant = "vector" if ny == 512 else "cell"
            before = ts.stencil_matvec.by_shape[variant, prec, (ny, nx)]
            got = ts.stencil_matvec(coef, x)
            assert ts.stencil_matvec.by_shape[variant, prec, (ny, nx)] \
                == before + 1
            assert torch.equal(got, ts.stencil_matvec_plain(coef, x))
            ny, nx = ny // 2, nx // 2


def test_jacobi_sweep_vector_variant(cuda):
    """jacobi_sweep shares the single-pass kernels: on a large aligned
    plane it takes the vector variant, bit for bit against the plain
    sweeps and the multisweep kernel, in both dtypes."""
    for dtype, prec in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        coef, x, b = _edge_operands((512, 2048), dtype, 17, cuda)
        before = ts.jacobi_sweep.by_shape["vector", prec, (512, 2048)]
        got = ts.jacobi_sweep(coef, x, b, 2)
        assert ts.jacobi_sweep.by_shape["vector", prec, (512, 2048)] \
            == before + 2
        for ref in (ts.jacobi_sweep_plain(coef, x, b, 2),
                    ts.jacobi_multisweep(coef, x, b, 2)):
            assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(3, 37, 70), (2, 272, 1040), (1, 41, 1375)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sweeps", [1, 2, 4, 8])
def test_momentum_kernel_stacks_offsets_and_sweeps(cuda, shape, sweeps):
    """The register-tiled momentum kernel on stacks of odd planes, from
    operands one element off 16 bytes too: within the tolerance of the
    plain version, and the stack equal to one launch per plane bit for
    bit."""
    per_case = [_operands(*shape[1:], seed=11 + k, device=cuda)
                for k in range(shape[0])]
    ops = [_offset_view(torch.stack(t), 1) for t in zip(*per_case)]
    got = tmom.momentum_multisweep(*ops, sweeps=sweeps)
    torch.cuda.synchronize()
    ref = tmom.momentum_multisweep_plain(*ops, sweeps=sweeps)
    for g, r in zip(got, ref):
        err = float((g - r).abs().max())
        assert err <= KERNEL_RTOL * float(r.abs().max()), err
    for k in range(shape[0]):
        single = tmom.momentum_multisweep(*per_case[k], sweeps=sweeps)
        for g, r in zip(got, single):
            assert torch.equal(g[k], r), k


def test_sharded_momentum_on_2x2_matches_plain(cuda):
    """The sharded launch on the 2 x 2 mesh of one card: within the
    tolerance of its sharded plain version, and of the global plain."""
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh((2, 2), [cuda] * 4)
    ops = _operands(512, 2048, seed=21, device=cuda)
    got = tsh.momentum_multisweep_sharded(mesh, *ops, sweeps=8)
    for ref in (tsh.momentum_multisweep_sharded_plain(mesh, *ops, sweeps=8),
                tmom.momentum_multisweep_plain(*ops, sweeps=8)):
        for g, r in zip(got, ref):
            err = float((g - r).abs().max())
            assert err <= KERNEL_RTOL * float(r.abs().max()), err
