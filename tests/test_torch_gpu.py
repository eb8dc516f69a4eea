"""Card-only tests of tpufoam_torch: the hand-written CUDA kernels against
their plain versions, and the port's step and multigrid solve on the card
against the same on the CPU. They skip without a CUDA device.

Run them on a machine with a card (no JAX needed; --noconftest keeps the
JAX test configuration out):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import contextlib

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
    with pytest.raises(ValueError, match="no backward"):  # no reverse mode
        ts.jacobi_sweep(coef, x.clone().requires_grad_(), b, 1)
    with torch.no_grad():
        ts.jacobi_sweep(coef, x.clone().requires_grad_(), b, 1)
    # the matvec has one: its backward is stencil_matvec_grad
    y = ts.stencil_matvec(coef, x.clone().requires_grad_())
    assert type(y.grad_fn).__name__ == "StencilMatvecBackward"
    with torch.no_grad():
        assert ts.stencil_matvec(coef, x.clone().requires_grad_()).grad_fn \
            is None


GRAD_NEEDS = [(True,) * 6, (True,) + (False,) * 5, (False,) * 5 + (True,),
              (False, True, False, True, False, False)]


@pytest.mark.parametrize("shape", [(512, 2048), (256, 1375), (37, 70),
                                   (1, 70), (43, 8), (4, 64, 256)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matvec_grad_kernel_matches_plain(cuda, shape, dtype):
    """The matvec's backward kernel (csrc/stencil_grad.cu) against
    `stencil_matvec_grad_plain` on the card, bit for bit (the same
    roundings in the same order), for several subsets of the gradients
    asked for: one launch a call, none of an output not asked for."""
    *lead, ny, nx = shape
    coef, x, g, _ = _pressure_operands(ny, nx, dtype, sum(shape), cuda)
    if lead:
        coef, x, g = _planes(coef, x, g, lead[0])
    for need in GRAD_NEEDS:
        before = ts.stencil_matvec_grad.by_shape["cell", ts._DTYPES[dtype],
                                                 (ny, nx)]
        got = ts.stencil_matvec_grad(coef, x, g, need)
        torch.cuda.synchronize()
        assert ts.stencil_matvec_grad.by_shape[
            "cell", ts._DTYPES[dtype], (ny, nx)] == before + 1
        ref = ts.stencil_matvec_grad_plain(coef, x, g, need)
        for n, a, r in zip(need, got, ref):
            assert (a is None) == (not n)
            if n:
                assert torch.equal(a, r), (need, shape)


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
    """Four or eight blocks of one card in one window launch, against one
    launch over the whole grid: bit for bit (each kept cell runs the same
    arithmetic on the same values)."""
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh(mesh_shape, [cuda] * (mesh_shape[0] * mesh_shape[1]))
    ops = _operands(*shape, seed=3, device=cuda)
    before = tsh.momentum_multisweep_sharded.launches
    window = tsh.momentum_multisweep_sharded.by_route["window"]
    got = tsh.momentum_multisweep_sharded(mesh, *ops, sweeps=8)
    torch.cuda.synchronize()
    assert tsh.momentum_multisweep_sharded.launches == before + 1
    assert tsh.momentum_multisweep_sharded.by_route["window"] == window + 1
    ref = tmom.momentum_multisweep(*ops, sweeps=8)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2), (4, 1), (1, 4)])
def test_sharded_jacobi_equals_the_single_kernel(cuda, mesh_shape, dtype):
    """All the blocks of one card in one window launch (one sweep: the
    single-pass kernels; more: the run kernel), against the single kernel
    over the whole grid and the sharded plain version: bit for bit."""
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh(mesh_shape, [cuda] * (mesh_shape[0] * mesh_shape[1]))
    coef, x, b, _ = _pressure_operands(512, 2048, dtype, 5, cuda)
    for iters in (1, 2, ts._halo_for(dtype)):
        before = tsh.jacobi_multisweep_sharded.launches
        window = tsh.jacobi_multisweep_sharded.by_route["window"]
        got = tsh.jacobi_multisweep_sharded(mesh, coef, x, b, iters)
        torch.cuda.synchronize()
        assert tsh.jacobi_multisweep_sharded.launches == before + 1
        assert tsh.jacobi_multisweep_sharded.by_route["window"] == window + 1
        assert torch.equal(got, ts.jacobi_multisweep(coef, x, b, iters))
        assert torch.equal(got, tsh.jacobi_multisweep_sharded_plain(
            mesh, coef, x, b, iters))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sharded_jacobi_exchange_route_on_odd_widths(cuda, dtype):
    """Blocks of 1030 columns (no whole number of 16-byte runs in either
    dtype) take the exchange route: one launch of the jacobi_multisweep
    kernel per haloed block, bit for bit against the single kernel and
    the sharded plain version."""
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh((2, 2), [cuda] * 4)
    coef, x, b, _ = _pressure_operands(512, 2060, dtype, 6, cuda)
    for iters in (1, 2, ts._halo_for(dtype)):
        assert set(tsh.sharded_routes(mesh, (512, 2060), dtype, "jacobi",
                                      iters).values()) == {"exchange"}
        before = tsh.jacobi_multisweep_sharded.launches
        exchange = tsh.jacobi_multisweep_sharded.by_route["exchange"]
        got = tsh.jacobi_multisweep_sharded(mesh, coef, x, b, iters)
        torch.cuda.synchronize()
        assert tsh.jacobi_multisweep_sharded.launches == before + 4
        assert tsh.jacobi_multisweep_sharded.by_route["exchange"] \
            == exchange + 4
        assert torch.equal(got, ts.jacobi_multisweep(coef, x, b, iters))
        assert torch.equal(got, tsh.jacobi_multisweep_sharded_plain(
            mesh, coef, x, b, iters))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2), (1, 4)])
def test_sharded_jacobi_window_fills_zero_diag(cuda, mesh_shape, dtype):
    """Solid cells with no conductance, a zero diag, x = b = 0 (a disc):
    the window launch fills the diag's zeros with 1 as it loads, as the
    sharded plain version fills the haloed diag; bit for bit at iters 1,
    2 and the halo, at 512 x 2048 and at 128 x 512 (the cell variant)."""
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh(mesh_shape, [cuda] * (mesh_shape[0] * mesh_shape[1]))
    for shape in ((512, 2048), (128, 512)):
        coef, x, b, _ = _disc_operands(shape, dtype, 8, cuda)
        yy = torch.arange(shape[0], device=cuda)[:, None] - shape[0] / 2
        xx = torch.arange(shape[1], device=cuda)[None] - shape[1] / 4
        solid = yy * yy + xx * xx < (shape[0] / 8) ** 2
        coef = PressureCoeffs(coef.c_e, coef.c_w, coef.c_n, coef.c_s,
                              coef.c_out, coef.diag.masked_fill(solid, 0))
        for iters in (1, 2, ts._halo_for(dtype)):
            before = tsh.jacobi_multisweep_sharded.launches
            got = tsh.jacobi_multisweep_sharded(mesh, coef, x, b, iters)
            torch.cuda.synchronize()
            assert tsh.jacobi_multisweep_sharded.launches == before + 1
            ref = tsh.jacobi_multisweep_sharded_plain(mesh, coef, x, b,
                                                      iters)
            assert bool(torch.isfinite(ref).all())
            assert torch.equal(got, ref), (shape, iters)


def test_sharded_kernels_across_two_cards(cuda):
    """A (1, 2) mesh over cuda:0 and cuda:1, operands on cuda:0: block
    (0, 0) takes the window route on cuda:0, block (0, 1) the exchange
    route on cuda:1 (its halo crosses by a peer copy); each launcher runs
    on its operands' card, and the result equals the single kernel on
    cuda:0 bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from tpufoam_torch.ops import sharded as tsh

    mesh = _card_mesh((1, 2), ["cuda:0", "cuda:1"])
    ops = _operands(256, 1024, seed=9, device=torch.device("cuda:0"))
    assert tsh.sharded_routes(mesh, (256, 1024)) == {
        torch.device("cuda:0"): "window", torch.device("cuda:1"): "exchange"}
    before = tsh.momentum_multisweep_sharded.launches
    routes = dict(tsh.momentum_multisweep_sharded.by_route)
    got = tsh.momentum_multisweep_sharded(mesh, *ops, sweeps=8)
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert tsh.momentum_multisweep_sharded.launches == before + 2
    for route in ("window", "exchange"):
        assert tsh.momentum_multisweep_sharded.by_route[route] \
            == routes.get(route, 0) + 1
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


# ---- the multisweep run kernel: jacobi_multisweep and corr_smooth ---------


def _levels(ny, nx, min_size=8):
    """The shapes of `solvers.multigrid.build_hierarchy`."""
    shapes = [(ny, nx)]
    while min(shapes[-1]) >= 2 * min_size:
        y, x = shapes[-1]
        shapes.append(((y + 1) // 2, (x + 1) // 2))
    return shapes


HIERARCHY_LEVELS = _levels(512, 2048) + _levels(256, 1375)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["jacobi_multisweep", "corr_smooth",
                                    "smooth_residual"])
def test_multisweep_kernels_bit_for_bit_at_every_level(cuda, kernel, dtype):
    """Every level of the 512 x 2048 and 256 x 1375 hierarchies, iters 1,
    2 and the most the kernel takes, from aligned operands and from
    operands one element off 16 bytes: each launch takes the variant
    `multisweep_geometry` names (the run kernel on the aligned levels of
    whole 16-byte runs; odd widths and operands off 16 bytes the region
    kernel, or the cell kernel for one sweep of jacobi_multisweep), is
    counted under it, and equals the plain version bit for bit (x, and r
    for smooth_residual)."""
    prec = "f32" if dtype == torch.float32 else "bf16"
    counter = getattr(ts, kernel)
    top = ts._max_iters(dtype, kernel)
    for shape in HIERARCHY_LEVELS:
        coef, x, b, corr = _pressure_operands(*shape, dtype, sum(shape), cuda)
        for offset in (0, 1):
            c = PressureCoeffs(*(_offset_view(t, offset) for t in (
                coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.c_out,
                coef.diag)))
            xx, bb, cc = (_offset_view(t, offset) for t in (x, b, corr))
            for iters in (1, 2, top):
                variant = ts.multisweep_geometry(
                    shape, dtype, iters, aligned=offset == 0,
                    kernel=kernel).variant
                assert variant in ("region", "cell") or not offset
                if not offset and shape[1] % (16 // dtype.itemsize) == 0 \
                        and (kernel, iters) != ("jacobi_multisweep", 1):
                    assert variant == "run", (shape, iters)
                before = counter.by_shape[variant, prec, shape]
                got, ref = _stencil_pair(kernel, c, xx, bb, cc, iters)
                torch.cuda.synchronize()
                assert counter.by_shape[variant, prec, shape] == before + 1
                assert len(got) == len(ref)
                for g, r in zip(got, ref):
                    assert torch.equal(g, r), (shape, offset, iters, variant)


def _disc_operands(shape, dtype, seed, device):
    """_pressure_operands with a solid disc, as the channel's cylinder (a
    quarter of the height across, a quarter of the length in): no
    conductance, diag 1, x = b = correction = 0 there, so the sweeps
    divide zeros by diag."""
    coef, x, b, corr = _pressure_operands(*shape, torch.float32, seed,
                                          device)
    ny, nx = shape
    yy = torch.arange(ny, device=device)[:, None] - ny / 2
    xx = torch.arange(nx, device=device)[None] - nx / 4
    fluid = (yy * yy + xx * xx >= (ny / 8) ** 2).float()
    c = [t * fluid for t in (coef.c_e, coef.c_w, coef.c_n, coef.c_s)]
    diag = coef.diag * fluid + (1 - fluid)
    return (PressureCoeffs(*(t.to(dtype) for t in c),
                           torch.zeros_like(diag, dtype=dtype),
                           diag.to(dtype)),
            *((t * fluid).to(dtype) for t in (x, b, corr)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_multisweep_kernels_with_a_solid_disc(cuda, dtype):
    """The three multisweep kernels on random operands with a solid disc
    (zero dividends in the disc on every sweep, which div_rn answers
    without dividing) at every kernel level of the 512 x 2048 hierarchy,
    iters 1, 2 and the most each takes: in the launch the geometry picks,
    in the run kernel forced to three rows a thread and to one (where the
    halo leaves a 16-row block a tile), and in the region kernel forced;
    each bit for bit against the plain versions."""
    prec = "f32" if dtype == torch.float32 else "bf16"
    forced = {"picked": {}, "three rows": {"_ONE_ROW_MAX_HALO": -1},
              "one row": {"_ONE_ROW_MAX_HALO": 7, "_ONE_ROW_BELOW_CELLS": 0},
              "region": {"_REGION_BELOW_CELLS": 1 << 62}}
    for shape in _levels(512, 2048)[:6]:
        ops = _disc_operands(shape, dtype, sum(shape) + 7, cuda)
        for kernel in ("jacobi_multisweep", "smooth_residual",
                       "corr_smooth"):
            counter = getattr(ts, kernel)
            for iters in (1, 2, ts._max_iters(dtype, kernel)):
                for label, attrs in forced.items():
                    saved = {k: getattr(ts, k) for k in attrs}
                    try:
                        for k, v in attrs.items():
                            setattr(ts, k, v)
                        geom = ts.multisweep_geometry(shape, dtype, iters,
                                                      kernel=kernel)
                        before = counter.by_shape[geom.variant, prec, shape]
                        got, ref = _stencil_pair(kernel, *ops, iters)
                        torch.cuda.synchronize()
                    finally:
                        for k, v in saved.items():
                            setattr(ts, k, v)
                    assert counter.by_shape[geom.variant, prec, shape] \
                        == before + 1
                    for g, r in zip(got, ref):
                        assert torch.equal(g, r), (kernel, shape, iters,
                                                   label, geom)


def test_jacobi_multisweep_one_sweep_equals_jacobi_sweep(cuda):
    """One sweep of the multisweep kernel and of the single-pass kernel
    compute the same arithmetic: bit for bit at every level of both
    hierarchies, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        for shape in HIERARCHY_LEVELS:
            coef, x, b = _edge_operands(shape, dtype, sum(shape) + 2, cuda)
            assert torch.equal(ts.jacobi_multisweep(coef, x, b, 1),
                               ts.jacobi_sweep(coef, x, b, 1)), shape


# ---- graded grids: the kernels on a stretched operator ---------------------


def _first_corrector_system(case, cfg, backend):
    """The first corrector's pressure operator and right-hand side of one
    step of `case` from its initial flow."""
    from tpufoam_torch.fv.case import initial_flow
    from tpufoam_torch.piso.engine import piso_step

    first = []

    def capture(case_, coef, rhs, p_prev, aux):
        if not first:
            first.append((coef, rhs))
        return backend(case_, coef, rhs, p_prev, aux)

    with torch.no_grad():
        piso_step(case, initial_flow(case, 5e-4), cfg, capture)
    return first[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernels_on_the_graded_hierarchy(cuda, dtype):
    """Rows 2-5 (stencil_matvec, jacobi_multisweep, smooth_residual,
    corr_smooth) at every level of the multigrid hierarchy of the 44 x 76
    graded Schaefer-Turek case's first-corrector operator (neighbouring
    conductances up to ~8:1 apart, odd widths), iters 1, 2 and the most
    each takes: each launch in the variant the geometry names, bit for
    bit against its plain version."""
    from tpufoam_torch.eval.benchmark import schafer_turek_case
    from tpufoam_torch.piso.engine import PisoConfig
    from tpufoam_torch.solvers import multigrid as mg
    from tpufoam_torch.solvers.backends import MGCGBackend

    case, _ = schafer_turek_case("2D-1", delta=None,
                                 grading=dict(h_fine=0.008), device=cuda)
    assert case.grid.shape == (44, 76)
    pcoef, rhs = _first_corrector_system(
        case, PisoConfig(max_co=0.4, max_dt=2e-3, ddt="backward",
                         momentum_smoother="kernel"),
        MGCGBackend(rtol=1e-6, smoother="kernel"))
    prec = "f32" if dtype == torch.float32 else "bf16"
    levels, b = mg.build_hierarchy(pcoef), rhs
    assert [tuple(c.diag.shape) for c in levels] == [(44, 76), (22, 38),
                                                     (11, 19)]
    for coef in levels:
        shape = tuple(b.shape)
        c = PressureCoeffs(*(t.to(dtype).contiguous() for t in (
            coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.c_out, coef.diag)))
        x = (b / coef.diag).to(dtype)
        bb = b.to(dtype)
        corr = (0.1 * torch.roll(b / coef.diag, 1, 1)).to(dtype)
        variant = ts.pass_geometry(shape, dtype).variant
        before = ts.stencil_matvec.by_shape[variant, prec, shape]
        got = ts.stencil_matvec(c, x)
        torch.cuda.synchronize()
        assert ts.stencil_matvec.by_shape[variant, prec, shape] == before + 1
        assert torch.equal(got, ts.stencil_matvec_plain(c, x)), shape
        for kernel in ("jacobi_multisweep", "smooth_residual", "corr_smooth"):
            counter = getattr(ts, kernel)
            for iters in sorted({1, 2, ts._max_iters(dtype, kernel)}):
                variant = ts.multisweep_geometry(shape, dtype, iters,
                                                 kernel=kernel).variant
                before = counter.by_shape[variant, prec, shape]
                got, ref = _stencil_pair(kernel, c, x, bb, corr, iters)
                torch.cuda.synchronize()
                assert counter.by_shape[variant, prec, shape] == before + 1
                for g, r in zip(got, ref):
                    assert torch.equal(g, r), (kernel, shape, iters, variant)
        b = mg.restrict(b)


class _PlainMatvec(torch.autograd.Function):
    """The matvec with its plain forward and backward: the reference the
    kernels' gradients are held to, bit for bit."""

    @staticmethod
    def forward(ctx, x, *coef):
        ctx.save_for_backward(x, *coef)
        return ts.stencil_matvec_plain(ts._Operator(*coef), x)

    @staticmethod
    def backward(ctx, g):
        x, *coef = ctx.saved_tensors
        return ts.stencil_matvec_grad_plain(
            ts._Operator(*coef), x, g.contiguous(), ctx.needs_input_grad)


@contextlib.contextmanager
def _plain_matvec():
    """ts.stencil_matvec replaced by _PlainMatvec inside the block."""
    kernel = ts.stencil_matvec
    ts.stencil_matvec = lambda coef, x: _PlainMatvec.apply(
        x, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag)
    try:
        yield
    finally:
        ts.stencil_matvec = kernel


def test_run_piso_refuses_autograd_through_the_kernels(cuda):
    """run_piso keeps autograd on. On the card the momentum kernel and the
    multisweep kernels (JAX's Pallas kernels have no reverse mode either)
    refuse an operand that requires a gradient, naming the kernel, and
    nothing switches to a plain version. With the plain smoothers (JAX's
    "xla") the rollout differentiates on the card: every taped matvec is
    a launch of the stencil_matvec kernel and its backward one launch of
    stencil_matvec_grad, and the gradient equals the same run with a
    Function of the plain forward and backward put in the matvec's place,
    bit for bit. Without a gradient, run_piso runs on the card and equals
    run_piso_eager."""
    import dataclasses

    from tpufoam_torch.core.geometry import ChannelCase
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.piso.engine import PisoConfig, run_piso, run_piso_eager
    from tpufoam_torch.solvers.backends import MGBackend

    case = build_channel_case(ChannelCase(length=2.0, height=1.0,
                                          shape=None, nu=0.05),
                              delta=1.0 / 16, device=cuda)
    flow0 = initial_flow(case, dt0=5e-3)
    cfg = PisoConfig(momentum_smoother="kernel")
    grad_case = dataclasses.replace(
        case, inlet_u=case.inlet_u.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="momentum kernel has no backward"):
        run_piso(grad_case, flow0, 1, cfg=cfg, backend=MGBackend(cycles=2))
    for smoother, kernel in (("kernel", "jacobi_multisweep"),
                             ("kernel-fused", "smooth_residual")):
        with pytest.raises(ValueError, match=f"{kernel} kernel has no "
                           "backward"):
            run_piso(grad_case, flow0, 1, cfg=PisoConfig(),
                     backend=MGBackend(cycles=2, smoother=smoother))

    def grad(backend):
        x = case.inlet_u.clone().requires_grad_(True)
        f = run_piso(dataclasses.replace(case, inlet_u=x), flow0, 3,
                     cfg=PisoConfig(), backend=backend)
        g, = torch.autograd.grad((f.u[:, case.grid.nx // 2:] ** 2).sum(), x)
        return g

    for backend in (MGBackend(cycles=2), MGBackend(cycles=2,
                                                   precision="bf16")):
        ts.stencil_matvec.launches = ts.stencil_matvec_grad.launches = 0
        ts.StencilMatvec.taped = 0
        got = grad(backend)
        torch.cuda.synchronize()
        # a matvec none of whose operands needs a gradient (a zero start)
        # launches its forward alone
        assert 0 < ts.StencilMatvec.taped <= ts.stencil_matvec.launches
        assert ts.stencil_matvec_grad.launches == ts.StencilMatvec.taped
        assert bool(torch.isfinite(got).all())
        assert float(got[case.grid.ny // 2]) > 0.0
        with _plain_matvec():
            ref = grad(backend)
        assert torch.equal(got, ref), backend
    got = run_piso(case, flow0, 2, cfg=cfg, backend=MGBackend(cycles=2))
    ref = run_piso_eager(case, flow0, 2, cfg=cfg, backend=MGBackend(cycles=2))
    for name in ("u", "v", "p", "phi_x", "phi_y", "dt", "t"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


# the decomposed gradient against the whole step's, relative L2:
# tests/test_torch_grad_rollout.py's bf16 bound (chip_smoke.py's
# GRAD_SHARDED_TOL; the CPU measured 7.6e-3 at this size on 2 x 2)
SHARDED_GRAD_TOL = 2e-2


def test_decomposed_step_gradient_on_the_card(cuda):
    """chip_smoke.py's grad-sharded gates at 64 x 256: bench.py's
    configuration (plain smoothers, MGBackend(cycles=2, precision="bf16"))
    through the decomposed step on a 2 x 2 mesh of the card, 2 steps, the
    gradient w.r.t. the whole inlet profile: the loss equals run_piso's
    bit for bit; finite, centre row positive; the forward launches the
    matvec kernel alone and the backward stencil_matvec_grad alone, once
    for each taped matvec; bit for bit equal to the same run with a
    Function of the plain forward and backward in the matvec's place;
    within SHARDED_GRAD_TOL of run_piso's gradient; the kernel smoothers
    refuse a gradient, naming the kernel."""
    import dataclasses

    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.parallel.mesh import (device_mesh,
                                             make_sharded_piso_step,
                                             shard_case, shard_flow,
                                             unshard_flow)
    from tpufoam_torch.piso.engine import PisoConfig, run_piso
    from tpufoam_torch.solvers.backends import MGBackend

    ny = 64
    case = build_channel_case(channel_case_geometry(
        "cylinder", length=8.0, height=2.0, obstacle_size=0.5, nu=8e-3),
        delta=2.0 / ny, device=cuda)
    flow0 = initial_flow(case, dt0=5e-4)
    cfg = PisoConfig(n_correctors=2, max_co=0.5, max_dt=2e-3)
    mesh = device_mesh(4, devices=[cuda] * 4)

    def grad(backend, cfg_=cfg, mesh_=mesh):
        x = case.inlet_u.clone().requires_grad_(True)
        c = dataclasses.replace(case, inlet_u=x)
        if mesh_ is None:
            u = run_piso(c, flow0, 2, cfg=cfg_, backend=backend).u
        else:
            step = make_sharded_piso_step(mesh_, cfg_, backend)
            sc, sf = shard_case(mesh_, c), shard_flow(mesh_, flow0)
            for _ in range(2):
                sf = step(sc, sf)
            u = unshard_flow(sf).u
        loss = (u[:, case.grid.nx // 2:] ** 2).sum()
        g, = torch.autograd.grad(loss, x)
        return g, float(loss.detach())

    backend = MGBackend(cycles=2, precision="bf16")
    whole, whole_loss = grad(backend, mesh_=None)
    for fn in (ts.stencil_matvec, ts.stencil_matvec_grad, tmom.
               momentum_multisweep, ts.jacobi_multisweep, ts.smooth_residual,
               ts.corr_smooth):
        fn.launches = 0
    ts.StencilMatvec.taped = 0
    got, loss = grad(backend)
    torch.cuda.synchronize()
    assert loss == whole_loss
    assert bool(torch.isfinite(got).all())
    assert float(got[ny // 2]) > 0.0
    assert 0 < ts.StencilMatvec.taped <= ts.stencil_matvec.launches
    assert ts.stencil_matvec_grad.launches == ts.StencilMatvec.taped
    assert tmom.momentum_multisweep.launches == 0
    assert ts.jacobi_multisweep.launches + ts.smooth_residual.launches \
        + ts.corr_smooth.launches == 0
    rel = float((got.double() - whole.double()).norm()
                / whole.double().norm())
    assert rel <= SHARDED_GRAD_TOL, rel
    with _plain_matvec():
        ref, _ = grad(backend)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="momentum kernel has no backward"):
        grad(backend, cfg_=PisoConfig(momentum_smoother="kernel"))
    for smoother, name in (("kernel", "jacobi_multisweep"),
                           ("kernel-fused", "smooth_residual")):
        with pytest.raises(ValueError, match=f"{name} kernel has no "
                           "backward"):
            grad(MGBackend(cycles=2, precision="bf16", smoother=smoother))


def test_gaussian_filter_on_the_card_equals_the_cpu(cuda):
    """The seam filter's two float32 convolutions on the card, with TF32
    left at PyTorch's default outside the call (cuDNN's is on): the filter
    turns it off inside, so the card's result is the CPU's to float32
    rounding (sums of 81 terms in another order: 1e-5 of the largest
    value, the CPU tests' bound against JAX and scipy), and the flag is
    as it was after the call."""
    from tpufoam_torch.surrogate.blocks import gaussian_filter2d

    assert torch.backends.cudnn.allow_tf32
    f = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (96, 256)).astype(np.float32))
    for sigma in (10.0, 3.0):
        ref = gaussian_filter2d(f, sigma)
        got = gaussian_filter2d(f.to(cuda), sigma).cpu()
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max()), sigma
    assert torch.backends.cudnn.allow_tf32


def test_sst_step_on_the_card_matches_the_cpu(cuda):
    """One k-omega SST step (both wall treatments) on the card against the
    same on the CPU, from one seeded state: elementwise float32 operations
    and four Jacobi sweeps each, 1e-5 of each field's largest value."""
    import dataclasses

    from tpufoam_torch.eval.benchmark import turbulent_channel_case
    from tpufoam_torch.fv.case import fluxes_from_velocity, initial_flow
    from tpufoam_torch.fv.turbulence import init_turbulence, sst_step

    cases = {d: turbulent_channel_case(nu=5e-5, length=8.0, delta=2.0 / 16,
                                       device=d)[0] for d in ("cpu", cuda)}
    rng = np.random.default_rng(2)
    c = cases["cpu"]
    noise = torch.as_tensor(rng.standard_normal((2,) + c.grid.shape).astype(
        np.float32))
    u = (initial_flow(c).u + 0.1 * noise[0]) * c.fluid
    v = 0.1 * noise[1] * c.fluid
    t0 = init_turbulence(c)
    for wall_fn in (False, True):
        out = {}
        for d, case in cases.items():
            ud, vd = u.to(d), v.to(d)
            phi_x, phi_y = fluxes_from_velocity(case, ud, vd)
            turb = dataclasses.replace(t0, **{
                f: getattr(t0, f).to(d) for f in ("k", "omega", "nu_t",
                                                  "k_in", "w_in")})
            out[d] = sst_step(case, turb, ud, vd, phi_x, phi_y,
                              torch.tensor(4e-3, device=d), wall_fn=wall_fn)
        for f in ("k", "omega", "nu_t"):
            ref, got = getattr(out["cpu"], f), getattr(out[cuda], f).cpu()
            assert torch.isfinite(got).all()
            assert float((got - ref).abs().max()) <= 1e-5 * float(
                ref.abs().max()), (wall_fn, f)


def test_bf16_pca_transform_has_a_float32_result(cuda):
    """The bf16 PCA encode on the card: bf16 operands, float32 sums and a
    float32 result that is not rounded to bf16 (the JAX package's
    preferred_element_type=float32), equal to the CPU's float32 product of
    the rounded operands to float32 rounding."""
    from tpufoam_torch.surrogate.pca import PCAModel

    rng = np.random.default_rng(3)
    d, k = 3 * 64 * 64, 24
    comp = torch.as_tensor(np.linalg.qr(rng.standard_normal((d, k)))[0].T
                           .astype(np.float32))
    mean = torch.as_tensor(rng.standard_normal(d).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((40, d)).astype(np.float32))
    ones = torch.ones(k)
    ref = PCAModel(mean, comp, ones, ones).transform(x, dtype=torch.bfloat16)
    pca = PCAModel(mean.to(cuda), comp.to(cuda).bfloat16(), ones.to(cuda),
                   ones.to(cuda))
    got = pca.transform(x.to(cuda), dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert not torch.equal(got, got.bfloat16().float())
    assert float((got.cpu() - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())


# ---- the training path --------------------------------------------------------


def test_streaming_pca_on_the_card_matches_the_cpu(cuda):
    """StreamingPCA of chunks on the card against the same fit on the
    CPU, on data with a clear spectral gap: explained-variance ratios
    within 1e-4, principal angles of the fitted subspace below 1e-3 rad
    (the two devices draw different random starts)."""
    from tpufoam_torch.surrogate.pca import StreamingPCA

    rng = np.random.default_rng(5)
    n, d, k = 2048, 3 * 32 * 32, 16
    x = (rng.standard_normal((n, k)) * np.linspace(10, 1, k)
         @ rng.standard_normal((k, d))
         + 0.01 * rng.standard_normal((n, d)) + rng.standard_normal(d)
         ).astype(np.float32)
    chunks = [x[i:i + 512] for i in range(0, n, 512)]
    cpu = StreamingPCA(k, oversample=32).fit(lambda: iter(chunks),
                                             device="cpu")
    on_card = [torch.as_tensor(c, device=cuda) for c in chunks]
    got = StreamingPCA(k, oversample=32).fit(lambda: iter(on_card))
    assert got.components.device.type == "cuda"
    assert float((got.explained_variance_ratio.cpu()
                  - cpu.explained_variance_ratio).abs().max()) <= 1e-4
    sv = torch.linalg.svdvals(got.components.cpu().double()
                              @ cpu.components.double().T)
    assert float(torch.arccos(torch.clamp(sv.min(), max=1.0))) <= 1e-3


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_train_step_on_the_card_matches_the_cpu(cuda, cdt):
    """One Adam step on a (1, 1) and a (2, 2) mesh of the card (data
    and tensor parallel) against the CPU's (1, 1) step: float32 compute
    within 1e-5 of the loss and of each leaf's largest parameter; bf16 compute within
    1e-3 of the loss and 1e-2 in the parameters' relative L2 norm
    (tests/test_torch_train.py)."""
    from tpufoam_torch.models.mlp import ModelDef, init_model, tree_leaves
    from tpufoam_torch.parallel.mesh import (device_mesh,
                                             make_sharded_train_step,
                                             unshard_params)
    from tpufoam_torch.train.trainer import Adam

    mdef = ModelDef.from_arch("MLP_small", in_dim=13, out_dim=64,
                              compute_dtype=cdt)
    p0 = init_model(0, mdef, device="cpu")
    rng = np.random.default_rng(6)
    xb = torch.as_tensor(rng.standard_normal((256, 13)).astype(np.float32))
    yb = torch.as_tensor(rng.standard_normal((256, 64)).astype(np.float32))

    def run(devices):
        opt = Adam(2e-4)
        step, shard = make_sharded_train_step(
            device_mesh(len(devices), devices=devices), mdef, opt)
        p, s, loss = step(*shard(p0, opt.init(p0), xb, yb))
        return [a.cpu() for a in tree_leaves(unshard_params(p))], \
            float(loss)

    ref, l_ref = run(["cpu"])
    for devices in ([cuda], [cuda] * 4):
        got, loss = run(devices)
        if cdt == "float32":
            assert abs(loss - l_ref) <= 1e-5 * abs(l_ref)
            for g, r in zip(got, ref):
                assert float((g - r).abs().max()) <= 1e-5 * float(
                    r.abs().max())
        else:
            assert abs(loss - l_ref) <= 1e-3 * abs(l_ref)
            num = sum(float(((g - r) ** 2).sum()) for g, r in zip(got, ref))
            den = sum(float((r ** 2).sum()) for r in ref)
            assert (num / den) ** 0.5 <= 1e-2


def test_bundle_save_load_predict_on_the_card(cuda, tmp_path):
    """A bundle trained on the card (a tiny rollout's blocks), saved in
    the JAX package's three files, loaded onto the card and onto the CPU:
    the two predictors agree (PRED_TOL, 2e-2: the bf16 MLP), and the
    card's reloaded predictor equals the trained bundle's."""
    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.piso.engine import PisoConfig, run_piso_eager
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)
    from tpufoam_torch.train.dataset import (build_block_dataset,
                                             frames_from_rollout)
    from tpufoam_torch.train.trainer import TrainConfig, train_surrogate

    geom = channel_case_geometry("cylinder", length=8.0, height=2.0,
                                 obstacle_size=0.5, nu=8e-3)
    cases = {d: build_channel_case(geom, delta=2.0 / 32, device=d)
             for d in ("cpu", cuda)}
    cfg = PisoConfig(max_co=0.5, max_dt=5e-3)
    flow = run_piso_eager(cases[cuda], initial_flow(cases[cuda], 1e-3), 10,
                          cfg=cfg)
    frames = frames_from_rollout(cases[cuda], flow, 8, 2, cfg=cfg)
    ds = build_block_dataset(cases[cuda], frames, n_samples_per_frame=60,
                             block_size=16)
    bundle, state = train_surrogate(ds, "deltaU_deltaP", TrainConfig(
        batch_size=128, max_epochs=10, max_num_pc=32, best_after_epoch=2,
        pca_device_cache=True), device=cuda)
    assert bundle.pca_in.components.device.type == "cuda"
    bundle.trimmed().save(str(tmp_path / "sm"))
    assert sorted(p.name for p in tmp_path.joinpath("sm").iterdir()) == [
        "arrays.npz", "manifest.json", "params_tree.json"]
    changes = {}
    for d, case in cases.items():
        pred = make_predictor(SurrogateBundle.load(str(tmp_path / "sm"),
                                                   device=d), stitch="lstsq")
        aux = {k: v.to(d) for k, v in frames[-1].items()}
        changes[d] = (pred(case, aux["p_prev"], aux) - aux["p_prev"]).cpu()
    trained = make_predictor(bundle.trimmed(), stitch="lstsq")
    aux = frames[-1]
    direct = (trained(cases[cuda], aux["p_prev"], aux) - aux["p_prev"]).cpu()
    assert torch.equal(direct, changes[cuda])
    ref = changes["cpu"]
    assert torch.isfinite(changes[cuda]).all() and ref.abs().max() > 0
    assert float((changes[cuda] - ref).abs().max()) <= 2e-2 * float(
        ref.abs().max())


def test_exact_pca_on_the_card_is_exact(cuda):
    """fit_pca_exact on the card against a float64 fit of the same rows:
    principal angles of the top 8 components below 1e-3 rad (cuSOLVER's
    gesvd; the default Jacobi driver missed by 1.5e-2 on a block matrix
    of the training path)."""
    from tpufoam_torch.surrogate.pca import fit_pca_exact

    rng = np.random.default_rng(7)
    n, d, k = 512, 3 * 64 * 64, 12
    x = (rng.standard_normal((n, k)) * np.geomspace(30, 1, k)
         @ rng.standard_normal((k, d)) + 0.1 * rng.standard_normal((n, d))
         ).astype(np.float32)
    got = fit_pca_exact(torch.as_tensor(x, device=cuda), 8)
    xc = torch.as_tensor(x, dtype=torch.float64)
    xc = xc - xc.mean(0)
    ref = torch.linalg.svd(xc, full_matrices=False)[2][:8]
    sv = torch.linalg.svdvals(got.components.cpu().double() @ ref.T)
    assert float(torch.arccos(torch.clamp(sv.min(), max=1.0))) <= 1e-3


def _fleet_pressure_problem(device):
    """Three channel cases at 64 x 256 on `device`, stacked, and a seeded
    pressure system whose warm starts leave the cases' polishes apart."""
    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case
    from tpufoam_torch.fv.pressure import pressure_coeffs, pressure_matvec
    from tpufoam_torch.piso.batched import stack_cases

    cases = [build_channel_case(channel_case_geometry(
        s, length=8.0, height=2.0, obstacle_size=z, nu=8e-3),
        delta=2.0 / 64, device=device)
        for s, z in (("cylinder", 0.5), ("rectangle", 0.4),
                     ("triangle", 0.45))]
    bc = stack_cases(cases)
    rng = np.random.default_rng(11)

    def field():
        return torch.as_tensor(rng.standard_normal(tuple(bc.fluid.shape))
                               .astype(np.float32), device=device) * bc.fluid

    rau = bc.alpha * bc.fluid * (1.0 + 0.5 * field().abs()) * 1e-3
    x_true = field()
    b = pressure_matvec(pressure_coeffs(bc, rau), x_true) * bc.fluid
    x0 = x_true + torch.tensor([1.0, 3e-2, 1e-3], device=device)[
        :, None, None] * field()
    return bc, cases, rau, b, x0


@pytest.mark.parametrize("kind", ["auto", "hybrid", "surrogate"])
def test_batched_backends_on_the_card_match_single_cases(cuda, kind):
    """AutoBackend (its tau between the cases' polish residuals, so that
    one case escalates), HybridBackend and SurrogateBackend on the card's
    stacked fleet against each case alone on the card: bit for bit (each
    case's norms and inner products reduced as alone), the same
    escalation verdicts; a case that needs no escalation keeps its polish
    exactly."""
    from tpufoam_torch.fv.pressure import pressure_coeffs, pressure_matvec
    from tpufoam_torch.solvers import backends as tb
    from tpufoam_torch.solvers.multigrid import mg_solve

    bc, cases, rau, b, x0 = _fleet_pressure_problem(cuda)
    bco = pressure_coeffs(bc, rau)
    y = torch.linspace(0.0, 1.0, b.shape[-2], device=cuda)[:, None]

    def predict(case, p_prev, aux):
        return 0.5 * p_prev + y

    log = []

    class Verdicts(tb.AutoBackend):
        def needs_escalation(self, case, coef, rhs, p1):
            need = super().needs_escalation(case, coef, rhs, p1)
            log.append(need.cpu())
            return need

    if kind == "auto":
        p1 = mg_solve(bco, b, x0, cycles=2) * bc.fluid
        r = torch.linalg.vector_norm((b - pressure_matvec(bco, p1))
                                     * bc.fluid, dim=(-2, -1))
        ratio = sorted((r / torch.linalg.vector_norm(
            b * bc.fluid, dim=(-2, -1))).tolist())
        backend = Verdicts(tau=float(np.sqrt(ratio[-1] * ratio[-2])),
                           precision="f32")
    else:
        backend = (tb.HybridBackend if kind == "hybrid"
                   else tb.SurrogateBackend)(predict=predict)
    got = backend(bc, bco, b, x0, {})
    for k, c in enumerate(cases):
        one = backend(c, pressure_coeffs(c, rau[k]), b[k], x0[k], {})
        assert torch.equal(got[k], one), k
    assert torch.isfinite(got).all()
    if kind == "auto":
        need = log[0]
        assert need.tolist().count(True) == 1
        assert [bool(v) for v in log[1:]] == need.tolist()
        for k in range(len(cases)):
            if not need[k]:
                assert torch.equal(got[k], p1[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 512, 2048), (3, 37, 70),
                                   (2, 272, 1040), (4, 8, 32)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", ["jacobi_multisweep", "smooth_residual",
                                    "corr_smooth"])
def test_multisweep_kernels_take_a_stack(cuda, kernel, shape, dtype):
    """Rows 3-5 on a (B, ny, nx) stack, each case its own operands: one
    launch (counted under the variant of a case's plane), equal to the
    plain version and to B single-case launches bit for bit, at iters 1,
    2 and the most the kernel takes (the run kernel at 512 x 2048 and 272
    x 1040, the region kernel at 37 x 70, one sweep the single-pass
    kernels)."""
    b_, ny, nx = shape
    cases = [_pressure_operands(ny, nx, dtype, seed=k, device=cuda)
             for k in range(b_)]
    coef = PressureCoeffs(*(torch.stack([getattr(c[0], f) for c in cases])
                            for f in ("c_e", "c_w", "c_n", "c_s", "c_out",
                                      "diag")))
    x, b, corr = (torch.stack([c[i] for c in cases]) for i in (1, 2, 3))
    counter = getattr(ts, kernel)
    top = ts._halo_for(dtype) - (kernel == "smooth_residual")
    for iters in (1, 2, top):
        key = (ts.multisweep_geometry((ny, nx), dtype, iters,
                                      kernel=kernel).variant,
               ts._DTYPES[dtype], (ny, nx))
        n0, by0 = counter.launches, counter.by_shape[key]
        got, ref = _stencil_pair(kernel, coef, x, b, corr, iters)
        torch.cuda.synchronize()
        assert counter.launches == n0 + 1 and counter.by_shape[key] == by0 + 1
        for g, r in zip(got, ref):
            assert g.shape == (b_, ny, nx) and torch.equal(g, r), iters
        for k, c in enumerate(cases):
            one, _ = _stencil_pair(kernel, *c, iters)
            for g, o in zip(got, one):
                assert torch.equal(g[k], o), (iters, k)


@pytest.mark.parametrize("smoother", ["kernel", "kernel-fused"])
def test_kernel_smoother_fleet_on_the_card_matches_single_cases(cuda,
                                                                smoother):
    """MGBackend with a kernel smoother on the card's stacked fleet (one
    launch a level for the three cases) against each case alone on the
    card: bit for bit, in float32 and in the bf16 correction form; the
    fleet launches each multisweep kernel as often as one case does."""
    from tpufoam_torch.fv.pressure import pressure_coeffs
    from tpufoam_torch.solvers import backends as tb

    bc, cases, rau, b, x0 = _fleet_pressure_problem(cuda)
    bco = pressure_coeffs(bc, rau)
    kernels = ("smooth_residual", "corr_smooth") \
        if smoother == "kernel-fused" else ("jacobi_multisweep",)
    for precision in ("f32", "bf16"):
        backend = tb.MGBackend(cycles=2, precision=precision,
                               smoother=smoother)
        n0 = {k: getattr(ts, k).launches for k in kernels}
        got = backend(bc, bco, b, x0, {})
        torch.cuda.synchronize()
        fleet = {k: getattr(ts, k).launches - n0[k] for k in kernels}
        assert all(v > 0 for v in fleet.values()), fleet
        for k, c in enumerate(cases):
            n0 = {k_: getattr(ts, k_).launches for k_ in kernels}
            one = backend(c, pressure_coeffs(c, rau[k]), b[k], x0[k], {})
            assert torch.equal(got[k], one), (precision, k)
            assert {k_: getattr(ts, k_).launches - n0[k_]
                    for k_ in kernels} == fleet


def test_resample_and_unstructured_case_on_the_card_equal_the_cpu(cuda):
    """build_resample's operator on the card, applied there, equals the
    CPU's bit for bit; UnstructuredCase.from_frame on the card (the SDF
    on the card) equals the CPU's: masks, SDF and a resampled field."""
    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.core.interp import build_resample
    from tpufoam_torch.eval.evaluation import UnstructuredCase
    from tpufoam_torch.fv.case import build_channel_case
    from tpufoam_torch.utils.hdf5_io import (CH_DELTAS, SimFrame,
                                             rollout_to_records)

    rng = np.random.default_rng(5)
    src = rng.uniform(0, 1, (4000, 2))
    dst = rng.uniform(-0.05, 1.05, (6000, 2))
    vals = rng.standard_normal(4000).astype(np.float32)
    ops = {d: build_resample(src, dst, device=d) for d in ("cpu", cuda)}
    assert ops[cuda].vertices.device.type == "cuda"
    assert torch.equal(ops[cuda](vals).cpu(), ops["cpu"](vals))

    geom = channel_case_geometry("cylinder", length=8.0, height=2.0,
                                 obstacle_size=0.5, nu=8e-3)
    case = build_channel_case(geom, delta=2.0 / 64, device="cpu")
    fluid = case.fluid.numpy()
    frame = {k: rng.standard_normal(fluid.shape).astype(np.float32) * fluid
             for k in ("u", "v", "p", "u_prev", "v_prev", "p_prev")}
    fr = SimFrame(data=rollout_to_records(case, [frame])[0],
                  top=geom.boundary_points_top(2000),
                  obst=geom.shape.boundary_points(720), channels=CH_DELTAS)
    uc = {d: UnstructuredCase.from_frame(fr, 2.0 / 64, device=d)
          for d in ("cpu", cuda)}
    for name in ("fluid", "sdf", "open_e", "wall_n", "inlet_u"):
        assert torch.equal(getattr(uc[cuda].case, name).cpu(),
                           getattr(uc["cpu"].case, name)), name
    assert torch.equal(uc[cuda].grid_field(fr.data[:, 0]).cpu(),
                       uc["cpu"].grid_field(fr.data[:, 0]))


def test_pointnet_forward_on_the_card_equals_the_cpu(cuda):
    """The point-cloud model at n_pts 4096 (pointcloud_main's default),
    batch 2, seeded weights, TF32 off: its output and penalty on the card
    against the CPU's to rel 1e-4 (cuDNN's convolutions sum in other
    orders)."""
    from tpufoam_torch.models.pointnet import PAD, PointNetUNet

    rng = np.random.default_rng(0)
    f = rng.uniform(0, 1, (2, 4096, 3)).astype(np.float32)
    c = rng.uniform(0, 4, (2, 4096, 2)).astype(np.float32)
    f[1, 3000:], c[1, 3000:] = PAD, PAD
    model = PointNetUNet(generator=torch.Generator().manual_seed(0))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref, ref_o = model(torch.tensor(f), torch.tensor(c))
            got, got_o = model.to(cuda)(torch.tensor(f, device=cuda),
                                        torch.tensor(c, device=cuda))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float((got.cpu() - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err
    assert abs(float(got_o) - float(ref_o)) <= 1e-4 * max(float(ref_o), 1e-6)


def test_pinn_loss_on_the_card_equals_the_cpu(cuda):
    """The 7 x 50 tanh PINN's loss (third derivatives for the psi form)
    and its gradient at one set of parameters, card against CPU, rel
    1e-4."""
    from tpufoam_torch.models import pinn
    from tpufoam_torch.train.trainer import value_and_grad

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _pinn_card_vs_cpu(cuda, pinn, value_and_grad)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _pinn_card_vs_cpu(cuda, pinn, value_and_grad):
    from tpufoam_torch.models.mlp import tree_map

    for form in (1, 3):
        cfg = pinn.PinnConfig(formulation=form)
        batch = pinn.make_training_points(cfg, n_colloc=2000, device="cpu")
        params = pinn.init_pinn(form, cfg, device="cpu")

        def on(tree):
            return tree_map(lambda t: t.to(cuda), tree)

        ref, rg = value_and_grad(lambda p: pinn.pinn_loss(p, cfg, batch),
                                 params)
        got, gg = value_and_grad(lambda p: pinn.pinn_loss(p, cfg, on(batch)),
                                 on(params))
        assert abs(float(got) - float(ref)) <= 1e-4 * abs(float(ref))
        for a, b in zip(gg["layers"], rg["layers"]):
            err = float((a["w"].cpu() - b["w"]).abs().max())
            assert err <= 1e-4 * float(b["w"].abs().max()) + 1e-7


def test_piso_main_on_the_card_launches_the_momentum_kernel(cuda, tmp_path,
                                                            capsys):
    """tpufoam-piso --platform cuda at 32 x 128 with the momentum kernel
    (JAX's flag value "pallas"): one launch a step, finite fields."""
    from tpufoam_torch.cli import piso_main

    out = str(tmp_path / "out.npz")
    before = tmom.momentum_multisweep.launches
    piso_main(["--platform", "cuda", "--delta", "0.0625", "--steps", "2",
               "--momentum-smoother", "pallas", "--out", out])
    assert tmom.momentum_multisweep.launches - before == 2
    d = np.load(out)
    assert all(np.isfinite(d[k]).all() for k in ("u", "v", "p"))
    assert "step 2/2" in capsys.readouterr().out


# ---- the domain-decomposed step ---------------------------------------------


def _small_channel(device):
    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case
    return build_channel_case(channel_case_geometry(
        "cylinder", length=4.0, height=1.0, obstacle_size=0.3),
        delta=1.0 / 128, device=device)


@pytest.mark.parametrize("smoother", ["plain", "kernel", "kernel-fused"])
def test_decomposed_step_on_the_card(cuda, smoother):
    """Two decomposed steps on a 2 x 2 mesh of the card (128 x 512, MG
    bf16, the momentum kernel) equal two piso_step steps bit for bit, the
    momentum kernel launched once per block a step and every matvec on a
    block's window."""
    from tpufoam_torch.fv.case import initial_flow
    from tpufoam_torch.parallel.mesh import (make_sharded_piso_step,
                                             shard_case, shard_flow,
                                             unshard_flow)
    from tpufoam_torch.piso.engine import PisoConfig, piso_step
    from tpufoam_torch.solvers.backends import MGBackend

    case = _small_channel(cuda)
    cfg = PisoConfig(momentum_smoother="kernel")
    be = MGBackend(cycles=2, precision="bf16", smoother=smoother)
    mesh = _card_mesh((2, 2), [cuda] * 4)
    step = make_sharded_piso_step(mesh, cfg, be)
    ref = flow = initial_flow(case, 2e-3)
    sc, sf = shard_case(mesh, case), shard_flow(mesh, flow)
    with torch.no_grad():
        for _ in range(2):
            ref = piso_step(case, ref, cfg, be)
        before = tmom.momentum_multisweep.launches
        ts.stencil_matvec.by_shape.clear()
        for _ in range(2):
            sf = step(sc, sf)
        torch.cuda.synchronize()
    assert tmom.momentum_multisweep.launches - before == 8
    assert all(shape[0] < 128 and shape[1] < 512
               for _, _, shape in ts.stencil_matvec.by_shape)
    got = unshard_flow(sf)
    for name in ("u", "v", "p", "phi_x", "phi_y", "dt", "t"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


_WORLD = """
import sys
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
from tpufoam_torch.parallel import distributed as d
from tpufoam_torch.parallel import mesh as tmesh
from tpufoam_torch.core.geometry import channel_case_geometry
from tpufoam_torch.fv.case import build_channel_case, initial_flow
from tpufoam_torch.piso.engine import PisoConfig
from tpufoam_torch.solvers.backends import MGBackend
rank = int(__import__("os").environ["RANK"])
torch.cuda.set_device(rank)
assert d.init_distributed(device="cuda") and dist.get_backend() == "nccl"
mesh = d.global_device_mesh(shape=(2, 1), devices=[f"cuda:{{rank}}"])
case = build_channel_case(channel_case_geometry(
    "cylinder", length=4.0, height=1.0, obstacle_size=0.3),
    delta=1.0 / 128, device=f"cuda:{{rank}}")
cfg = PisoConfig(momentum_smoother="kernel")
be = MGBackend(cycles=2, precision="bf16", smoother="kernel")
outs = []
for m in (mesh, tmesh.device_mesh(2, shape=(2, 1),
                                  devices=[f"cuda:{{rank}}"] * 2)):
    sc = tmesh.shard_case(m, case)
    sf = tmesh.shard_flow(m, initial_flow(case, 2e-3))
    step = tmesh.make_sharded_piso_step(m, cfg, be)
    with torch.no_grad():
        for _ in range(2):
            sf = step(sc, sf)
    outs.append(tmesh.unshard_flow(sf))
for name in ("u", "v", "p", "phi_x", "phi_y", "dt", "t"):
    assert torch.equal(getattr(outs[0], name), getattr(outs[1], name)), name
print("rank", rank, "equal")
dist.barrier()
dist.destroy_process_group()
"""


def test_decomposed_world_across_two_cards(cuda):
    """Two processes, one card each (NCCL refuses two ranks on one card),
    each owning one block of a 2 x 1 mesh: two decomposed steps equal the
    same steps on a 2 x 1 mesh of one card bit for bit (the strips cross
    by NCCL point-to-point copies)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORLD.format(root=root)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "MASTER_ADDR": "localhost",
             "MASTER_PORT": str(port), "WORLD_SIZE": "2",
             "RANK": str(rank)}) for rank in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out + err
        assert f"rank {rank} equal" in out, out + err


def test_every_sync_of_a_hybrid_lockstep_is_a_counted_host_read(cuda):
    """torch.cuda.set_sync_debug_mode("warn") over two locksteps of a
    two-case hybrid fleet at 128 x 512 (the sm_ref512 warm start with the
    lstsq stitch, the momentum kernel, the bf16 polish), after two
    warm-up locksteps: every synchronising call it reports is one that
    utils.profiling.host_read.count counts (a host read or upload)."""
    import os
    import warnings

    from tpufoam_torch.core.geometry import channel_case_geometry
    from tpufoam_torch.fv.case import build_channel_case, initial_flow
    from tpufoam_torch.piso.batched import (run_piso_batched_eager,
                                            stack_cases, stack_flows)
    from tpufoam_torch.piso.engine import PisoConfig
    from tpufoam_torch.solvers.backends import MGBackend
    from tpufoam_torch.surrogate.pipeline import (SurrogateBundle,
                                                  make_predictor)
    from tpufoam_torch.utils.profiling import host_read

    ny, nx = 128, 512
    cases = [build_channel_case(channel_case_geometry(
        shape, length=nx * 2.0 / ny, height=2.0, obstacle_size=size,
        nu=8e-3), delta=2.0 / ny, device=cuda)
        for shape, size in (("cylinder", 0.5), ("triangle", 0.45))]
    case = stack_cases(cases)
    pred = make_predictor(SurrogateBundle.load(os.path.join(
        os.path.dirname(__file__), "..", "artifacts", "sm_ref512"),
        device=cuda), stitch="lstsq").bind(case)
    kw = dict(cfg=PisoConfig(max_co=0.5, max_dt=2e-3,
                             momentum_smoother="kernel"),
              backend=MGBackend(cycles=2, precision="bf16"),
              sm_predict=pred)
    flow = run_piso_batched_eager(
        case, stack_flows([initial_flow(c, 5e-4) for c in cases]), 2, **kw)
    torch.cuda.synchronize()
    n0 = host_read.count
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            run_piso_batched_eager(case, flow, 2, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in rec if "synchroniz" in str(w.message).lower()]
    sites = sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                    for w in syncs})
    assert len(syncs) == host_read.count - n0 > 0, sites
