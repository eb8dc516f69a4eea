"""The momentum multisweep of tpufoam_torch.ops.momentum on the CPU: its
plain version against the JAX package's Pallas kernel run in interpret
mode (one case, and a fleet through the kernel's batched rule), and the
wrapper's dispatch rules.

The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py and
chip_smoke.py). Tolerance: 1e-5 relative to max |u|, |v| — eight float32
sweeps of the same update in both, summed in a different order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.core.geometry import channel_case_geometry as jax_geom
from tpufoam.fv.case import build_channel_case as jax_build
from tpufoam.fv.case import initial_flow as jax_initial_flow
from tpufoam.fv.momentum import jacobi_momentum as jax_jacobi_momentum
from tpufoam.fv.momentum import momentum_coeffs as jax_momentum_coeffs
from tpufoam.ops.stencil import momentum_multisweep_pallas
from tpufoam_torch.ops import momentum as tmom

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def operands():
    """The first momentum solve of a 64 x 256 cylinder channel (the
    operands of tests/test_pallas_ops.py), with a seeded pressure source."""
    geom = jax_geom("cylinder", length=4.0, height=1.0, obstacle_size=0.3)
    case = jax_build(geom, delta=1.0 / 64)
    flow = jax_initial_flow(case, dt0=2e-3)
    coef = jax_momentum_coeffs(case, flow.phi_x, flow.phi_y, flow.u, flow.v,
                               flow.dt, convection="limitedLinear")
    rng = np.random.default_rng(3)
    src_u, src_v = (jnp.asarray(rng.standard_normal(case.grid.shape) * 1e-3,
                                dtype=jnp.float32) for _ in range(2))
    api = case.fluid / coef.a_p
    ops = (coef.a_e, coef.a_w, coef.a_n, coef.a_s, api, coef.b_u + src_u,
           coef.b_v + src_v, flow.u, flow.v)
    return case, coef, flow, src_u, src_v, ops


def _close(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= RTOL * float(np.abs(r).max()), err


@pytest.mark.parametrize("sweeps", [1, 4, 8])
def test_plain_matches_pallas_interpret(operands, sweeps):
    *_, ops = operands
    ref = momentum_multisweep_pallas(*ops, sweeps=sweeps, interpret=True)
    got = tmom.momentum_multisweep_plain(*(T(a) for a in ops),
                                         sweeps=sweeps)
    _close(got, ref)


@pytest.mark.parametrize("sweeps", [0, 3, 8])
def test_plain_matches_jax_sweep_loop(operands, sweeps):
    case, coef, flow, src_u, src_v, ops = operands
    ref = jax_jacobi_momentum(coef, case, flow.u, flow.v, src_u, src_v,
                              sweeps=sweeps)
    got = tmom.momentum_multisweep_plain(*(T(a) for a in ops),
                                         sweeps=sweeps)
    _close(got, ref)


def test_cpu_tensor_runs_plain_version_without_counting(operands):
    *_, ops = operands
    before = tmom.momentum_multisweep.launches
    got = tmom.momentum_multisweep(*(T(a) for a in ops), sweeps=8)
    ref = tmom.momentum_multisweep_plain(*(T(a) for a in ops), sweeps=8)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert tmom.momentum_multisweep.launches == before


def _batched_operands(b_sz, ny, nx, seed):
    """B cases of random structured operands: zero conductances on the
    domain edges, diagonally dominant, a few solid cells."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return rng.uniform(lo, hi, (b_sz, ny, nx)).astype(np.float32)

    a_e, a_w, a_n, a_s = (f(0, 1) for _ in range(4))
    a_e[..., -1] = 0
    a_w[..., 0] = 0
    a_n[..., -1, :] = 0
    a_s[..., 0, :] = 0
    fluid = (f(0, 1) > 0.05).astype(np.float32)
    api = fluid / (a_e + a_w + a_n + a_s + f(0.5, 2.0))
    return (a_e, a_w, a_n, a_s, api, f(-1, 1), f(-1, 1), f(-1, 1) * fluid,
            f(-1, 1) * fluid)


@pytest.mark.parametrize("sweeps", [1, 8])
def test_batched_plain_equals_per_case_plain(sweeps):
    ops = [T(a) for a in _batched_operands(3, 20, 36, seed=sweeps)]
    got = tmom.momentum_multisweep(*ops, sweeps=sweeps)
    for k in range(3):
        ref = tmom.momentum_multisweep_plain(*(a[k] for a in ops),
                                             sweeps=sweeps)
        for g, r in zip(got, ref):
            assert torch.equal(g[k], r)


def test_batched_plain_matches_vmapped_pallas():
    """jax.vmap of the Pallas kernel takes its custom_vmap rule
    (`_msp_batched`: the cases folded into rows with zero separator rows)
    on (3, 16, 128) operands; the port's batched plain version at
    RTOL."""
    import jax
    ops = _batched_operands(3, 16, 128, seed=11)
    ref = jax.vmap(lambda *a: momentum_multisweep_pallas(
        *a, sweeps=8, interpret=True))(*(jnp.asarray(a) for a in ops))
    got = tmom.momentum_multisweep_plain(*(T(a) for a in ops), sweeps=8)
    assert tuple(got[0].shape) == (3, 16, 128)
    _close(got, ref)


def test_mismatched_operand_shapes_are_rejected():
    x = torch.zeros(2, 6, 9)
    with pytest.raises(ValueError, match="share one"):
        tmom.momentum_multisweep(*([x] * 8), x[0], sweeps=2)
    with pytest.raises(ValueError, match="share one"):
        tmom.momentum_multisweep(*([x[..., :-1]] + [x] * 8), sweeps=2)
    with pytest.raises(ValueError, match="share one"):
        tmom.momentum_multisweep(*([x[None]] * 9), sweeps=2)


@pytest.mark.parametrize("sweeps", [-1, 9])
def test_sweeps_beyond_the_halo_are_rejected(sweeps):
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="sweeps"):
        tmom.momentum_multisweep(*([x] * 9), sweeps=sweeps)


def test_non_cuda_device_is_rejected_not_emulated():
    x = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="no momentum kernel"):
        tmom.momentum_multisweep(*([x] * 9), sweeps=2)


def test_zero_padded_edges_and_solid_cells():
    """A neighbour beyond the domain reads as 0 and ap_inv = 0 keeps a
    solid cell at 0, whatever its conductances and source."""
    rng = np.random.default_rng(8)
    a = [T(rng.uniform(0, 1, (6, 9)).astype(np.float32)) for _ in range(4)]
    api = T(rng.uniform(0.1, 0.2, (6, 9)).astype(np.float32))
    api[2, 3] = 0.0
    b = [T(rng.standard_normal((6, 9)).astype(np.float32)) for _ in range(2)]
    u0 = T(rng.standard_normal((6, 9)).astype(np.float32))
    u, v = tmom.momentum_multisweep_plain(*a, api, *b, u0, u0, sweeps=1)
    assert u[2, 3] == 0 and v[2, 3] == 0
    # corner cell: only its east and north neighbours exist
    ref = (a[0][0, 0] * u0[0, 1] + a[2][0, 0] * u0[1, 0] + b[0][0, 0]) \
        * api[0, 0]
    torch.testing.assert_close(u[0, 0], ref)


def _tiled_schedule(ops, sweeps, tile=32, halo=8):
    """The CUDA kernel's schedule in numpy: each tile x tile block loads
    u, v over the tile plus `halo` cells per side (zeros beyond the
    domain), sweeps with the region's outer ring frozen and the
    coefficients read at each cell, and keeps only the tile."""
    a_e, a_w, a_n, a_s, api, bu, bv, u0, v0 = (np.asarray(a) for a in ops)
    ny, nx = u0.shape
    outs = [np.zeros_like(u0), np.zeros_like(v0)]
    for y0 in range(0, ny, tile):
        for x0 in range(0, nx, tile):
            gy = np.arange(y0 - halo, y0 + tile + halo)
            gx = np.arange(x0 - halo, x0 + tile + halo)
            inside = ((gy[:, None] >= 0) & (gy[:, None] < ny)
                      & (gx[None, :] >= 0) & (gx[None, :] < nx))
            cy, cx = np.clip(gy, 0, ny - 1), np.clip(gx, 0, nx - 1)

            def region(a):
                return np.where(inside, a[cy][:, cx], 0.0).astype(np.float32)

            ae, aw, an, as_, ai = (region(a) for a in (a_e, a_w, a_n, a_s,
                                                        api))
            for k, (b, x0_) in enumerate(((bu, u0), (bv, v0))):
                b, x = region(b), region(x0_)
                for _ in range(sweeps):
                    y = x.copy()
                    y[1:-1, 1:-1] = (ae * np.roll(x, -1, 1)
                                     + aw * np.roll(x, 1, 1)
                                     + an * np.roll(x, -1, 0)
                                     + as_ * np.roll(x, 1, 0)
                                     + b)[1:-1, 1:-1] * ai[1:-1, 1:-1]
                    x = np.where(inside, y, 0.0).astype(np.float32)
                core = x[halo:halo + tile, halo:halo + tile]
                h, w = min(tile, ny - y0), min(tile, nx - x0)
                outs[k][y0:y0 + h, x0:x0 + w] = core[:h, :w]
    return outs


@pytest.mark.parametrize("sweeps", [1, 8])
def test_tiled_halo_schedule_is_exact(operands, sweeps):
    """The kernel's design (32 x 32 tiles, 8-cell halo, frozen outer ring,
    bounds-checked loads) reproduces the plain sweeps for sweeps <= 8 on a
    grid that the tiles do not divide: the trapezoid argument and the
    zero-padded edges, checked where the kernel itself cannot run."""
    *_, ops = operands
    ops = [np.asarray(a)[:70, :100] for a in ops]
    got = _tiled_schedule(ops, sweeps)
    ref = tmom.momentum_multisweep_plain(*(T(a) for a in ops), sweeps=sweeps)
    _close([T(g) for g in got], ref)


@pytest.mark.parametrize("halo,sweeps,exact", [(2, 2, True),
                                               (2, 3, False)])
def test_tiled_schedule_needs_sweeps_within_the_halo(halo, sweeps, exact):
    """The check above has teeth: with weakly dominant operands (each hop
    passes ~1/4 of a neighbour's error) a halo of 2 is exact for 2 sweeps
    and wrong for 3, as the frozen ring's stale values reach the tile."""
    rng = np.random.default_rng(12)
    a = [rng.uniform(0, 1, (40, 50)).astype(np.float32) for _ in range(4)]
    api = (1.0 / (sum(a) + 0.1)).astype(np.float32)
    rest = [rng.standard_normal((40, 50)).astype(np.float32)
            for _ in range(4)]
    ops = [*a, api, *rest]
    got = _tiled_schedule(ops, sweeps, tile=16, halo=halo)
    ref = tmom.momentum_multisweep_plain(*(T(x) for x in ops), sweeps=sweeps)
    err = max(float(np.abs(g - r.numpy()).max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    assert (err <= RTOL * scale) == exact, err / scale
