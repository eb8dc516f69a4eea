"""Card-only tests of tpufoam_torch: the hand-written CUDA kernels against
their plain versions, and the port's step on the card against the same
step on the CPU. They skip without a CUDA device.

Run them on a machine with a card (no JAX needed; --noconftest keeps the
JAX test configuration out):

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from tpufoam_torch.ops import momentum as tmom

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
    cfg = PisoConfig(max_co=0.5, max_dt=2e-3)
    flows = {}
    for dev in ("cpu", cuda):
        case = build_channel_case(geom, delta=2.0 / ny, device=dev)
        pred = make_predictor(SurrogateBundle.load(bundle_dir, device=dev))
        flows[str(dev)] = run_piso_eager(case, initial_flow(case, 5e-4), 3,
                                         cfg=cfg, backend=MGBackend(cycles=2),
                                         sm_predict=pred)
    for name in ("u", "v", "p"):
        a = getattr(flows["cuda"], name).cpu()
        b = getattr(flows["cpu"], name)
        # f32 everywhere; differences are float32 rounding amplified by
        # the pressure equation's cancellation (see chip_smoke.py parity)
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
