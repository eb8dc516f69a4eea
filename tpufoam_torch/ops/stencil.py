"""Pressure-stencil kernels of the multigrid: the hand-written CUDA kernels
and their plain PyTorch versions.

The pressure operator is the variable-coefficient 5-point stencil

    A x = diag*x - c_e*E(x) - c_w*W(x) - c_n*N(x) - c_s*S(x)

with neighbours beyond the domain read as 0, and the multigrid smoother is
damped Jacobi, x <- x + omega*(b - A x)/diag. The kernels of
csrc/pressure_stencil.cu:

  stencil_matvec     A x in one pass          (fv.pressure.pressure_matvec)
  jacobi_sweep       one sweep per launch, `iters` launches
  jacobi_multisweep  `iters` sweeps                 (multigrid._smooth)
  smooth_residual    `iters` sweeps, then r = b - A x  (V-cycle down leg)
  corr_smooth        x + corr, then `iters` sweeps     (V-cycle up leg)

The two single-pass kernels take (ny, nx) operands or a fleet's
(B, ny, nx); the multisweep kernels take (ny, nx).

On CUDA tensors each wrapper launches its kernel (or raises); on CPU
tensors it runs the `*_plain` version beside it. The plain versions repeat
the kernels' arithmetic operation by operation: the division by diag (not
a multiply by 1/diag), omega rounded to the operand dtype, and a rounding
to the operand dtype after every operation, as the TPU kernels do
("arithmetic stays in the operand dtype"). Operands are float32 or
bfloat16, all of one dtype, contiguous. The kernels have no backward, so
on CUDA they refuse operands that require a gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ..fv.operators import nb_e, nb_n, nb_s, nb_w
from . import build

_NAME = "pressure_stencil"
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The kernels' output tile depends on the halo; its region is at most
# REGION x REGION cells and the grid's y extent is capped by CUDA.
REGION = 64
_MAX_GRID_Y = 65535


def _halo_for(dtype) -> int:
    """The TPU kernels' halo (16 rows for 2-byte dtypes, else 8). It sets
    the iterations the kernels accept: iters <= halo for jacobi_multisweep
    and corr_smooth, iters <= halo - 1 for smooth_residual (its residual
    needs one more ring)."""
    return 16 if torch.tensor([], dtype=dtype).element_size() == 2 else 8


def _max_iters(dtype, kernel: str) -> int:
    return _halo_for(dtype) - (kernel == "smooth_residual")


# the kernels that take one pass per launch (one cell per thread, 8 rows
# per block) and a leading case axis
_PASS_KERNELS = ("matvec", "jacobi_sweep")
_PASS_ROWS = 8


def kernel_available_for(shape, dtype=torch.float32,
                         kernel: str = "jacobi") -> bool:
    """True when the named kernel takes fields of `shape` and `dtype`.
    The counterpart of the TPU package's `pallas_available_for` (its
    scoped-VMEM fit of row bands): the CUDA kernels tile in 2-D with
    bounds-checked reads, so every (ny, nx) fits, up to CUDA's grid limit
    on the number of tiles in y (and on the cases of a (B, ny, nx) shape,
    which only "matvec" and "jacobi_sweep" take). `kernel` is "jacobi"
    (the multisweep), "smooth_residual", "corr_smooth", "matvec" or
    "jacobi_sweep"."""
    if kernel not in ("jacobi", "smooth_residual", "corr_smooth",
                      *_PASS_KERNELS):
        raise ValueError(f"unknown kernel {kernel!r}")
    rank = (2, 3) if kernel in _PASS_KERNELS else (2,)
    if len(shape) not in rank or min(shape) < 1 or dtype not in _DTYPES:
        return False
    if kernel in _PASS_KERNELS:
        return -(-shape[-2] // _PASS_ROWS) <= _MAX_GRID_Y \
            and (len(shape) == 2 or shape[0] <= _MAX_GRID_Y)
    min_tile = REGION - 2 * (_halo_for(dtype) + 1)
    return -(-shape[0] // min_tile) <= _MAX_GRID_Y


# ---- plain versions ----------------------------------------------------


def _omega(omega: float, dtype) -> float:
    """omega rounded to the operand dtype, as the TPU kernels pass it."""
    return float(torch.tensor(omega, dtype=dtype))


def stencil_matvec_plain(coef, x):
    """A x = diag*x - c_e*E(x) - c_w*W(x) - c_n*N(x) - c_s*S(x), evaluated
    left to right: the one plain expression of the pressure operator."""
    return (coef.diag * x - coef.c_e * nb_e(x) - coef.c_w * nb_w(x)
            - coef.c_n * nb_n(x) - coef.c_s * nb_s(x))


def _sweeps(coef, x, b, iters, om):
    for _ in range(iters):
        x = x + om * (b - stencil_matvec_plain(coef, x)) / coef.diag
    return x


def jacobi_multisweep_plain(coef, x, b, iters: int = 2, omega: float = 0.8):
    """`iters` damped-Jacobi sweeps x <- x + omega*(b - A x)/diag."""
    return _sweeps(coef, x, b, iters, _omega(omega, x.dtype))


# one sweep a launch or all in one launch: the same arithmetic
jacobi_sweep_plain = jacobi_multisweep_plain


def smooth_residual_plain(coef, x, b, iters: int = 2, omega: float = 0.8):
    """(x after `iters` sweeps, b - A x of that x)."""
    x = _sweeps(coef, x, b, iters, _omega(omega, x.dtype))
    return x, b - stencil_matvec_plain(coef, x)


def corr_smooth_plain(coef, x, corr, b, iters: int = 2, omega: float = 0.8):
    """`iters` sweeps from x + corr (rounded to the operand dtype)."""
    return _sweeps(coef, x + corr, b, iters, _omega(omega, x.dtype))


# ---- kernels -------------------------------------------------------------


def _fn(entry: str, n_ptr: int, scalars):
    lib = build.load(_NAME)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + list(scalars) \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pressure_stencil_error_string.argtypes = [ctypes.c_int]
        lib.pressure_stencil_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(name, coef, fields, iters, kernel):
    """Returns True for CPU operands (take the plain version), False for
    CUDA operands the kernel takes; raises on anything else: another
    dtype, mixed dtypes, shapes or devices, a strided operand, too many
    iterations, and on CUDA an operand that requires a gradient."""
    x = fields[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    top = None if kernel in _PASS_KERNELS else _max_iters(x.dtype, kernel)
    if iters < 0 or (top is not None and iters > top):
        raise ValueError(f"{name}: iters={iters} outside [0, {top}] for "
                         f"{x.dtype}")
    ops = (*fields, coef.c_e, coef.c_w, coef.c_n, coef.c_s, coef.diag)
    for t in ops:
        if t.device != x.device or t.dtype != x.dtype \
                or t.shape != x.shape:
            raise ValueError(
                f"{name} takes operands of one shape and dtype on one "
                f"device; got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"beside {x.dtype} {tuple(x.shape)} on {x.device}")
    # the same layout contract on both devices, so that CPU runs catch a
    # caller that would hand the kernel a strided or broadcast view
    if not kernel_available_for(tuple(x.shape), x.dtype, kernel):
        raise ValueError(f"{name} kernel cannot take shape {tuple(x.shape)}")
    for t in ops:
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous operands")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise ValueError(f"the {name} kernel has no backward; call it "
                         "under torch.no_grad()")
    return False


def _launch(name, entry, coef, fields, outs, iters, omega):
    x = fields[0]
    lib, fn = _fn(f"{entry}_{_DTYPES[x.dtype]}", len(fields) + 5 + len(outs),
                  (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float))
    ny, nx = x.shape
    ptrs = [t.data_ptr() for t in (*fields, coef.c_e, coef.c_w, coef.c_n,
                                   coef.c_s, coef.diag, *outs)]
    with torch.cuda.device(x.device):   # launch on the operands' card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptrs, ny, nx, iters, _omega(omega, x.dtype), stream)
    _raise_on(lib, name, err)


def _launch_pass(name, entry, coef, fields, out, omega=None):
    """One launch of a single-pass kernel over every plane of `out`."""
    x = fields[0]
    scalars = (ctypes.c_int,) * 3 + ((ctypes.c_float,) if omega is not None
                                     else ())
    lib, fn = _fn(f"{entry}_{_DTYPES[x.dtype]}", len(fields) + 6, scalars)
    *lead, ny, nx = x.shape
    ptrs = [t.data_ptr() for t in (*fields, coef.c_e, coef.c_w, coef.c_n,
                                   coef.c_s, coef.diag, out)]
    args = (lead[0] if lead else 1, ny, nx) \
        + ((_omega(omega, x.dtype),) if omega is not None else ())
    with torch.cuda.device(x.device):   # launch on the operands' card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*ptrs, *args, stream)
    _raise_on(lib, name, err)


def _raise_on(lib, name, err):
    if err != 0:
        msg = lib.pressure_stencil_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


def stencil_matvec(coef, x):
    """A x in one launch of csrc/pressure_stencil.cu on (ny, nx) or
    (B, ny, nx) operands (replaces the TPU kernel `stencil_matvec_pallas`,
    tpufoam/ops/stencil.py:221). On CPU tensors: `stencil_matvec_plain`."""
    if _check("stencil_matvec", coef, (x,), 0, "matvec"):
        return stencil_matvec_plain(coef, x)
    out = torch.empty_like(x)
    _launch_pass("stencil_matvec", "stencil_matvec", coef, (x,), out)
    stencil_matvec.launches += 1
    return out


def jacobi_sweep(coef, x, b, iters: int = 2, omega: float = 0.8):
    """`iters` damped-Jacobi sweeps, one launch of csrc/pressure_stencil.cu
    each, through two ping-pong buffers: one device-memory round trip of x
    per sweep, as the TPU kernel `jacobi_sweep_pallas`
    (tpufoam/ops/stencil.py:245) it replaces. Takes (ny, nx) or
    (B, ny, nx) operands and any iters >= 0. On CPU tensors:
    `jacobi_sweep_plain`."""
    if _check("jacobi_sweep", coef, (x, b), iters, "jacobi_sweep"):
        return jacobi_sweep_plain(coef, x, b, iters, omega)
    bufs = [torch.empty_like(x) for _ in range(min(iters, 2))]
    for k in range(iters):
        _launch_pass("jacobi_sweep", "jacobi_sweep", coef, (x, b),
                     bufs[k % 2], omega)
        jacobi_sweep.launches += 1
        x = bufs[k % 2]
    return x


def jacobi_multisweep(coef, x, b, iters: int = 2, omega: float = 0.8):
    """`iters` <= halo damped-Jacobi sweeps in one launch of
    csrc/pressure_stencil.cu (replaces the TPU kernel
    `jacobi_multisweep_pallas`, tpufoam/ops/stencil.py:520). On CPU
    tensors: `jacobi_multisweep_plain`."""
    if _check("jacobi_multisweep", coef, (x, b), iters, "jacobi"):
        return jacobi_multisweep_plain(coef, x, b, iters, omega)
    out = torch.empty_like(x)
    _launch("jacobi_multisweep", "jacobi_multisweep", coef, (x, b), (out,),
            iters, omega)
    jacobi_multisweep.launches += 1
    return out


def smooth_residual(coef, x, b, iters: int = 2, omega: float = 0.8):
    """The V-cycle down leg, `iters` <= halo - 1 sweeps then the residual,
    in one launch; returns (x, r). Replaces the TPU kernel
    `smooth_residual_pallas`, tpufoam/ops/stencil.py:629. On CPU tensors:
    `smooth_residual_plain`."""
    if _check("smooth_residual", coef, (x, b), iters, "smooth_residual"):
        return smooth_residual_plain(coef, x, b, iters, omega)
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(x)
    _launch("smooth_residual", "smooth_residual", coef, (x, b),
            (x_out, r_out), iters, omega)
    smooth_residual.launches += 1
    return x_out, r_out


def corr_smooth(coef, x, corr, b, iters: int = 2, omega: float = 0.8):
    """The V-cycle up leg, x + corr then `iters` <= halo sweeps, in one
    launch. Replaces the TPU kernel `corr_smooth_pallas`,
    tpufoam/ops/stencil.py:722. On CPU tensors: `corr_smooth_plain`."""
    if _check("corr_smooth", coef, (x, corr, b), iters, "corr_smooth"):
        return corr_smooth_plain(coef, x, corr, b, iters, omega)
    out = torch.empty_like(x)
    _launch("corr_smooth", "corr_smooth", coef, (x, corr, b), (out,), iters,
            omega)
    corr_smooth.launches += 1
    return out


stencil_matvec.launches = 0
jacobi_sweep.launches = 0
jacobi_multisweep.launches = 0
smooth_residual.launches = 0
corr_smooth.launches = 0
