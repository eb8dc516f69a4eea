"""Coupled momentum multisweep: the hand-written CUDA kernel and its plain
PyTorch version.

`momentum_multisweep` runs `sweeps` <= 8 coupled plain-Jacobi sweeps
    u <- (a_e E(u) + a_w W(u) + a_n N(u) + a_s S(u) + bu) * ap_inv
(the same for v with bv) in one launch of csrc/momentum_multisweep.cu on
CUDA tensors, and `momentum_multisweep_plain` on CPU tensors. Neighbours
beyond the domain read as 0; ap_inv = fluid / a_P keeps solid cells at 0.
Operands are (ny, nx), or (B, ny, nx) for a fleet of B cases: one launch
then sweeps every case (the JAX package's batched rule `_msp_batched`),
each case as if alone.
"""

from __future__ import annotations

import ctypes

import torch

from ..fv.operators import nb_e, nb_n, nb_s, nb_w
from . import build

MAX_SWEEPS = 8    # the kernel's halo: exact for sweeps <= halo
# the kernel's tiling (csrc/momentum_multisweep.cu): each block sweeps a
# region of TILE plus MAX_SWEEPS cells on every side and writes the TILE
# (rows, columns) of outputs
TILE = (32, 48)
_NAME = "momentum_multisweep"


def momentum_multisweep_plain(a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0,
                              sweeps: int = 8):
    """The kernel's arithmetic, one stencil pass per sweep."""
    u, v = u0, v0
    for _ in range(sweeps):
        u, v = (
            (a_e * nb_e(u) + a_w * nb_w(u) + a_n * nb_n(u) + a_s * nb_s(u)
             + bu) * ap_inv,
            (a_e * nb_e(v) + a_w * nb_w(v) + a_n * nb_n(v) + a_s * nb_s(v)
             + bv) * ap_inv,
        )
    return u, v


def _kernel():
    lib = build.load(_NAME)
    fn = lib.momentum_multisweep_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.momentum_multisweep_error_string.argtypes = [ctypes.c_int]
        lib.momentum_multisweep_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(ops, sweeps: int) -> bool:
    """True for CPU operands (take the plain version), False for CUDA
    operands; raises on too many sweeps, differing shapes or another
    device."""
    u0 = ops[7]
    if not 0 <= sweeps <= MAX_SWEEPS:
        raise ValueError(f"sweeps={sweeps} outside [0, {MAX_SWEEPS}]")
    if u0.dim() not in (2, 3) or any(t.shape != u0.shape for t in ops):
        raise ValueError("momentum operands must share one (ny, nx) or "
                         f"(B, ny, nx) shape; got "
                         f"{[tuple(t.shape) for t in ops]}")
    if u0.device.type == "cpu":
        return True
    if u0.device.type != "cuda":
        raise ValueError(f"no momentum kernel for device {u0.device}")
    return False


def _launch(ops, sweeps: int, out=None):
    """One launch of the kernel over the (ny, nx) or (B, ny, nx) CUDA
    operands `ops` = (a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0), on the
    card that holds them, into `out` = (u, v) (new tensors if None);
    returns (u, v). Counts nothing: the callers count their own
    launches."""
    u0 = ops[7]
    for t in ops:
        if t.device != u0.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                "momentum kernel takes contiguous float32 tensors on one "
                f"device; got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    lib, fn = _kernel()
    *lead, ny, nx = u0.shape
    planes = lead[0] if lead else 1
    u_out, v_out = out if out is not None else (torch.empty_like(u0),
                                                torch.empty_like(u0))
    for t in (u_out, v_out):
        if t.shape != u0.shape or t.device != u0.device \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("momentum kernel writes contiguous float32 "
                             "outputs of its operands' shape and device")
    with torch.cuda.device(u0.device):
        stream = torch.cuda.current_stream(u0.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ops), u_out.data_ptr(),
                 v_out.data_ptr(), planes, ny, nx, sweeps, stream)
    if err != 0:
        msg = lib.momentum_multisweep_error_string(err).decode()
        raise RuntimeError(f"momentum_multisweep launch failed: {msg}")
    return u_out, v_out


def momentum_multisweep(a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0,
                        sweeps: int = 8):
    """`sweeps` coupled Jacobi momentum sweeps on (ny, nx) or (B, ny, nx)
    operands; returns (u, v).

    On CUDA tensors this launches the kernel once, whatever B, on the card
    that holds them (and raises if it cannot); on CPU tensors it runs
    `momentum_multisweep_plain`. Both check that the nine operands share
    one shape."""
    ops = (a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0)
    if _check(ops, sweeps):
        return momentum_multisweep_plain(*ops, sweeps=sweeps)
    out = _launch(ops, sweeps)
    momentum_multisweep.launches += 1
    return out


momentum_multisweep.launches = 0
