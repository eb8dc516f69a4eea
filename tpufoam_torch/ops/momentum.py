"""Coupled momentum multisweep: the hand-written CUDA kernel and its plain
PyTorch version.

`momentum_multisweep` runs `sweeps` <= 8 coupled plain-Jacobi sweeps
    u <- (a_e E(u) + a_w W(u) + a_n N(u) + a_s S(u) + bu) * ap_inv
(the same for v with bv) in one launch of csrc/momentum_multisweep.cu on
CUDA tensors, and `momentum_multisweep_plain` on CPU tensors. Neighbours
beyond the domain read as 0; ap_inv = fluid / a_P keeps solid cells at 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..fv.operators import nb_e, nb_n, nb_s, nb_w
from . import build

MAX_SWEEPS = 8    # the kernel's halo: exact for sweeps <= halo
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
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.momentum_multisweep_error_string.argtypes = [ctypes.c_int]
        lib.momentum_multisweep_error_string.restype = ctypes.c_char_p
    return lib, fn


def momentum_multisweep(a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0,
                        sweeps: int = 8):
    """`sweeps` coupled Jacobi momentum sweeps; returns (u, v).

    On CUDA tensors this launches the kernel (and raises if it cannot);
    on CPU tensors it runs `momentum_multisweep_plain`."""
    ops = (a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0)
    if not 0 <= sweeps <= MAX_SWEEPS:
        raise ValueError(f"sweeps={sweeps} outside [0, {MAX_SWEEPS}]")
    if u0.device.type == "cpu":
        return momentum_multisweep_plain(*ops, sweeps=sweeps)
    if u0.device.type != "cuda":
        raise ValueError(f"no momentum kernel for device {u0.device}")
    if u0.dim() != 2:
        raise ValueError(f"expected (ny, nx) fields, got {tuple(u0.shape)}")
    for t in ops:
        if t.device != u0.device or t.dtype != torch.float32 \
                or t.shape != u0.shape or not t.is_contiguous():
            raise ValueError(
                "momentum kernel takes contiguous float32 (ny, nx) tensors "
                f"on one device; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    lib, fn = _kernel()
    ny, nx = u0.shape
    u_out = torch.empty_like(u0)
    v_out = torch.empty_like(v0)
    stream = torch.cuda.current_stream(u0.device).cuda_stream
    err = fn(*(t.data_ptr() for t in ops), u_out.data_ptr(),
             v_out.data_ptr(), ny, nx, sweeps, stream)
    if err != 0:
        msg = lib.momentum_multisweep_error_string(err).decode()
        raise RuntimeError(f"momentum_multisweep launch failed: {msg}")
    momentum_multisweep.launches += 1
    return u_out, v_out


momentum_multisweep.launches = 0
