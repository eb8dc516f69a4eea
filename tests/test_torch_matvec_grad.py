"""The reverse mode of the pressure matvec on the CPU: `ops.stencil.
StencilMatvec` (what `stencil_matvec` runs under autograd) and its plain
backward `stencil_matvec_grad_plain`, which csrc/stencil_grad.cu computes
on the card (tests/test_torch_gpu.py holds the kernel to it bit for bit).

Operands are seeded with numpy, in float32 and bfloat16, on one (ny, nx)
plane and on a stack of three, of two kinds: "random" (every conductance
nonzero, those pointing out of the domain too, and no symmetry: the
gradient must be A^T g for any operands, as on coarse levels and cut
cells) and "edges" (the outward conductances 0, as on every real case,
and x and g 0 on the first and last rows and columns). Tolerances:
- against torch.autograd of `stencil_matvec_plain`: the five coefficient
  gradients bit for bit (the same products, negated); dx within
  8 u sum|t_i| per cell, u the unit roundoff (2^-24, bfloat16 2^-8), t_i
  the five products: autograd adds the same rounded terms in another
  order, and two orders of a 5-term sum differ by at most 2 x 4 u
  sum|t_i| (measured: up to 1 float32 ulp, 2 bfloat16 ulps).
- against jax.vjp of the JAX package's `pressure_matvec` (vmapped over a
  stack): the coefficient gradients bit for bit (one product each, on
  both sides); dx in float32 within 4 u sum|t_i| per cell (XLA sums the
  same terms, possibly in another order), in bfloat16 within 10 u
  sum|t_i|: the port rounds to bfloat16 nine times, XLA on the CPU keeps
  the sum in float32 and rounds once (measured 0.012 sum|t_i|, three
  bfloat16 ulps of the largest term).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufoam.fv import pressure as jpres
from tpufoam_torch.fv.operators import nb_e, nb_n, nb_s, nb_w
from tpufoam_torch.fv.pressure import PressureCoeffs
from tpufoam_torch.ops import stencil as st

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
UNIT = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}
SHAPES = [(13, 21), (3, 13, 21)]
NAMES = ("x", "c_e", "c_w", "c_n", "c_s", "diag")


def _operands(shape, dtype, kind, seed=0):
    """(x, c_e, c_w, c_n, c_s, diag, g) as tensors of `dtype`."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    c = [f(0.1, 1.0) for _ in range(4)]
    diag = sum(c) + f(0.0, 0.5)
    x, g = f(-1.0, 1.0), f(-1.0, 1.0)
    if kind == "edges":
        c[0][..., :, -1] = 0.0
        c[1][..., :, 0] = 0.0
        c[2][..., -1, :] = 0.0
        c[3][..., 0, :] = 0.0
        for a in (x, g):
            a[..., [0, -1], :] = 0.0
            a[..., :, [0, -1]] = 0.0
    return [torch.as_tensor(a).to(dtype) for a in (x, *c, diag, g)]


def _coef(c_e, c_w, c_n, c_s, diag):
    return PressureCoeffs(c_e, c_w, c_n, c_s, torch.zeros_like(diag), diag)


def _dx_terms(ops, g):
    """|t_i| of dx's five products, summed per cell, in float64."""
    _, c_e, c_w, c_n, c_s, diag = (t.double() for t in ops)
    g = g.double()
    return ((diag * g).abs() + nb_w(c_e * g).abs() + nb_e(c_w * g).abs()
            + nb_s(c_n * g).abs() + nb_n(c_s * g).abs())


def _autograd(fn, ops, g, need):
    leaves = [t.clone().requires_grad_(n) for t, n in zip(ops, need)]
    y = fn(_coef(*leaves[1:]), leaves[0])
    wanted = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(y, wanted, g))
    return [next(got) if n else None for n in need]


@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("prec", DTYPES)
def test_backward_matches_autograd_of_the_plain_matvec(prec, shape, kind):
    """Through `stencil_matvec` under autograd (StencilMatvec, its plain
    backward on the CPU) against autograd of `stencil_matvec_plain`, for
    every subset of the inputs that need a gradient; the plain backward
    called directly returns None where a gradient is not asked for."""
    dtype = DTYPES[prec]
    *ops, g = _operands(shape, dtype, kind)
    bound = 8 * UNIT[dtype] * _dx_terms(ops, g)
    before = st.stencil_matvec_grad.launches
    for need in itertools.product((False, True), repeat=6):
        if not any(need):
            continue
        got = _autograd(st.stencil_matvec, ops, g, need)
        ref = _autograd(st.stencil_matvec_plain, ops, g, need)
        direct = st.stencil_matvec_grad_plain(_coef(*ops[1:]), ops[0], g,
                                              need)
        for name, n, a, b, d in zip(NAMES, need, got, ref, direct):
            if not n:
                assert a is None and d is None, name
                continue
            assert a.dtype == dtype and torch.equal(a, d), (need, name)
            if name == "x":
                err = (a.double() - b.double()).abs()
                assert bool((err <= bound).all()), float(err.max())
            else:
                assert torch.equal(a, b), (need, name)
    # on the CPU nothing launches
    assert st.stencil_matvec_grad.launches == before


@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("prec", DTYPES)
def test_backward_matches_jax_vjp(prec, shape, kind):
    """All six gradients against jax.vjp of the JAX package's
    `pressure_matvec` (vmapped over a stack's planes) from the same
    operands."""
    dtype = DTYPES[prec]
    *ops, g = _operands(shape, dtype, kind, seed=1)
    got = st.stencil_matvec_grad_plain(_coef(*ops[1:]), ops[0], g)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def matvec(x, c_e, c_w, c_n, c_s, diag):
        return jpres.pressure_matvec(jpres.PressureCoeffs(
            c_e=c_e, c_w=c_w, c_n=c_n, c_s=c_s, c_out=jnp.zeros_like(diag),
            diag=diag), x)

    if len(shape) == 3:
        matvec = jax.vmap(matvec)
    args = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ops]
    _, vjp = jax.vjp(matvec, *args)
    ref = [torch.as_tensor(np.array(a.astype(jnp.float32)))
           for a in vjp(jnp.asarray(g.float().numpy()).astype(jdt))]
    rounds = 4 if dtype == torch.float32 else 10
    dx_bound = rounds * UNIT[dtype] * _dx_terms(ops, g)
    assert bool(((got[0].double() - ref[0].double()).abs()
                 <= dx_bound).all())
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a.float(), b)


def test_matvec_takes_the_function_only_under_autograd():
    """Without a gradient to record (no_grad, or no operand that requires
    one) `stencil_matvec` returns a plain tensor; with one, a
    StencilMatvec node whose backward is once differentiable."""
    *ops, g = _operands((9, 11), torch.float32, "random")
    coef = _coef(*ops[1:])
    assert st.stencil_matvec(coef, ops[0]).grad_fn is None
    x = ops[0].clone().requires_grad_()
    with torch.no_grad():
        assert st.stencil_matvec(coef, x).grad_fn is None
    y = st.stencil_matvec(coef, x)
    assert type(y.grad_fn).__name__ == "StencilMatvecBackward"
    assert torch.equal(y.detach(), st.stencil_matvec_plain(coef, ops[0]))
    g = g.clone().requires_grad_()
    dx, = torch.autograd.grad(y, x, g, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()
