"""The plain forms of the two stencil operations the hybrid step uses:
the pressure operator A x and the coupled momentum multisweep. No kernel
is built or launched here."""

from __future__ import annotations

from .operators import nb_e, nb_n, nb_s, nb_w

MAX_SWEEPS = 8


def stencil_matvec(coef, x):
    """A x = diag*x - c_e*E(x) - c_w*W(x) - c_n*N(x) - c_s*S(x), evaluated
    left to right."""
    return (coef.diag * x - coef.c_e * nb_e(x) - coef.c_w * nb_w(x)
            - coef.c_n * nb_n(x) - coef.c_s * nb_s(x))


def momentum_multisweep(a_e, a_w, a_n, a_s, ap_inv, bu, bv, u0, v0,
                        sweeps: int = 8):
    """`sweeps` coupled Jacobi sweeps, one stencil pass per sweep."""
    u, v = u0, v0
    for _ in range(sweeps):
        u, v = (
            (a_e * nb_e(u) + a_w * nb_w(u) + a_n * nb_n(u) + a_s * nb_s(u)
             + bu) * ap_inv,
            (a_e * nb_e(v) + a_w * nb_w(v) + a_n * nb_n(v) + a_s * nb_s(v)
             + bv) * ap_inv,
        )
    return u, v


