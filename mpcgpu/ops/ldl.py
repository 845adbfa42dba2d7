"""Direct block-tridiagonal LDL^T solver (the qdldl-equivalent baseline).

The reference's second linear-system path ships the Schur lower triangle to
the CPU each SQP iteration and factorizes with osqp/qdldl
(include/qdldl/sqp.cuh:22-49, :268-273).  Here the factorization stays
on device as a block LDL^T over the BTD structure (lax.scan over knots), and
additionally provide a C++ CPU implementation (native/) mirroring the
reference's host-side role for cross-checking.

Factorization of SPD BTD S (blocks theta_k diag, phi_k sub-diag):
    D_0 = theta_0
    L_k = phi_k D_{k-1}^{-1}            (k = 1..N-1)
    D_k = theta_k - L_k phi_k^T
solve via forward substitution, block solves with D_k, back substitution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from mpcgpu.precision import highest_precision


@highest_precision
def btd_ldl_factor(S):
    """Factor BTD S (N,3,n,n) -> (D (N,n,n), L (N-1,n,n))."""
    theta = S[:, 1]
    phi = S[1:, 0]

    def step(Dprev, inputs):
        th, ph = inputs
        Lk = jnp.linalg.solve(Dprev.T, ph.T).T    # ph @ inv(Dprev)
        Dk = th - Lk @ ph.T
        return Dk, (Dk, Lk)

    D0 = theta[0]
    _, (Drest, L) = jax.lax.scan(step, D0, (theta[1:], phi))
    D = jnp.concatenate([D0[None], Drest], axis=0)
    return D, L


@highest_precision
def btd_ldl_solve(S, b):
    """Direct solve S x = b for SPD BTD S; returns (N,n)."""
    D, L = btd_ldl_factor(S)

    # forward: y_0 = b_0; y_k = b_k - L_k y_{k-1}
    def fwd(yprev, inputs):
        bk, Lk = inputs
        yk = bk - Lk @ yprev
        return yk, yk

    y0 = b[0]
    _, yrest = jax.lax.scan(fwd, y0, (b[1:], L))
    y = jnp.concatenate([y0[None], yrest], axis=0)

    # diagonal: w_k = D_k^{-1} y_k
    w = jnp.linalg.solve(D, y[..., None])[..., 0]

    # backward: x_{N-1} = w_{N-1}; x_k = w_k - L_{k+1}^T x_{k+1}
    def bwd(xnext, inputs):
        wk, Lk1 = inputs
        xk = wk - Lk1.T @ xnext
        return xk, xk

    xN = w[-1]
    _, xrest = jax.lax.scan(bwd, xN, (w[:-1][::-1], L[::-1]))
    x = jnp.concatenate([xrest[::-1], xN[None]], axis=0)
    return x
