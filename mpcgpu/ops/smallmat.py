"""Batched small-matrix inverse/solve via unrolled Gauss-Jordan elimination.

The equivalent of the reference's in-place shared-memory Gauss-Jordan
without pivoting (utils/matrix.cuh:120-238): the elimination is unrolled over
the (static, tiny) matrix dimension so XLA sees n fused vector steps over the
batch — no generic LU/Cholesky while-loops.  Valid for the rho-regularized
SPD blocks this solver produces (same assumption as the reference).
"""

from __future__ import annotations

import jax.numpy as jnp


def gj_solve_aug(M, rhs):
    """Solve M X = rhs for batched small SPD M.

    M: (..., n, n), rhs: (..., n, m) -> (..., n, m).  Unrolled Gauss-Jordan
    on the augmented system; no pivoting (SPD assumption, matching
    utils/matrix.cuh:120-148).
    """
    n = M.shape[-1]
    A = jnp.concatenate([M, rhs], axis=-1)
    for i in range(n):
        piv = A[..., i : i + 1, :] / A[..., i : i + 1, i : i + 1]
        A = A - A[..., :, i : i + 1] * piv
        A = A.at[..., i, :].set(piv[..., 0, :])
    return A[..., n:]


def gj_inverse(M):
    """Batched inverse of small SPD matrices: (..., n, n) -> (..., n, n)."""
    n = M.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape)
    return gj_solve_aug(M, eye)


def gj_solve_vec(M, b):
    """Solve M x = b for batched small SPD M and vector b (..., n)."""
    return gj_solve_aug(M, b[..., None])[..., 0]
