"""Parallel cyclic reduction (PCR): exact direct solve of block-tridiagonal
systems in log2(N) data-parallel levels.

An alternative to both of the reference's linear solvers: GBD-PCG
iterates ~100+ SpMVs on the ill-conditioned Schur system (and is routinely
max-iter-capped, mpcsim.cuh:382-387), and qdldl is a sequential CPU LDL^T
(qdldl/sqp.cuh:268-273, one D2H/H2D round trip per SQP iteration).  PCR does
neither: every level eliminates the +-2^l neighbors of EVERY block row
simultaneously (pure lane-parallel work, no back-substitution), so the exact
solution costs log2(N) levels of batched 14x14 inverses and products — a
good fit for one vmapped XLA program.

Level update (s = 2^l; rows with k-s < 0 or k+s >= N have L/U = 0):

    x_{k-s} = th_{k-s}^{-1} (b_{k-s} - L_{k-s} x_{k-2s} - U_{k-s} x_k)
    x_{k+s} = th_{k+s}^{-1} (b_{k+s} - L_{k+s} x_k - U_{k+s} x_{k+2s})

substituted into row k gives the next-level coefficients

    L'  = -L_k A_{k-s},            A = th^{-1} L
    U'  = -U_k B_{k+s},            B = th^{-1} U
    th' = th_k - L_k B_{k-s} - U_k A_{k+s}
    b'  = b_k - L_k v_{k-s} - U_k v_{k+s},    v = th^{-1} b

after ceil(log2(N)) levels all rows are decoupled: x = th^{-1} b.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from mpcgpu.ops.smallmat import gj_inverse
from mpcgpu.precision import highest_precision


@highest_precision
@partial(jax.jit, static_argnames=("refine",))
def pcr_solve_refined(S, b, refine: int = 1):
    """PCR solve + `refine` steps of iterative refinement.

    The Schur systems here are ill-conditioned enough (cond ~ 1e5-1e6 after
    regularization) that a single f32 PCR pass loses most digits; one
    refinement pass (recompute the residual, re-solve, correct) recovers a
    solution whose true residual beats even a fully-converged stair-PCG run
    in f32 (see tests/test_pcr.py)."""
    from mpcgpu.ops.btd import btd_matvec

    x = pcr_solve(S, b)
    for _ in range(refine):
        r = b - btd_matvec(S, x)
        x = x + pcr_solve(S, r)
    return x


@highest_precision
@partial(jax.jit, static_argnames=())
def pcr_solve(S, b):
    """Solve the SPD BTD system S x = b exactly.

    Args:
      S: (N, 3, n, n) BTD blocks — S[k,0] = block (k,k-1), S[k,1] = diagonal,
         S[k,2] = block (k,k+1)  (the layout of ops/schur.py).
      b: (N, n) right-hand side.
    Returns: x (N, n).
    """
    N = S.shape[0]
    L, th, U = S[:, 0], S[:, 1], S[:, 2]
    # structural zeros on the corner blocks
    L = L.at[0].set(0.0)
    U = U.at[N - 1].set(0.0)

    levels = max(1, math.ceil(math.log2(N))) if N > 1 else 0
    for lvl in range(levels):
        s = 1 << lvl
        thinv = gj_inverse(th)
        A = jnp.einsum("kij,kjl->kil", thinv, L)
        B = jnp.einsum("kij,kjl->kil", thinv, U)
        v = jnp.einsum("kij,kj->ki", thinv, b)

        def roll_blocks(M, shift):
            return jnp.roll(M, shift, axis=0)

        A_m, B_m, v_m = roll_blocks(A, s), roll_blocks(B, s), roll_blocks(v, s)
        A_p, B_p, v_p = roll_blocks(A, -s), roll_blocks(B, -s), roll_blocks(v, -s)

        L_new = -jnp.einsum("kij,kjl->kil", L, A_m)
        U_new = -jnp.einsum("kij,kjl->kil", U, B_p)
        th_new = (
            th
            - jnp.einsum("kij,kjl->kil", L, B_m)
            - jnp.einsum("kij,kjl->kil", U, A_p)
        )
        b_new = (
            b
            - jnp.einsum("kij,kj->ki", L, v_m)
            - jnp.einsum("kij,kj->ki", U, v_p)
        )
        L = L_new.at[:s].set(0.0)        # rows with k - s < 0 lose their L
        U = U_new.at[N - s :].set(0.0)   # rows with k + s >= N lose their U
        th, b = th_new, b_new

    return jnp.einsum("kij,kj->ki", gj_inverse(th), b)
