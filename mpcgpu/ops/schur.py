"""Schur-complement condensation of the KKT system + symmetric-stair preconditioner.

Equivalent of form_S_gamma_Pinv_kernel (include/pcg/linsys_setup.cuh:565-612,
phase 1 :141-562, phase 2 :9-137) and compute_dz (include/common/dz.cuh), as
batched einsums over knot-leading blocks.

Sign convention: we form the POSITIVE-definite Schur system

    S lambda = gamma,   S = C G_rho^{-1} C^T,  gamma = C G_rho^{-1} g - c*

(the reference stores the negated pair d_S = -S, d_gamma = -gamma and runs CG
on it; all CG iterates for lambda are identical, so lambda here matches the
reference bit-for-bit in exact arithmetic).  Blocks (k = 1..N-1):

    theta_0 = Qr_0^{-1};                       gamma_0 = Qr_0^{-1} q_0
    theta_k = A Qr_{k-1}^{-1} A^T + B Rr^{-1} B^T + Qr_k^{-1}
    phi_k   = -A_{k-1} Qr_{k-1}^{-1}           (block (k, k-1))
    gamma_k = Qr_k^{-1} q_k - c_k - A Qr_{k-1}^{-1} q_{k-1} - B Rr^{-1} r_{k-1}

with Qr = Q + rho*I, Rr = R + rho*I (Levenberg-Marquardt regularization,
pcg/linsys_setup.cuh:180-181, :329-331).  Note the reference omits the
initial-state residual c_0 from gamma_0 (linsys_setup.cuh:272-276) — the
initial constraint influences the step only through the line-search merit; we
replicate that behavior.

The symmetric-stair preconditioner (arXiv:2309.06427; linsys_setup.cuh:97-136)
in this convention is

    Pinv = D^{-1} - D^{-1} T D^{-1}

where D = blockdiag(theta_k) and T = the off-diagonal part of S, i.e.
Pinv[k,k] = theta_k^{-1}, Pinv[k,k+-1] = -theta_k^{-1} S[k,k+-1] theta_{k+-1}^{-1}.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp

from mpcgpu.ops.smallmat import gj_inverse
from mpcgpu.precision import highest_precision

if TYPE_CHECKING:  # avoid a circular import; KKTBlocks is duck-typed here
    from mpcgpu.solver.kkt import KKTBlocks


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SchurSystem:
    S: jax.Array        # (N, 3, nx, nx) positive-definite BTD Schur matrix
    Pinv: jax.Array     # (N, 3, nx, nx) stair preconditioner (BTD); (N, 5, ...) for stair2
    gamma: jax.Array    # (N, nx) rhs
    Qinv: jax.Array     # (N, nx, nx) cached (Q+rho I)^{-1}  (for dz, like d_G reuse)
    Rinv: jax.Array     # (N-1, nu, nu) cached (R+rho I)^{-1}


def _inv_blocks(M):
    """Batched SPD inverse (N, n, n) -> (N, n, n) via unrolled Gauss-Jordan
    (ops/smallmat.py) — same algorithm as the reference's invertMatrix
    (utils/matrix.cuh:120-238), vectorized over the knot batch instead of
    thread-strided; avoids XLA's generic loop-based LU on tiny blocks."""
    return gj_inverse(M)


@highest_precision
def form_schur_system(
    kkt: "KKTBlocks", rho, preconditioner: str = "stair"
) -> SchurSystem:
    """Form (S, Pinv, gamma) from KKT blocks. Fully batched; jit-friendly."""
    Q, q, R, r, A, B, c = kkt.Q, kkt.q, kkt.R, kkt.r, kkt.A, kkt.B, kkt.c
    N, nx, _ = Q.shape
    dtype = Q.dtype
    rho = jnp.asarray(rho, dtype)

    eyex = jnp.eye(nx, dtype=dtype)
    eyeu = jnp.eye(R.shape[-1], dtype=dtype)
    Qinv = _inv_blocks(Q + rho * eyex)          # (N, nx, nx)
    Rinv = _inv_blocks(R + rho * eyeu)          # (N-1, nu, nu)

    AQ = jnp.einsum("kij,kjl->kil", A, Qinv[:-1])       # A_k Qr_k^{-1}
    BR = jnp.einsum("kij,kjl->kil", B, Rinv)            # B_k Rr_k^{-1}

    theta_rest = (
        jnp.einsum("kij,klj->kil", AQ, A)
        + jnp.einsum("kij,klj->kil", BR, B)
        + Qinv[1:]
    )
    theta = jnp.concatenate([Qinv[0][None], theta_rest], axis=0)   # (N, nx, nx)
    phi = -AQ                                                      # (N-1,) block (k+1, k)

    gamma_0 = Qinv[0] @ q[0]
    gamma_rest = (
        jnp.einsum("kij,kj->ki", Qinv[1:], q[1:])
        - c[1:]
        - jnp.einsum("kij,kj->ki", AQ, q[:-1])
        - jnp.einsum("kij,kj->ki", BR, r)
    )
    gamma = jnp.concatenate([gamma_0[None], gamma_rest], axis=0)

    # pack BTD: S[k,0] = phi_k (k>=1), S[k,1] = theta_k, S[k,2] = phi_{k+1}^T
    zero_blk = jnp.zeros((1, nx, nx), dtype)
    S = jnp.stack(
        [
            jnp.concatenate([zero_blk, phi], axis=0),
            theta,
            jnp.concatenate([jnp.swapaxes(phi, -1, -2), zero_blk], axis=0),
        ],
        axis=1,
    )

    D = _inv_blocks(theta)
    if preconditioner == "none":
        eyeblk = jnp.broadcast_to(eyex, (N, nx, nx))
        Pinv = jnp.stack([jnp.zeros_like(S[:, 0]), eyeblk, jnp.zeros_like(S[:, 2])], axis=1)
    elif preconditioner == "jacobi":
        Pinv = jnp.stack([jnp.zeros_like(S[:, 0]), D, jnp.zeros_like(S[:, 2])], axis=1)
    elif preconditioner == "stair":
        # Pinv off-diagonals: -D_k S[k, k+-1] D_{k+-1}  (linsys_setup.cuh:97-136)
        left = -jnp.einsum("kij,kjl,klm->kim", D[1:], S[1:, 0], D[:-1])
        right = -jnp.einsum("kij,kjl,klm->kim", D[:-1], S[:-1, 2], D[1:])
        Pinv = jnp.stack(
            [
                jnp.concatenate([zero_blk, left], axis=0),
                D,
                jnp.concatenate([right, zero_blk], axis=0),
            ],
            axis=1,
        )
    elif preconditioner == "stair2":
        # One more Neumann term than stair: with T the off-diagonal part of S,
        #   Pinv = D^-1 - D^-1 T D^-1 + D^-1 T D^-1 T D^-1
        # (block-PENTAdiagonal, slots (k, k-2..k+2)).  Writing
        # Y = D^-1/2 T D^-1/2, this is D^-1/2 (I - Y + Y^2) D^-1/2 with
        # eigenvalues 1 - y + y^2 >= 3/4, so unlike the stair truncation it
        # is unconditionally SPD.  XLA PCG path only (the fused kernel and
        # the sharded halo exchange emit the 3-band stair).
        L, U = S[:, 0], S[:, 2]            # blocks (k,k-1) / (k,k+1); 0 at edges
        off1_l = -jnp.einsum("kij,kjl,klm->kim", D[1:], L[1:], D[:-1])
        off1_r = -jnp.einsum("kij,kjl,klm->kim", D[:-1], U[:-1], D[1:])
        t_lo = jnp.einsum("kij,kjl,kml->kim", L[1:], D[:-1], L[1:])    # L D L^T
        t_hi = jnp.einsum("kij,kjl,kml->kim", U[:-1], D[1:], U[:-1])   # U D U^T
        t = jnp.zeros_like(D).at[1:].add(t_lo).at[:-1].add(t_hi)
        diag = D + jnp.einsum("kij,kjl,klm->kim", D, t, D)
        off2_l = jnp.einsum(
            "kij,kjl,klm,kmn,knp->kip", D[2:], L[2:], D[1:-1], L[1:-1], D[:-2]
        )
        off2_r = jnp.einsum(
            "kij,kjl,klm,kmn,knp->kip", D[:-2], U[:-2], D[1:-1], U[1:-1], D[2:]
        )
        zero2 = jnp.zeros((2, nx, nx), dtype)
        Pinv = jnp.stack(
            [
                jnp.concatenate([zero2, off2_l], axis=0),
                jnp.concatenate([zero_blk, off1_l], axis=0),
                diag,
                jnp.concatenate([off1_r, zero_blk], axis=0),
                jnp.concatenate([off2_r, zero2], axis=0),
            ],
            axis=1,
        )
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    return SchurSystem(S=S, Pinv=Pinv, gamma=gamma, Qinv=Qinv, Rinv=Rinv)


@highest_precision
def compute_dz(kkt: "KKTBlocks", schur: SchurSystem, lam) -> jax.Array:
    """Primal step recovery from the costate solve (include/common/dz.cuh:3-137).

        dx_k = Qr_k^{-1} (q_k - lam_k + A_k^T lam_{k+1})     (A term absent at N-1)
        du_k = Rr_k^{-1} (r_k + B_k^T lam_{k+1})

    Applied as xu <- xu + alpha * dz with alpha in {-1/2^i} (pcg/sqp.cuh:317).
    Returns dz shaped (N, nx+nu) with a zero tail control row.
    """
    q, r, A, B = kkt.q, kkt.r, kkt.A, kkt.B
    N, nx = q.shape
    nu = r.shape[-1]

    at_lam = jnp.einsum("kji,kj->ki", A, lam[1:])           # A_k^T lam_{k+1}
    rhs_x = q - lam
    rhs_x = rhs_x.at[:-1].add(at_lam)
    dx = jnp.einsum("kij,kj->ki", schur.Qinv, rhs_x)

    bt_lam = jnp.einsum("kji,kj->ki", B, lam[1:])           # B_k^T lam_{k+1}
    du = jnp.einsum("kij,kj->ki", schur.Rinv, r + bt_lam)
    du = jnp.concatenate([du, jnp.zeros((1, nu), du.dtype)], axis=0)
    return jnp.concatenate([dx, du], axis=-1)
