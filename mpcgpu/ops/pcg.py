"""Preconditioned conjugate gradient on the block-tridiagonal Schur system.

Equivalent of the GBD-PCG cooperative kernel (consumed surface documented at
SURVEY.md C17; pcg/sqp.cuh:129-151, :230): warm-started PCG with a BTD SpMV,
BTD preconditioner apply, and two scalar reductions per iteration, exiting on
|eta| = |r . P^{-1} r| < exit_tol or max_iter.

Written as a ``lax.while_loop`` over fused batched einsums: one XLA program
that works under vmap (batched instances) and shard_map (knot-sharded; see
parallel/pcg_sharded.py) and is the portable reference for the GPU kernel
(ops/pcg_pallas.py).  On a GPU, XLA runs each iteration as a predicate copy
to the host plus one CUDA-graph launch of ~8 small kernels.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpcgpu.ops.btd import btd_matvec
from mpcgpu.precision import highest_precision


class PCGResult(NamedTuple):
    lam: jax.Array        # (N, n) solution
    iters: jax.Array      # () int32 iterations taken
    converged: jax.Array  # () bool — True if exit_tol reached before max_iter


@highest_precision
@partial(jax.jit, static_argnames=("max_iter", "exit_criterion", "precond_poly"))
def pcg_solve(S, Pinv, gamma, lam0, max_iter: int = 173, exit_tol=1e-6,
              exit_criterion: str = "eta", precond_poly: int = 1) -> PCGResult:
    """Solve S lam = gamma with BTD S and block-banded preconditioner Pinv.

    Args:
      S: (N, 3, n, n) BTD matrix (see ops/btd.py).
      Pinv: (N, 2b+1, n, n) block-banded preconditioner (3 bands for
        jacobi/stair, 5 for stair2).
      gamma: (N, n) rhs.
      lam0: (N, n) warm start (the reference warm-starts from the previous
        MPC step's multipliers, mpcsim.cuh:186-190).
      max_iter: static iteration cap (settings.cuh:124-144).
      exit_tol: tolerance on the exit metric.
      exit_criterion: "eta" = |r . P^{-1} r| < exit_tol — the reference/
        GBD-PCG semantics (SURVEY.md C17, re-derived round 5 from the
        consumed kernel surface: d_eta_new_temp is the only exit-testable
        reduction, pcg/sqp.cuh:120-125); "rnorm" = ||r||_2 < exit_tol, an
        absolute-residual research variant (cap-bound at reference tols in
        f32 — see tools/diagnose_rnorm.py).
      precond_poly: 1 applies Pinv directly; 2 applies the first-order
        polynomial refinement z = (2 Pinv - Pinv S Pinv) r (one extra S and
        Pinv matvec per iteration; SPD only while lambda_max(S Pinv) < 2 —
        an experimental knob, see benchmarks/precond_study.py).
    """
    if exit_criterion not in ("eta", "rnorm"):
        raise ValueError(f"unknown exit_criterion {exit_criterion!r}")
    if precond_poly not in (1, 2):
        raise ValueError(f"precond_poly must be 1 or 2, got {precond_poly}")
    dtype = gamma.dtype
    exit_tol = jnp.asarray(exit_tol, dtype)

    def apply_precond(r):
        z = btd_matvec(Pinv, r)
        if precond_poly == 2:
            z = 2.0 * z - btd_matvec(Pinv, btd_matvec(S, z))
        return z

    def exit_test(r, eta):
        if exit_criterion == "rnorm":
            return jnp.vdot(r, r) < exit_tol * exit_tol
        return jnp.abs(eta) < exit_tol

    r0 = gamma - btd_matvec(S, lam0)
    z0 = apply_precond(r0)
    eta0 = jnp.vdot(r0, z0)

    def cond(state):
        lam, r, p, eta, it, done = state
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    def body(state):
        lam0_, r0_, p0_, eta0_, it0_, done0_ = state
        Sp = btd_matvec(S, p0_)
        pSp = jnp.vdot(p0_, Sp)
        alpha = eta0_ / pSp
        lam = lam0_ + alpha * p0_
        r = r0_ - alpha * Sp
        z = apply_precond(r)
        eta_new = jnp.vdot(r, z)
        done = exit_test(r, eta_new)
        beta = eta_new / eta0_
        p = z + beta * p0_
        # freeze finished lanes: under vmap the loop runs until ALL lanes
        # exit, so converged lanes must stop mutating to keep exact per-lane
        # iteration counts and iterates (batched-instance mode).
        keep = lambda new, old: jnp.where(done0_, old, new)
        return (
            keep(lam, lam0_),
            keep(r, r0_),
            keep(p, p0_),
            keep(eta_new, eta0_),
            keep(it0_ + 1, it0_),
            jnp.logical_or(done0_, done),
        )

    init = (lam0, r0, z0, eta0, jnp.int32(0), exit_test(r0, eta0))
    lam, r, p, eta, iters, done = jax.lax.while_loop(cond, body, init)
    return PCGResult(lam=lam, iters=iters, converged=done)
