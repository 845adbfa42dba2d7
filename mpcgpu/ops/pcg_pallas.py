"""Whole-solve PCG as one Pallas-Triton kernel launch (GPU).

The GPU counterpart of the reference's single cooperative PCG kernel
(GBD-PCG, launched at pcg/sqp.cuh:230): the entire CG loop of one solve runs
inside ONE program, so a solve costs one launch and no host round trip,
where ``ops.pcg.pcg_solve`` is a ``lax.while_loop`` of about ten small
fusions per iteration.  Exit semantics are those of ``pcg_solve``: the
``eta`` (|r . P^{-1} r| < tol) and ``rnorm`` (||r|| < tol) criteria, the
static cap, the warm start and exact iteration counts.

Layout and memory:

* Blocks are padded from n to ``nb`` (the next power of two, 16 for the
  IIWA's n = 14) with zero off-diagonal entries and an identity diagonal;
  knots are padded to a power of two with identity blocks, zero coupling and
  zero rhs.  Padded rows of r, z and p stay exactly zero, so eta and p.Sp do
  not change.
* One program solves one system.  Under ``vmap`` Pallas adds a grid axis
  over instances, so every instance exits on its own iteration count (the
  vmapped ``while_loop`` runs every lane to the slowest one).
* S and Pinv stay in device memory and are streamed through L2 in chunks of
  ``_CHUNK`` knots every iteration, which keeps the live tiles in registers
  at any horizon.  The CG vectors live in output buffers used as scratch;
  r and p carry one zero guard row at each end so that the neighbour rows
  of the block-tridiagonal matvec are plain shifted loads.
* Arithmetic is elementwise products and sums in float32: no ``dot``, so
  nothing can run in TF32.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from mpcgpu.ops.pcg import PCGResult
from mpcgpu.precision import highest_precision


# Knots per step of the in-kernel loops, and the program's warps: the best
# of a sweep over 32-128 knots and 4-16 warps on an H100 (see PERF.md).
_CHUNK = 64
_NUM_WARPS = 8


def _next_pow2(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def pad_btd(S, Pinv, gamma, lam0, chunk: int):
    """Pad a BTD system to power-of-two blocks and knots.

    Returns (S_p, P_p, g_p, l_p, chunk) with S_p/P_p (Np, 3, nb, nb) and
    g_p/l_p (Np, nb).  Padded diagonal entries are 1, everything else
    padded is 0, so padded rows of every CG vector stay exactly zero.
    """
    N, _, n, _ = S.shape
    nb = _next_pow2(n)
    chunk = min(_next_pow2(chunk), _next_pow2(N))
    Np = max(_next_pow2(N), chunk)
    dn, dN = nb - n, Np - N
    eye_pad = jnp.diag(jnp.concatenate(
        [jnp.zeros((n,), S.dtype), jnp.ones((dn,), S.dtype)]))
    diag_fill = jnp.eye(nb, dtype=S.dtype)

    def pad_mat(M):
        M = jnp.pad(M, ((0, dN), (0, 0), (0, dn), (0, dn)))
        real = (jnp.arange(Np) < N)[:, None, None]
        diag = jnp.where(real, M[:, 1] + eye_pad, diag_fill)
        return M.at[:, 1].set(diag)

    def pad_vec(v):
        return jnp.pad(v, ((0, dN), (0, dn)))

    return pad_mat(S), pad_mat(Pinv), pad_vec(gamma), pad_vec(lam0), chunk


def _make_kernel(Np: int, nb: int, chunk: int, max_iter: int,
                 exit_criterion: str, interpret: bool):
    C = chunk
    nchunks = Np // C

    def barrier():
        # the interpreter runs the program sequentially: nothing to order
        if not interpret:
            pltriton.debug_barrier()

    def for_chunks(fn, init):
        """Run fn(k0, acc) over the knot chunks, threading a scalar acc."""
        if nchunks == 1:
            return fn(0, init)
        return jax.lax.fori_loop(0, nchunks, lambda c, a: fn(c * C, a), init)

    def kernel(S_ref, P_ref, g_ref, lam0_ref, tol_ref,
               lam_ref, it_ref, conv_ref, r_ref, p_ref, w_ref):
        # r_ref / p_ref rows: 0 and Np+1 are zero guards, knot k is row k+1
        dtype = g_ref.dtype
        tol = tol_ref[0]
        zero = jnp.zeros((), dtype)

        def matvec(M_ref, x_ref, k0):
            """(M x) for knots [k0, k0+C) and x's own rows there."""
            x_prev = x_ref[pl.ds(k0, C), :]
            x_cur = x_ref[pl.ds(k0 + 1, C), :]
            x_next = x_ref[pl.ds(k0 + 2, C), :]
            y = jnp.sum(M_ref[pl.ds(k0, C), 1] * x_cur[:, None, :], axis=2)
            y = y + jnp.sum(M_ref[pl.ds(k0, C), 0] * x_prev[:, None, :], axis=2)
            y = y + jnp.sum(M_ref[pl.ds(k0, C), 2] * x_next[:, None, :], axis=2)
            return y, x_cur

        def exit_test(rr, eta):
            if exit_criterion == "rnorm":
                return rr < tol * tol
            return jnp.abs(eta) < tol

        guard = jnp.zeros((1, nb), dtype)
        for ref in (r_ref, p_ref):
            ref[pl.ds(0, 1), :] = guard
            ref[pl.ds(Np + 1, 1), :] = guard

        # p holds lam0 in the guarded layout for the initial residual
        def copy_lam0(k0, acc):
            lam = lam0_ref[pl.ds(k0, C), :]
            lam_ref[pl.ds(k0, C), :] = lam
            p_ref[pl.ds(k0 + 1, C), :] = lam
            return acc

        for_chunks(copy_lam0, zero)
        barrier()

        def init_residual(k0, rr):
            Sl, _ = matvec(S_ref, p_ref, k0)
            r = g_ref[pl.ds(k0, C), :] - Sl
            r_ref[pl.ds(k0 + 1, C), :] = r
            return rr + jnp.sum(r * r)

        rr0 = for_chunks(init_residual, zero)
        barrier()

        def precond(k0, eta):
            """z = Pinv r into w; returns eta + r.z over the chunk."""
            z, r = matvec(P_ref, r_ref, k0)
            w_ref[pl.ds(k0, C), :] = z
            return eta + jnp.sum(r * z)

        eta0 = for_chunks(precond, zero)
        barrier()

        def p_from_z(beta):
            def step(k0, acc):
                p = w_ref[pl.ds(k0, C), :] + beta * p_ref[pl.ds(k0 + 1, C), :]
                p_ref[pl.ds(k0 + 1, C), :] = p
                return acc
            return step

        # p = z0 (beta = 0; p currently holds lam0)
        def copy_z0(k0, acc):
            p_ref[pl.ds(k0 + 1, C), :] = w_ref[pl.ds(k0, C), :]
            return acc

        for_chunks(copy_z0, zero)
        barrier()

        def cond(state):
            it, _, done = state
            return jnp.logical_and(it < max_iter, jnp.logical_not(done))

        def body(state):
            it, eta, _ = state

            def spmv(k0, pSp):
                Sp, p = matvec(S_ref, p_ref, k0)
                w_ref[pl.ds(k0, C), :] = Sp
                return pSp + jnp.sum(p * Sp)

            pSp = for_chunks(spmv, zero)
            barrier()
            alpha = eta / pSp

            def update(k0, rr):
                p = p_ref[pl.ds(k0 + 1, C), :]
                r = r_ref[pl.ds(k0 + 1, C), :] - alpha * w_ref[pl.ds(k0, C), :]
                lam_ref[pl.ds(k0, C), :] = lam_ref[pl.ds(k0, C), :] + alpha * p
                r_ref[pl.ds(k0 + 1, C), :] = r
                return rr + jnp.sum(r * r)

            rr = for_chunks(update, zero)
            barrier()
            eta_new = for_chunks(precond, zero)
            barrier()
            for_chunks(p_from_z(eta_new / eta), zero)
            barrier()
            return it + 1, eta_new, exit_test(rr, eta_new)

        it, _, done = jax.lax.while_loop(
            cond, body, (jnp.int32(0), eta0, exit_test(rr0, eta0)))
        it_ref[0] = it
        conv_ref[0] = done.astype(jnp.int32)

    return kernel


@highest_precision
@partial(jax.jit, static_argnames=("max_iter", "exit_criterion", "interpret"))
def pcg_solve_pallas(S, Pinv, gamma, lam0, max_iter: int = 173, exit_tol=1e-6,
                     exit_criterion: str = "eta",
                     interpret: bool = False) -> PCGResult:
    """Drop-in for ``ops.pcg.pcg_solve`` (3-band preconditioners only).

    Args as in ``pcg_solve``; ``interpret=True`` runs the kernel in the
    Pallas interpreter (CPU tests).
    """
    if exit_criterion not in ("eta", "rnorm"):
        raise ValueError(f"unknown exit_criterion {exit_criterion!r}")
    if S.shape[1] != 3 or Pinv.shape[1] != 3:
        raise ValueError(
            f"pcg_solve_pallas needs 3-band BTD operands; got S bands "
            f"{S.shape[1]}, Pinv bands {Pinv.shape[1]} (use ops.pcg.pcg_solve)")
    N, n = gamma.shape
    dtype = gamma.dtype
    S_p, P_p, g_p, l_p, chunk = pad_btd(S, Pinv, gamma, lam0, _CHUNK)
    Np, nb = g_p.shape
    tol = jnp.reshape(jnp.asarray(exit_tol, dtype), (1,))
    vec = jax.ShapeDtypeStruct((Np, nb), dtype)
    guarded = jax.ShapeDtypeStruct((Np + 2, nb), dtype)
    flag = jax.ShapeDtypeStruct((1,), jnp.int32)
    lam, iters, conv, _, _, _ = pl.pallas_call(
        _make_kernel(Np, nb, chunk, max_iter, exit_criterion, interpret),
        out_shape=(vec, flag, flag, guarded, guarded, vec),
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        backend="triton",
        name="pcg_solve_pallas",
    )(S_p, P_p, g_p, l_p, tol)
    return PCGResult(lam=lam[:N, :n], iters=iters[0],
                     converged=conv[0].astype(jnp.bool_))
