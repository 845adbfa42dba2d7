"""Knot-sharded PCG: the BTD Schur system row-partitioned across devices.

The horizon axis is the reference's defining parallel axis (one CUDA block
per knot, SURVEY.md section 2); across devices it becomes sequence parallelism:
each device owns a contiguous slab of knot block-rows.  Per PCG iteration the
BTD SpMV and the stair preconditioner apply need only each neighbor's
boundary block-vector rows — O(1) communication via a `ppermute` ring (over
NVLink every GPU reaches every other at the same rate, so the ring follows
the knot order alone) — and the CG dot products reduce with `psum`
(BASELINE configs[4], SURVEY.md section 5 "long-context/sequence
parallelism").

Two iteration formulations (`shard_map` over the ``knot`` mesh axis; the
while_loop runs identically on every device):

* ``method="classic"``: textbook PCG — two halo exchanges + two DEPENDENT
  psums per iteration (alpha's dot must land before the beta dot can start).
* ``method="pipelined"`` (default): the Chronopoulos-Gear single-reduction
  formulation.  Both dot products (plus ||r||^2 for the rnorm exit) fuse
  into ONE psum of a stacked scalar triple, and the two chained halo
  exchanges collapse into ONE bidirectional exchange of TWO-row packets:
  since Pinv and S are both block-tridiagonal, u = Pinv r on rows [-1, L]
  needs r rows [-2, L+1], after which w = S u is entirely local.  The
  neighbors' boundary Pinv rows are loop-invariant and exchanged once
  before the loop.  Interior compute is written against purely local
  slices (no concatenate with halo results), so XLA's latency-hiding
  scheduler overlaps the ppermutes with it.  Exit semantics (eta and the
  reference's rnorm, SURVEY.md C17) and iteration counts match classic
  exactly; iterates agree to reassociation-level rounding.

Collective budget per iteration: classic 4 ppermutes + 2 psums (3 for
rnorm); pipelined 2 ppermutes + 1 psum — asserted structurally in
tests/test_parallel.py by counting collectives in the while-body jaxpr.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mpcgpu.ops.pcg import PCGResult
from mpcgpu.precision import highest_precision


def _halo_rows(x_loc, axis_name: str):
    """Exchange boundary rows with ring neighbors.

    Returns (from_left (n,), from_right (n,)): the left neighbor's LAST row
    and the right neighbor's FIRST row.  Ring wraparound rows are multiplied
    by the (structurally zero) corner blocks S[0,0] / S[N-1,2], so no masking
    is needed.
    """
    n_dev = jax.lax.axis_size(axis_name)
    perm_fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]   # send to right
    perm_bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]   # send to left
    from_left = jax.lax.ppermute(x_loc[-1], axis_name, perm_fwd)
    from_right = jax.lax.ppermute(x_loc[0], axis_name, perm_bwd)
    return from_left, from_right


def btd_matvec_halo(S_loc, x_loc, axis_name: str):
    """Local slab of y = S @ x with halo exchange (overlappable with the
    interior diag/off-diag compute by XLA's latency-hiding scheduler)."""
    from_left, from_right = _halo_rows(x_loc, axis_name)
    x_prev = jnp.concatenate([from_left[None], x_loc[:-1]], axis=0)
    x_next = jnp.concatenate([x_loc[1:], from_right[None]], axis=0)
    return (
        jnp.einsum("kij,kj->ki", S_loc[:, 1], x_loc)
        + jnp.einsum("kij,kj->ki", S_loc[:, 0], x_prev)
        + jnp.einsum("kij,kj->ki", S_loc[:, 2], x_next)
    )


def _pdot(a, b, axis_name: str):
    return jax.lax.psum(jnp.vdot(a, b), axis_name)


def _pcg_local(S_loc, Pinv_loc, gamma_loc, lam_loc, max_iter: int, exit_tol,
               axis_name: str, exit_criterion: str = "eta"):
    matvec = lambda M, x: btd_matvec_halo(M, x, axis_name)
    dot = lambda a, b: _pdot(a, b, axis_name)
    dtype = gamma_loc.dtype
    exit_tol = jnp.asarray(exit_tol, dtype)

    def exit_test(r, eta):
        # "rnorm" = the reference/GBD-PCG ||r|| < tol (SURVEY.md C17);
        # the extra psum'd dot rides the same latency window as eta's.
        if exit_criterion == "rnorm":
            return dot(r, r) < exit_tol * exit_tol
        return jnp.abs(eta) < exit_tol

    r0 = gamma_loc - matvec(S_loc, lam_loc)
    z0 = matvec(Pinv_loc, r0)
    eta0 = dot(r0, z0)

    def cond(state):
        *_, it, done = state
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    def body(state):
        lam, r, p, eta, it, _ = state
        Sp = matvec(S_loc, p)
        alpha = eta / dot(p, Sp)
        lam = lam + alpha * p
        r = r - alpha * Sp
        z = matvec(Pinv_loc, r)
        eta_new = dot(r, z)
        done = exit_test(r, eta_new)
        p = z + (eta_new / eta) * p
        return (lam, r, p, eta_new, it + 1, done)

    init = (lam_loc, r0, z0, eta0, jnp.int32(0), exit_test(r0, eta0))
    lam, _, _, _, iters, done = jax.lax.while_loop(cond, body, init)
    return lam, iters, done


def _halo_rows2(x_loc, axis_name: str):
    """One bidirectional exchange of TWO-row packets: returns
    (from_left (2, n) = left neighbor's last two rows,
     from_right (2, n) = right neighbor's first two rows)."""
    n_dev = jax.lax.axis_size(axis_name)
    perm_fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    perm_bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    from_left = jax.lax.ppermute(x_loc[-2:], axis_name, perm_fwd)
    from_right = jax.lax.ppermute(x_loc[:2], axis_name, perm_bwd)
    return from_left, from_right


def _blockmv(M, v):
    """(n, n) @ (n,)."""
    return M @ v


def _pcg_local_pipelined(S_loc, Pinv_loc, gamma_loc, lam_loc, max_iter: int,
                         exit_tol, axis_name: str,
                         exit_criterion: str = "eta"):
    """Chronopoulos-Gear PCG: 1 psum + 1 bidirectional 2-row halo exchange
    per iteration.  Identical exit semantics and iteration counts as
    _pcg_local (see module docstring)."""
    dtype = gamma_loc.dtype
    exit_tol = jnp.asarray(exit_tol, dtype)
    L = gamma_loc.shape[0]

    # loop-invariant: the neighbors' boundary Pinv block-rows (needed to
    # evaluate u = Pinv r at rows -1 and L).  Exchanged ONCE.
    n_dev = jax.lax.axis_size(axis_name)
    perm_fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    perm_bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    PinvL = jax.lax.ppermute(Pinv_loc[-1], axis_name, perm_fwd)  # (3, n, n)
    PinvR = jax.lax.ppermute(Pinv_loc[0], axis_name, perm_bwd)

    def dual_apply(r):
        """u = Pinv r (local rows) and w = S u, with ONE halo exchange.

        Ring-wrap garbage at the global edges is annihilated by the
        structurally-zero corner blocks (Pinv[0,0] = S[0,0] = 0 at the
        global first row; Pinv[N-1,2] = S[N-1,2] = 0 at the last)."""
        fl, fr = _halo_rows2(r, axis_name)          # issued first: overlaps
        # interior of u: purely local slices, independent of the halo
        u = jnp.einsum("kij,kj->ki", Pinv_loc[:, 1], r)
        u = u.at[1:].add(jnp.einsum("kij,kj->ki", Pinv_loc[1:, 0], r[:-1]))
        u = u.at[:-1].add(jnp.einsum("kij,kj->ki", Pinv_loc[:-1, 2], r[1:]))
        # boundary contributions (first touch of the halo data)
        u = u.at[0].add(_blockmv(Pinv_loc[0, 0], fl[1]))
        u = u.at[-1].add(_blockmv(Pinv_loc[-1, 2], fr[0]))
        # off-slab u rows from the neighbors' (loop-invariant) Pinv rows
        u_m1 = (_blockmv(PinvL[0], fl[0]) + _blockmv(PinvL[1], fl[1])
                + _blockmv(PinvL[2], r[0]))
        u_Lp = (_blockmv(PinvR[0], r[-1]) + _blockmv(PinvR[1], fr[0])
                + _blockmv(PinvR[2], fr[1]))
        w = jnp.einsum("kij,kj->ki", S_loc[:, 1], u)
        w = w.at[1:].add(jnp.einsum("kij,kj->ki", S_loc[1:, 0], u[:-1]))
        w = w.at[:-1].add(jnp.einsum("kij,kj->ki", S_loc[:-1, 2], u[1:]))
        w = w.at[0].add(_blockmv(S_loc[0, 0], u_m1))
        w = w.at[-1].add(_blockmv(S_loc[-1, 2], u_Lp))
        return u, w

    def reduce3(r, u, w):
        """ONE psum: (eta = r.u, d = w.u, rr = r.r) stacked."""
        loc = jnp.stack([jnp.vdot(r, u), jnp.vdot(w, u), jnp.vdot(r, r)])
        tot = jax.lax.psum(loc, axis_name)
        return tot[0], tot[1], tot[2]

    def exit_test(eta, rr):
        if exit_criterion == "rnorm":
            return rr < exit_tol * exit_tol
        return jnp.abs(eta) < exit_tol

    r0 = gamma_loc - btd_matvec_halo(S_loc, lam_loc, axis_name)
    u0, w0 = dual_apply(r0)
    eta0, d0, rr0 = reduce3(r0, u0, w0)
    one = jnp.ones((), dtype)

    def cond(state):
        return jnp.logical_and(state[-2] < max_iter,
                               jnp.logical_not(state[-1]))

    def body(state):
        x, r, u, w, eta, d, eta_prev, alpha_prev, p, s, it, _ = state
        first = it == 0
        beta = jnp.where(first, jnp.zeros((), dtype), eta / eta_prev)
        denom = jnp.where(first, d, d - beta * eta / alpha_prev)
        alpha = eta / denom
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        u, w = dual_apply(r)                    # 1 halo exchange
        eta_n, d_n, rr_n = reduce3(r, u, w)     # 1 psum
        done = exit_test(eta_n, rr_n)
        return (x, r, u, w, eta_n, d_n, eta, alpha, p, s, it + 1, done)

    init = (lam_loc, r0, u0, w0, eta0, d0, one, one,
            jnp.zeros_like(r0), jnp.zeros_like(r0), jnp.int32(0),
            exit_test(eta0, rr0))
    out = jax.lax.while_loop(cond, body, init)
    return out[0], out[-2], out[-1]


def _matvec_ext(M_ext, x_ext):
    """BTD matvec on a halo-EXTENDED slab with zero (not ring) ends.

    The end lanes produce garbage that propagates inward one lane per
    application — by construction the halo depth exceeds the total number
    of applications, so the local lanes stay exact (see _pcg_local_ca)."""
    y = jnp.einsum("kij,kj->ki", M_ext[:, 1], x_ext)
    y = y.at[1:].add(jnp.einsum("kij,kj->ki", M_ext[1:, 0], x_ext[:-1]))
    y = y.at[:-1].add(jnp.einsum("kij,kj->ki", M_ext[:-1, 2], x_ext[1:]))
    return y


def _ca_shift_matrix(s: int, dtype):
    """Coefficient-space image of one P^-1 S application on the monomial
    basis [v_0..v_s, w_0..w_{s-1}]: T e_{v_j} = e_{v_{j+1}}, T e_{w_j} =
    e_{w_{j+1}}.  Rows v_s / w_{s-1} are never produced by the inner
    recurrences (degree argument in _pcg_local_ca's docstring)."""
    m = 2 * s + 1
    T = jnp.zeros((m, m), dtype)
    for j in range(s):
        T = T.at[j + 1, j].set(1)
    for j in range(s - 1):
        T = T.at[s + 1 + j + 1, s + 1 + j].set(1)
    return T


def _ca_coeff_iters(G, b, F, f, rr0, gT, eta, it, done, s: int,
                    max_iter: int, exit_test, dtype):
    """The s masked exact-CG iterations in (2s+1)-dim coefficient space.

    Runs identically on every device (all inputs are psum'd/global).
    Returns (e, a, c, eta, it, done): e = coefficients of x - x_0 in Y,
    a = of p, c = of z.  See _pcg_local_ca for the derivation."""
    m = 2 * s + 1
    e = jnp.zeros((m,), dtype)
    a = jnp.zeros((m,), dtype).at[0].set(1)        # p = v_0
    c = jnp.zeros((m,), dtype).at[s + 1].set(1)    # z = w_0
    for _ in range(s):
        act = jnp.logical_and(jnp.logical_not(done), it < max_iter)
        denom = a @ (G @ a)
        denom = jnp.where(denom == 0, jnp.ones((), dtype), denom)
        alpha = eta / denom
        e_n = e + alpha * a
        c_n = c - alpha * (gT @ a)
        eta_n = b @ c_n - e_n @ (G @ c_n)
        rr_n = rr0 - 2 * (f @ e_n) + e_n @ (F @ e_n)
        beta = eta_n / jnp.where(eta == 0, jnp.ones((), dtype), eta)
        a_n = c_n + beta * a
        done_n = exit_test(eta_n, rr_n)
        sel = lambda new, old: jnp.where(act, new, old)
        e, c, a = sel(e_n, e), sel(c_n, c), sel(a_n, a)
        eta = sel(eta_n, eta)
        it = it + act.astype(jnp.int32)
        done = jnp.logical_or(done, jnp.logical_and(act, done_n))
    return e, a, c, eta, it, done


def _ca_next_scale(G, g, s: int, dtype):
    """Next basis scale from the psum'd Gram: measured per-application norm
    growth of the scaled v-chain (diag(G)[j] = v_j . S v_j ~ ||v_j||^2 up
    to the S Rayleigh quotient).  Identical on every device."""
    ratio = jnp.abs(G[s, s]) / jnp.maximum(jnp.abs(G[0, 0]),
                                           jnp.finfo(dtype).tiny)
    g_n = g * ratio ** (1 / (2 * s))
    g_n = jnp.clip(g_n, 1e-6, 1e6)
    return jnp.where(jnp.isfinite(g_n), g_n, g).astype(dtype)


def _pcg_local_ca(S_loc, Pinv_loc, gamma_loc, lam_loc, max_iter: int,
                  exit_tol, axis_name: str, exit_criterion: str = "eta",
                  s_steps: int = 4):
    """Communication-avoiding s-step PCG: s exact-CG-equivalent iterations
    per ONE wide halo exchange (2 ppermutes) + ONE psum.

    Algebra (derived for this solver; the s-step idea is Chronopoulos-Gear
    1989 / CA-CG): per outer step build the monomial bases
        V = [p, (P^-1 S)p, ..., (P^-1 S)^s p]          (s+1 vectors)
        W = [z, (P^-1 S)z, ..., (P^-1 S)^{s-1} z]      (s vectors)
    with the S-images Ytil = S [V|W] computed alongside.  By induction the
    CG vectors of the next s iterations stay in span(Y), Y = [V|W]:
    p_j needs v up to j and w up to j-1 (p_0 = v_0; z_{j+1} = z_j -
    alpha_j (P^-1 S) p_j raises each degree by one; the last application,
    to p_{s-1}, reaches exactly v_s / w_{s-1}).  With coefficient vectors
    p_j = Y a_j, z_j = Y c_j, x_j = x_0 + Y e_j, r_j = r_0 - Ytil e_j, the
    CG scalars need only the Gram data
        G = Y^T S Y = Y^T Ytil,  b = Y^T r_0
        (rnorm exit additionally: F = Ytil^T Ytil, f = Ytil^T r_0, r_0.r_0)
    which reduce in ONE psum; the s iterations then advance in m=2s+1
    dimensional coefficient space identically on every device:
        alpha_j = eta_j / (a_j G a_j),   e += alpha a,   c -= alpha T a,
        eta_{j+1} = b.c - e.(G c),       beta = eta_{j+1}/eta_j,
        a = c + beta a,
    (T = _ca_shift_matrix) and the slab vectors are recovered locally:
    x += Y e, r -= Ytil e, z = Y c, p = Y a.

    Halo structure: basis generation applies S/P^-1 at most 2s+1 times, so
    an extension of h = 2s+1 knots per side (p/z rows exchanged per outer
    step, S/Pinv halo BLOCKS loop-invariant and exchanged once) keeps the
    local lanes exact: end-lane garbage propagates one lane inward per
    application, and at the global edges the structurally-zero corner
    blocks S[0,0]/Pinv[0,0] (resp. [N-1,2]) annihilate the ring-wrap rows
    exactly as in the per-iteration methods.

    Exit semantics and iteration counts match exact CG in exact
    arithmetic; in floating point the monomial basis reorders the same
    arithmetic (iterates agree to f32/f64 rounding-accumulation for
    moderate s — validated against pcg_solve in tests/test_parallel.py).
    Collective budget: 2 ppermutes + 1 psum per s ITERATIONS (the
    per-iteration methods pay 2 ppermutes + 1 psum per iteration).
    """
    dtype = gamma_loc.dtype
    exit_tol = jnp.asarray(exit_tol, dtype)
    L, n = gamma_loc.shape
    s = s_steps
    h = 2 * s + 1          # halo depth
    m = 2 * s + 1          # basis size

    n_dev = jax.lax.axis_size(axis_name)
    perm_fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    perm_bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    # loop-invariant: h-deep halo BLOCKS of S and Pinv (2x2 ppermutes, once)
    def ext_blocks(M):
        left = jax.lax.ppermute(M[-h:], axis_name, perm_fwd)
        right = jax.lax.ppermute(M[:h], axis_name, perm_bwd)
        return jnp.concatenate([left, M, right], axis=0)

    S_ext = ext_blocks(S_loc)
    P_ext = ext_blocks(Pinv_loc)
    T = _ca_shift_matrix(s, dtype)

    def exit_test(eta, rr):
        if exit_criterion == "rnorm":
            return rr < exit_tol * exit_tol
        return jnp.abs(eta) < exit_tol

    def basis_and_gram(p, z, r, g):
        """2 ppermutes + the local basis chains + Gram partials.

        `g` is a GLOBAL scalar (identical on every device: derived from the
        previous outer step's psum'd Gram) that rescales each basis step,
        v_{j+1} = (P^-1 S v_j)/g, keeping f32 basis-vector norms O(1); in
        coefficient space P^-1 S then acts as g*T (see body)."""
        pkt_last = jnp.stack([p[-h:], z[-h:]])      # (2, h, n)
        pkt_first = jnp.stack([p[:h], z[:h]])
        fl = jax.lax.ppermute(pkt_last, axis_name, perm_fwd)
        fr = jax.lax.ppermute(pkt_first, axis_name, perm_bwd)
        p_ext = jnp.concatenate([fl[0], p, fr[0]], axis=0)
        z_ext = jnp.concatenate([fl[1], z, fr[1]], axis=0)
        ginv = 1 / g
        # NOTE: Vt[j] must stay the EXACT S-image of V[j] (it feeds
        # G = Y^T Ytil and r = r0 - Ytil e), so the rescale rides the
        # P^-1 step: v_{j+1} = (P^-1 (S v_j)) / g.
        V, Vt = [p_ext], []
        for _ in range(s):
            Vt.append(_matvec_ext(S_ext, V[-1]))
            V.append(_matvec_ext(P_ext, Vt[-1]) * ginv)
        Vt.append(_matvec_ext(S_ext, V[-1]))
        W, Wt = [z_ext], []
        for _ in range(s - 1):
            Wt.append(_matvec_ext(S_ext, W[-1]))
            W.append(_matvec_ext(P_ext, Wt[-1]) * ginv)
        Wt.append(_matvec_ext(S_ext, W[-1]))
        Y = jnp.stack(V + W)[:, h:h + L]            # (m, L, n) local lanes
        Yt = jnp.stack(Vt + Wt)[:, h:h + L]
        # Gram partials packed for ONE psum: rows [G | b ; F | f ; rr0 | 0]
        G = jnp.einsum("alk,blk->ab", Y, Yt)
        b = jnp.einsum("alk,lk->a", Y, r)
        F = jnp.einsum("alk,blk->ab", Yt, Yt)
        f = jnp.einsum("alk,lk->a", Yt, r)
        rr0 = jnp.vdot(r, r)
        packed = jnp.concatenate([
            jnp.concatenate([G, b[:, None]], axis=1),
            jnp.concatenate([F, f[:, None]], axis=1),
            jnp.zeros((1, m + 1), dtype).at[0, 0].set(rr0),
        ], axis=0)
        tot = jax.lax.psum(packed, axis_name)       # 1 psum
        return Y, Yt, tot[:m, :m], tot[:m, m], tot[m:2 * m, :m], \
            tot[m:2 * m, m], tot[2 * m, 0]

    # init: true r0/z0 with per-iteration halos (one-time), matching
    # _pcg_local's init semantics (exit check before any iteration)
    r0 = gamma_loc - btd_matvec_halo(S_loc, lam_loc, axis_name)
    z0 = btd_matvec_halo(Pinv_loc, r0, axis_name)
    loc0 = jnp.stack([jnp.vdot(r0, z0), jnp.vdot(r0, r0)])
    tot0 = jax.lax.psum(loc0, axis_name)
    eta_init, rr_init = tot0[0], tot0[1]

    def cond(state):
        *_, it, done = state
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    def body(state):
        x, r, z, p, eta, g, it, done = state
        Y, Yt, G, b, F, f, rr0 = basis_and_gram(p, z, r, g)
        e, a, c, eta, it, done = _ca_coeff_iters(
            G, b, F, f, rr0, g * T, eta, it, done, s, max_iter, exit_test,
            dtype)
        # local recovery
        x = x + jnp.einsum("a,alk->lk", e, Y)
        r = r - jnp.einsum("a,alk->lk", e, Yt)
        z = jnp.einsum("a,alk->lk", c, Y)
        p = jnp.einsum("a,alk->lk", a, Y)
        g = _ca_next_scale(G, g, s, dtype)
        return (x, r, z, p, eta, g, it, done)

    init = (lam_loc, r0, z0, z0, eta_init, jnp.ones((), dtype), jnp.int32(0),
            exit_test(eta_init, rr_init))
    out = jax.lax.while_loop(cond, body, init)
    x, iters, done = out[0], out[-2], out[-1]
    return x, iters, done


@highest_precision
def pcg_solve_sharded(
    S, Pinv, gamma, lam0, mesh: Mesh, max_iter: int = 173, exit_tol=1e-6,
    knot_axis: str = "knot", exit_criterion: str = "eta",
    method: str = "pipelined", s_steps: int = 4,
) -> PCGResult:
    """Solve S lam = gamma with knot blocks sharded over ``mesh[knot_axis]``.

    Shapes as in ops/pcg.py; N must be divisible by the knot axis size.
    method: "pipelined" (1 psum + 1 halo exchange per iteration, default)
    or "classic" (the textbook 2-psum formulation) — see module docstring.
    The pipelined form needs slab length >= 2 (its halo packets carry two
    boundary rows); at L == 1 it falls back to classic automatically.

    method="ca": communication-avoiding s-step CG — s exact-CG
    iterations per ONE wide halo exchange + ONE psum (collective budget
    divided by s; per-shard basis compute batchable into one kernel region
    per s iterations).  `s_steps` picks s (default 4; halo depth 2s+1, so
    slabs must be >= 2s+1 knots or it falls back to pipelined).  See
    _pcg_local_ca for the algebra and the floating-point caveat (monomial
    basis; iterates match exact CG to rounding for moderate s).
    """
    if method == "pipelined" and S.shape[0] < 2 * mesh.shape[knot_axis]:
        # the pipelined halo packets carry two boundary rows; a one-row slab
        # would fail at trace time — classic only needs
        # single-row halos
        method = "classic"
    if method == "ca" and \
            S.shape[0] < (2 * s_steps + 1) * mesh.shape[knot_axis]:
        # the s-step halo packets carry 2s+1 boundary rows per side
        method = "pipelined"
    if method == "ca":
        impl = partial(_pcg_local_ca, s_steps=s_steps)
    elif method == "pipelined":
        impl = _pcg_local_pipelined
    elif method == "classic":
        impl = _pcg_local
    else:
        raise ValueError(f"unknown method {method!r}")
    fn = shard_map(
        partial(impl, max_iter=max_iter, exit_tol=exit_tol,
                axis_name=knot_axis, exit_criterion=exit_criterion),
        mesh=mesh,
        in_specs=(P(knot_axis), P(knot_axis), P(knot_axis), P(knot_axis)),
        out_specs=(P(knot_axis), P(), P()),
    )
    lam, iters, done = fn(S, Pinv, gamma, lam0)
    return PCGResult(lam=lam, iters=iters, converged=done)
