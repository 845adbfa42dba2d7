"""Knot-sharded FULL SQP iteration: the entire solve as one SPMD program.

Extends parallel/pcg_sharded.py (which shards only the linear solve) to the
whole pipeline for long horizons spanning several devices (BASELINE
configs[4]: N=512 row-partitioned with halo exchange): KKT assembly and cost
blocks are embarrassingly knot-parallel; the Schur condensation, dz recovery,
and merit defects each need exactly ONE neighbor block-row per stage (the
coupling is block-tridiagonal), exchanged between ring neighbours with
`ppermute`; the line-search merits and CG dot products reduce with `psum`.
Over NVLink every GPU reaches every other at the same rate, so the ring
follows the knot order alone.

Communication per SQP iteration: 1 halo packet (Schur), 2 block halos
(stair preconditioner), 2 ppermutes + 2 psums per PCG iteration, 1 halo
(dz), 1 halo + 1 psum (line search) — all O(block size), independent of the
local slab length.

Semantics match solver/sqp.py::sqp_solve (linsys="pcg", stair
preconditioner) — tests/test_parallel.py checks equality on the virtual CPU
mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu.models.robot import RobotModel
from mpcgpu.ops.smallmat import gj_inverse
from mpcgpu.parallel.pcg_sharded import (
    _pcg_local, _pcg_local_ca, _pcg_local_pipelined)
from mpcgpu.precision import highest_precision
from mpcgpu.solver.kkt import euler_step_and_jacobians, tracking_cost_grad_hess
from mpcgpu.solver.sqp import SQPResult


def _send_right(x, axis):
    """Every shard receives its LEFT neighbor's value (ring)."""
    n = jax.lax.axis_size(axis)
    return jax.lax.ppermute(x, axis, [(i, (i + 1) % n) for i in range(n)])


def _send_left(x, axis):
    """Every shard receives its RIGHT neighbor's value (ring)."""
    n = jax.lax.axis_size(axis)
    return jax.lax.ppermute(x, axis, [(i, (i - 1) % n) for i in range(n)])


@highest_precision
def sqp_solve_sharded(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    xu, lam, xs, ee_goal, rho, dt,
    mesh: Mesh,
    integrator_type: int = 0,
    knot_axis: str = "knot",
    iter_budget=None,
    pcg_method: str = "pipelined",
    pcg_s_steps: int = 4,
) -> SQPResult:
    """Full SQP solve with (N, ...) arrays sharded over mesh[knot_axis].

    iter_budget: optional TRACED iteration cap <= sqp_cfg.max_iter — the
    on-device sqpTimecheck equivalent (pcg/sqp.cuh:161-169), same semantics
    as solver/sqp.py::sqp_solve's iter_budget: the MPC layer converts
    SQP_MAX_TIME_US into an iteration count via one-time calibration.

    pcg_method: "pipelined" (Chronopoulos-Gear, 1 psum + 1 halo exchange
    per CG iteration; the default), "classic", or the s-step
    communication-avoiding form "ca" (ONE psum + ONE halo exchange per
    `pcg_s_steps` ITERATIONS) — see parallel/pcg_sharded.py.  Slabs
    narrower than the 2s+1 halo fall back to "pipelined".
    """
    N = xu.shape[0]
    nq = model.nq
    nx = 2 * nq
    dtype = xu.dtype
    n_shard = mesh.shape[knot_axis]
    if N % n_shard:
        raise ValueError(f"N={N} not divisible by {n_shard} knot shards")
    if pcg_cfg.preconditioner not in ("stair", "jacobi", "none"):
        raise ValueError(f"unknown preconditioner {pcg_cfg.preconditioner!r}")
    L = N // n_shard
    mu = jnp.asarray(sqp_cfg.mu, dtype)
    dt = jnp.asarray(dt, dtype)
    alphas = jnp.concatenate([
        jnp.zeros((1,), dtype), -1.0 / (2.0 ** jnp.arange(sqp_cfg.num_alphas, dtype=dtype))
    ])
    if pcg_method == "ca" and L < 2 * pcg_s_steps + 1:
        pcg_method = "pipelined"       # halo packets carry 2s+1 rows/side
    if pcg_method == "ca":
        _pcg_impl = partial(_pcg_local_ca, s_steps=pcg_s_steps)
    elif pcg_method == "pipelined":
        _pcg_impl = _pcg_local_pipelined
    elif pcg_method == "classic":
        _pcg_impl = _pcg_local
    else:
        raise ValueError(f"unknown pcg_method {pcg_method!r}")

    def local(xu_loc, lam_loc, ee_loc, xs_rep, rho0, iter_bound):
        ax = knot_axis
        shard = jax.lax.axis_index(ax)
        gpos = shard * L + jnp.arange(L)                 # global knot indices
        is_g0 = (gpos == 0)
        is_gl = (gpos == N - 1)

        def build_blocks(xu_loc):
            x = xu_loc[:, :nx]
            u = xu_loc[:, nx:]
            xnext, A, B = jax.vmap(
                lambda xx, uu: euler_step_and_jacobians(model, xx, uu, dt,
                                                        integrator_type)
            )(x, u)
            # terminal-eval quirk (solver/kkt.py:164-167): with
            # terminal_at_last_state=False the global LAST knot's cost blocks
            # are evaluated at x_{N-2} — the previous local row, or the left
            # neighbor's last row when the slab length is 1
            x_eval = x
            if not cost.terminal_at_last_state:
                prev_row = (x[-2] if L >= 2 else _send_right(x[-1], ax))
                x_eval = jnp.where(
                    is_gl[:, None],
                    jnp.broadcast_to(prev_row[None, :], x.shape), x)
            Q, q, R, r = jax.vmap(
                lambda xx, uu, gg: tracking_cost_grad_hess(model, cost, xx, uu, gg)
            )(x_eval, u, ee_loc)
            # defect c_k = x_k - xnext_{k-1}; global row 0: x_0 - xs
            xnext_left = _send_right(xnext[-1], ax)
            xnext_prev = jnp.concatenate([xnext_left[None], xnext[:-1]], axis=0)
            c = jnp.where(is_g0[:, None], x - xs_rep[None, :], x - xnext_prev)
            return x, u, xnext, A, B, Q, q, R, r, c

        def form_schur(A, B, Q, q, R, r, c, rho):
            eyex = jnp.eye(nx, dtype=dtype)
            eyeu = jnp.eye(nq, dtype=dtype)
            Qinv = gj_inverse(Q + rho * eyex)
            Rinv = gj_inverse(R + rho * eyeu)
            AQ = jnp.einsum("kij,kjl->kil", A, Qinv)
            BR = jnp.einsum("kij,kjl->kil", B, Rinv)
            T = (jnp.einsum("kij,klj->kil", AQ, A)
                 + jnp.einsum("kij,klj->kil", BR, B))
            aqq = jnp.einsum("kij,kj->ki", AQ, q)
            brr = jnp.einsum("kij,kj->ki", BR, r)
            # one packed halo from the left neighbor
            packet = (T[-1], AQ[-1], aqq[-1], brr[-1])
            T_l, AQ_l, aqq_l, brr_l = _send_right(packet, ax)
            T_prev = jnp.concatenate([T_l[None], T[:-1]], axis=0)
            AQ_prev = jnp.concatenate([AQ_l[None], AQ[:-1]], axis=0)
            aqq_prev = jnp.concatenate([aqq_l[None], aqq[:-1]], axis=0)
            brr_prev = jnp.concatenate([brr_l[None], brr[:-1]], axis=0)
            z_blk = jnp.zeros((nx, nx), dtype)
            theta = Qinv + jnp.where(is_g0[:, None, None], 0.0, T_prev)
            phi = jnp.where(is_g0[:, None, None], z_blk, -AQ_prev)
            phiT = jnp.where(is_gl[:, None, None], z_blk,
                             -jnp.swapaxes(AQ, -1, -2))
            gamma = jnp.einsum("kij,kj->ki", Qinv, q) - jnp.where(
                is_g0[:, None], 0.0, c + aqq_prev + brr_prev)
            S = jnp.stack([phi, theta, phiT], axis=1)
            zero3 = jnp.zeros_like(S[:, 0])
            if pcg_cfg.preconditioner == "none":
                eyeblk = jnp.broadcast_to(eyex, S[:, 1].shape)
                Pinv = jnp.stack([zero3, eyeblk, zero3], axis=1)
                return S, Pinv, gamma, Qinv, Rinv
            D = gj_inverse(theta)
            if pcg_cfg.preconditioner == "jacobi":
                Pinv = jnp.stack([zero3, D, zero3], axis=1)
                return S, Pinv, gamma, Qinv, Rinv
            # stair preconditioner: off-diags need both neighbors' D
            D_l = _send_right(D[-1], ax)
            D_r = _send_left(D[0], ax)
            D_prev = jnp.concatenate([D_l[None], D[:-1]], axis=0)
            D_next = jnp.concatenate([D[1:], D_r[None]], axis=0)
            left = jnp.where(is_g0[:, None, None], z_blk,
                             -jnp.einsum("kij,kjl,klm->kim", D, phi, D_prev))
            right = jnp.where(is_gl[:, None, None], z_blk,
                              -jnp.einsum("kij,kjl,klm->kim", D, phiT, D_next))
            Pinv = jnp.stack([left, D, right], axis=1)
            return S, Pinv, gamma, Qinv, Rinv

        def compute_dz(A, B, q, r, Qinv, Rinv, lam_loc):
            lam_r = _send_left(lam_loc[0], ax)
            lam_next = jnp.concatenate([lam_loc[1:], lam_r[None]], axis=0)
            at_lam = jnp.einsum("kji,kj->ki", A, lam_next)
            rhs_x = q - lam_loc + jnp.where(is_gl[:, None], 0.0, at_lam)
            dx = jnp.einsum("kij,kj->ki", Qinv, rhs_x)
            bt_lam = jnp.einsum("kji,kj->ki", B, lam_next)
            du = jnp.einsum("kij,kj->ki", Rinv, r + bt_lam)
            du = jnp.where(is_gl[:, None], 0.0, du)
            return jnp.concatenate([dx, du], axis=-1)

        def merits_of(xu_loc, dz_loc):
            """l1-penalty merits of all alphas; one halo + one psum."""
            from mpcgpu.solver.kkt import integrator_step

            # next global knot's candidate state, per alpha
            x0r, dz0r = _send_left((xu_loc[0, :nx], dz_loc[0, :nx]), ax)

            def one(alpha):
                cand = xu_loc + alpha * dz_loc
                x, u = cand[:, :nx], cand[:, nx:]
                xn = jax.vmap(lambda xx, uu: integrator_step(
                    model, xx, uu, dt, integrator_type))(x, u)
                x_next = jnp.concatenate(
                    [x[1:], (x0r + alpha * dz0r)[None]], axis=0)
                defect = jnp.sum(jnp.abs(x_next - xn), axis=-1)
                defect = jnp.where(is_gl, 0.0, defect)
                from mpcgpu.solver.merit import tracking_cost

                J = tracking_cost(model, cost, cand, ee_loc)
                # tracking_cost masks its own last row's control term by
                # LOCAL position; correct globally only at the last shard —
                # add the dropped term back elsewhere
                u_last = cand[-1, nx:]
                extra = 0.5 * cost.r_cost * jnp.sum(u_last**2)
                J = J + jnp.where(shard == n_shard - 1, 0.0, extra)
                x0_res = jnp.where(
                    shard == 0, jnp.sum(jnp.abs(x[0] - xs_rep)), 0.0)
                return J + mu * (jnp.sum(defect) + x0_res)

            local_merits = jax.vmap(one)(alphas)
            return jax.lax.psum(local_merits, ax)

        def body(state):
            xu_loc, lam_loc, rho, drho, it = (
                state["xu"], state["lam"], state["rho"], state["drho"],
                state["it"])
            x, u, xnext, A, B, Q, q, R, r, c = build_blocks(xu_loc)
            S, Pinv, gamma, Qinv, Rinv = form_schur(A, B, Q, q, R, r, c, rho)
            lam_new, lin_iters, lin_ok = _pcg_impl(
                S, Pinv, gamma, lam_loc, pcg_cfg.max_iter,
                pcg_cfg.exit_tol, ax,
                exit_criterion=pcg_cfg.exit_criterion)
            dz = compute_dz(A, B, q, r, Qinv, Rinv, lam_new)
            merits = merits_of(xu_loc, dz)
            merit_cur = merits[0]
            best = 1 + jnp.argmin(merits[1:])
            min_merit = merits[best]
            success = min_merit < merit_cur
            drho_fail = jnp.maximum(drho * sqp_cfg.rho_factor, sqp_cfg.rho_factor)
            rho_fail = jnp.maximum(rho * drho_fail, sqp_cfg.rho_min)
            gave_up = rho_fail > sqp_cfg.rho_max
            drho_ok = jnp.minimum(drho / sqp_cfg.rho_factor, 1.0 / sqp_cfg.rho_factor)
            rho_ok = jnp.maximum(rho * drho_ok, sqp_cfg.rho_min)
            xu_new = jnp.where(success, xu_loc + alphas[best] * dz, xu_loc)
            rho_new = jnp.where(
                success, rho_ok,
                jnp.where(gave_up, jnp.asarray(sqp_cfg.rho_reset, dtype), rho_fail))
            return dict(
                xu=xu_new, lam=lam_new, rho=rho_new,
                drho=jnp.where(success, drho_ok, drho_fail),
                merit=jnp.where(success, min_merit, merit_cur),
                it=it + 1,
                stop=jnp.logical_and(~success, gave_up),
                gave_up=jnp.logical_or(state["gave_up"],
                                       jnp.logical_and(~success, gave_up)),
                pcg_iters=state["pcg_iters"].at[it].set(lin_iters),
                pcg_converged=state["pcg_converged"].at[it].set(lin_ok),
                ls_alpha_idx=state["ls_alpha_idx"].at[it].set(
                    jnp.where(success, (best - 1).astype(jnp.int32), -1)),
            )

        init = dict(
            xu=xu_loc, lam=lam_loc, rho=jnp.asarray(rho0, dtype),
            drho=jnp.asarray(1.0, dtype), merit=jnp.asarray(jnp.inf, dtype),
            it=jnp.int32(0), stop=jnp.bool_(False), gave_up=jnp.bool_(False),
            pcg_iters=jnp.full((sqp_cfg.max_iter,), -1, jnp.int32),
            pcg_converged=jnp.zeros((sqp_cfg.max_iter,), jnp.bool_),
            ls_alpha_idx=jnp.full((sqp_cfg.max_iter,), -1, jnp.int32),
        )
        final = jax.lax.while_loop(
            lambda s: jnp.logical_and(s["it"] < iter_bound, ~s["stop"]),
            body, init)
        return (final["xu"], final["lam"], final["rho"], final["drho"],
                final["it"], final["merit"], final["gave_up"],
                final["pcg_iters"], final["pcg_converged"],
                final["ls_alpha_idx"])

    if iter_budget is None:
        iter_bound = jnp.int32(sqp_cfg.max_iter)
    else:
        iter_bound = jnp.minimum(jnp.int32(sqp_cfg.max_iter),
                                 jnp.asarray(iter_budget, jnp.int32))
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(knot_axis), P(knot_axis), P(knot_axis), P(), P(), P()),
        out_specs=(P(knot_axis), P(knot_axis), P(), P(), P(), P(), P(), P(),
                   P(), P()),
    )
    out = fn(xu, lam, ee_goal, xs, jnp.asarray(rho, dtype), iter_bound)
    return SQPResult(xu=out[0], lam=out[1], rho=out[2], drho=out[3],
                     sqp_iters=out[4], merit=out[5], gave_up=out[6],
                     pcg_iters=out[7], pcg_converged=out[8],
                     ls_alpha_idx=out[9])
