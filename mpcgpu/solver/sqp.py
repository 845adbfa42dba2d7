"""SQP outer loop: KKT -> Schur -> linear solve -> dz -> line search -> rho.

Equivalent of sqpSolvePcg / sqpSolveQdldl (include/pcg/sqp.cuh:21-393,
include/qdldl/sqp.cuh:52-435) as ONE jitted XLA program: the whole solve —
including the Levenberg-Marquardt rho schedule and the 8-alpha line search —
runs on device inside a ``lax.while_loop`` (the reference round-trips for
the merit argmin, pcg/sqp.cuh:288-301, and allocates its entire workspace
per call, pcg/sqp.cuh:94-135; we persist everything in the jit arena with
donated iterates).  On a GPU, XLA still drives each iteration of a
data-dependent while loop from the host — one predicate copy and one
CUDA-graph launch per iteration — which is why the PCG loop, the innermost
and longest, runs as one kernel there (ops/pcg_pallas.py, PERF.md).

Wall-clock budgeting (sqpTimecheck, pcg/sqp.cuh:161-169) cannot live inside a
traced program; the MPC simulator layer replicates it host-side by chunked
calls when needed (sim/mpc.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu.device import resolve_linsys
from mpcgpu.models.robot import RobotModel
from mpcgpu.ops import pcg_pallas
from mpcgpu.ops.ldl import btd_ldl_solve
from mpcgpu.ops.pcg import pcg_solve
from mpcgpu.ops.schur import compute_dz, form_schur_system
from mpcgpu.solver.kkt import build_kkt
from mpcgpu.solver.merit import line_search_merits
from mpcgpu.precision import highest_precision


class SQPResult(NamedTuple):
    xu: jax.Array           # (N, nx+nu) updated iterate
    lam: jax.Array          # (N, nx) updated multipliers
    rho: jax.Array          # () updated regularization
    drho: jax.Array         # () updated L-M rho multiplier (pcg/sqp.cuh:304-320)
    sqp_iters: jax.Array    # () int32 iterations performed
    merit: jax.Array        # () final merit value
    gave_up: jax.Array      # () bool — rho exceeded rho_max (pcg/sqp.cuh:309-313)
    pcg_iters: jax.Array    # (max_sqp_iter,) int32 per-iteration linsys iters (-1 pad)
    pcg_converged: jax.Array  # (max_sqp_iter,) bool per-iteration linsys exit flag
    ls_alpha_idx: jax.Array   # (max_sqp_iter,) int32 chosen alpha index (-1 = fail)


@highest_precision
def sqp_solve(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    xu,
    lam,
    xs,
    ee_goal,
    rho,
    dt,
    linsys: str = "auto",
    max_sqp_iter: int | None = None,
    integrator_type: int = 0,
    drho0=1.0,
    angle_wrap: bool = False,
    iter_budget=None,
) -> SQPResult:
    """One SQP solve. All array args traced; model/configs/linsys static.

    linsys: "auto" (the platform's default, see ``mpcgpu.device``),
    "pcg" (``lax.while_loop`` PCG), "pcg_pallas" (the whole-solve GPU
    kernel), "ldl" (on-device block LDL^T), "pcr" (refined parallel cyclic
    reduction) or "qdldl_host" (the reference's host direct solve).
    iter_budget: optional TRACED iteration cap <= max_iter — the on-device
    equivalent of the reference's sqpTimecheck wall-clock exit
    (pcg/sqp.cuh:161-169): the MPC layer converts SQP_MAX_TIME_US into an
    iteration count via one-time calibration (sim/mpc.py) so budgeted solves
    cost zero extra host round-trips. Result buffers stay sized by the
    static max_iter.
    """
    dtype = xu.dtype
    max_iter = sqp_cfg.max_iter if max_sqp_iter is None else max_sqp_iter
    linsys = resolve_linsys(linsys, pcg_cfg.preconditioner, xu.shape[0])

    rho = jnp.asarray(rho, dtype)
    mu = jnp.asarray(sqp_cfg.mu, dtype)
    dt = jnp.asarray(dt, dtype)

    # The merit of the current iterate is evaluated as the alpha = 0 candidate
    # inside each iteration's line-search batch (see line_search_merits), so
    # no standalone compute_merit pass is needed (unlike pcg/sqp.cuh:173-182).
    # Note the comparison baseline therefore INCLUDES the initial-state l1
    # residual, unlike the reference's initial merit (merit.cuh:133-134) —
    # self-consistent with the candidates, which always include it.

    def solve_linsys(schur, lam, lin_tol):
        if linsys in ("pcg", "pcg_pallas"):
            pcg = pcg_solve if linsys == "pcg" else pcg_pallas.pcg_solve_pallas
            res = pcg(
                schur.S, schur.Pinv, schur.gamma, lam,
                max_iter=pcg_cfg.max_iter, exit_tol=lin_tol,
                exit_criterion=pcg_cfg.exit_criterion,
            )
            return res.lam, res.iters, res.converged
        elif linsys == "ldl":
            lam_new = btd_ldl_solve(schur.S, schur.gamma)
            return lam_new, jnp.int32(1), jnp.bool_(True)
        elif linsys == "pcr":
            from mpcgpu.ops.pcr import pcr_solve_refined

            lam_new = pcr_solve_refined(schur.S, schur.gamma, refine=1)
            return lam_new, jnp.int32(1), jnp.bool_(True)
        elif linsys == "qdldl_host":
            # the reference's LITERAL per-SQP-iteration host round-trip:
            # D2H Schur values -> QDLDL numeric factor + solve on the host
            # (symbolic cached) -> H2D (qdldl/sqp.cuh:268-273).  Kept for
            # reference parity/cross-checking; linsys="ldl" is the on-device
            # direct solver that replaces it in production.
            def _host_solve(S_np, gamma_np):
                import numpy as np

                from mpcgpu.native import qdldl_solve_schur_cached

                return qdldl_solve_schur_cached(S_np, gamma_np).astype(
                    np.asarray(gamma_np).dtype)

            lam_new = jax.pure_callback(
                _host_solve,
                jax.ShapeDtypeStruct(schur.gamma.shape, schur.gamma.dtype),
                schur.S, schur.gamma, vmap_method="sequential")
            return lam_new, jnp.int32(1), jnp.bool_(True)
        else:
            raise ValueError(f"unknown linsys {linsys!r}")

    if iter_budget is None:
        iter_bound = max_iter
    else:
        iter_bound = jnp.minimum(jnp.int32(max_iter),
                                 jnp.asarray(iter_budget, jnp.int32))

    def cond(state):
        return jnp.logical_and(state["it"] < iter_bound, ~state["stop"])

    def body(state):
        xu, lam, rho, drho = state["xu"], state["lam"], state["rho"], state["drho"]
        it = state["it"]
        lin_tol = state["lin_tol"]

        # stage names label the ops in profiler traces
        with jax.named_scope("kkt"):
            kkt = build_kkt(model, cost, xu, xs, ee_goal, dt,
                            integrator_type, angle_wrap)
        with jax.named_scope("schur"):
            schur = form_schur_system(
                kkt, rho, preconditioner=pcg_cfg.preconditioner)
        with jax.named_scope("pcg"):
            lam, lin_iters, lin_ok = solve_linsys(schur, lam, lin_tol)
        with jax.named_scope("dz"):
            dz = compute_dz(kkt, schur, lam)
        with jax.named_scope("merit"):
            merits, alphas = line_search_merits(
                model, cost, xu, dz, xs, ee_goal, mu, dt,
                num_alphas=sqp_cfg.num_alphas,
                integrator_type=integrator_type, include_zero=True,
                angle_wrap=angle_wrap,
            )
        merit_cur = merits[0]
        best = 1 + jnp.argmin(merits[1:])
        min_merit = merits[best]
        success = min_merit < merit_cur

        # Levenberg-Marquardt rho schedule (pcg/sqp.cuh:304-320)
        drho_fail = jnp.maximum(drho * sqp_cfg.rho_factor, sqp_cfg.rho_factor)
        rho_fail = jnp.maximum(rho * drho_fail, sqp_cfg.rho_min)
        gave_up = rho_fail > sqp_cfg.rho_max
        drho_ok = jnp.minimum(drho / sqp_cfg.rho_factor, 1.0 / sqp_cfg.rho_factor)
        rho_ok = jnp.maximum(rho * drho_ok, sqp_cfg.rho_min)

        xu_new = jnp.where(success, xu + alphas[best] * dz, xu)
        rho_new = jnp.where(
            success, rho_ok, jnp.where(gave_up, jnp.asarray(sqp_cfg.rho_reset, dtype), rho_fail)
        )
        drho_new = jnp.where(success, drho_ok, drho_fail)
        merit_new = jnp.where(success, min_merit, merit_cur)
        stop = jnp.logical_and(~success, gave_up)

        # Eisenstat-Walker-style forcing: decay the linear-solve tolerance
        # boost with the merit-decrease ratio; a failed line search drops
        # straight to full accuracy (config.py PCGConfig.forcing)
        if pcg_cfg.forcing == "ew":
            ratio = jnp.clip(min_merit / jnp.maximum(merit_cur, 1e-30), 0.0, 1.0)
            factor = jnp.minimum(
                jnp.asarray(pcg_cfg.ew_decay, dtype),
                jnp.power(ratio, jnp.asarray(pcg_cfg.ew_alpha, dtype)))
            decayed = jnp.maximum(exit_tol_target, lin_tol * factor)
            lin_tol_new = jnp.where(success, decayed, exit_tol_target)
        else:
            lin_tol_new = lin_tol

        return dict(
            xu=xu_new,
            lam=lam,
            rho=rho_new,
            drho=drho_new,
            merit=merit_new,
            it=it + 1,
            stop=stop,
            lin_tol=lin_tol_new,
            gave_up=jnp.logical_or(state["gave_up"], jnp.logical_and(~success, gave_up)),
            pcg_iters=state["pcg_iters"].at[it].set(lin_iters),
            pcg_converged=state["pcg_converged"].at[it].set(lin_ok),
            ls_alpha_idx=state["ls_alpha_idx"].at[it].set(
                jnp.where(success, (best - 1).astype(jnp.int32), jnp.int32(-1))
            ),
        )

    exit_tol_target = jnp.asarray(pcg_cfg.exit_tol, dtype)
    lin_tol0 = (exit_tol_target * jnp.asarray(pcg_cfg.ew_boost0, dtype)
                if pcg_cfg.forcing == "ew" else exit_tol_target)
    init = dict(
        xu=xu,
        lam=lam,
        rho=rho,
        drho=jnp.asarray(drho0, dtype),
        merit=jnp.asarray(jnp.inf, dtype),
        it=jnp.int32(0),
        stop=jnp.bool_(False),
        gave_up=jnp.bool_(False),
        pcg_iters=jnp.full((max_iter,), -1, jnp.int32),
        pcg_converged=jnp.zeros((max_iter,), jnp.bool_),
        ls_alpha_idx=jnp.full((max_iter,), -1, jnp.int32),
        lin_tol=lin_tol0,
    )
    final = jax.lax.while_loop(cond, body, init)
    return SQPResult(
        xu=final["xu"],
        lam=final["lam"],
        rho=final["rho"],
        drho=final["drho"],
        sqp_iters=final["it"],
        merit=final["merit"],
        gave_up=final["gave_up"],
        pcg_iters=final["pcg_iters"],
        pcg_converged=final["pcg_converged"],
        ls_alpha_idx=final["ls_alpha_idx"],
    )


def make_sqp_solver(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    dt: float,
    linsys: str = "auto",
    donate: bool = True,
    integrator_type: int = 0,
    angle_wrap: bool = False,
):
    """Build a jitted solver fn(xu, lam, xs, ee_goal, rho[, drho[, iter_budget]])
    -> SQPResult.

    Iterate buffers are donated so repeated MPC solves reuse device memory
    (unlike the reference's per-call cudaMalloc of the whole workspace,
    pcg/sqp.cuh:94-135). The optional drho argument lets chunked callers
    (sim/mpc.py time-budget mode) carry the compounding Levenberg-Marquardt
    multiplier across 1-iteration solves; the optional iter_budget argument
    is the traced on-device iteration cap (see sqp_solve)."""

    def _solve(xu, lam, xs, ee_goal, rho, drho0=1.0, iter_budget=None):
        return sqp_solve(
            model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, rho, dt,
            linsys=linsys, integrator_type=integrator_type, drho0=drho0,
            angle_wrap=angle_wrap, iter_budget=iter_budget,
        )

    donate_argnums = (0, 1) if donate else ()
    return jax.jit(_solve, donate_argnums=donate_argnums)
