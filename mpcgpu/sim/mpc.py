"""Closed-loop MPC simulator: solve -> simulate plant -> shift -> repeat.

Equivalent of simulateMPC (include/mpcsim.cuh:146-426) and simple_simulate
(include/common/integrator.cuh:295-325).  The control loop is a host loop (as
in the reference), but each stage is one jitted XLA program; plant stepping is
a ``lax.scan`` over fixed 2e-4 s substeps instead of the reference's one
kernel launch per substep (integrator.cuh:314-319).

Timing semantics (CONST_UPDATE_FREQ, settings.cuh:56-72, mpcsim.cuh:280-284):
each control update advances the plant by ``simulation_period_us`` using the
PREVIOUS plan's controls offset by the previous solve time, then shifts the
plan/goal/multipliers once per trajectory timestep.
"""

from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpcgpu.config import CostConfig, PCGConfig, SimConfig, SQPConfig
from mpcgpu.models import dynamics
from mpcgpu.models.robot import RobotModel
from mpcgpu.precision import highest_precision
from mpcgpu.solver.sqp import make_sqp_solver, sqp_solve


@dataclasses.dataclass
class MPCStats:
    """Reference metric set (mpcsim.cuh:358-394; SURVEY.md section 5)."""

    linsys_iters: list
    linsys_exits: list
    sqp_times_us: list
    sqp_iters: list
    sqp_exits: list
    tracking_errors: list
    tracking_path: list
    final_tracking_error: float = float("nan")

    def summary(self) -> dict:
        te = np.asarray(self.tracking_errors, dtype=np.float64)
        st = np.asarray(self.sqp_times_us, dtype=np.float64)
        it = np.concatenate([np.asarray(v) for v in self.linsys_iters]) if self.linsys_iters else np.zeros(0)
        ex = np.concatenate([np.asarray(v) for v in self.linsys_exits]) if self.linsys_exits else np.zeros(0)
        return dict(
            avg_tracking_error=float(te.mean()) if te.size else float("nan"),
            final_tracking_error=self.final_tracking_error,
            avg_sqp_time_us=float(st.mean()) if st.size else float("nan"),
            avg_sqp_iters=float(np.mean(self.sqp_iters)) if self.sqp_iters else float("nan"),
            avg_pcg_iters=float(it.mean()) if it.size else float("nan"),
            pcg_maxiter_exit_pct=float(100.0 * (1.0 - ex.mean())) if ex.size else float("nan"),
            control_updates=len(self.sqp_times_us),
        )


@highest_precision
@partial(jax.jit, static_argnames=("n_steps",))
def _simulate_plant(model: RobotModel, xs, xu_plan, time_offset_s, sim_time_s,
                    timestep, n_steps: int, sim_step: float):
    """Advance the plant from xs for sim_time using xu_plan's controls.

    Mirrors simple_simulate (integrator.cuh:295-325): Euler substeps of
    ``sim_step`` seconds; the control applied at each substep is the plan knot
    whose window contains (time_offset + elapsed); a final fmod-length partial
    step finishes the interval.
    """
    nq = model.nq
    N = xu_plan.shape[0]

    def substep(x, dt_k):
        t, dt = dt_k
        idx = jnp.minimum((t / timestep).astype(jnp.int32), N - 1)
        u = jax.lax.dynamic_index_in_dim(xu_plan, idx, axis=0, keepdims=False)[2 * nq :]
        qdd = dynamics.forward_dynamics_aba(model, x[:nq], x[nq:], u)
        xn = jnp.concatenate([x[:nq] + dt * x[nq:], x[nq:] + dt * qdd])
        return xn, None

    # dt_i = clip(sim_time - i*sim_step, 0, sim_step): full substeps while
    # time remains, one exact partial step, zero-length steps after — sums to
    # exactly sim_time for ANY traced sim_time <= (n_steps+1)*sim_step (so
    # the adaptive-frequency mode's varying solve times integrate correctly,
    # and exact multiples of sim_step don't gain a spurious extra substep)
    offsets = sim_step * jnp.arange(n_steps + 1, dtype=xs.dtype)
    ts = time_offset_s + offsets
    sim_time_s = jnp.asarray(sim_time_s, xs.dtype)
    dts = jnp.clip(sim_time_s - offsets, 0.0, sim_step)
    xs_final, _ = jax.lax.scan(substep, xs, (ts, dts))
    return xs_final


@highest_precision
@jax.jit
def _ee_xyz(model: RobotModel, q):
    return dynamics.fk_ee_xyz(model, q)


@jax.jit
def _shift_all(xu, lam, ee_goal, backfill_xu, backfill_goal):
    """Warm-start shift of plan/goal/multipliers (mpcsim.cuh:313-340).

    All three shift left one knot (just_shift, integrator.cuh:257-263 — there
    a host loop of N small D2D memcpys; here a single roll) and the tails are
    backfilled: xu tail from the precomputed trajectory (or goal-with-zero-
    velocity past its end), goal tail from the goal trace, lambda tail
    duplicated.
    """
    xu = jnp.concatenate([xu[1:], backfill_xu[None]], axis=0)
    ee_goal = jnp.concatenate([ee_goal[1:], backfill_goal[None]], axis=0)
    lam = jnp.concatenate([lam[1:], lam[-1:]], axis=0)
    return xu, lam, ee_goal


def calibrate_sqp_iteration_us(
    model: RobotModel, cost, sqp_cfg, pcg_cfg, timestep, linsys,
    xu, lam, xs, ee_goal, rho, chain_len: int = 32, reps: int = 3,
    integrator_type: int = 0,
) -> float:
    """Measure the mean device latency of ONE SQP iteration (us).

    Chains ``chain_len`` 1-iteration solves inside one jitted fori_loop
    (feeding each result into the next) and divides the warm wall time, so
    the per-call dispatch cost is spread over the chain.  Used by the
    on-device time-budget mode to convert SQP_MAX_TIME_US into an iteration
    cap (the reference checks wall time between stages, sqpTimecheck
    pcg/sqp.cuh:161-169; an iteration cap is the equivalent here since the
    whole solve is one XLA program)."""
    dtype = xu.dtype

    @jax.jit
    def chain(xu0, lam0, rho0):
        def body(i, c):
            xu_, lam_, rho_ = c
            res = sqp_solve(
                model, cost, sqp_cfg, pcg_cfg, xu_, lam_, xs, ee_goal, rho_,
                timestep, linsys=linsys, max_sqp_iter=1,
                integrator_type=integrator_type,
            )
            return (res.xu, res.lam, res.rho)

        return jax.lax.fori_loop(0, chain_len, body, (xu0, lam0, rho0))

    rho = jnp.asarray(rho, dtype)
    jax.block_until_ready(chain(xu, lam, rho))          # compile + warm
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(xu, lam, rho))
        samples.append((time.perf_counter() - t0) * 1e6 / chain_len)
    return float(np.median(samples))


def simulate_mpc(
    model: RobotModel,
    xu_traj: np.ndarray,          # (traj_steps, nx+nu) precomputed trajectory
    eepos_traj: np.ndarray,       # (traj_steps, 6) ee goal trace
    knot_points: int,
    timestep: float,
    cost: Optional[CostConfig] = None,
    sqp_cfg: SQPConfig = SQPConfig(),
    pcg_cfg: Optional[PCGConfig] = None,
    sim_cfg: SimConfig = SimConfig(),
    linsys: str = "auto",
    linsys_exit_tol: Optional[float] = None,
    dtype=jnp.float32,
    verbose: bool = False,
) -> MPCStats:
    """Track the recorded trajectory closed-loop; returns reference-style stats."""
    N = knot_points
    nq = model.nq
    nx, nu = 2 * nq, nq
    traj_steps = xu_traj.shape[0]
    cost = cost or CostConfig.for_knots(N)
    pcg_cfg = pcg_cfg or PCGConfig(max_iter=PCGConfig.tuned_max_iter(N))
    if linsys_exit_tol is not None:
        pcg_cfg = dataclasses.replace(pcg_cfg, exit_tol=linsys_exit_tol)

    xu_traj_j = jnp.asarray(xu_traj, dtype)
    ee_traj_j = jnp.asarray(eepos_traj, dtype)

    xu = xu_traj_j[:N]
    xu_old = xu
    ee_goal = ee_traj_j[:N]
    lam = jnp.zeros((N, nx), dtype)
    xs = xu[0, :nx]
    rho = jnp.asarray(1e-3, dtype)

    solver = make_sqp_solver(model, cost, sqp_cfg, pcg_cfg, timestep, linsys=linsys, donate=False)
    if sim_cfg.time_budget_mode and sim_cfg.time_budget_impl == "ondevice":
        # one-time calibration -> traced iteration cap inside the jitted
        # while_loop; every control step is then still ONE dispatch
        per_iter_us = calibrate_sqp_iteration_us(
            model, cost, sqp_cfg, pcg_cfg, timestep, linsys,
            xu, lam, xs, ee_goal, rho)
        budget = max(1, min(sqp_cfg.max_iter,
                            int((sqp_cfg.max_time_us or 2000.0) / per_iter_us)))
        if verbose:
            print(f"[budget] {per_iter_us:.0f} us/SQP-iteration calibrated -> "
                  f"iteration budget {budget}")
        iter_budget_arr = jnp.int32(budget)
        base_solver = solver

        def solve_ondevice_budget(xu, lam, xs, ee_goal, rho):
            return base_solver(xu, lam, xs, ee_goal, rho, 1.0, iter_budget_arr)

        solver = solve_ondevice_budget
    elif sim_cfg.time_budget_mode:
        one_iter_cfg = dataclasses.replace(sqp_cfg, max_iter=1)
        solver_1 = make_sqp_solver(
            model, cost, one_iter_cfg, pcg_cfg, timestep, linsys=linsys, donate=False
        )

        def solve_budgeted(xu, lam, xs, ee_goal, rho):
            """Chunked 1-iteration solves under the SQP_MAX_TIME_US wall cap
            (stage-granular in the reference, iteration-granular here)."""
            budget_s = (sqp_cfg.max_time_us or 2000.0) * 1e-6
            t0 = time.perf_counter()
            agg_iters, agg_conv, agg_alpha = [], [], []
            res = None
            drho = jnp.asarray(1.0, dtype)
            for _ in range(sqp_cfg.max_iter):
                res = solver_1(xu, lam, xs, ee_goal, rho, drho)
                jax.block_until_ready(res.xu)
                xu, lam, rho, drho = res.xu, res.lam, res.rho, res.drho
                agg_iters.append(int(res.pcg_iters[0]))
                agg_conv.append(bool(res.pcg_converged[0]))
                agg_alpha.append(int(res.ls_alpha_idx[0]))
                if bool(res.gave_up) or time.perf_counter() - t0 > budget_s:
                    break
            n = len(agg_iters)
            pad = sqp_cfg.max_iter - n
            return res._replace(
                xu=xu, lam=lam, rho=rho,
                sqp_iters=jnp.int32(n),
                pcg_iters=jnp.asarray(agg_iters + [-1] * pad, jnp.int32),
                pcg_converged=jnp.asarray(agg_conv + [False] * pad),
                ls_alpha_idx=jnp.asarray(agg_alpha + [-1] * pad, jnp.int32),
            )

        solver = solve_budgeted

    # static substep budget; the clip schedule in _simulate_plant makes any
    # traced sim_time <= this budget integrate exactly (adaptive mode uses
    # the measured solve time, bounded by the SQP wall cap)
    sim_time_s = sim_cfg.simulation_period_us * 1e-6
    max_sim_s = sim_time_s if sim_cfg.const_update_freq else max(
        sim_time_s, (sqp_cfg.max_time_us or sim_cfg.simulation_period_us) * 1e-6)
    n_sub = int(round(max_sim_s / sim_cfg.sim_step_time))
    plant = _simulate_plant

    # warm-up (REMOVE_JITTERS, mpcsim.cuh:222-242) + compile
    for _ in range(max(1, sim_cfg.remove_jitters)):
        res = solver(xu, lam, xs, ee_goal, rho)
        jax.block_until_ready(res.xu)

    stats = MPCStats([], [], [], [], [], [], [])
    stats.tracking_path.append(xs)

    shift_threshold = sim_cfg.shift_threshold_frac * timestep
    time_since_timestep = 0.0
    prev_sim_time = 0.0
    shifted = False
    traj_offset = 0

    for step in range(sim_cfg.max_control_updates):
        if traj_offset >= traj_steps:
            break

        t0 = time.perf_counter()
        res = solver(xu, lam, xs, ee_goal, rho)
        jax.block_until_ready(res.xu)
        sqp_time_us = (time.perf_counter() - t0) * 1e6
        xu, lam, rho = res.xu, res.lam, res.rho

        # stats stay on device; one conversion pass after the loop (the
        # reference D2H-copies per step, mpcsim.cuh:361 — pointless here)
        stats.linsys_iters.append(res.pcg_iters)
        stats.linsys_exits.append(res.pcg_converged)
        stats.sqp_times_us.append(sqp_time_us)
        stats.sqp_iters.append(res.sqp_iters)
        stats.sqp_exits.append(res.gave_up)

        sim_time_us = (
            sim_cfg.simulation_period_us if sim_cfg.const_update_freq else sqp_time_us
        )
        # adaptive mode: the plant's static substep schedule integrates at
        # most max_sim_s; clamp so reported sim time == integrated time (a
        # slow host round trip can exceed the solve budget)
        if sim_time_us > max_sim_s * 1e6:
            import warnings

            warnings.warn(
                f"solve wall time {sim_time_us:.0f} us exceeds the plant "
                f"substep budget {max_sim_s * 1e6:.0f} us; clamping sim time "
                "(host overhead, not solver time — see sim/mpc.py)")
            sim_time_us = max_sim_s * 1e6
        xs = plant(
            model, xs, xu_old,
            jnp.asarray(prev_sim_time * 1e-6, dtype),
            jnp.asarray(sim_time_us * 1e-6, dtype),
            jnp.asarray(timestep, dtype),
            n_sub, sim_cfg.sim_step_time,
        )
        xu_old = xu
        time_since_timestep += sim_time_us * 1e-6

        if not shifted and time_since_timestep > shift_threshold:
            # record tracking error before shifting the goal (mpcsim.cuh:300-309)
            stats.tracking_errors.append(
                jnp.abs(_ee_xyz(model, xs[:nq]) - ee_goal[0, :3]).sum()
            )
            traj_offset += 1

            if traj_offset + N < traj_steps:
                # NOTE: the reference backfills the shifted tail from the
                # trajectory at offset `traj_offset` (mpcsim.cuh:316), i.e.
                # horizon-START-relative; we use the horizon END index, which
                # is the consistent warm start (the goal shift at
                # mpcsim.cuh:327-328 already uses the end index).
                tail = xu_traj_j[traj_offset + N - 1]
                goal_tail = ee_traj_j[traj_offset + N - 1]
            else:
                qgoal = xu_traj_j[traj_steps - 1, :nq]
                tail = jnp.concatenate([qgoal, jnp.zeros((nx - nq + nu,), dtype)])
                goal_tail = ee_traj_j[traj_steps - 1]
            xu, lam, ee_goal = _shift_all(xu, lam, ee_goal, tail, goal_tail)
            shifted = True

        if time_since_timestep > timestep:
            shifted = False
            time_since_timestep = math.fmod(time_since_timestep, timestep)

        # pin the plan's initial state to the measured state (mpcsim.cuh:348)
        xu = xu.at[0, :nx].set(xs)
        prev_sim_time = sim_time_us

        stats.tracking_path.append(xs)

        if sim_cfg.live_print_path:
            # LIVE_PRINT_PATH (settings.cuh:20-26, mpcsim.cuh:256-262):
            # stream the measured state every control step
            print(" ".join(f"{v:.6f}" for v in np.asarray(xs)))
        if verbose and step % 200 == 0:
            print(
                f"step {step:5d} offset {traj_offset:4d} sqp {sqp_time_us:8.1f}us"
            )

        # live PCG-health telemetry every 1000 steps (mpcsim.cuh:382-387):
        # warn when more than half of the linear solves exit on max_iter
        if step > 0 and step % 1000 == 0:
            ex = np.asarray(jnp.stack(stats.linsys_exits))
            its = np.asarray(jnp.stack(stats.sqp_iters))
            valid = np.arange(ex.shape[1])[None, :] < its[:, None]
            if valid.any():
                exit_rate = 100.0 * (1.0 - ex[valid].mean())
                if exit_rate > 50.0:
                    print(f"WARNING: PCG max-iter exit rate {exit_rate:.1f}% "
                          "> 50% — increase PCGConfig.max_iter or loosen "
                          "exit_tol (mpcsim.cuh:384-387)")

    stats.final_tracking_error = float(
        jnp.abs(_ee_xyz(model, xs[:nq]) - ee_goal[0, :3]).sum()
    )
    _finalize_stats(stats)
    return stats


def _finalize_stats(stats: MPCStats) -> None:
    """Convert deferred device values to host (one sync at end of run)."""
    sqp_iters = [int(v) for v in np.asarray(jnp.stack(stats.sqp_iters))] if stats.sqp_iters else []
    iters_np = np.asarray(jnp.stack(stats.linsys_iters)) if stats.linsys_iters else np.zeros((0, 1))
    exits_np = np.asarray(jnp.stack(stats.linsys_exits)) if stats.linsys_exits else np.zeros((0, 1))
    stats.linsys_iters = [iters_np[i, : sqp_iters[i]] for i in range(len(sqp_iters))]
    stats.linsys_exits = [exits_np[i, : sqp_iters[i]] for i in range(len(sqp_iters))]
    stats.sqp_iters = sqp_iters
    stats.sqp_exits = [bool(v) for v in np.asarray(jnp.stack(stats.sqp_exits))] if stats.sqp_exits else []
    stats.tracking_errors = (
        [float(v) for v in np.asarray(jnp.stack(stats.tracking_errors))]
        if stats.tracking_errors else []
    )
    stats.tracking_path = list(np.asarray(jnp.stack(stats.tracking_path)))


# ---------------------------------------------------------------------------
# fully on-device closed-loop simulation
# ---------------------------------------------------------------------------


def _ondevice_scan(model, cost, sqp_cfg, pcg_cfg, linsys, timestep, period_s,
                   n_sub, sim_step,
                   xu0, lam0, xs0, ee0, rho0, shift_flags, tails, goal_tails,
                   offsets, knot_mesh=None, pcg_method="pipelined"):
    """Traced core of the on-device closed loop (shared single/batched).

    knot_mesh: optional Mesh — run every solve KNOT-SHARDED over its "knot"
    axis (parallel/sqp_sharded.py SPMD), so whole long-horizon tracking
    experiments execute across devices as one program."""
    nq = lam0.shape[-1] // 2
    nx = lam0.shape[-1]
    dtype = xu0.dtype
    plant = _simulate_plant

    def step(carry, inp):
        xu, xu_old, lam, xs, ee_goal, rho = carry
        do_shift, tail, goal_tail, t_off = inp

        if knot_mesh is not None:
            from mpcgpu.parallel.sqp_sharded import sqp_solve_sharded

            res = sqp_solve_sharded(model, cost, sqp_cfg, pcg_cfg, xu, lam,
                                    xs, ee_goal, rho, timestep, knot_mesh,
                                    pcg_method=pcg_method)
        else:
            res = sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs,
                            ee_goal, rho, timestep, linsys=linsys)
        xu_n, lam_n, rho_n = res.xu, res.lam, res.rho

        xs_n = plant(model, xs, xu_old, t_off,
                     jnp.asarray(period_s, dtype),
                     jnp.asarray(timestep, dtype),
                     n_sub, sim_step)
        err = jnp.abs(_ee_xyz(model, xs_n[:nq]) - ee_goal[0, :3]).sum()

        def with_shift(args):
            xu_, lam_, ee_ = args
            return _shift_all(xu_, lam_, ee_, tail, goal_tail)

        xu_solved = xu_n              # plan used by NEXT step's plant window
        xu_n, lam_n, ee_n = jax.lax.cond(
            do_shift, with_shift, lambda a: a, (xu_n, lam_n, ee_goal))
        xu_n = xu_n.at[0, :nx].set(xs_n)
        out = dict(err=err, shifted=do_shift, xs=xs_n,
                   sqp_iters=res.sqp_iters, pcg_iters=res.pcg_iters)
        return (xu_n, xu_solved, lam_n, xs_n, ee_n, rho_n), out

    carry0 = (xu0, xu0, lam0, xs0, ee0, rho0)
    (xu, _, lam, xs, ee_goal, rho), outs = jax.lax.scan(
        step, carry0, (shift_flags, tails, goal_tails, offsets))
    final_err = jnp.abs(_ee_xyz(model, xs[:nq]) - ee_goal[0, :3]).sum()
    return outs, final_err


@highest_precision
@partial(jax.jit, static_argnames=("cost", "sqp_cfg", "pcg_cfg", "linsys",
                                   "timestep", "period_s", "n_sub", "sim_step",
                                   "knot_mesh", "pcg_method"))
def _ondevice_run(model, cost, sqp_cfg, pcg_cfg, linsys, timestep, period_s,
                  n_sub, sim_step,
                  xu0, lam0, xs0, ee0, rho0, shift_flags, tails, goal_tails,
                  offsets, knot_mesh=None, pcg_method="pipelined"):
    """Module-level jit (a closure-local jit would retrace per call)."""
    return _ondevice_scan(model, cost, sqp_cfg, pcg_cfg, linsys, timestep,
                          period_s, n_sub, sim_step,
                          xu0, lam0, xs0, ee0, rho0,
                          shift_flags, tails, goal_tails, offsets,
                          knot_mesh=knot_mesh, pcg_method=pcg_method)


def _ondevice_scan_adaptive(model, cost, sqp_cfg, pcg_cfg, linsys, timestep,
                            n_sub, sim_step, shift_threshold, per_iter_s,
                            base_s, n_steps, traj_steps,
                            xu0, lam0, xs0, ee0, rho0, xu_traj_j, ee_traj_j,
                            knot_mesh=None, pcg_method="pipelined"):
    """Adaptive-frequency closed loop entirely on device.

    The reference's non-CONST_UPDATE_FREQ mode advances the plant by the
    PREVIOUS solve's measured wall time (mpcsim.cuh:280-288) — a host-clock
    quantity that cannot exist inside a traced program.  The on-device
    equivalent models the solve time from its on-device observables:
        t_solve = base_s + per_iter_s * sqp_iters_performed
    with per_iter_s calibrated once (calibrate_sqp_iteration_us).  Everything
    downstream of that substitution — the data-dependent shift schedule,
    trajectory-offset advance, and tail backfill — runs inside the scan with
    dynamic indexing; steps after the trajectory is exhausted freeze the
    carry and are masked in the outputs."""
    nq = lam0.shape[-1] // 2
    nx = lam0.shape[-1]
    nu = xu0.shape[-1] - nx
    dtype = xu0.dtype
    plant = _simulate_plant
    max_sim_s = (n_sub + 1) * sim_step
    qgoal = xu_traj_j[traj_steps - 1, :nq]
    rest_row = jnp.concatenate([qgoal, jnp.zeros((nx - nq + nu,), dtype)])

    def step(carry, _):
        (xu, xu_old, lam, xs, ee_goal, rho, time_since, traj_offset,
         shifted, prev_sim, active) = carry

        if knot_mesh is not None:
            from mpcgpu.parallel.sqp_sharded import sqp_solve_sharded

            res = sqp_solve_sharded(model, cost, sqp_cfg, pcg_cfg, xu, lam,
                                    xs, ee_goal, rho, timestep, knot_mesh,
                                    pcg_method=pcg_method)
        else:
            res = sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs,
                            ee_goal, rho, timestep, linsys=linsys)
        xu_n, lam_n, rho_n = res.xu, res.lam, res.rho

        sim_time = jnp.clip(
            base_s + per_iter_s * res.sqp_iters.astype(dtype), 0.0, max_sim_s)
        xs_n = plant(model, xs, xu_old, prev_sim,
                     sim_time, jnp.asarray(timestep, dtype), n_sub, sim_step)
        time_since = time_since + sim_time

        err = jnp.abs(_ee_xyz(model, xs_n[:nq]) - ee_goal[0, :3]).sum()
        do_shift = jnp.logical_and(jnp.logical_and(~shifted, active),
                                   time_since > shift_threshold)
        traj_offset_n = traj_offset + do_shift.astype(jnp.int32)
        tail_i = jnp.minimum(traj_offset_n + xu0.shape[0] - 1, traj_steps - 1)
        in_range = traj_offset_n + xu0.shape[0] < traj_steps
        tail_row = jax.lax.dynamic_index_in_dim(
            xu_traj_j, tail_i, keepdims=False)
        tail = jnp.where(in_range, tail_row, rest_row)
        goal_tail = jax.lax.dynamic_index_in_dim(
            ee_traj_j, tail_i, keepdims=False)

        def with_shift(args):
            xu_, lam_, ee_ = args
            return _shift_all(xu_, lam_, ee_, tail, goal_tail)

        xu_solved = xu_n
        xu_n, lam_n, ee_n = jax.lax.cond(
            do_shift, with_shift, lambda a: a, (xu_n, lam_n, ee_goal))
        shifted_n = jnp.logical_or(shifted, do_shift)
        wrap = time_since > timestep
        shifted_n = jnp.where(wrap, False, shifted_n)
        time_since = jnp.where(wrap, jnp.mod(time_since, timestep), time_since)
        xu_n = xu_n.at[0, :nx].set(xs_n)
        active_n = jnp.logical_and(active, traj_offset_n < traj_steps)

        # freeze the whole carry once the trajectory is exhausted
        keep = lambda new, old: jax.tree_util.tree_map(
            lambda a, b: jnp.where(active, a, b), new, old)
        new_carry = keep(
            (xu_n, xu_solved, lam_n, xs_n, ee_n, rho_n, time_since,
             traj_offset_n, shifted_n, sim_time, active_n),
            carry)
        out = dict(err=err, shifted=jnp.logical_and(do_shift, active),
                   xs=xs_n, sqp_iters=res.sqp_iters, pcg_iters=res.pcg_iters,
                   sim_time=sim_time, active=active)
        return new_carry, out

    carry0 = (xu0, xu0, lam0, xs0, ee0, rho0,
              jnp.asarray(0.0, dtype), jnp.int32(0), jnp.bool_(False),
              jnp.asarray(0.0, dtype), jnp.bool_(True))
    final, outs = jax.lax.scan(step, carry0, None, length=n_steps)
    xs, ee_goal = final[3], final[4]
    final_err = jnp.abs(_ee_xyz(model, xs[:nq]) - ee_goal[0, :3]).sum()
    return outs, final_err


@highest_precision
@partial(jax.jit, static_argnames=("cost", "sqp_cfg", "pcg_cfg", "linsys",
                                   "timestep", "n_sub", "sim_step",
                                   "shift_threshold", "per_iter_s", "base_s",
                                   "n_steps", "traj_steps", "knot_mesh",
                                   "pcg_method"))
def _ondevice_run_adaptive(model, cost, sqp_cfg, pcg_cfg, linsys, timestep,
                           n_sub, sim_step, shift_threshold, per_iter_s,
                           base_s, n_steps, traj_steps,
                           xu0, lam0, xs0, ee0, rho0, xu_traj_j, ee_traj_j,
                           knot_mesh=None, pcg_method="pipelined"):
    return _ondevice_scan_adaptive(
        model, cost, sqp_cfg, pcg_cfg, linsys, timestep, n_sub, sim_step,
        shift_threshold, per_iter_s, base_s, n_steps, traj_steps,
        xu0, lam0, xs0, ee0, rho0, xu_traj_j, ee_traj_j,
        knot_mesh=knot_mesh, pcg_method=pcg_method)


def _ondevice_schedule(xu_traj, eepos_traj, N, nx, nu, timestep, period_s,
                       shift_threshold, max_updates, dtype):
    """Host-side precomputation of the deterministic const-frequency shift
    schedule and backfill rows (shared by single/batched on-device sims)."""
    traj_steps = xu_traj.shape[0]
    shift_flags, tail_idx, offsets = [], [], []
    time_since, shifted, traj_offset, prev_off = 0.0, False, 0, 0.0
    while traj_offset < traj_steps and len(shift_flags) < max_updates:
        offsets.append(prev_off)
        time_since += period_s
        do_shift = (not shifted) and time_since > shift_threshold
        shift_flags.append(do_shift)
        if do_shift:
            traj_offset += 1
            shifted = True
        tail_idx.append(min(traj_offset + N - 1, traj_steps - 1))
        if time_since > timestep:
            shifted = False
            time_since = math.fmod(time_since, timestep)
        prev_off = period_s
    steps = len(shift_flags)
    nq = nx // 2
    xu_traj_j = jnp.asarray(xu_traj, dtype)
    ee_traj_j = jnp.asarray(eepos_traj, dtype)
    qgoal = xu_traj_j[traj_steps - 1, :nq]
    rest_row = jnp.concatenate([qgoal, jnp.zeros((nx - nq + nu,), dtype)])
    in_range = np.array(tail_idx) < traj_steps - 1
    tails = jnp.where(jnp.asarray(in_range)[:, None],
                      xu_traj_j[jnp.asarray(tail_idx)], rest_row[None, :])
    goal_tails = ee_traj_j[jnp.asarray(tail_idx)]
    return (jnp.asarray(np.array(shift_flags)), tails, goal_tails,
            jnp.asarray(np.array(offsets), dtype), steps, xu_traj_j, ee_traj_j)


def simulate_mpc_ondevice(
    model: RobotModel,
    xu_traj: np.ndarray,
    eepos_traj: np.ndarray,
    knot_points: int,
    timestep: float,
    cost: Optional[CostConfig] = None,
    sqp_cfg: SQPConfig = SQPConfig(max_iter=2),
    pcg_cfg: Optional[PCGConfig] = None,
    sim_cfg: SimConfig = SimConfig(),
    linsys: str = "auto",
    dtype=jnp.float32,
    per_iter_us: Optional[float] = None,
    base_us: float = 0.0,
    knot_mesh=None,
    pcg_method: str = "pipelined",
):
    """The ENTIRE closed-loop tracking run as one jitted ``lax.scan``.

    knot_mesh: optional jax.sharding.Mesh with a "knot" axis — every solve
    then runs KNOT-SHARDED SPMD (parallel/sqp_sharded.py), so long-horizon
    tracking experiments execute across devices as one program.

    The reference's control loop lives on the host (mpcsim.cuh:249-397, one
    solver launch + plant kernel per control step); here every control step —
    SQP solve, plant rollout, warm-start shift, tracking metrics — happens on
    device, so a full tracking experiment is a single program execution (no
    per-step dispatch or host synchronisation).

    CONST_UPDATE_FREQ mode (settings.cuh:56): the shift schedule is a
    deterministic function of (period, timestep) precomputed host-side as
    per-step flags/backfill indices.  Adaptive-frequency mode
    (const_update_freq=False, mpcsim.cuh:280-288): solve wall time is modeled
    on device as base_us + per_iter_us * sqp_iters (per_iter_us from
    ``calibrate_sqp_iteration_us`` when not given) and the shift schedule
    becomes data-dependent inside the scan — see _ondevice_scan_adaptive.

    Returns a dict of device arrays:
      tracking_errors (n_shifts,), xs_path (steps, nx), sqp_iters (steps,),
      pcg_iters (steps, max_iter), final_tracking_error ().
    """
    N = knot_points
    nq = model.nq
    nx, nu = 2 * nq, nq
    traj_steps = xu_traj.shape[0]
    cost = cost or CostConfig.for_knots(N)
    pcg_cfg = pcg_cfg or PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)

    period_s = sim_cfg.simulation_period_us * 1e-6
    shift_threshold = sim_cfg.shift_threshold_frac * timestep
    n_sub = int(period_s / sim_cfg.sim_step_time)

    if (knot_mesh is not None and not sim_cfg.const_update_freq
            and per_iter_us is None):
        # the one-time latency calibration measures the single-device
        # solver; a knot-sharded adaptive loop must be given its own
        # measured per-iteration latency explicitly
        raise ValueError("adaptive mode with knot_mesh requires an explicit "
                         "per_iter_us (calibrate the sharded solver once)")
    if not sim_cfg.const_update_freq:
        xu_traj_j = jnp.asarray(xu_traj, dtype)
        ee_traj_j = jnp.asarray(eepos_traj, dtype)
        xu0 = xu_traj_j[:N]
        ee0 = ee_traj_j[:N]
        lam0 = jnp.zeros((N, nx), dtype)
        xs0 = xu0[0, :nx]
        rho0 = jnp.asarray(1e-3, dtype)
        if per_iter_us is None:
            per_iter_us = calibrate_sqp_iteration_us(
                model, cost, sqp_cfg, pcg_cfg, timestep, linsys,
                xu0, lam0, xs0, ee0, rho0)
        # plant substeps must cover the largest modeled solve
        max_solve_s = (base_us + per_iter_us * sqp_cfg.max_iter) * 1e-6
        n_sub_a = max(1, int(math.ceil(max_solve_s / sim_cfg.sim_step_time)))
        min_solve_s = max((base_us + per_iter_us) * 1e-6, 1e-9)
        n_steps = min(sim_cfg.max_control_updates,
                      int(math.ceil(traj_steps * timestep / min_solve_s)) + 8)
        outs, final_err = _ondevice_run_adaptive(
            model, cost, sqp_cfg, pcg_cfg, linsys, timestep, n_sub_a,
            sim_cfg.sim_step_time, shift_threshold,
            float(per_iter_us) * 1e-6, float(base_us) * 1e-6,
            n_steps, traj_steps,
            xu0, lam0, xs0, ee0, rho0, xu_traj_j, ee_traj_j,
            knot_mesh=knot_mesh, pcg_method=pcg_method)
        active = outs["active"]
        return dict(
            tracking_errors=outs["err"][outs["shifted"]],
            xs_path=outs["xs"][active],
            sqp_iters=outs["sqp_iters"][active],
            pcg_iters=outs["pcg_iters"][active],
            sim_times_us=outs["sim_time"][active] * 1e6,
            final_tracking_error=final_err,
            control_updates=int(np.asarray(active).sum()),
            per_iter_us=float(per_iter_us),
        )

    (shift_flags_j, tails, goal_tails, offsets_j, steps,
     xu_traj_j, ee_traj_j) = _ondevice_schedule(
        xu_traj, eepos_traj, N, nx, nu, timestep, period_s, shift_threshold,
        sim_cfg.max_control_updates, dtype)

    xu0 = xu_traj_j[:N]
    ee0 = ee_traj_j[:N]
    lam0 = jnp.zeros((N, nx), dtype)
    xs0 = xu0[0, :nx]
    rho0 = jnp.asarray(1e-3, dtype)

    outs, final_err = _ondevice_run(
        model, cost, sqp_cfg, pcg_cfg, linsys, timestep, period_s, n_sub,
        sim_cfg.sim_step_time,
        xu0, lam0, xs0, ee0, rho0, shift_flags_j, tails, goal_tails,
        offsets_j, knot_mesh=knot_mesh, pcg_method=pcg_method)
    return dict(
        tracking_errors=outs["err"][outs["shifted"]],
        xs_path=outs["xs"],
        sqp_iters=outs["sqp_iters"],
        pcg_iters=outs["pcg_iters"],
        final_tracking_error=final_err,
        control_updates=steps,
    )


def simulate_mpc_ondevice_batched(
    model: RobotModel,
    xu_traj: np.ndarray,
    eepos_traj: np.ndarray,
    knot_points: int,
    timestep: float,
    batch: int,
    perturb_scale: float = 0.05,
    seed: int = 0,
    cost: Optional[CostConfig] = None,
    sqp_cfg: SQPConfig = SQPConfig(max_iter=2),
    pcg_cfg: Optional[PCGConfig] = None,
    sim_cfg: SimConfig = SimConfig(),
    linsys: str = "auto",
    dtype=jnp.float32,
    instance_mesh=None,
):
    """Scenario-parallel closed-loop MPC: `batch` perturbed-initial-state
    tracking experiments as ONE jitted program.

    instance_mesh: optional Mesh with an "instance" axis — the batch is
    shard_mapped across its devices (each device runs the identical scan on
    its local instance slab; zero collectives), so closed-loop MPC fleets
    scale across devices.

    The per-instance scan is vmapped: per-instance arrays are (batch,
    steps, ...), and ``shift_mask`` is (steps,) — the shift schedule is
    shared across instances.
    """
    N = knot_points
    nq = model.nq
    nx, nu = 2 * nq, nq
    traj_steps = xu_traj.shape[0]
    cost = cost or CostConfig.for_knots(N)
    pcg_cfg = pcg_cfg or PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
    if not sim_cfg.const_update_freq:
        raise ValueError("on-device sim supports const_update_freq mode only")

    period_s = sim_cfg.simulation_period_us * 1e-6
    shift_threshold = sim_cfg.shift_threshold_frac * timestep
    n_sub = int(period_s / sim_cfg.sim_step_time)

    # identical schedule logic to simulate_mpc_ondevice (shared helper)
    (shift_flags_j, tails, goal_tails, offsets_j, steps,
     xu_traj_j, ee_traj_j) = _ondevice_schedule(
        xu_traj, eepos_traj, N, nx, nu, timestep, period_s, shift_threshold,
        sim_cfg.max_control_updates, dtype)

    xu0 = xu_traj_j[:N]
    ee0 = ee_traj_j[:N]
    key = jax.random.PRNGKey(seed)
    dx0 = perturb_scale * jax.random.normal(key, (batch, nx), dtype)
    xs0_b = xu0[0, :nx][None, :] + dx0
    xu0_b = jnp.broadcast_to(xu0, (batch,) + xu0.shape)
    xu0_b = xu0_b.at[:, 0, :nx].set(xs0_b)
    lam0_b = jnp.zeros((batch, N, nx), dtype)
    ee0_b = jnp.broadcast_to(ee0, (batch,) + ee0.shape)
    rho0_b = jnp.full((batch,), 1e-3, dtype)

    if instance_mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        ax = "instance"
        if batch % instance_mesh.shape[ax]:
            raise ValueError(f"batch {batch} not divisible by "
                             f"{instance_mesh.shape[ax]} instance devices")

        def local(xu_b, lam_b, xs_b, ee_b, rho_b):
            outs, fe = _ondevice_run_batched(
                model, cost, sqp_cfg, pcg_cfg, linsys, timestep, period_s,
                n_sub, sim_cfg.sim_step_time, xu_b, lam_b, xs_b, ee_b, rho_b,
                shift_flags_j, tails, goal_tails, offsets_j)
            return outs["err"], outs["shifted"], fe

        fn = shard_map(local, mesh=instance_mesh,
                       in_specs=(P(ax),) * 5,
                       out_specs=(P(ax), P(), P(ax)),
                       check_vma=False)
        err, shifted, final_err = fn(xu0_b, lam0_b, xs0_b, ee0_b, rho0_b)
        return dict(tracking_errors=err, shift_mask=shifted,
                    final_tracking_error=final_err, control_updates=steps)

    outs, final_err = _ondevice_run_batched(
        model, cost, sqp_cfg, pcg_cfg, linsys, timestep, period_s, n_sub,
        sim_cfg.sim_step_time,
        xu0_b, lam0_b, xs0_b, ee0_b, rho0_b,
        shift_flags_j, tails, goal_tails, offsets_j)
    return dict(
        tracking_errors=outs["err"],            # (batch, steps)
        shift_mask=outs["shifted"],             # (steps,) shared schedule
        final_tracking_error=final_err,         # (batch,)
        control_updates=steps,
    )


@highest_precision
@partial(jax.jit, static_argnames=("cost", "sqp_cfg", "pcg_cfg", "linsys",
                                   "timestep", "period_s", "n_sub", "sim_step"))
def _ondevice_run_batched(model, cost, sqp_cfg, pcg_cfg, linsys, timestep,
                          period_s, n_sub, sim_step,
                          xu0_b, lam0_b, xs0_b, ee0_b, rho0_b,
                          shift_flags, tails, goal_tails, offsets):
    run1 = lambda xu0, lam0, xs0, ee0, rho0: _ondevice_scan(
        model, cost, sqp_cfg, pcg_cfg, linsys, timestep, period_s, n_sub,
        sim_step, xu0, lam0, xs0, ee0, rho0,
        shift_flags, tails, goal_tails, offsets)
    outs, final_err = jax.vmap(run1)(xu0_b, lam0_b, xs0_b, ee0_b, rho0_b)
    outs["shifted"] = outs["shifted"][0]
    return outs, final_err
