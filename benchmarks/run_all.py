#!/usr/bin/env python3
"""Benchmark harness covering the BASELINE.json config matrix.

Configs (BASELINE.json "configs"):
  1. direct LDL^T SQP solve, IIWA N=16 (qdldl-equivalent baseline)
  2. PCG with Jacobi (block-diagonal) preconditioner, N=32, one device
  3. full symmetric-stair PCG + SQP line search, N=64 (the headline; bench.py)
  4. batched parallel-scenario MPC: 256 instances/device, batched PCG
  5. long-horizon N=512 knot-sharded PCG (ppermute halos) — on all visible
     devices when there are several, else on one
  6. parallel-cyclic-reduction exact direct solve, N=64 (extra config)
  7. fully on-device closed-loop MPC (one jitted scan; extra config)
  8. scenario-parallel on-device closed loop (vmap of config 7; extra config)

Methodology: every metric is measured as chained invocations INSIDE one
jitted ``lax.fori_loop`` (a data token threads each result into the next
call's inputs) at TWO chain lengths (K and 3K); the reported value is the
slope (t_3K - t_K)/2K, which cancels the per-CALL dispatch cost exactly
(see bench.py).  Each PCG config runs the platform's default linear solver
(mpcgpu.device).

Prints one JSON line per config; PCG configs also report nnz/s throughput
(nnz of the BTD Schur matrix = 3*N*nx^2 - 2*nx^2 per PCG iteration).
Usage (on the GPU): python benchmarks/run_all.py [--configs 1 2 3]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from mpcgpu import device
from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu.models import iiwa14
from mpcgpu.ops import pcg_pallas
from mpcgpu.ops.pcg import pcg_solve
from mpcgpu.ops.pcr import pcr_solve_refined
from mpcgpu.ops.schur import form_schur_system
from mpcgpu.parallel.batched import make_batched_sqp_solver
from mpcgpu.parallel.mesh import make_mesh
from mpcgpu.parallel.pcg_sharded import pcg_solve_sharded
from mpcgpu.solver.kkt import build_kkt
from mpcgpu.solver.sqp import sqp_solve
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

NX = 14
DT = 1.0 / 64.0


def _problem(N, B=None, dtype=jnp.float32, seed=0):
    model = iiwa14(dtype=dtype)
    reps = (N + 665) // 666
    xu_np = np.concatenate([np.asarray(load_xu_traj("0_0"))] * reps)[:N]
    ee_np = np.concatenate([np.asarray(load_eepos_traj("0_0"))] * reps)[:N]
    xu = jnp.asarray(xu_np, dtype)
    ee = jnp.asarray(ee_np, dtype)
    xu = xu + 0.01 * jax.random.normal(jax.random.PRNGKey(seed), xu.shape, dtype)
    xs = xu[0, :NX]
    lam = jnp.zeros((N, NX), dtype)
    if B is not None:
        xu = jnp.broadcast_to(xu, (B,) + xu.shape)
        ee = jnp.broadcast_to(ee, (B,) + ee.shape)
        xs = jnp.broadcast_to(xs, (B,) + xs.shape)
        lam = jnp.zeros((B, N, NX), dtype)
    return model, xu, lam, xs, ee


def chain_time(stage, K=200, reps=3):
    """stage: scalar token -> scalar token (must consume/produce a data dep).

    Returns per-invocation seconds as the TWO-K SLOPE (t_3K - t_K)/2K of
    chains at K and 3K invocations: the per-CALL dispatch cost cancels
    exactly instead of leaving dispatch/K pollution in every row."""
    tiny = jnp.asarray(1e-37, jnp.float32)

    def make(k):
        @jax.jit
        def run(t):
            return jax.lax.fori_loop(0, k, lambda i, tt: stage(tt * tiny), t)
        return run

    run_lo, run_hi = make(K), make(3 * K)
    t0 = jnp.asarray(1.0, jnp.float32)
    jax.block_until_ready(run_lo(t0))
    jax.block_until_ready(run_hi(t0))
    slopes = []
    for _ in range(reps):  # interleave lo/hi so machine drift cancels
        s = time.perf_counter()
        jax.block_until_ready(run_lo(t0))
        t_lo = time.perf_counter() - s
        s = time.perf_counter()
        jax.block_until_ready(run_hi(t0))
        t_hi = time.perf_counter() - s
        slopes.append((t_hi - t_lo) / (2 * K))
    return float(np.median(slopes))


def emit(**kw):
    print(json.dumps(kw))


def cfg1_direct_n16(K=100):
    N = 16
    model, xu, lam, xs, ee = _problem(N)
    cost = CostConfig.for_knots(N)

    def stage(t):
        res = sqp_solve(model, cost, SQPConfig(max_iter=1), PCGConfig(),
                        xu + t, lam, xs, ee, 1e-3, DT, linsys="ldl")
        return res.merit + 1.0

    dt_s = chain_time(stage, K=K)
    emit(metric="direct_ldl_sqp_iteration_n16", value=round(dt_s * 1e6, 1), unit="us")


def _pcg_solver(N, preconditioner):
    """The platform's default PCG for this preconditioner and horizon."""
    if device.resolve_linsys("auto", preconditioner, N) == "pcg_pallas":
        return pcg_pallas.pcg_solve_pallas
    return pcg_solve


def _pcg_cfg(N, preconditioner, max_iter, metric, K=200):
    model, xu, lam, xs, ee = _problem(N)
    cost = CostConfig.for_knots(N)
    kkt = build_kkt(model, cost, xu, xs, ee, DT)
    schur = form_schur_system(kkt, 1e-3, preconditioner=preconditioner)
    pcg = _pcg_solver(N, preconditioner)
    solver = lambda g: pcg(
        schur.S, schur.Pinv, g, lam, max_iter=max_iter, exit_tol=0.0)

    def stage(t):
        return solver(schur.gamma + t).lam[0, 0] + 1.0

    dt_s = chain_time(stage, K=K)
    nnz = 3 * N * NX * NX - 2 * NX * NX
    emit(metric=metric, value=round(dt_s * 1e6, 1), unit="us", iters=max_iter,
         nnz_per_s=round(nnz * max_iter / dt_s),
         us_per_iter=round(dt_s * 1e6 / max_iter, 3))


def cfg2_jacobi_n32():
    _pcg_cfg(32, "jacobi", 173, "pcg_jacobi_solve_n32")


def cfg3_stair_n64(K=200):
    _pcg_cfg(64, "stair", 167, "pcg_stair_solve_n64")
    model, xu, lam, xs, ee = _problem(64)
    cost = CostConfig.for_knots(64)

    def stage(t):
        res = sqp_solve(model, cost, SQPConfig(max_iter=1),
                        PCGConfig(max_iter=167, exit_tol=1e-5),
                        xu + t, lam, xs, ee, 1e-3, DT)
        return res.merit + 1.0

    dt_s = chain_time(stage, K=K)
    emit(metric="sqp_pcg_iteration_n64", value=round(dt_s * 1e6, 1), unit="us",
         vs_2ms_budget=round(2000.0 / (dt_s * 1e6), 3))


def cfg4_batched(B=256, K=20, N=32):
    model, xu, lam, xs, ee = _problem(N, B=B)
    cost = CostConfig.for_knots(N)
    rho = jnp.full((B,), 1e-3, jnp.float32)
    batched = make_batched_sqp_solver(
        model, cost, SQPConfig(max_iter=1),
        PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5), DT,
        donate=False)

    def stage(t):
        res = batched(xu + t, lam, xs, ee, rho)
        return res.merit[0] + 1.0

    dt_s = chain_time(stage, K=K)
    emit(metric=f"batched_sqp_iteration_n{N}_b{B}", value=round(dt_s * 1e6, 1),
         unit="us", solves_per_s=round(B / dt_s))


def cfg5_long_horizon(N=512, K=50):
    n_dev = len(jax.devices())
    model, xu, lam, xs, ee = _problem(N)
    cost = CostConfig.for_knots(N)
    kkt = build_kkt(model, cost, xu, xs, ee, DT)
    schur = form_schur_system(kkt, 1e-3)
    nnz = 3 * N * NX * NX - 2 * NX * NX
    iters = 67
    if n_dev > 1:
        mesh = make_mesh(1, n_dev)
        solver = lambda g: pcg_solve_sharded(
            schur.S, schur.Pinv, g, lam, mesh, max_iter=iters, exit_tol=0.0)
    else:
        pcg = _pcg_solver(N, "stair")
        solver = lambda g: pcg(
            schur.S, schur.Pinv, g, lam, max_iter=iters, exit_tol=0.0)

    def stage(t):
        return solver(schur.gamma + t).lam[0, 0] + 1.0

    dt_s = chain_time(stage, K=K)
    emit(metric=f"pcg_long_horizon_n{N}_dev{n_dev}", value=round(dt_s * 1e6, 1),
         unit="us", iters=iters, nnz_per_s=round(nnz * iters / dt_s),
         devices=n_dev)


def cfg6_pcr_n64(K=200):
    N = 64
    model, xu, lam, xs, ee = _problem(N)
    cost = CostConfig.for_knots(N)
    kkt = build_kkt(model, cost, xu, xs, ee, DT)
    schur = form_schur_system(kkt, 1e-3)

    def stage(t):
        return pcr_solve_refined(schur.S, schur.gamma + t, refine=1)[0, 0] + 1.0

    dt_s = chain_time(stage, K=K)
    emit(metric="pcr_direct_solve_n64", value=round(dt_s * 1e6, 1), unit="us")


def cfg7_ondevice_sim():
    import time as _t

    from mpcgpu.sim.mpc import simulate_mpc_ondevice

    model = iiwa14()
    xu_traj = np.asarray(load_xu_traj("0_0"))
    ee_traj = np.asarray(load_eepos_traj("0_0"))
    scfg = SQPConfig(max_iter=2, max_time_us=None)
    dev = simulate_mpc_ondevice(model, xu_traj[:300], ee_traj[:300], 32, DT,
                                sqp_cfg=scfg)
    jax.block_until_ready(dev["final_tracking_error"])
    walls = []
    for _ in range(3):
        t0 = _t.perf_counter()
        dev = simulate_mpc_ondevice(model, xu_traj[:300], ee_traj[:300], 32, DT,
                                    sqp_cfg=scfg)
        jax.block_until_ready(dev["final_tracking_error"])
        walls.append(_t.perf_counter() - t0)
    wall = float(np.median(walls))
    steps = int(dev["control_updates"])
    emit(metric="ondevice_closed_loop_n32", value=round(wall * 1e6 / steps, 1),
         unit="us_per_control_step", control_updates=steps,
         avg_tracking_error=round(float(np.asarray(dev["tracking_errors"]).mean()), 5),
         run_wall_s=round(wall, 3))


def cfg8_scenario_parallel(B=32):
    import time as _t

    from mpcgpu.config import SimConfig
    from mpcgpu.sim.mpc import simulate_mpc_ondevice_batched

    model = iiwa14()
    xu_traj = np.asarray(load_xu_traj("0_0"))[:300]
    ee_traj = np.asarray(load_eepos_traj("0_0"))[:300]
    scfg = SQPConfig(max_iter=2, max_time_us=None)
    sim = SimConfig(max_control_updates=400)
    dev = simulate_mpc_ondevice_batched(model, xu_traj, ee_traj, 32, DT,
                                        batch=B, sqp_cfg=scfg, sim_cfg=sim)
    jax.block_until_ready(dev["final_tracking_error"])
    walls = []
    for _ in range(3):
        t0 = _t.perf_counter()
        dev = simulate_mpc_ondevice_batched(model, xu_traj, ee_traj, 32, DT,
                                            batch=B, sqp_cfg=scfg, sim_cfg=sim)
        jax.block_until_ready(dev["final_tracking_error"])
        walls.append(_t.perf_counter() - t0)
    wall = float(np.median(walls))
    steps = int(dev["control_updates"])
    errs = np.asarray(dev["final_tracking_error"])
    emit(metric=f"scenario_parallel_closed_loop_n32_b{B}",
         value=round(wall * 1e6 / (steps * B), 1), unit="us_per_instance_step",
         control_updates=steps, batch=B,
         instance_steps_per_s=round(steps * B / wall),
         mean_final_tracking_error=round(float(errs.mean()), 5))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batch-knots", type=int, default=32,
                    help="horizon for the batched config (BASELINE configs[3] "
                    "north star: N=64 B=256)")
    ap.add_argument("--configs", nargs="*", type=int, default=[1, 2, 3, 4, 5, 6, 7, 8])
    args = ap.parse_args()
    import bench
    from mpcgpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"run_all.py measures a GPU; JAX's default device "
                         f"is {dev.platform!r}")
    emit(platform=dev.platform, kind=dev.device_kind,
         devices=len(jax.devices()), card=bench.card_line())
    if 1 in args.configs:
        cfg1_direct_n16()
    if 2 in args.configs:
        cfg2_jacobi_n32()
    if 3 in args.configs:
        cfg3_stair_n64()
    if 4 in args.configs:
        cfg4_batched(args.batch, N=args.batch_knots)
    if 5 in args.configs:
        cfg5_long_horizon()
    if 6 in args.configs:
        cfg6_pcr_n64()
    if 7 in args.configs:
        cfg7_ondevice_sim()
    if 8 in args.configs:
        cfg8_scenario_parallel()


if __name__ == "__main__":
    main()
