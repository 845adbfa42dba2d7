#!/usr/bin/env python3
"""THE canonical performance methodology — regenerates PARITY.md's numbers.

One methodology, one script: every
headline latency is the per-control-step device latency of a REALISTIC
WARM-STARTED MPC CHAIN, identical to bench.py:

  * K control steps run INSIDE one jitted ``lax.fori_loop``;
  * each step: ONE full SQP iteration (KKT -> Schur+stair -> PCG -> dz ->
    9-candidate line search -> L-M rho update), then the MPC shift
    (mpcsim.cuh:297-347): roll the plan/multipliers one knot, advance the
    goal window along the recorded 0_0 trace, re-pin the initial state;
  * TWO chain lengths (K and 3K) over the same trajectory prefix; the
    latency is the two-K SLOPE (t_3K - t_K)/2K — the steady-state
    per-step device cost of steps K..3K-1, with the per-call dispatch
    constant cancelled exactly.  Each row also reports ``wall_us``, the
    single-K wall time per step, which still contains the dispatch;
  * PCG capped at the reference's tuned per-N max_iter (settings.cuh:124-144)
    with exit_tol 1e-5; one row per exit criterion — ``eta`` (PRIMARY:
    |r.P^-1 r| < tol IS the reference/GBD-PCG exit, re-derived round 5 from
    the consumed kernel surface, SURVEY.md C17 — its tolerance tables
    transfer under eta) and ``rnorm`` (absolute ||r|| < tol, a research
    variant that is always cap-bound at these tols in f32, i.e. the
    fixed-cap worst case — see tools/diagnose_rnorm.py);
  * each row reports the % of solves that exited on max-iter (the
    reference's health telemetry, mpcsim.cuh:382-387 warns above 50%);
  * each row also reports the chain's mean L1 end-effector tracking error
    (FK of the applied state vs the goal trace, the reference harness's
    accuracy metric, experiment.cuh:106-142) so latency is never quoted
    without its accuracy operating point.

Labeled variants (cold start, more SQP iterations, different linsys) belong
in benchmarks/run_all.py — anything in PARITY.md's horizon table comes from
HERE and nowhere else.

Usage: python benchmarks/parity_table.py [--knots 32 64 ...] [-K 256]
Emits one JSON line per horizon plus a ready-to-paste markdown table.
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, nargs="*",
                    default=[32, 64, 128, 256, 512])
    ap.add_argument("-K", type=int, default=256, help="chain length")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--linsys", default="auto")
    ap.add_argument("--exit-criterion", default="both",
                    choices=["rnorm", "eta", "both"])
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of perturbation seeds; >1 adds error bars "
                    "to the tracking-error column (latency is re-measured "
                    "per seed too; the 256-step chain's "
                    "quality column is seed-noisy)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu.device import resolve_linsys
    from mpcgpu.solver.sqp import sqp_solve
    from mpcgpu.models import iiwa14
    from mpcgpu.utils.compile_cache import enable_compile_cache
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"parity_table.py measures a GPU; JAX's default "
                         f"device is {dev.platform!r}")
    dtype = jnp.float32
    model = iiwa14(dtype=dtype)
    ee_full = jnp.asarray(load_eepos_traj("0_0"), dtype)
    xu_full = jnp.asarray(load_xu_traj("0_0"), dtype)
    K = args.K
    rows = []

    from mpcgpu.models.dynamics import fk_ee_xyz

    criteria = (["eta", "rnorm"] if args.exit_criterion == "both"
                else [args.exit_criterion])

    for N in args.knots:
        cost = CostConfig.for_knots(N)
        sqp_cfg = SQPConfig(max_iter=1)

        xu_seeds = [
            xu_full[:N] + 0.01 * jax.random.normal(
                jax.random.PRNGKey(s), xu_full[:N].shape, dtype)
            for s in range(args.seeds)
        ]
        xu = xu_seeds[0]
        ee0 = ee_full[:N]
        lam = jnp.zeros((N, 14), dtype)
        rho = jnp.asarray(1e-3, dtype)

        def make_chain(linsys, pcg_cfg, N=N, cost=cost, k=K):
            @jax.jit
            def chain(xu0, lam0, xs0, ee0, rho0):
                def body(i, carry):
                    xu_, lam_, xs_, ee_, rho_, iters, err, capped = carry
                    res = sqp_solve(
                        model, cost, sqp_cfg, pcg_cfg, xu_, lam_, xs_, ee_,
                        rho_, 1.0 / 64.0, linsys=linsys,
                    )
                    xu_n = jnp.roll(res.xu, -1, axis=0).at[-1].set(res.xu[-1])
                    lam_n = jnp.roll(res.lam, -1, axis=0).at[-1].set(res.lam[-1])
                    xs_n = res.xu[1, :14]
                    # L1 ee tracking error of the applied state vs its goal
                    # (the goal for knot 1 of the current window)
                    e = jnp.abs(fk_ee_xyz(model, xs_n[:7]) - ee_[1, :3]).sum()
                    ee_n = jnp.roll(ee_, -1, axis=0).at[-1].set(
                        jax.lax.dynamic_index_in_dim(
                            ee_full, (i + N) % ee_full.shape[0], keepdims=False))
                    return (xu_n, lam_n, xs_n, ee_n, res.rho,
                            iters + res.pcg_iters[0], err + e,
                            capped + (~res.pcg_converged[0]).astype(jnp.int32))

                init = (xu0, lam0, xs0, ee0, rho0, jnp.int32(0),
                        jnp.asarray(0.0, dtype), jnp.int32(0))
                return jax.lax.fori_loop(0, k, body, init)

            return chain

        for criterion in criteria:
            pcg_cfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(N),
                                exit_tol=1e-5, exit_criterion=criterion)
            linsys = resolve_linsys(args.linsys, "stair", N)
            xs = xu[0, :14]
            K_HI = 3 * K
            fn = make_chain(linsys, pcg_cfg)
            out = fn(xu, lam, xs, ee0, rho)
            jax.block_until_ready(out)
            fn_hi = make_chain(linsys, pcg_cfg, k=K_HI)
            jax.block_until_ready(fn_hi(xu, lam, xs, ee0, rho))

            slopes, walls, errs, iters_l, capped_l = [], [], [], [], []
            for xu_s in xu_seeds:
                xs_s = xu_s[0, :14]
                for _ in range(args.reps):
                    # interleave lo/hi so machine drift cancels in the slope
                    t0 = time.perf_counter()
                    out = fn(xu_s, lam, xs_s, ee0, rho)
                    jax.block_until_ready(out)
                    t_lo = (time.perf_counter() - t0) * 1e6
                    t0 = time.perf_counter()
                    out_hi = fn_hi(xu_s, lam, xs_s, ee0, rho)
                    jax.block_until_ready(out_hi)
                    t_hi = (time.perf_counter() - t0) * 1e6
                    slopes.append((t_hi - t_lo) / (K_HI - K))
                    walls.append(t_lo / K)
                # quality stats over the full long chain (3K steps)
                iters_l.append(float(np.asarray(out_hi[5])) / K_HI)
                errs.append(float(np.asarray(out_hi[6])) / K_HI)
                capped_l.append(100.0 * float(np.asarray(out_hi[7])) / K_HI)
            med = float(np.median(slopes))
            wall_med = float(np.median(walls))
            row = dict(knots=N, exit=criterion,
                       us_per_sqp_iteration=round(med, 1),
                       vs_2ms_budget=round(2000.0 / med, 2),
                       mean_pcg_iters=round(float(np.mean(iters_l)), 1),
                       mean_tracking_err=round(float(np.mean(errs)), 5),
                       max_iter_exit_pct=round(float(np.mean(capped_l)), 1),
                       pcg_cap=pcg_cfg.max_iter, linsys=linsys,
                       wall_us=round(wall_med, 1),
                       chain_len=[K, K_HI], warm="mpc-chain",
                       platform=dev.platform, kind=dev.device_kind)
            if args.seeds > 1:
                row["seeds"] = args.seeds
                row["tracking_err_std"] = round(float(np.std(errs)), 5)
            rows.append(row)
            print(json.dumps(row))

    print("\n| N | exit | SQP iter (us) | vs 2 ms budget | mean PCG iters "
          "| max-iter exits | mean L1 track err | cap | linsys |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['knots']} | {r['exit']} | {r['us_per_sqp_iteration']} | "
              f"{r['vs_2ms_budget']}x | {r['mean_pcg_iters']} | "
              f"{r['max_iter_exit_pct']}% | "
              f"{r['mean_tracking_err']} | "
              f"{r['pcg_cap']} | {r['linsys']} |")


if __name__ == "__main__":
    main()
