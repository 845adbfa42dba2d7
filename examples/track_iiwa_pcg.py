#!/usr/bin/env python3
"""IIWA end-effector tracking with the PCG linear-system solver.

The counterpart of examples/track_iiwa_pcg.cu: loads the recorded
start/goal trajectory pair, sweeps PCG exit tolerances, runs the closed-loop
MPC tracker, and writes per-run .result files plus an `_overall_stats.csv`
(track_iiwa_pcg.cu:39-175).

Usage:  python examples/track_iiwa_pcg.py [--knots 32] [--steps 200] [--save]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp

from mpcgpu.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu.models import iiwa14
from mpcgpu.sim.mpc import simulate_mpc
from mpcgpu.utils.compile_cache import enable_compile_cache
from mpcgpu.utils.experiment import dump_tracking_data, print_stats, write_overall_stats_csv
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

# reference tolerance sweeps (track_iiwa_pcg.cu:46-73)
TOL_SWEEP = {
    32: [5e-6, 7.5e-6, 5e-6, 2.5e-6, 1e-6],
    64: [5e-5, 7.5e-5, 5e-5, 2.5e-5, 1e-5],
}
DEFAULT_TOLS = [1e-5, 5e-5, 1e-4, 5e-4, 1e-3]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, default=32)
    ap.add_argument("--steps", type=int, default=None, help="trajectory steps to track")
    ap.add_argument("--traj", default="0_0")
    ap.add_argument("--grid", action="store_true",
                    help="iterate the reference's 5x5 start/goal grid with "
                         "its skip rule (track_iiwa_pcg.cu:30-43) instead of "
                         "a single --traj pair")
    ap.add_argument("--tols", type=float, nargs="*", default=None)
    ap.add_argument("--exit-criterion", default="eta", choices=["eta", "rnorm"],
                    help="PCG exit metric: 'eta' = |r.P^-1 r| < tol (default), "
                         "'rnorm' = ||r|| < tol (reference/GBD-PCG semantics; "
                         "the reference tolerance tables transfer directly)")
    ap.add_argument("--test-iters", type=int, default=1)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--linsys", default="auto",
                    help="linear solver (auto = the platform's default, pcg, "
                    "pcg_pallas, ldl, pcr, qdldl_host)")
    ap.add_argument("--knot-shards", type=int, default=0,
                    help="with --ondevice: run every solve knot-sharded SPMD "
                    "over this many devices (parallel/sqp_sharded.py)")
    ap.add_argument("--ondevice", action="store_true",
                    help="run the whole closed loop as ONE jitted scan "
                         "(no per-control-step host dispatch)")
    ap.add_argument("--remove-jitters", type=int, default=0,
                    help="discarded warm-up solves before the tracking loop "
                         "(REMOVE_JITTERS, mpcsim.cuh:222-242; the reference "
                         "defaults to 100 — here jit caching makes warm-up "
                         "redundant beyond the single compile call, so the "
                         "default is 0)")
    ap.add_argument("--forcing", default="fixed", choices=["fixed", "ew"],
                    help="per-SQP-iteration linear-solve tolerance schedule "
                         "(ew = Eisenstat-Walker-style loose first solve)")
    ap.add_argument("--live-print-path", action="store_true",
                    help="stream the measured state every control step "
                         "(LIVE_PRINT_PATH, settings.cuh:20-26)")
    args = ap.parse_args()
    enable_compile_cache()

    model = iiwa14(dtype=jnp.float32)
    if args.grid:
        # 5x5 start/goal grid, skip start == goal != 0 -> 21 pairs
        # (track_iiwa_pcg.cu:30-43; the reference `break`s after the first
        # combo at :177 — here the loop really runs)
        traj_names = [f"{ind % 5}_{ind // 5}" for ind in range(25)
                      if not (ind % 5 == ind // 5 and ind % 5 != 0)]
    else:
        traj_names = [args.traj]

    def load_pair(name):
        xu_traj = load_xu_traj(name)
        ee_traj = load_eepos_traj(name)
        if args.steps:
            if args.steps <= args.knots:
                ap.error(f"--steps ({args.steps}) must exceed --knots ({args.knots})")
            xu_traj, ee_traj = xu_traj[: args.steps], ee_traj[: args.steps]
        return xu_traj, ee_traj

    xu_traj, ee_traj = load_pair(traj_names[0])

    if args.ondevice:
        import time

        import jax
        import numpy as np

        from mpcgpu.sim.mpc import simulate_mpc_ondevice

        mesh_kw = {}
        if args.knot_shards:
            from mpcgpu.parallel.mesh import make_mesh

            mesh_kw = dict(knot_mesh=make_mesh(1, args.knot_shards))
        tols = args.tols or [1e-5]
        for tol in tols:
            scfg = SQPConfig(max_iter=2, max_time_us=None)
            pcfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(args.knots),
                             exit_tol=tol, exit_criterion=args.exit_criterion,
                             forcing=args.forcing)
            dev = simulate_mpc_ondevice(model, xu_traj, ee_traj, args.knots,
                                        1.0 / 64.0, sqp_cfg=scfg, pcg_cfg=pcfg,
                                        linsys=args.linsys, **mesh_kw)
            jax.block_until_ready(dev["final_tracking_error"])
            t0 = time.perf_counter()
            dev = simulate_mpc_ondevice(model, xu_traj, ee_traj, args.knots,
                                        1.0 / 64.0, sqp_cfg=scfg, pcg_cfg=pcfg,
                                        linsys=args.linsys, **mesh_kw)
            jax.block_until_ready(dev["final_tracking_error"])
            wall = time.perf_counter() - t0
            steps = int(dev["control_updates"])
            print(f"tol={tol}: {steps} control steps in {wall:.3f}s "
                  f"({1e6 * wall / steps:.0f} us/step), "
                  f"avg_tracking_error={float(np.asarray(dev['tracking_errors']).mean()):.5f}, "
                  f"final={float(dev['final_tracking_error']):.5f}")
        return

    tols = args.tols or TOL_SWEEP.get(args.knots, DEFAULT_TOLS)
    print(f"knots={args.knots} solver=PCG pairs={traj_names} "
          f"max_iter={PCGConfig.tuned_max_iter(args.knots)} tols={tols}")

    rows = []
    for name in traj_names:
        xu_traj, ee_traj = load_pair(name)
        if args.grid:
            print(f"start/goal pair {name}: {len(xu_traj)} steps")
        for tol in tols:
            for it in range(args.test_iters):
                stats = simulate_mpc(
                    model, xu_traj, ee_traj,
                    knot_points=args.knots,
                    timestep=1.0 / 64.0,
                    sqp_cfg=SQPConfig(),
                    pcg_cfg=PCGConfig(max_iter=PCGConfig.tuned_max_iter(args.knots),
                                      exit_tol=tol,
                                      exit_criterion=args.exit_criterion,
                                      forcing=args.forcing),
                    sim_cfg=SimConfig(remove_jitters=args.remove_jitters,
                                      live_print_path=args.live_print_path),
                    linsys=args.linsys,
                    verbose=args.verbose,
                )
                s = stats.summary()
                s["exit_tol"] = tol
                s["traj"] = name
                rows.append(s)
                print(f"{name} tol={tol:g}: {s}")
                print_stats(stats.sqp_times_us, "sqp solve time (us)")
                if args.save:
                    dump_tracking_data(
                        args.outdir, f"pcg_{args.knots}_{name}_{tol:g}", stats, it)
    if args.save:
        write_overall_stats_csv(f"{args.outdir}/pcg_{args.knots}_overall_stats.csv", rows)


if __name__ == "__main__":
    main()
