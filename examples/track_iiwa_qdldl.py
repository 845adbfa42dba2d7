#!/usr/bin/env python3
"""IIWA end-effector tracking with the direct LDL^T linear-system solver.

The counterpart of examples/track_iiwa_qdldl.cu: identical pipeline to
the PCG driver with the linear solve swapped for the block-tridiagonal LDL^T
factorization (the reference's qdldl path, include/qdldl/sqp.cuh; exit_tol is
the -1 sentinel there, track_iiwa_qdldl.cu:44).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp

from mpcgpu.config import SimConfig, SQPConfig
from mpcgpu.models import iiwa14
from mpcgpu.sim.mpc import simulate_mpc
from mpcgpu.utils.compile_cache import enable_compile_cache
from mpcgpu.utils.experiment import dump_tracking_data, print_stats, write_overall_stats_csv
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, default=32)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--traj", default="0_0")
    ap.add_argument("--grid", action="store_true",
                    help="iterate the reference's 5x5 start/goal grid with "
                         "its skip rule (track_iiwa_pcg.cu:30-43)")
    ap.add_argument("--test-iters", type=int, default=1)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--linsys", default="ldl",
                    choices=["ldl", "pcr", "qdldl_host"],
                    help="direct solver: 'ldl' = on-device block LDL^T "
                    "(default; no per-iteration D2H), 'qdldl_host' = the "
                    "reference's literal host factor/solve round-trip "
                    "(qdldl/sqp.cuh:268-273)")
    args = ap.parse_args()
    enable_compile_cache()

    model = iiwa14(dtype=jnp.float32)
    traj_names = ([f"{i % 5}_{i // 5}" for i in range(25)
                   if not (i % 5 == i // 5 and i % 5 != 0)]
                  if args.grid else [args.traj])

    print(f"knots={args.knots} solver=LDL^T (qdldl-equivalent) pairs={traj_names}")
    rows = []
    for name in traj_names:
        xu_traj = load_xu_traj(name)
        ee_traj = load_eepos_traj(name)
        if args.steps:
            if args.steps <= args.knots:
                ap.error(f"--steps ({args.steps}) must exceed --knots ({args.knots})")
            xu_traj, ee_traj = xu_traj[: args.steps], ee_traj[: args.steps]
        for it in range(args.test_iters):
            stats = simulate_mpc(
                model, xu_traj, ee_traj,
                knot_points=args.knots,
                timestep=1.0 / 64.0,
                sqp_cfg=SQPConfig(),
                sim_cfg=SimConfig(),
                linsys=args.linsys,
                verbose=args.verbose,
            )
            s = stats.summary()
            s["traj"] = name
            rows.append(s)
            print(name, s)
            print_stats(stats.sqp_times_us, "sqp solve time (us)")
            if args.save:
                dump_tracking_data(args.outdir, f"qdldl_{args.knots}_{name}", stats, it)
    if args.save:
        write_overall_stats_csv(f"{args.outdir}/qdldl_{args.knots}_overall_stats.csv", rows)


if __name__ == "__main__":
    main()
