#!/usr/bin/env python3
"""Re-derive the tuned PCG iteration caps on the GPU.

The reference ships an empirical PCG_MAX_ITER table "found using experiments"
(settings.cuh:123-144: N=32:173, 64:167, 128:167, 256:118, 512:67). This tool
reproduces that tuning workflow natively: for each horizon it runs the fully
on-device closed-loop tracker across a sweep of iteration caps and reports
tracking quality vs per-step latency, so the caps can be re-tuned for any
robot/horizon/chip combination.

Usage: python tools/tune_pcg_caps.py [--knots 32 64] [--caps 20 40 80 167] \
         [--steps 600]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from mpcgpu.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu.models import iiwa14
from mpcgpu.sim.mpc import simulate_mpc_ondevice
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, nargs="*", default=[32, 64])
    ap.add_argument("--caps", type=int, nargs="*",
                    default=[20, 40, 80, 120, 167])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--sqp-iters", type=int, default=2)
    ap.add_argument("--exit-criterion", default="eta",
                    choices=["eta", "rnorm"],
                    help="rnorm = the reference's ||r|| < tol (the headline "
                    "criterion); retunes the caps under it")
    ap.add_argument("--tols", type=float, nargs="*", default=[1e-5],
                    help="exit tolerances to sweep (eta<->rnorm mapping: "
                    "sweep both criteria over a tol grid and match rows of "
                    "equal tracking error)")
    args = ap.parse_args()

    model = iiwa14()
    xu_traj = load_xu_traj("0_0")[:300]
    ee_traj = load_eepos_traj("0_0")[:300]
    sim = SimConfig(max_control_updates=args.steps)
    scfg = SQPConfig(max_iter=args.sqp_iters, max_time_us=None)

    for N in args.knots:
      for tol in args.tols:
        for cap in args.caps:
            pcfg = PCGConfig(max_iter=cap, exit_tol=tol,
                             exit_criterion=args.exit_criterion)
            dev = simulate_mpc_ondevice(model, xu_traj, ee_traj, N, 1 / 64.0,
                                        sqp_cfg=scfg, pcg_cfg=pcfg, sim_cfg=sim)
            jax.block_until_ready(dev["final_tracking_error"])
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                dev = simulate_mpc_ondevice(model, xu_traj, ee_traj, N,
                                            1 / 64.0, sqp_cfg=scfg,
                                            pcg_cfg=pcfg, sim_cfg=sim)
                jax.block_until_ready(dev["final_tracking_error"])
                walls.append(time.perf_counter() - t0)
            wall = float(np.median(walls))
            steps = int(dev["control_updates"])
            errs = np.asarray(dev["tracking_errors"])
            it = np.asarray(dev["pcg_iters"])
            live = it[it >= 0]
            print(json.dumps(dict(
                knots=N, pcg_cap=cap, exit_criterion=args.exit_criterion,
                exit_tol=tol, sqp_iters=args.sqp_iters,
                us_per_control_step=round(wall * 1e6 / steps, 1),
                avg_tracking_error=round(float(errs.mean()), 5),
                final_tracking_error=round(float(dev["final_tracking_error"]), 5),
                mean_pcg_iters=round(float(live.mean()), 1) if live.size else None,
                max_iter_exit_pct=(round(100.0 * float((live >= cap).mean()), 1)
                                   if live.size else None),
            )))


if __name__ == "__main__":
    main()
