#!/usr/bin/env python3
"""Preconditioner-variant study: iterations-to-tolerance on real Schur systems.

Measures what each preconditioner variant buys in PCG iteration count under
the reference's ||r|| < tol exit (the headline-primary criterion), on Schur
systems captured from the actual tracking problem (0_0 trace, production
float32), with MPC-style warm starts.

Variants (ops/schur.py::form_schur_system + ops/pcg.py::pcg_solve):
  jacobi        Pinv = D^-1                                (3 bands, baseline)
  stair         Pinv = D^-1 - D^-1 T D^-1                  (3 bands, reference:
                linsys_setup.cuh:97-136)
  stair+poly2   z = (2 Pinv - Pinv S Pinv) r in-loop       (3 bands, 2x matvec
                work per iteration)
  stair2        Pinv = stair + D^-1 T D^-1 T D^-1          (5 bands, 1.33x
                matvec work, unconditionally SPD)
  stair2+poly2  both                                       (1.66x... 2.33x)

Cost model: one classic PCG iteration moves (bands(S) + k_applies *
bands(Pinv) + extra S applies) block-matvec units; the table reports raw
iterations AND matvec-unit-weighted cost relative to stair, which is what
survives on hardware where the iteration is bandwidth/latency bound.

Usage: JAX_PLATFORMS=cpu python benchmarks/precond_study.py
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, nargs="*", default=[32, 64, 128])
    ap.add_argument("--tols", type=float, nargs="*", default=[1e-4, 1e-5, 1e-6])
    ap.add_argument("--max-iter", type=int, default=10000)
    args = ap.parse_args()

    import jax.numpy as jnp

    from mpcgpu.config import CostConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.ops.pcg import pcg_solve
    from mpcgpu.ops.schur import form_schur_system
    from mpcgpu.solver.kkt import build_kkt
    from mpcgpu.utils.compile_cache import enable_compile_cache
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    enable_compile_cache()

    dtype = jnp.float32
    model = iiwa14(dtype=dtype)
    cost = CostConfig()
    rho = 1e-3
    dt = 1.0 / 64.0
    nx = 14

    # per-iteration block-matvec units: S apply + preconditioner applies
    variants = {
        "jacobi": dict(precond="jacobi", poly=1, cost=(3 + 3) / 6.0),
        "stair": dict(precond="stair", poly=1, cost=(3 + 3) / 6.0),
        "stair+poly2": dict(precond="stair", poly=2, cost=(3 + 3 + 3 + 3) / 6.0),
        "stair2": dict(precond="stair2", poly=1, cost=(3 + 5) / 6.0),
        "stair2+poly2": dict(precond="stair2", poly=2, cost=(3 + 5 + 3 + 5) / 6.0),
    }

    rows = []
    for N in args.knots:
        xu_traj = load_xu_traj("0_0")
        ee_traj = load_eepos_traj("0_0")
        xu = jnp.asarray(xu_traj[:N], dtype)
        xu = xu + 0.01 * jnp.sin(jnp.arange(xu.size, dtype=dtype)).reshape(xu.shape)
        xs = xu[0, :nx] + 0.005
        ee_goal = jnp.asarray(ee_traj[:N], dtype)
        kkt = build_kkt(model, cost, xu, xs, ee_goal, dt)

        # MPC-style warm start: solve the same system loosely first
        base = form_schur_system(kkt, rho, preconditioner="stair")
        warm = pcg_solve(
            base.S, base.Pinv, base.gamma, jnp.zeros_like(base.gamma),
            max_iter=args.max_iter, exit_tol=1e-2, exit_criterion="rnorm",
        ).lam

        for name, v in variants.items():
            schur = form_schur_system(kkt, rho, preconditioner=v["precond"])
            for tol in args.tols:
                res = pcg_solve(
                    schur.S, schur.Pinv, schur.gamma, warm,
                    max_iter=args.max_iter, exit_tol=tol,
                    exit_criterion="rnorm", precond_poly=v["poly"],
                )
                it = int(res.iters)
                rows.append(
                    dict(N=N, variant=name, tol=tol, iters=it,
                         converged=bool(res.converged),
                         rel_cost=round(it * v["cost"], 1))
                )
                print(json.dumps(rows[-1]))

    # summary table: iterations (cost-weighted) per variant x (N, tol)
    names = list(variants)
    print("\n| N | tol | " + " | ".join(names) + " |")
    print("|" + "---|" * (2 + len(names)))
    for N in args.knots:
        for tol in args.tols:
            cells = []
            for name in names:
                r = next(r for r in rows
                         if r["N"] == N and r["tol"] == tol and r["variant"] == name)
                mark = "" if r["converged"] else "*"
                cells.append(f"{r['iters']}{mark} ({r['rel_cost']})")
            print(f"| {N} | {tol:g} | " + " | ".join(cells) + " |")
    print("\ncells: iterations (stair-matvec-equivalent cost); * = hit max_iter")


if __name__ == "__main__":
    main()
