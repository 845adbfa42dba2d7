#!/usr/bin/env python3
"""Warm-start study: does extrapolating the shifted multipliers cut PCG work?

The reference warm-starts each MPC step's PCG from the previous step's
multipliers shifted by one knot (mpcsim.cuh:186-190, :297-347).  Since lambda
varies smoothly along the tracked trajectory, a linear extrapolation

    lam_warm = shift(lam_t) + beta * (shift(lam_t) - shift(lam_{t-1}))

might start PCG closer to the solution at zero per-iteration cost — directly
cutting the rnorm-primary headline if it works.  This script measures mean
live PCG iterations and final merit over a warm MPC chain for beta in
{0 (reference), 0.5, 1.0}.

Usage: JAX_PLATFORMS=cpu python benchmarks/warmstart_study.py
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, default=32)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--betas", type=float, nargs="*", default=[0.0, 0.5, 1.0])
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--exit-criterion", default="rnorm",
                    choices=["eta", "rnorm"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.solver.sqp import sqp_solve
    from mpcgpu.utils.compile_cache import enable_compile_cache
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    enable_compile_cache()

    N = args.knots
    dtype = jnp.float32
    model = iiwa14(dtype=dtype)
    cost = CostConfig.for_knots(N)
    pcg_cfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(N),
                        exit_tol=args.tol, exit_criterion=args.exit_criterion)
    sqp_cfg = SQPConfig(max_iter=1)

    ee_full = jnp.asarray(load_eepos_traj("0_0"), dtype)
    xu0 = jnp.asarray(load_xu_traj("0_0")[:N], dtype)
    xu0 = xu0 + 0.01 * jax.random.normal(jax.random.PRNGKey(0), xu0.shape, dtype)

    @jax.jit
    def chain(beta):
        def body(i, carry):
            xu_, lam_, lam_prev_aligned, xs_, ee_, rho_, iters = carry
            # lam_ = shift(lam_{t-1}); lam_prev_aligned = shift(shift-base of
            # step t-1) — both aligned with this step's knot window, so their
            # difference is a per-knot time derivative estimate
            lam_warm = lam_ + beta * (lam_ - lam_prev_aligned)
            res = sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu_, lam_warm,
                            xs_, ee_, rho_, 1.0 / 64.0, linsys="pcg")
            xu_n = jnp.roll(res.xu, -1, axis=0).at[-1].set(res.xu[-1])
            lam_n = jnp.roll(res.lam, -1, axis=0).at[-1].set(res.lam[-1])
            lam_shift_cur = jnp.roll(lam_, -1, axis=0).at[-1].set(lam_[-1])
            xs_n = res.xu[1, :14]
            ee_n = jnp.roll(ee_, -1, axis=0).at[-1].set(
                jax.lax.dynamic_index_in_dim(
                    ee_full, (i + N) % ee_full.shape[0], keepdims=False))
            return (xu_n, lam_n, lam_shift_cur, xs_n, ee_n, res.rho,
                    iters + res.pcg_iters[0])

        lam = jnp.zeros((N, 14), dtype)
        init = (xu0, lam, lam, xu0[0, :14], ee_full[:N],
                jnp.asarray(1e-3, dtype), jnp.int32(0))
        out = jax.lax.fori_loop(0, args.steps, body, init)
        return out[6], out[5]

    for beta in args.betas:
        iters, rho = chain(jnp.asarray(beta, dtype))
        print(json.dumps(dict(beta=beta, mean_pcg_iters=round(
            float(iters) / args.steps, 1), final_rho=float(rho))))


if __name__ == "__main__":
    main()
