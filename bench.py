#!/usr/bin/env python3
"""Headline benchmark: per-control-step latency of the warm-started MPC chain.

One control step is one full SQP iteration (KKT assembly -> Schur + stair
preconditioner -> PCG -> dz recovery -> 8-alpha line search -> iterate
update) on the IIWA-14 at N knots (default 64), against the reference's
real-time budget of SQP_MAX_TIME_US = 2000 us per control step
(settings.cuh:161-163, BASELINE.md).  PCG runs at the reference cap for the
horizon (PCGConfig.tuned_max_iter, settings.cuh:124-144) with the eta exit
at 1e-5.

Methodology: K control steps of a warm-started MPC chain run inside one
jitted program (`lax.fori_loop` with a traced trip count, so every length
shares one compiled program); each step shifts the goal window and the warm
start by one knot and advances the initial state, like the closed-loop
tracker (mpcsim.cuh:297-347), so every solve does real work.  Two chain
lengths (K_LO and K_HI over the same trajectory prefix) are timed in turns
and the headline is their difference over the extra steps: the per-call
dispatch cost cancels, leaving the steady-state device latency per step.

Usage:
    python bench.py                          # N=64, platform default solver
    python bench.py --linsys pcg_pallas pcg  # both, timed in turns

Runs in one process on the default device and fails (non-zero exit) when
that is not a GPU, or on any error.  Prints the device and the card's name
and power limit, then one JSON line per variant; the last line is the
first variant's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

METRIC = "sqp_iteration_latency_iiwa"
K_LO, K_HI = 256, 768
REPS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_chain(N: int, linsys: str):
    """jitted chain(k, xu, lam, xs, ee, rho) -> (state..., total PCG iters)."""
    import jax
    import jax.numpy as jnp

    from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.solver.sqp import sqp_solve
    from mpcgpu.utils.trajfiles import load_eepos_traj

    dtype = jnp.float32
    model = iiwa14(dtype=dtype)
    cost = CostConfig.for_knots(N)
    pcg_cfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)
    sqp_cfg = SQPConfig(max_iter=1)
    ee_full = jnp.asarray(load_eepos_traj("0_0"), dtype)

    @jax.jit
    def chain(k, xu0, lam0, xs0, ee0, rho0):
        def body(i, carry):
            xu_, lam_, xs_, ee_, rho_, iters = carry
            res = sqp_solve(model, cost, sqp_cfg, pcg_cfg, xu_, lam_, xs_,
                            ee_, rho_, 1.0 / 64.0, linsys=linsys)
            # MPC shift (mpcsim.cuh:297-347): advance one knot, backfill the
            # tail, move the goal window along the recorded trace
            xu_n = jnp.roll(res.xu, -1, axis=0).at[-1].set(res.xu[-1])
            lam_n = jnp.roll(res.lam, -1, axis=0).at[-1].set(res.lam[-1])
            ee_n = jnp.roll(ee_, -1, axis=0).at[-1].set(
                jax.lax.dynamic_index_in_dim(
                    ee_full, (i + N) % ee_full.shape[0], keepdims=False))
            return (xu_n, lam_n, res.xu[1, :14], ee_n, res.rho,
                    iters + res.pcg_iters[0])

        init = (xu0, lam0, xs0, ee0, rho0, jnp.int32(0))
        return jax.lax.fori_loop(0, k, body, init)

    return chain, pcg_cfg


def chain_inputs(N: int):
    import jax
    import jax.numpy as jnp

    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    dtype = jnp.float32
    xu = jnp.asarray(load_xu_traj("0_0")[:N], dtype)
    xu = xu + 0.01 * jax.random.normal(jax.random.PRNGKey(0), xu.shape, dtype)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], dtype)
    return (xu, jnp.zeros((N, 14), dtype), xu[0, :14], ee,
            jnp.asarray(1e-3, dtype))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--knots", type=int, default=64)
    ap.add_argument("--linsys", nargs="+", default=["auto"],
                    help="linear solvers to time in turns (auto, pcg, "
                         "pcg_pallas, ldl, pcr)")
    args = ap.parse_args(argv)

    import jax

    from mpcgpu.device import resolve_linsys
    from mpcgpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's default device is "
                         f"{dev.platform!r}")
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()))
    card = card_line()
    print(f"device: {device}  card: {card}", flush=True)

    N = args.knots
    inputs = chain_inputs(N)
    variants = []
    for name in args.linsys:
        linsys = resolve_linsys(name, "stair", N)
        chain, pcg_cfg = make_chain(N, linsys)
        t0 = time.perf_counter()
        jax.block_until_ready(chain(K_LO, *inputs))
        compile_s = time.perf_counter() - t0
        variants.append(dict(linsys=linsys, chain=chain, cap=pcg_cfg.max_iter,
                             compile_s=compile_s, t_lo=[], t_hi=[]))

    def timed(v, k):
        t0 = time.perf_counter()
        out = v["chain"](k, *inputs)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) * 1e6, int(out[-1])

    for _ in range(REPS):          # variants and lengths in turns: drift cancels
        for v in variants:
            t, v["it_lo"] = timed(v, K_LO)
            v["t_lo"].append(t)
            t, v["it_hi"] = timed(v, K_HI)
            v["t_hi"].append(t)

    lines = []
    for v in variants:
        slopes = [(b - a) / (K_HI - K_LO) for a, b in zip(v["t_lo"], v["t_hi"])]
        slope = float(np.median(slopes))
        lines.append(json.dumps(dict(
            metric=f"{METRIC}_n{N}", value=slope, unit="us",
            vs_baseline=2000.0 / slope,
            slopes_us=slopes,
            knots=N, linsys=v["linsys"], pcg_cap=v["cap"], exit_tol=1e-5,
            exit_criterion="eta",
            mean_pcg_iters=(v["it_hi"] - v["it_lo"]) / (K_HI - K_LO),
            wall_per_step_us=float(np.median(v["t_lo"])) / K_LO,
            dispatch_us=float(np.median(v["t_lo"])) - K_LO * slope,
            compile_s=v["compile_s"], chain_len=[K_LO, K_HI],
            device=device, card=card)))
    for line in lines[1:] + lines[:1]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
