#!/usr/bin/env python3
"""Device time per SQP stage and how the loops run, from jax.profiler traces.

For each horizon (optionally over a vmapped batch of instances) and each
linear solver:

* the whole chain: bench.py's warm-started MPC chain for a few control
  steps under the profiler -> device window, busy time and idle share per
  step, device kernels, device-to-host copies and CUDA-graph launches per
  step;
* each stage alone: KKT assembly, Schur + stair preconditioner, PCG (at the
  reference cap, forced to run all of it), dz recovery and the 9-candidate
  line search, each applied STAGE_REPS times in one jitted loop with a data
  dependence from one application to the next -> device busy time per
  application and, for PCG, kernels, device-to-host copies and graph
  launches per CG iteration.

The reduction is mpcgpu.utils.profiling.reduce_trace.

Usage (on the GPU):
    python benchmarks/profile_stages.py --knots 32 64 --linsys pcg_pallas pcg
    python benchmarks/profile_stages.py --knots 32 --batch 256

Prints one JSON line per configuration; traces go under --outdir.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAGE_REPS = 10
DT = 1.0 / 64.0


def traced(jax, fn, args, logdir):
    """Run the compiled fn(*args) once under the profiler; trace stats."""
    from mpcgpu.utils.profiling import load_trace, reduce_trace, trace

    jax.block_until_ready(fn(*args))                    # compile + warm
    with trace(logdir):
        out = fn(*args)
        jax.block_until_ready(out)
    path = sorted(glob.glob(f"{logdir}/plugins/profile/*/*.xplane.pb"))[-1]
    return out, reduce_trace(*load_trace(path))


def stage_programs(jax, jnp, N, linsys, batch):
    """jitted stage loops: fn(token) applies the stage STAGE_REPS times.
    Only the "pcg" stage depends on linsys."""
    import bench
    from mpcgpu.config import CostConfig, PCGConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.ops import pcg_pallas
    from mpcgpu.ops.pcg import pcg_solve
    from mpcgpu.ops.schur import compute_dz, form_schur_system
    from mpcgpu.solver.kkt import build_kkt
    from mpcgpu.solver.merit import line_search_merits

    model = iiwa14(dtype=jnp.float32)
    cost = CostConfig.for_knots(N)
    cap = PCGConfig.tuned_max_iter(N)
    xu, lam, xs, ee, rho = bench.chain_inputs(N)
    pcg = pcg_pallas.pcg_solve_pallas if linsys == "pcg_pallas" else pcg_solve
    kkt = build_kkt(model, cost, xu, xs, ee, DT)
    schur = form_schur_system(kkt, rho)
    lam1 = pcg(schur.S, schur.Pinv, schur.gamma, lam, max_iter=cap,
               exit_tol=1e-5).lam
    dz = compute_dz(kkt, schur, lam1)
    mu = jnp.asarray(10.0, jnp.float32)
    tiny = jnp.asarray(1e-30, jnp.float32)

    stages = {
        "kkt": lambda t: build_kkt(model, cost, xu + t, xs, ee, DT).q[0, 0],
        "schur": lambda t: form_schur_system(kkt, rho + t).gamma[0, 0],
        "pcg": lambda t: pcg(schur.S, schur.Pinv, schur.gamma + t, lam,
                             max_iter=cap, exit_tol=0.0).lam[0, 0],
        "dz": lambda t: compute_dz(kkt, schur, lam1 + t)[0, 0],
        "merit": lambda t: line_search_merits(
            model, cost, xu + t, dz, xs, ee, mu, DT, include_zero=True)[0][0],
    }
    progs = {}
    for name, stage in stages.items():
        one = stage
        if batch:
            one = lambda t, stage=stage: jnp.sum(jax.vmap(
                lambda b: stage(t + b * tiny))(jnp.arange(batch, dtype=t.dtype)))
        progs[name] = jax.jit(lambda t0, one=one: jax.lax.fori_loop(
            0, STAGE_REPS, lambda i, t: one(t) * tiny, t0))
    return progs, cap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--knots", type=int, nargs="+", default=[64])
    ap.add_argument("--linsys", nargs="+", default=["auto"])
    ap.add_argument("--batch", type=int, default=0,
                    help="vmap over this many instances")
    ap.add_argument("--steps", type=int, default=8,
                    help="control steps in the traced chain window")
    ap.add_argument("--outdir", default=str(ROOT / "chiprun_out" / "profile"))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from mpcgpu.device import resolve_linsys
    from mpcgpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"profiling measures a GPU; JAX's default device is "
                         f"{dev.platform!r}")
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()))
    card = bench.card_line()

    for N in args.knots:
        inputs = bench.chain_inputs(N)
        if args.batch:
            # per-instance perturbations, so PCG exits differ between them
            B = args.batch
            xu, lam, _, ee, rho = inputs
            noise = 0.01 * jax.random.normal(jax.random.PRNGKey(1),
                                             (B,) + xu.shape, xu.dtype)
            xu_b = xu[None] + noise
            inputs = (xu_b, jnp.broadcast_to(lam, (B,) + lam.shape),
                      xu_b[:, 0, :14], jnp.broadcast_to(ee, (B,) + ee.shape),
                      jnp.full((B,), rho))
        shared = {}        # stages that do not depend on the linear solver
        for name in args.linsys:
            linsys = resolve_linsys(name, "stair", N)
            tag = f"n{N}_b{args.batch}_{linsys}"
            chain, _ = bench.make_chain(N, linsys)
            if args.batch:
                chain = jax.jit(jax.vmap(chain, in_axes=(None, 0, 0, 0, 0, 0)))
            out, r = traced(jax, chain, (args.steps,) + inputs,
                            os.path.join(args.outdir, tag, "chain"))
            steps = args.steps
            per_step = lambda v: v / steps
            row = dict(
                knots=N, batch=args.batch, linsys=linsys, steps=steps,
                pcg_iters_per_step=float(np.mean(np.asarray(out[-1]))) / steps,
                window_us_per_step=per_step(r["window_ns"] / 1e3),
                busy_us_per_step=per_step(r["busy_ns"] / 1e3),
                idle_share=r["idle_share"],
                kernels_per_step=per_step(r["kernels"]),
                d2h_copies_per_step=per_step(r["d2h_copies"]),
                graph_launches_per_step=per_step(r["graph_launches"]))

            progs, cap = stage_programs(jax, jnp, N, linsys, args.batch)
            stages = {}
            for sname, prog in progs.items():
                if sname in shared:
                    stages[sname] = shared[sname]
                    continue
                _, s = traced(jax, prog, (jnp.asarray(0.0, jnp.float32),),
                              os.path.join(args.outdir, tag, sname))
                stages[sname] = dict(
                    busy_us=s["busy_ns"] / 1e3 / STAGE_REPS,
                    kernels=s["kernels"] / STAGE_REPS,
                    d2h_copies=s["d2h_copies"] / STAGE_REPS,
                    graph_launches=s["graph_launches"] / STAGE_REPS)
                if sname != "pcg":
                    shared[sname] = stages[sname]
            pcg = stages["pcg"]
            row.update(
                stage_busy_us={k: v["busy_us"] for k, v in stages.items()},
                stage_kernels={k: v["kernels"] for k, v in stages.items()},
                pcg_cap=cap,
                pcg_us_per_iter=pcg["busy_us"] / cap,
                pcg_kernels_per_iter=pcg["kernels"] / cap,
                pcg_d2h_per_iter=pcg["d2h_copies"] / cap,
                pcg_graph_launches_per_iter=pcg["graph_launches"] / cap,
                device=device, card=card)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
