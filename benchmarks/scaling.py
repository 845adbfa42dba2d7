#!/usr/bin/env python3
"""Knot-sharded PCG scaling harness: nnz/s across 1 -> n_devices shards.

Measures the sequence-parallel PCG (parallel/pcg_sharded.py: ppermute halo
ring + psum dots) on an N=512 IIWA Schur system — the reference's largest
tuned operating point (settings.cuh:124-144) — at every power-of-two shard
count the mesh supports, and reports per-iteration throughput
(nnz processed per second) plus scaling efficiency vs 1 shard.

On the virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N,
JAX_PLATFORMS=cpu) the run validates the communication logic only; on GPUs
joined by NVLink the same script measures the scaling curve (BASELINE.json
configs[4] sets a >= 80% efficiency target).

Timing: a fixed-iteration solve (exit_tol=0 so no early exit) chained
``reps`` times; median wall over the chain / iterations.
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, default=512)
    ap.add_argument("--iters", type=int, default=67,
                    help="fixed PCG iteration count (tuned cap for N=512)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--method", default="pipelined",
                    choices=["pipelined", "classic", "ca"],
                    help="sharded CG formulation (parallel/pcg_sharded.py): "
                    "pipelined = 1 psum + 1 halo exchange per iteration")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mpcgpu.config import CostConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.ops.csr import btd_nnz_lower
    from mpcgpu.ops.schur import form_schur_system
    from mpcgpu.parallel.mesh import make_mesh
    from mpcgpu.parallel.pcg_sharded import pcg_solve_sharded
    from mpcgpu.solver.kkt import build_kkt
    from mpcgpu.utils.compile_cache import enable_compile_cache
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    enable_compile_cache()
    N = args.knots
    n = 14
    dtype = jnp.float32
    model = iiwa14(dtype=dtype)
    cost = CostConfig.for_knots(N)
    xu = jnp.asarray(load_xu_traj("0_0")[:N], dtype)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], dtype)
    kkt = build_kkt(model, cost, xu, xu[0, :n], ee, 1.0 / 64.0)
    schur = form_schur_system(kkt, 1e-3)
    lam0 = jnp.zeros((N, n), dtype)

    # full symmetric nnz of the BTD matrix (both triangles)
    nnz = 2 * btd_nnz_lower(n, N) - N * n

    n_avail = len(jax.devices())
    shard_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_avail and N % c == 0]

    rows = []
    base_rate = None
    for n_shard in shard_counts:
        mesh = make_mesh(n_instance=1, n_knot=n_shard)

        def run():
            out = pcg_solve_sharded(
                schur.S, schur.Pinv, schur.gamma, lam0, mesh,
                max_iter=args.iters, exit_tol=0.0, method=args.method)
            return out

        out = run()
        jax.block_until_ready(out.lam)             # compile + warm
        assert int(out.iters) == args.iters
        samples = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run().lam)
            samples.append(time.perf_counter() - t0)
        per_iter_s = float(np.median(samples)) / args.iters
        rate = nnz / per_iter_s                    # nnz/s per iteration
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n_shard)
        rows.append(dict(shards=n_shard, per_iter_us=round(per_iter_s * 1e6, 2),
                         gnnz_per_s=round(rate / 1e9, 3),
                         efficiency_vs_1shard=round(eff, 3)))
        print(json.dumps(rows[-1]))

    print(json.dumps(dict(metric="pcg_sharded_scaling", knots=N,
                          method=args.method,
                          platform=jax.devices()[0].platform,
                          kind=jax.devices()[0].device_kind, nnz=nnz,
                          table=rows)))


if __name__ == "__main__":
    main()
