#!/usr/bin/env python3
"""Diagnose the cap-bound rnorm exit regime.

Under the absolute exit criterion ||r||_2 < tol, PCG hits its max-iter cap
on every warm-chain solve at the reference tolerances (mean iters == cap at
all tuned horizons) — a regime the reference itself flags as unhealthy
(mpcsim.cuh:382-387: live warning when >50% of solves exit on max-iter).

This tool reproduces the bench warm chain (bench.py methodology), samples
Schur systems (S, Pinv, gamma, warm lam) along it, and runs an instrumented
host PCG per sample in BOTH f32 and f64, recording per iteration:

  - the recurrence residual ||r_k||   (what the solver's exit test sees)
  - the TRUE residual ||gamma - S lam_k||  (what the recurrence drifts from)
  - eta_k = r_k . P^{-1} r_k          (the native criterion)

and prints, per sample: ||gamma||, the f32 true-residual floor, and the
iteration count needed to reach a grid of tolerances under each criterion —
exactly the data needed to decide whether the reference's GPU-tuned
(tol, cap) tables are reachable in f32 on this problem scaling.

Run on CPU (fast, f64 available):
  JAX_PLATFORMS=cpu PYTHONPATH=. python tools/diagnose_rnorm.py
"""

from __future__ import annotations

import argparse
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

TOL_GRID = (1e-3, 1e-4, 5e-5, 2.5e-5, 1e-5, 5e-6, 1e-6)


def np_btd_matvec(S, x):
    """y = S @ x, S (N,3,n,n) BTD (ops/btd.py layout), numpy."""
    y = np.einsum("kij,kj->ki", S[:, 1], x)
    y[1:] += np.einsum("kij,kj->ki", S[1:, 0], x[:-1])
    y[:-1] += np.einsum("kij,kj->ki", S[:-1, 2], x[1:])
    return y


def instrumented_pcg(S, Pinv, gamma, lam0, iters):
    """Host PCG mirroring ops/pcg.py; returns per-iteration trajectories."""
    dt = S.dtype
    lam = lam0.copy()
    r = gamma - np_btd_matvec(S, lam)
    z = np_btd_matvec(Pinv, r)
    eta = float(np.vdot(r, z))
    rec_rnorm, true_rnorm, etas = [], [], []
    for _ in range(iters):
        p = z if not etas else z + dt.type(beta) * p  # noqa: F821
        Sp = np_btd_matvec(S, p)
        alpha = eta / float(np.vdot(p, Sp))
        lam = lam + dt.type(alpha) * p
        r = r - dt.type(alpha) * Sp
        z = np_btd_matvec(Pinv, r)
        eta_new = float(np.vdot(r, z))
        beta = eta_new / eta
        eta = eta_new
        rec_rnorm.append(float(np.linalg.norm(r)))
        true_rnorm.append(
            float(np.linalg.norm(gamma - np_btd_matvec(S, lam))))
        etas.append(abs(eta_new))
    return np.array(rec_rnorm), np.array(true_rnorm), np.array(etas)


def iters_to(traj, tol):
    hit = np.nonzero(traj < tol)[0]
    return int(hit[0]) + 1 if hit.size else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, default=64)
    ap.add_argument("--steps", type=int, default=64,
                    help="warm-chain length before/between samples")
    ap.add_argument("--samples", type=int, nargs="*", default=[16, 32, 48, 64])
    ap.add_argument("--iters", type=int, default=600)
    args = ap.parse_args()

    from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.ops.schur import form_schur_system
    from mpcgpu.solver.kkt import build_kkt
    from mpcgpu.solver.sqp import sqp_solve
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    N = args.knots
    dtype = jnp.float32
    model = iiwa14(dtype=dtype)
    cost = CostConfig.for_knots(N)
    pcg_cfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5,
                        exit_criterion="rnorm")
    sqp_cfg = SQPConfig(max_iter=1)
    dt = 1.0 / 64.0

    ee_full = jnp.asarray(load_eepos_traj("0_0"), dtype)
    xu = jnp.asarray(load_xu_traj("0_0")[:N], dtype)
    ee = ee_full[:N]
    xu = xu + 0.01 * jax.random.normal(jax.random.PRNGKey(0), xu.shape, dtype)
    xs = xu[0, :14]
    lam = jnp.zeros((N, 14), dtype)
    rho = jnp.asarray(1e-3, dtype)

    solve = jax.jit(lambda xu, lam, xs, ee, rho: sqp_solve(
        model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho, dt,
        linsys="pcg"))
    kkt_schur = jax.jit(lambda xu, xs, ee, rho: form_schur_system(
        build_kkt(model, cost, xu, xs, ee, jnp.asarray(dt, dtype)), rho))

    samples = sorted(set(args.samples))
    out = []
    for step in range(1, max(samples) + 1):
        if step in samples:
            schur = kkt_schur(xu, xs, ee, rho)
            S32 = np.asarray(schur.S, np.float32)
            P32 = np.asarray(schur.Pinv, np.float32)
            g32 = np.asarray(schur.gamma, np.float32)
            l32 = np.asarray(lam, np.float32)
            rec32, true32, eta32 = instrumented_pcg(S32, P32, g32, l32,
                                                    args.iters)
            rec64, true64, eta64 = instrumented_pcg(
                S32.astype(np.float64), P32.astype(np.float64),
                g32.astype(np.float64), l32.astype(np.float64), args.iters)
            row = dict(
                step=step,
                gamma_norm=float(np.linalg.norm(g32)),
                r0_norm=float(np.linalg.norm(
                    g32 - np_btd_matvec(S32, l32))),
                f32_true_floor=float(true32.min()),
                f32_rec_floor=float(rec32.min()),
                f64_floor=float(true64.min()),
                f32_eta_floor=float(eta32.min()),
                cap=pcg_cfg.max_iter,
                iters_rnorm_f32={f"{t:g}": iters_to(rec32, t)
                                 for t in TOL_GRID},
                iters_rnorm_true_f32={f"{t:g}": iters_to(true32, t)
                                      for t in TOL_GRID},
                iters_rnorm_f64={f"{t:g}": iters_to(rec64, t)
                                 for t in TOL_GRID},
                iters_eta_f32={f"{t:g}": iters_to(eta32, t)
                               for t in TOL_GRID},
            )
            out.append(row)
            print(json.dumps(row), flush=True)
        res = solve(xu, lam, xs, ee, rho)
        xu = jnp.roll(res.xu, -1, axis=0).at[-1].set(res.xu[-1])
        lam = jnp.roll(res.lam, -1, axis=0).at[-1].set(res.lam[-1])
        xs = res.xu[1, :14]
        ee = jnp.roll(ee, -1, axis=0).at[-1].set(ee_full[(step + N) %
                                                         ee_full.shape[0]])
        rho = res.rho

    # summary verdict
    floors = [r["f32_true_floor"] for r in out]
    caps_hit = [r["iters_rnorm_f32"]["1e-05"] is None or
                r["iters_rnorm_f32"]["1e-05"] > r["cap"] for r in out]
    print(json.dumps(dict(
        knots=N,
        tol=1e-5,
        f32_true_floor_range=[min(floors), max(floors)],
        tol_below_f32_floor=all(f > 1e-5 for f in floors),
        cap_bound_at_1em5=all(caps_hit),
    )), flush=True)


if __name__ == "__main__":
    main()
