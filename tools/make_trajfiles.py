#!/usr/bin/env python3
"""Generate standalone trajectory fixtures (C19-equivalent) with our own stack.

The reference ships recorded IIWA traces (examples/trajfiles/{s}_{g}_traj.csv:
666 rows x 21 = 14 state + 7 control per knot; {s}_{g}_eepos.traj: 666 x 6 =
ee [xyz, rpy] goal per knot; readCSVToVecVec, include/utils/experiment.cuh:
144-170). This script synthesizes fixtures of the same format so the
framework runs standalone when the reference checkout is absent:

  1. pick a smooth joint-space path q(t) between two workspace poses,
  2. roll the true dynamics forward with a PD tracking controller to obtain a
     dynamically consistent (x, u) trace (defect ~ integrator truncation),
  3. write the FK ee pose of the reference joint path as the goal trace.

Writes data/trajfiles/{s}_{g}_traj.csv and {s}_{g}_eepos.traj for every
start/goal pair requested (default: the full 5x5 grid the reference driver
iterates, track_iiwa_pcg.cu:39-44).  Loader preference order (per file):
$MPCGPU_TRAJDIR > /root/reference trajfiles > data/trajfiles
(utils/trajfiles.py::_find).
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

from mpcgpu.models import dynamics, iiwa14

OUT = Path(__file__).resolve().parent.parent / "data" / "trajfiles"
STEPS = 666
DT = 0.015625           # reference trajectory timestep (track_iiwa_pcg.cu:19)
SUBSTEPS = 78           # ~2e-4 s plant substeps, like the reference plant
                        # (integrator.cuh:304, sim_step_time)


# the reference records 5 workspace poses and runs the 5x5 start/goal grid
# skipping start == goal != 0 (track_iiwa_pcg.cu:30-43) -> 21 pairs
RECORDED_POSES = np.array([
    [0.0, 0.6, 0.0, -1.2, 0.0, 0.8, 0.0],
    [0.8, 1.0, 0.4, -0.8, 0.3, 1.4, 0.5],
    [-0.6, 0.4, -0.3, -1.5, 0.4, 0.6, -0.4],
    [0.4, 1.2, -0.5, -0.6, -0.3, 1.1, 0.8],
    [-0.3, 0.8, 0.6, -1.0, 0.5, 1.3, -0.6],
])


def grid_pairs():
    """(start, goal) pairs of the reference's 5x5 loop with its skip rule."""
    for ind in range(25):
        s, g = ind % 5, ind // 5
        if s == g and s != 0:
            continue
        yield s, g


def make_pair(model, start: int, goal: int):
    nq = model.nq

    q0 = RECORDED_POSES[start]
    # goal == start only happens for 0_0 (skip rule); keep the original 0_0
    # fixture semantics: a pose-0 -> pose-1 sweep
    q1 = RECORDED_POSES[goal] if goal != start else RECORDED_POSES[(start + 1) % 5]
    t = np.linspace(0.0, 1.0, STEPS)
    blend = 3 * t**2 - 2 * t**3                      # smooth-step
    q_ref = q0[None, :] + blend[:, None] * (q1 - q0)[None, :]
    qd_ref = np.gradient(q_ref, DT, axis=0)

    fk = jax.jit(jax.vmap(lambda q: dynamics.fk_ee(model, q)))
    ee_ref = np.asarray(fk(jnp.asarray(q_ref)))
    return q_ref, qd_ref, ee_ref


def _make_rollout(model, nq):
    """PD + feedforward inverse-dynamics tracking of a joint path, rolled out
    as one jitted scan over knots (substeps in a fori_loop).  Torques are
    zero-order-held over a whole knot (64 Hz), so gains must be scaled per
    joint by its inertia: wn = 8 rad/s critically damped keeps h_knot * kd_j
    / m_j well under the discrete stability bound."""
    h = DT / SUBSTEPS
    wn = 8.0

    @jax.jit
    def rollout(q0v, qrefs, qdrefs, kp, kd):
        def knot(carry, ref):
            q, qd = carry
            qr, qdr = ref
            u = dynamics.rnea(model, qr, qdr, jnp.zeros(nq)) \
                + kp * (qr - q) + kd * (qdr - qd)
            row = jnp.concatenate([q, qd, u])

            def sub(i, st):
                q_, qd_ = st
                qdd = dynamics.forward_dynamics_aba(model, q_, qd_, u)
                qd_n = qd_ + h * qdd     # semi-implicit: damping acts this step
                return (q_ + h * qd_n, qd_n)

            q, qd = jax.lax.fori_loop(0, SUBSTEPS, sub, (q, qd))
            return (q, qd), row

        (_, _), rows = jax.lax.scan(
            knot, (q0v, jnp.zeros(nq)), (qrefs, qdrefs))
        return rows

    def run(q_ref, qd_ref):
        m_diag = np.diag(np.asarray(
            dynamics.mass_matrix(model, jnp.asarray(q_ref[0]))))
        kp = jnp.asarray(wn * wn * m_diag)
        kd = jnp.asarray(2.0 * wn * m_diag)
        return np.asarray(rollout(jnp.asarray(q_ref[0]), jnp.asarray(q_ref),
                                  jnp.asarray(qd_ref), kp, kd))

    return run


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", nargs="*", default=None,
                    help="s_g pairs to generate (default: full reference grid)")
    args = ap.parse_args()

    model = iiwa14(dtype=jnp.float64)
    nq = model.nq
    run = _make_rollout(model, nq)
    pairs = ([tuple(map(int, p.split("_"))) for p in args.pairs]
             if args.pairs else list(grid_pairs()))

    OUT.mkdir(parents=True, exist_ok=True)
    for s, g in pairs:
        q_ref, qd_ref, ee_ref = make_pair(model, s, g)
        rows = run(q_ref, qd_ref)
        np.savetxt(OUT / f"{s}_{g}_traj.csv", rows, delimiter=",", fmt="%.10g")
        np.savetxt(OUT / f"{s}_{g}_eepos.traj", ee_ref, delimiter=",", fmt="%.10g")
        err = np.abs(rows[-1][:nq] - q_ref[-1]).max()
        print(f"wrote {s}_{g}_traj.csv + {s}_{g}_eepos.traj "
              f"({STEPS} rows, final joint tracking err {err:.2e})")


if __name__ == "__main__":
    main()
