#!/usr/bin/env python3
"""Closed-loop MPC tracking for a PROGRAMMATIC robot model (non-IIWA).

The reference framework is hard-wired to the IIWA-14 via GRiD codegen
(SURVEY.md C12); this stack is nq-generic.  This driver builds an arbitrary
revolute-z serial chain (`models/chain.py`), synthesizes a reference
trajectory with the chain's own dynamics (inverse-dynamics feedforward along
a smooth joint path), and runs the same closed-loop SQP-PCG tracker the IIWA
drivers use — every layer (dynamics, KKT, Schur, PCG, merit, simulator)
unchanged.

Usage: python examples/track_chain.py [--nq 5] [--knots 16] [--steps 120]
       python examples/track_chain.py --urdf robot.urdf      # onboard a URDF
       python examples/track_chain.py --urdf builtin:iiwa    # iiwa via URDF
                                                             # round-trip demo
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nq", type=int, default=5)
    ap.add_argument("--knots", type=int, default=16)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ondevice", action="store_true")
    ap.add_argument("--urdf", default=None,
                    help="load the robot from a URDF file instead of the "
                    "programmatic planar arm (models/urdf.py); the sentinel "
                    "'builtin:iiwa' round-trips the baked IIWA-14 through "
                    "export_urdf -> load_urdf")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mpcgpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from mpcgpu.config import CostConfig, PCGConfig, SimConfig, SQPConfig
    from mpcgpu.models import dynamics
    from mpcgpu.models.chain import planar_arm
    from mpcgpu.sim.mpc import simulate_mpc, simulate_mpc_ondevice

    if args.urdf == "builtin:iiwa":
        from mpcgpu.models import iiwa14
        from mpcgpu.models.urdf import export_urdf, load_urdf

        model = load_urdf(export_urdf(iiwa14()))
        print("onboarded IIWA-14 via export_urdf -> load_urdf round trip")
    elif args.urdf is not None:
        from mpcgpu.models.urdf import load_urdf

        model = load_urdf(args.urdf)
        print(f"onboarded {model.nq}-joint robot from {args.urdf}")
    else:
        model = planar_arm(nq=args.nq, link_len=0.4, link_mass=0.8)
    nq = model.nq
    dt = 1.0 / 64.0
    steps = args.steps

    # smooth joint path + dynamically consistent (x, u) trace
    q0 = 0.3 * np.ones(nq)
    q1 = q0 + np.linspace(0.8, -0.6, nq)
    t = np.linspace(0.0, 1.0, steps)
    blend = 3 * t**2 - 2 * t**3
    q_ref = q0[None, :] + blend[:, None] * (q1 - q0)[None, :]
    qd_ref = np.gradient(q_ref, dt, axis=0)
    qdd_ref = np.gradient(qd_ref, dt, axis=0)

    rnea_v = jax.jit(jax.vmap(
        lambda q, qd, qdd: dynamics.rnea(model, q, qd, qdd)))
    u_ref = np.asarray(rnea_v(jnp.asarray(q_ref, jnp.float32),
                              jnp.asarray(qd_ref, jnp.float32),
                              jnp.asarray(qdd_ref, jnp.float32)))
    xu_traj = np.concatenate([q_ref, qd_ref, u_ref], axis=1).astype(np.float32)

    fk_v = jax.jit(jax.vmap(lambda q: dynamics.fk_ee(model, q)))
    ee_traj = np.asarray(fk_v(jnp.asarray(q_ref, jnp.float32)))

    cost = CostConfig(qd_cost=1e-4, r_cost=1e-4)
    sqp_cfg = SQPConfig(max_iter=4)
    pcg_cfg = PCGConfig(max_iter=120, exit_tol=1e-7)

    if args.ondevice:
        out = simulate_mpc_ondevice(
            model, xu_traj, ee_traj, args.knots, dt,
            cost=cost, sqp_cfg=SQPConfig(max_iter=2), pcg_cfg=pcg_cfg)
        errs = np.asarray(out["tracking_errors"])
        print(f"nq={nq} knots={args.knots} (on-device): "
              f"{int(out['control_updates'])} control steps, "
              f"avg tracking err {errs.mean():.5f}, "
              f"final {float(out['final_tracking_error']):.5f}")
        return

    stats = simulate_mpc(
        model, xu_traj, ee_traj, knot_points=args.knots, timestep=dt,
        cost=cost, sqp_cfg=sqp_cfg, pcg_cfg=pcg_cfg,
        sim_cfg=SimConfig(max_control_updates=600), linsys="pcg")
    s = stats.summary()
    print(f"nq={nq} knots={args.knots}: {s['control_updates']} control steps, "
          f"avg tracking err {s['avg_tracking_error']:.5f}, "
          f"final {s['final_tracking_error']:.5f}, "
          f"avg PCG iters {s['avg_pcg_iters']:.1f}")


if __name__ == "__main__":
    main()
