"""Programmatic serial-chain models: physics oracles + nq-generic stack.

The framework must not be IIWA-specific: models/chain.py builds a RobotModel
for any revolute-z serial chain, and every layer (dynamics, kernels, solver)
is nq-generic. Oracles here are independent of the implementation: the
textbook closed-form two-link-arm mass matrix, kinetic-energy conservation
under zero torque, and a full SQP solve at nq = 3.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mpcgpu.models import dynamics
from mpcgpu.models.chain import planar_arm

jax.config.update("jax_enable_x64", True)


def test_two_link_mass_matrix_closed_form():
    l, m = 0.7, 2.3
    model = planar_arm(nq=2, link_len=l, link_mass=m, dtype=jnp.float64)
    r = l / 2
    Izz = m * l * l / 12.0
    for q2 in (0.0, 0.4, -1.1, 2.8):
        q = jnp.asarray([0.3, q2], jnp.float64)
        M = np.asarray(dynamics.mass_matrix(model, q))
        c2 = np.cos(q2)
        M11 = Izz + Izz + m * r**2 + m * (l**2 + r**2 + 2 * l * r * c2)
        M12 = Izz + m * (r**2 + l * r * c2)
        M22 = Izz + m * r**2
        np.testing.assert_allclose(M[0, 0], M11, rtol=1e-10)
        np.testing.assert_allclose(M[0, 1], M12, rtol=1e-10)
        np.testing.assert_allclose(M[1, 0], M12, rtol=1e-10)
        np.testing.assert_allclose(M[1, 1], M22, rtol=1e-10)


def test_energy_conservation_free_chain():
    """Zero torque, zero gravity: kinetic energy 1/2 qd' M qd is conserved."""
    model = planar_arm(nq=3, dtype=jnp.float64)
    q = jnp.asarray([0.2, -0.5, 0.9], jnp.float64)
    qd = jnp.asarray([0.7, -0.3, 0.4], jnp.float64)
    u = jnp.zeros(3, jnp.float64)

    def energy(q, qd):
        M = dynamics.mass_matrix(model, q)
        return 0.5 * qd @ M @ qd

    e0 = float(energy(q, qd))
    h = 1e-4
    step = jax.jit(lambda q, qd: (
        q + h * qd, qd + h * dynamics.forward_dynamics_aba(model, q, qd, u)))
    for _ in range(2000):
        q, qd = step(q, qd)
    e1 = float(energy(q, qd))
    assert abs(e1 - e0) / e0 < 1e-3   # explicit-Euler drift ~ O(h)


def test_fk_matches_planar_geometry():
    l = 0.5
    model = planar_arm(nq=3, link_len=l, dtype=jnp.float64)
    q = np.array([0.3, -0.7, 1.1])
    ee = np.asarray(dynamics.fk_ee_xyz(model, jnp.asarray(q)))
    a1, a12, a123 = q[0], q[0] + q[1], q[0] + q[1] + q[2]
    x = l * (np.cos(a1) + np.cos(a12) + np.cos(a123))
    y = l * (np.sin(a1) + np.sin(a12) + np.sin(a123))
    np.testing.assert_allclose(ee, [x, y, 0.0], atol=1e-12)


def test_full_sqp_on_three_link_arm(on_gpu):
    """The whole solver stack is nq-generic: the XLA path, and the GPU path
    with the PCG kernel interpreted (n = 6 blocks padded to 8)."""
    from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu.solver.sqp import sqp_solve

    model = planar_arm(nq=3)
    N = 16
    nx, nu = 6, 3
    dtype = jnp.float32
    q0 = jnp.asarray([0.1, 0.2, -0.1], dtype)
    xu = jnp.zeros((N, nx + nu), dtype).at[:, :3].set(q0)
    xs = xu[0, :nx]
    goal = jnp.asarray(dynamics.fk_ee(model, jnp.asarray([0.5, 0.3, 0.2], dtype)), dtype)
    ee_goal = jnp.broadcast_to(goal, (N, 6))
    lam = jnp.zeros((N, nx), dtype)
    cost = CostConfig(qd_cost=1e-3, r_cost=1e-4)

    res_xla = sqp_solve(model, cost, SQPConfig(max_iter=12),
                        PCGConfig(max_iter=60, exit_tol=1e-8),
                        xu, lam, xs, ee_goal, 1e-3, 1 / 32.0, linsys="pcg")
    assert np.isfinite(np.asarray(res_xla.xu)).all()
    ee_end = np.asarray(dynamics.fk_ee_xyz(model, res_xla.xu[-1, :3]))
    err0 = np.linalg.norm(np.asarray(goal[:3]) - np.asarray(
        dynamics.fk_ee_xyz(model, q0)))
    err1 = np.linalg.norm(np.asarray(goal[:3]) - ee_end)
    assert err1 < 0.85 * err0      # the solve moves the arm toward the goal

    res_pal = sqp_solve(model, cost, SQPConfig(max_iter=12),
                        PCGConfig(max_iter=60, exit_tol=1e-8),
                        xu, lam, xs, ee_goal, 1e-3, 1 / 32.0,
                        linsys="pcg_pallas")
    # separate compilations of the same f32 math, 12 iterations deep
    np.testing.assert_allclose(np.asarray(res_pal.xu), np.asarray(res_xla.xu),
                               rtol=2e-3, atol=1e-3)
