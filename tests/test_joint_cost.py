"""Joint-space tracking cost variant (reference C11', iiwa_plant.cuh):
gradient/Hessian consistency and an SQP regulation solve to a setpoint."""

import jax
import jax.numpy as jnp
import numpy as np

from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu.models import iiwa14
from mpcgpu.solver.kkt import tracking_cost_grad_hess
from mpcgpu.solver.merit import tracking_cost
from mpcgpu.solver.sqp import sqp_solve

N = 16
NX, NU = 14, 7
DT = 1.0 / 64.0


def test_joint_cost_grad_matches_fd():
    model = iiwa14(dtype=jnp.float64)
    cost = CostConfig(mode="joint", q_cost=2.0, qd_cost=0.1, r_cost=1e-3)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(NX))
    u = jnp.asarray(rng.standard_normal(NU))
    goal = jnp.asarray(rng.standard_normal(NX))

    Q, g, R, r = tracking_cost_grad_hess(model, cost, x, u, goal)

    def J(xx, uu):
        xu = jnp.concatenate([xx, uu])[None]
        # single knot with control masked off => add it back for the test
        base = tracking_cost(model, cost, jnp.concatenate([xu, xu]), jnp.stack([goal, goal]))
        return base

    gx = jax.grad(lambda xx: J(xx, u))(x)
    gu = jax.grad(lambda uu: J(x, uu))(u)
    # two identical knots => gradient is 2x state term; control counted once
    np.testing.assert_allclose(np.asarray(gx) / 2.0, np.asarray(g), atol=1e-10)
    np.testing.assert_allclose(np.asarray(gu), np.asarray(r), atol=1e-10)
    # Hessian diagonal
    np.testing.assert_allclose(np.asarray(Q), np.diag([cost.q_cost] * 7 + [cost.qd_cost] * 7))


def test_joint_mode_sqp_regulates_to_reference():
    model = iiwa14(dtype=jnp.float32)
    cost = CostConfig(mode="joint", q_cost=1.0, qd_cost=1e-2, r_cost=1e-4)
    q0 = jnp.asarray([0.3, 0.4, -0.2, 0.5, 0.1, -0.3, 0.2], jnp.float32)
    x0 = jnp.concatenate([q0, jnp.zeros(7, jnp.float32)])
    xu = jnp.tile(jnp.concatenate([x0, jnp.zeros(7, jnp.float32)])[None], (N, 1))
    goal = jnp.tile(x0[None], (N, 1))  # regulate at the setpoint
    lam = jnp.zeros((N, NX), jnp.float32)
    res = sqp_solve(
        model, cost, SQPConfig(max_iter=5), PCGConfig(max_iter=200, exit_tol=1e-8),
        xu, lam, x0, goal, 1e-3, DT, linsys="pcg",
    )
    # stationary point: iterate stays at the setpoint
    np.testing.assert_allclose(
        np.asarray(res.xu[:, :7]), np.asarray(goal[:, :7]), atol=5e-3
    )
