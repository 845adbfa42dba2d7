"""L1-penalty merit function and vmapped 8-alpha line search.

Equivalent of compute_merit / ls_gato_compute_merit
(include/common/merit.cuh:17-143): per-knot tracking cost plus mu * l1 norm
of the integrator defect.  The reference evaluates the 8 line-search
candidates as 8 concurrent cooperative launches on 8 streams
(pcg/sqp.cuh:265-282); here it is one ``vmap`` over the alpha axis — a single
batched XLA program with the argmin on device.

Knot-role details replicated from the reference:
  * knots 0..N-2 contribute the Euler defect |x_{k+1} - f(x_k, u_k)|_1
    (merit.cuh:65-66);
  * the LAST knot contributes the initial-state residual
    |x_0^cand - xs|_1 in the line-search variant (merit.cuh:69-76) and 0 in
    the initial-merit variant (merit.cuh:133-134);
  * the last knot has no control penalty (iiwa_eepos_plant.cuh:252).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mpcgpu.config import CostConfig
from mpcgpu.models import dynamics
from mpcgpu.models.robot import RobotModel
from mpcgpu.precision import highest_precision


@highest_precision
def tracking_cost(model: RobotModel, cost: CostConfig, xu, goal):
    """Sum of per-knot tracking costs J_k.

    ee mode (iiwa_eepos_plant.cuh:240-290):
      J_k = 1/2 |ee(q_k) - goal_k|^2 + 1/2 QD |qd_k|^2 + 1/2 R |u_k|^2
    joint mode (iiwa_plant.cuh:130-180):
      J_k = 1/2 Q |q_k - qref_k|^2 + 1/2 QD |qd_k - qdref_k|^2 + 1/2 R |u_k|^2
    Control term masked at the terminal knot in both.
    """
    nq = model.nq
    N = xu.shape[0]
    q, qd, u = xu[:, :nq], xu[:, nq : 2 * nq], xu[:, 2 * nq :]
    if cost.mode == "ee":
        ee = jax.vmap(lambda qq: dynamics.fk_ee_xyz(model, qq))(q)
        pos_err = jnp.sum((ee - goal[:, :3]) ** 2, axis=-1)
        qd_pen = cost.qd_cost * jnp.sum(qd**2, axis=-1)
    elif cost.mode == "joint":
        pos_err = cost.q_cost * jnp.sum((q - goal[:, :nq]) ** 2, axis=-1)
        qd_err = qd if cost.absolute_qd_penalty else qd - goal[:, nq : 2 * nq]
        qd_pen = cost.qd_cost * jnp.sum(qd_err**2, axis=-1)
    else:
        raise ValueError(f"unknown cost mode {cost.mode!r}")
    u_pen = cost.r_cost * jnp.sum(u**2, axis=-1)
    u_mask = jnp.arange(N) < N - 1
    per_knot = 0.5 * (pos_err + qd_pen + jnp.where(u_mask, u_pen, 0.0))
    return jnp.sum(per_knot)


@highest_precision
def constraint_l1(model: RobotModel, xu, xs, dt, include_x0: bool,
                  integrator_type: int = 0, angle_wrap: bool = False):
    """mu-free total l1 constraint violation over knots."""
    from mpcgpu.solver.kkt import integrator_step

    nq = model.nq
    nx = 2 * nq
    x, u = xu[:, :nx], xu[:, nx:]

    def defect(xk, uk, xk1):
        xnext = integrator_step(model, xk, uk, dt, integrator_type, angle_wrap)
        return jnp.sum(jnp.abs(xk1 - xnext))

    defects = jax.vmap(defect)(x[:-1], u[:-1], x[1:])
    total = jnp.sum(defects)
    if include_x0:
        total = total + jnp.sum(jnp.abs(x[0] - xs))
    return total


@highest_precision
def merit_function(
    model: RobotModel, cost: CostConfig, xu, xs, ee_goal, mu, dt, include_x0: bool,
    integrator_type: int = 0, angle_wrap: bool = False,
):
    """phi(xu) = sum_k J_k + mu * sum_k |c_k|_1."""
    return tracking_cost(model, cost, xu, ee_goal) + mu * constraint_l1(
        model, xu, xs, dt, include_x0, integrator_type, angle_wrap
    )


@highest_precision
def line_search_merits(
    model: RobotModel, cost: CostConfig, xu, dz, xs, ee_goal, mu, dt,
    num_alphas: int = 8, integrator_type: int = 0, include_zero: bool = False,
    angle_wrap: bool = False,
):
    """Merit at xu + alpha_i dz for alpha_i = -1/2^i, i = 0..num_alphas-1.

    With ``include_zero``, alpha = 0 is prepended so merits[0] is the merit of
    the CURRENT iterate — evaluated in the same batched pass, which lets the
    SQP loop drop its standalone initial-merit evaluation (the reference
    launches compute_merit separately, pcg/sqp.cuh:173-182; folding it into
    the candidate batch costs one more vmap lane).

    Returns (merits (num_alphas[+1],), alphas (num_alphas[+1],)).
    """
    alphas = -1.0 / (2.0 ** jnp.arange(num_alphas, dtype=xu.dtype))
    if include_zero:
        alphas = jnp.concatenate([jnp.zeros((1,), xu.dtype), alphas])

    def merit_at(alpha):
        cand = xu + alpha * dz
        return merit_function(
            model, cost, cand, xs, ee_goal, mu, dt, include_x0=True,
            integrator_type=integrator_type, angle_wrap=angle_wrap,
        )

    return jax.vmap(merit_at)(alphas), alphas
