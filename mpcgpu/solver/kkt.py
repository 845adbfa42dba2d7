"""KKT block assembly: dynamics linearization + tracking-cost quadratics.

Equivalent of generate_kkt_submatrices (include/common/kkt.cuh:22-163) with
the integrator gradient of include/common/integrator.cuh:59-100 and the
Gauss-Newton tracking cost of iiwa_eepos_plant.cuh:295-401 — as one vmapped
jitted function over knot-leading block arrays.

Trajectory layout: ``xu`` is (N, nx+nu); the last knot's control slot is
unused (the reference stores a ragged (nx+nu)*N - nu vector; we keep a
rectangular array for static shapes and mask the tail).

QP convention (matches the reference exactly):
  min 1/2 dz^T G dz + g^T dz  s.t.  C dz + c = 0, with per-knot blocks
  G = blkdiag(Q_0, R_0, ..., Q_{N-1}),  g = (q_0, r_0, ..., q_{N-1}),
  constraint rows: row0: dx_0 + (x_0 - xs) = 0;
  row k+1: dx_{k+1} - A_k dx_k - B_k du_k + c_{k+1} = 0 with
  c_{k+1} = x_{k+1} - f_euler(x_k, u_k)  (the integrator defect,
  kkt.cuh:115-117 stores C = -[A|B] and d_c = defect).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mpcgpu.config import CostConfig
from mpcgpu.models import dynamics
from mpcgpu.models.robot import RobotModel
from mpcgpu.precision import highest_precision


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KKTBlocks:
    """Per-knot KKT data (all knot-leading)."""

    Q: jax.Array        # (N, nx, nx) state cost Hessians
    q: jax.Array        # (N, nx)     state cost gradients
    R: jax.Array        # (N-1, nu, nu) control cost Hessians
    r: jax.Array        # (N-1, nu)     control cost gradients
    A: jax.Array        # (N-1, nx, nx) dynamics state Jacobians
    B: jax.Array        # (N-1, nx, nu) dynamics control Jacobians
    c: jax.Array        # (N, nx) constraint residuals; c[0] = x0 - xs


# The reference's angleWrap uses a truncated pi literal (integrator.cuh:15);
# replicated for numerical parity of the wrapped branch.
_WRAP_PI = 3.14159


def angle_wrap(q):
    """Reference angleWrap (integrator.cuh:12-19): a REFLECTION at +-pi, not
    a modular wrap — q > pi maps to -(q - pi), q < -pi to -(q + pi)."""
    q = jnp.where(q > _WRAP_PI, -(q - _WRAP_PI), q)
    return jnp.where(q < -_WRAP_PI, -(q + _WRAP_PI), q)


def integrator_step(model: RobotModel, x, u, dt, integrator_type: int = 0,
                    wrap: bool = False):
    """One integrator step (no Jacobians). Types as in integrator.cuh:22-57:
    0 = explicit Euler, 1 = semi-implicit Euler.  ``wrap`` applies the
    ANGLE_WRAP post-step to the position half (integrator.cuh:125-128)."""
    nq = model.nq
    q, qd = x[:nq], x[nq:]
    qdd = dynamics.forward_dynamics_aba(model, q, qd, u)
    if integrator_type == 0:
        qn, qdn = q + dt * qd, qd + dt * qdd
    elif integrator_type == 1:
        qdn = qd + dt * qdd
        qn = q + dt * qdn
    else:
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if wrap:
        qn = angle_wrap(qn)
    return jnp.concatenate([qn, qdn])


def euler_step_and_jacobians(model: RobotModel, x, u, dt, integrator_type: int = 0,
                             wrap: bool = False):
    """One integrator step x+ and its Jacobians.

    Matches exec_integrator / exec_integrator_gradient
    (integrator.cuh:103-130, :59-100):
      type 0 (Euler):        A = I + dt*[[0, I], [dqdd/dq, dqdd/dqd]],
                             B = [0; dt * M^{-1}]
      type 1 (semi-implicit): qd+ = qd + dt*qdd; q+ = q + dt*qd+;
                             A = [[I + dt^2 dq, dt I + dt^2 dqd],
                                  [dt dq,       I + dt dqd     ]],
                             B = [dt^2 M^{-1}; dt M^{-1}]
    """
    nq = model.nq
    q, qd = x[:nq], x[nq:]
    qdd, dq, dqd, minv = dynamics.fd_and_gradient(model, q, qd, u)
    eye = jnp.eye(nq, dtype=x.dtype)
    zero = jnp.zeros((nq, nq), dtype=x.dtype)
    if integrator_type == 0:
        qn = q + dt * qd
        A = jnp.block([[eye, dt * eye], [dt * dq, eye + dt * dqd]])
        B = jnp.concatenate([zero, dt * minv], axis=0)
        qdn = qd + dt * qdd
    elif integrator_type == 1:
        qdn = qd + dt * qdd
        qn = q + dt * qdn
        A = jnp.block(
            [[eye + dt * dt * dq, dt * eye + dt * dt * dqd],
             [dt * dq, eye + dt * dqd]]
        )
        B = jnp.concatenate([dt * dt * minv, dt * minv], axis=0)
    else:
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if wrap:
        # ANGLE_WRAP affects the step value only; the reference leaves the
        # Jacobians untouched (integratorAndGradient, integrator.cuh:133-157)
        qn = angle_wrap(qn)
    xnext = jnp.concatenate([qn, qdn])
    return xnext, A, B


def tracking_cost_grad_hess(model: RobotModel, cost: CostConfig, x, u, goal):
    """Per-knot tracking-cost gradient and (reference-style) Hessian.

    ee mode — matches trackingCostGradientAndHessian
    (iiwa_eepos_plant.cuh:295-378):
      q[:nq]  = J_ee^T (ee(q) - goal_xyz);     q[nq:] = QD * qd
      Q[:nq,:nq] = outer(q[:nq], q[:nq])   <- the reference's rank-1
                   gradient-outer-product "Gauss-Newton" block
      Q[nq:,nq:] = QD * I;   R = R_COST * I;  r = R_COST * u.

    joint mode — matches the inactive joint-state variant
    (iiwa_plant.cuh:186-298): diagonal quadratic tracking of the (nx,) state
    reference with Q_COST / QD_COST weights.
    """
    nq = model.nq
    qpos, qd = x[:nq], x[nq:]
    dtype = x.dtype
    if cost.mode == "ee":
        ee, J = dynamics.fk_ee_xyz_and_jac(model, qpos)
        err = ee - goal[:3]
        gq = J.T @ err
        grad = jnp.concatenate([gq, cost.qd_cost * qd])
        Q = jnp.zeros((2 * nq, 2 * nq), dtype=dtype)
        Q = Q.at[:nq, :nq].set(jnp.outer(gq, gq))
        Q = Q.at[nq:, nq:].set(cost.qd_cost * jnp.eye(nq, dtype=dtype))
    elif cost.mode == "joint":
        qd_err = qd if cost.absolute_qd_penalty else qd - goal[nq : 2 * nq]
        grad = jnp.concatenate(
            [cost.q_cost * (qpos - goal[:nq]), cost.qd_cost * qd_err]
        )
        diag = jnp.concatenate(
            [jnp.full((nq,), cost.q_cost, dtype), jnp.full((nq,), cost.qd_cost, dtype)]
        )
        Q = jnp.diag(diag)
    else:
        raise ValueError(f"unknown cost mode {cost.mode!r}")
    r = cost.r_cost * u
    R = cost.r_cost * jnp.eye(nq, dtype=dtype)
    return Q, grad, R, r


@highest_precision
def build_kkt(
    model: RobotModel, cost: CostConfig, xu, xs, ee_goal, dt,
    integrator_type: int = 0, angle_wrap: bool = False,
) -> KKTBlocks:
    """Assemble all KKT blocks for the current iterate (jit-friendly).

    Args:
      xu: (N, nx+nu) trajectory iterate.
      xs: (nx,) measured initial state.
      ee_goal: (N, 6) ee goal trace.
      dt: knot timestep (static python float ok, traced ok).
      integrator_type: 0 Euler / 1 semi-implicit (static).
      angle_wrap: apply the ANGLE_WRAP post-step in the defect (kkt.cuh:22,77).
    """
    nq = model.nq
    nx = 2 * nq
    N = xu.shape[0]
    x = xu[:, :nx]
    u = xu[:, nx:]

    # dynamics linearization at knots 0..N-2
    xnext, A, B = jax.vmap(
        lambda xx, uu: euler_step_and_jacobians(model, xx, uu, dt,
                                                integrator_type, angle_wrap)
    )(x[:-1], u[:-1])
    defect = x[1:] - xnext
    c = jnp.concatenate([(x[0] - xs)[None], defect], axis=0)

    # cost quadratics at every knot; terminal knot has no control term.
    # The reference evaluates the terminal block at x_{N-2}
    # (iiwa_eepos_plant.cuh:399 passes the same s_xux); cost.terminal_at_last_
    # state=True uses the mathematically-correct x_{N-1}.
    x_eval = x if cost.terminal_at_last_state else x.at[N - 1].set(x[N - 2])
    Q, q, R, r = jax.vmap(
        lambda xx, uu, gg: tracking_cost_grad_hess(model, cost, xx, uu, gg)
    )(x_eval, u, ee_goal)

    return KKTBlocks(Q=Q, q=q, R=R[:-1], r=r[:-1], A=A, B=B, c=c)
