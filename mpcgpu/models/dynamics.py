"""Batched rigid-body dynamics: FK, RNEA, mass matrix, forward dynamics + grads.

Functional equivalents of the GRiD codegen device routines (reference
citations per function), written as plain JAX over a ``RobotModel`` so every
op batches with ``vmap`` and fuses under ``jit``.  Joint loops are unrolled in
Python (nq is static and small), so XLA sees a flat graph of tiny fused
einsums — the replacement for the reference's one-thread-block unrolled
spatial algebra.

All functions are single-sample over the robot state; use ``jax.vmap`` for
knot/instance batching (the solver stack does this).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mpcgpu.models.robot import RobotModel
from mpcgpu.models.spatial import crf_apply, crm_apply
from mpcgpu.ops.smallmat import gj_inverse, gj_solve_vec
from mpcgpu.precision import highest_precision

# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------


@highest_precision
def fk_ee_hom(model: RobotModel, q: jax.Array) -> jax.Array:
    """Base->end-effector homogeneous transform.

    Mirrors end_effector_positions_inner's leaf-to-root chaining
    (iiwa_eepos_grid.cuh:2015-2067): T = Xhom_0 @ Xhom_1 @ ... @ Xhom_{nq-1}.
    """
    H = model.hom_xmats(q)
    T = H[0]
    for k in range(1, model.nq):
        T = T @ H[k]
    return T


@highest_precision
def fk_ee_xyz(model: RobotModel, q: jax.Array) -> jax.Array:
    """End-effector position (3,)."""
    return fk_ee_hom(model, q)[0:3, 3]


@highest_precision
def fk_ee(model: RobotModel, q: jax.Array) -> jax.Array:
    """End-effector pose (6,) = [xyz, roll, pitch, yaw].

    RPY extraction matches iiwa_eepos_grid.cuh:2072-2081.
    """
    T = fk_ee_hom(model, q)
    roll = jnp.arctan2(T[2, 1], T[2, 2])
    pitch = -jnp.arctan2(T[2, 0], jnp.sqrt(T[2, 1] ** 2 + T[2, 2] ** 2))
    yaw = jnp.arctan2(T[1, 0], T[0, 0])
    return jnp.concatenate([T[0:3, 3], jnp.stack([roll, pitch, yaw])])


@highest_precision
def fk_ee_xyz_and_jac(model: RobotModel, q: jax.Array):
    """(ee_xyz (3,), d ee_xyz / dq (3, nq)).

    Equivalent to end_effector_positions[_gradient]_device
    (iiwa_eepos_grid.cuh:2094, :2255-2509); here the analytic dXhom chain rule
    is realized by forward-mode AD through the same affine transform product,
    which is algebraically identical.
    """
    return fk_ee_xyz(model, q), jax.jacfwd(lambda qq: fk_ee_xyz(model, qq))(q)


# ---------------------------------------------------------------------------
# inverse dynamics (RNEA)
# ---------------------------------------------------------------------------


@highest_precision
def rnea(model: RobotModel, q: jax.Array, qd: jax.Array, qdd=None) -> jax.Array:
    """Recursive Newton-Euler inverse dynamics: tau = ID(q, qd, qdd).

    With qdd=None computes the bias term c(q, qd) = ID(q, qd, 0) — the
    overload split of inverse_dynamics_inner (iiwa_eepos_grid.cuh:2511-3497).
    Joints are revolute-z (S = e_z) and gravity enters as the base spatial
    acceleration [0,0,0, 0,0,g] (iiwa_eepos_grid.cuh:2752-2756).
    """
    nq = model.nq
    X = model.xmats(q)
    I = model.inertia
    dtype = X.dtype
    ez = jnp.zeros((6,), dtype).at[2].set(1.0)

    a_base = jnp.zeros((6,), dtype).at[5].set(jnp.asarray(model.gravity, dtype))
    va_prev = jnp.stack([jnp.zeros((6,), dtype), a_base], axis=-1)  # (6, 2)

    def crm_ez(m, s):
        """m x (e_z * s) — the revolute-z joint-velocity cross, specialized:
        [w x ez; v x ez] * s = [w1, -w0, 0, m4, -m3, 0] * s."""
        return s * jnp.stack(
            [m[1], -m[0], jnp.zeros((), dtype), m[4], -m[3], jnp.zeros((), dtype)]
        )

    vs, fs = [], []
    for k in range(nq):
        va = X[k] @ va_prev                      # one (6,6)@(6,2) matmul
        vk = va[:, 0] + ez * qd[k]
        ak = va[:, 1] + crm_ez(vk, qd[k])
        if qdd is not None:
            ak = ak + ez * qdd[k]
        Iva = I[k] @ jnp.stack([ak, vk], axis=-1)  # I@a and I@v in one matmul
        fk = Iva[:, 0] + crf_apply(vk, Iva[:, 1])
        vs.append(vk)
        fs.append(fk)
        va_prev = jnp.stack([vk, ak], axis=-1)

    taus = [None] * nq
    f_carry = fs[nq - 1]
    for k in range(nq - 1, -1, -1):
        taus[k] = f_carry[2]
        if k > 0:
            f_carry = fs[k - 1] + X[k].T @ f_carry
    return jnp.stack(taus)


# ---------------------------------------------------------------------------
# mass matrix and forward dynamics
# ---------------------------------------------------------------------------


@highest_precision
def mass_matrix(model: RobotModel, q: jax.Array) -> jax.Array:
    """Joint-space inertia matrix M(q) via CRBA (nq, nq).

    Functional counterpart of GRiD's direct M^{-1} articulated-body pass
    (direct_minv_inner, iiwa_eepos_grid.cuh:3753-4186): we form M by the
    composite-rigid-body algorithm and factorize with Cholesky on device,
    which maps better onto XLA than the branchy ABA recursion.
    """
    nq = model.nq
    X = model.xmats(q)
    IC = [model.inertia[k] for k in range(nq)]
    for k in range(nq - 1, 0, -1):
        IC[k - 1] = IC[k - 1] + X[k].T @ IC[k] @ X[k]

    # all columns' spatial forces walked down together: column k's force
    # IC_k e_z is injected when the walk reaches frame k, then every active
    # column steps down one frame per level with a single (6,6)@(6,nq)
    # matmul; entries for not-yet-injected columns are masked by the final
    # triu.  (Replaces the per-column matvec chains of the scalar CRBA.)
    F = jnp.zeros((6, nq), X.dtype)
    rows = [None] * nq
    for j in range(nq - 1, -1, -1):
        F = F.at[:, j].set(IC[j][:, 2])
        rows[j] = F[2]                       # M[j, k] for k >= j
        if j > 0:
            F = X[j].T @ F
    M = jnp.stack(rows, axis=0)
    # row j holds M[j, k] valid for k >= j (upper triangle); mirror it
    return jnp.triu(M) + jnp.triu(M, 1).T


@highest_precision
def minv(model: RobotModel, q: jax.Array) -> jax.Array:
    """Dense M(q)^{-1} (direct_minv_inner equivalent)."""
    return gj_inverse(mass_matrix(model, q))


@highest_precision
def forward_dynamics(model: RobotModel, q, qd, u) -> jax.Array:
    """qdd = M(q)^{-1} (u - c(q, qd)).

    Matches forward_dynamics_inner / forward_dynamics_finish
    (iiwa_eepos_grid.cuh:4351-4556): bias from RNEA at qdd=0, then an M solve
    (unrolled Gauss-Jordan — no XLA loop-based factorizations on tiny blocks).
    """
    c = rnea(model, q, qd)
    M = mass_matrix(model, q)
    return gj_solve_vec(M, u - c)


@highest_precision
def forward_dynamics_aba(model: RobotModel, q, qd, u) -> jax.Array:
    """qdd via the articulated-body algorithm (Featherstone RBDA Table 7.1).

    Produces the same qdd as ``forward_dynamics`` (= GRiD's
    forward_dynamics_inner chain, iiwa_eepos_grid.cuh:4351-4556) but never
    forms or inverts M: the backward articulated-inertia pass reduces the
    joint-space solve to nq scalar divisions.  This is the cheap path for
    merit / line-search / plant evaluations, which need only qdd (no
    gradients): ~40% fewer tiny XLA ops than RNEA + CRBA + Gauss-Jordan.
    """
    nq = model.nq
    X = model.xmats(q)
    I = model.inertia
    dtype = X.dtype

    v_par = jnp.zeros((6,), dtype)
    vs, cs, pAs = [], [], []
    for k in range(nq):
        vk = X[k] @ v_par + jnp.zeros((6,), dtype).at[2].set(qd[k])
        # c_k = v_k x (S qd_k) with S = e_z, specialized like rnea's crm_ez
        ck = qd[k] * jnp.stack(
            [vk[1], -vk[0], jnp.zeros((), dtype), vk[4], -vk[3], jnp.zeros((), dtype)]
        )
        pAk = crf_apply(vk, I[k] @ vk)
        vs.append(vk)
        cs.append(ck)
        pAs.append(pAk)
        v_par = vk

    IA = [I[k] for k in range(nq)]
    pA = list(pAs)
    U, d, uu = [None] * nq, [None] * nq, [None] * nq
    for k in range(nq - 1, -1, -1):
        U[k] = IA[k][:, 2]
        d[k] = IA[k][2, 2]
        uu[k] = u[k] - pA[k][2]
        if k > 0:
            Ia = IA[k] - jnp.outer(U[k], U[k]) / d[k]
            pa = pA[k] + Ia @ cs[k] + U[k] * (uu[k] / d[k])
            IaX = Ia @ X[k]
            IA[k - 1] = IA[k - 1] + X[k].T @ IaX
            pA[k - 1] = pA[k - 1] + X[k].T @ pa

    a_base = jnp.zeros((6,), dtype).at[5].set(jnp.asarray(model.gravity, dtype))
    a_par = a_base
    qdds = []
    for k in range(nq):
        ap = X[k] @ a_par + cs[k]
        qdd_k = (uu[k] - U[k] @ ap) / d[k]
        qdds.append(qdd_k)
        a_par = ap + jnp.zeros((6,), dtype).at[2].set(qdd_k)
    return jnp.stack(qdds)


@highest_precision
def fd_and_gradient(model: RobotModel, q, qd, u):
    """(qdd, dqdd_dq (nq,nq), dqdd_dqd (nq,nq), dqdd_du = M^{-1} (nq,nq)).

    Same math as gato_plant::forwardDynamicsAndGradient
    (iiwa_eepos_plant.cuh:126-156): by implicit differentiation of
    RNEA(q, qd, qdd) = u at the solved qdd,

        dqdd/d{q,qd} = -M^{-1} * d RNEA/d{q,qd} |_{qdd fixed},   dqdd/du = M^{-1}.

    The inner dRNEA/d{q,qd} is exact forward-mode AD of the same RNEA —
    algebraically identical to GRiD's hand-rolled inverse_dynamics_gradient
    (iiwa_eepos_grid.cuh:4558-5275).
    """
    c = rnea(model, q, qd)
    M = mass_matrix(model, q)
    minv_ = gj_inverse(M)
    qdd = minv_ @ (u - c)

    did_dq, did_dqd = jax.jacfwd(
        lambda qq, qqd: rnea(model, qq, qqd, qdd), argnums=(0, 1)
    )(q, qd)
    dqdd_dq = -minv_ @ did_dq
    dqdd_dqd = -minv_ @ did_dqd
    return qdd, dqdd_dq, dqdd_dqd, minv_
