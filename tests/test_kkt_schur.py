"""KKT/Schur/preconditioner/PCG/LDL tests against a dense numpy KKT oracle.

The oracle builds the full dense equality-constrained QP
    [G_rho C^T] [dz*]   [-g]
    [C     0  ] [lam*] = [-c]
from the same KKT blocks and checks:
  * the BTD Schur system equals C G^{-1} C^T (and gamma its rhs);
  * the stair preconditioner equals D^{-1} - D^{-1} T D^{-1};
  * PCG (tight tol), block LDL^T, and the dense solve agree on lambda;
  * compute_dz recovers the Newton step: -dz == dz*.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpcgpu.config import CostConfig
from mpcgpu.models import iiwa14
from mpcgpu.ops.btd import btd_matvec, btd_to_dense
from mpcgpu.ops.ldl import btd_ldl_solve
from mpcgpu.ops.pcg import pcg_solve
from mpcgpu.ops.schur import compute_dz, form_schur_system
from mpcgpu.solver.kkt import build_kkt
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

jax.config.update("jax_enable_x64", True)

N = 8
NX, NU = 14, 7
DT = 1.0 / 64.0
RHO = 1e-3


@pytest.fixture(scope="module")
def problem():
    model = iiwa14(dtype=jnp.float64)
    cost = CostConfig()
    xu_traj = load_xu_traj("0_0")
    ee_traj = load_eepos_traj("0_0")
    xu = jnp.asarray(xu_traj[:N])
    # perturb so defects are nonzero
    xu = xu + 0.01 * jnp.sin(jnp.arange(xu.size, dtype=jnp.float64)).reshape(xu.shape)
    xs = xu[0, :NX] + 0.005
    ee_goal = jnp.asarray(ee_traj[:N])
    kkt = build_kkt(model, cost, xu, xs, ee_goal, DT)
    schur = form_schur_system(kkt, RHO, preconditioner="stair")
    return model, cost, xu, xs, ee_goal, kkt, schur


def dense_G_C(kkt, rho):
    """Densify G_rho (block diag) and C (dynamics+initial constraint rows)."""
    Q, R, A, B = map(np.asarray, (kkt.Q, kkt.R, kkt.A, kkt.B))
    q, r, c = map(np.asarray, (kkt.q, kkt.r, kkt.c))
    nz = N * (NX + NU) - NU
    G = np.zeros((nz, nz))
    g = np.zeros(nz)
    for k in range(N):
        o = k * (NX + NU)
        G[o : o + NX, o : o + NX] = Q[k] + rho * np.eye(NX)
        g[o : o + NX] = q[k]
        if k < N - 1:
            G[o + NX : o + NX + NU, o + NX : o + NX + NU] = R[k] + rho * np.eye(NU)
            g[o + NX : o + NX + NU] = r[k]
    C = np.zeros((N * NX, nz))
    C[0:NX, 0:NX] = np.eye(NX)
    for k in range(N - 1):
        o = k * (NX + NU)
        C[(k + 1) * NX : (k + 2) * NX, o : o + NX] = -A[k]
        C[(k + 1) * NX : (k + 2) * NX, o + NX : o + NX + NU] = -B[k]
        C[(k + 1) * NX : (k + 2) * NX, o + NX + NU : o + 2 * NX + NU] = np.eye(NX)
    return G, C, g, c.ravel()


def test_schur_matches_dense_oracle(problem):
    *_, kkt, schur = problem
    G, C, g, c = dense_G_C(kkt, RHO)
    Ginv = np.linalg.inv(G)
    S_dense = np.asarray(btd_to_dense(schur.S))
    np.testing.assert_allclose(S_dense, C @ Ginv @ C.T, atol=1e-9)
    # gamma = C G^{-1} g - c  with the initial-state residual c_0 omitted,
    # replicating pcg/linsys_setup.cuh:272-276
    c_mod = c.copy()
    c_mod[:NX] = 0.0
    np.testing.assert_allclose(
        np.asarray(schur.gamma).ravel(), C @ Ginv @ g - c_mod, atol=1e-9
    )


def test_stair_preconditioner_structure(problem):
    *_, schur = problem
    S = np.asarray(schur.S)
    P = np.asarray(schur.Pinv)
    for k in range(N):
        Dk = np.linalg.inv(S[k, 1])
        np.testing.assert_allclose(P[k, 1], Dk, atol=1e-9)
        if k > 0:
            Dkm1 = np.linalg.inv(S[k - 1, 1])
            np.testing.assert_allclose(P[k, 0], -Dk @ S[k, 0] @ Dkm1, atol=1e-9)
        if k < N - 1:
            Dkp1 = np.linalg.inv(S[k + 1, 1])
            np.testing.assert_allclose(P[k, 2], -Dk @ S[k, 2] @ Dkp1, atol=1e-9)


def test_btd_matvec_vs_dense(problem):
    *_, schur = problem
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, NX))
    y = np.asarray(btd_matvec(schur.S, jnp.asarray(x)))
    y_dense = (np.asarray(btd_to_dense(schur.S)) @ x.ravel()).reshape(N, NX)
    np.testing.assert_allclose(y, y_dense, atol=1e-10)


def test_pcg_ldl_dense_agree(problem):
    *_, schur = problem
    S_dense = np.asarray(btd_to_dense(schur.S))
    gamma = np.asarray(schur.gamma).ravel()
    lam_dense = np.linalg.solve(S_dense, gamma).reshape(N, NX)

    lam_ldl = np.asarray(btd_ldl_solve(schur.S, schur.gamma))
    np.testing.assert_allclose(lam_ldl, lam_dense, atol=1e-8)

    res = pcg_solve(
        schur.S, schur.Pinv, schur.gamma, jnp.zeros((N, NX), jnp.float64),
        max_iter=500, exit_tol=1e-18,
    )
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.lam), lam_dense, atol=1e-6)
    # the stair preconditioner should converge far faster than unpreconditioned
    assert int(res.iters) < N * NX


def test_dz_recovers_newton_step(problem):
    model, cost, xu, xs, ee_goal, kkt, schur = problem
    G, C, g, c = dense_G_C(kkt, RHO)
    c_mod = c.copy()
    c_mod[:NX] = 0.0  # reference omits c_0 from the Schur rhs
    nz = G.shape[0]
    KKT = np.block([[G, C.T], [C, np.zeros((C.shape[0], C.shape[0]))]])
    sol = np.linalg.solve(KKT, np.concatenate([-g, -c_mod]))
    dz_star, lam_star = sol[:nz], sol[nz:]

    lam = btd_ldl_solve(schur.S, schur.gamma)
    np.testing.assert_allclose(np.asarray(lam).ravel(), -lam_star, atol=1e-7)

    dz = np.asarray(compute_dz(kkt, schur, lam))
    # rectangular (N, nx+nu) -> ragged layout; alpha = -1 applies the full step
    dz_flat = np.concatenate([dz[k, : NX + (NU if k < N - 1 else 0)] for k in range(N)])
    np.testing.assert_allclose(-dz_flat, dz_star, atol=1e-7)


def test_stair2_preconditioner(problem):
    """stair2 = one more Neumann term (block-pentadiagonal, 5 slots):
    Pinv = D^-1 - D^-1 T D^-1 + D^-1 T D^-1 T D^-1, checked against the
    dense construction; pcg_solve with the 5-band Pinv must reach the same
    solution.  (Iteration-count advantage is workload-dependent — see
    benchmarks/precond_study.py — so only correctness is asserted here.)"""
    *_, kkt, schur = problem
    schur2 = form_schur_system(kkt, RHO, preconditioner="stair2")
    assert schur2.Pinv.shape == (N, 5, NX, NX)

    S_dense = np.asarray(btd_to_dense(schur.S))
    D_dense = np.zeros_like(S_dense)
    for k in range(N):
        D_dense[k * NX:(k + 1) * NX, k * NX:(k + 1) * NX] = np.asarray(
            schur.S[k, 1])
    Dinv = np.linalg.inv(D_dense)
    T = S_dense - D_dense
    P_oracle = Dinv - Dinv @ T @ Dinv + Dinv @ T @ Dinv @ T @ Dinv

    # densify the 5-band Pinv
    P2 = np.asarray(schur2.Pinv)
    P_dense = np.zeros_like(S_dense)
    for k in range(N):
        for s, d in enumerate(range(-2, 3)):
            j = k + d
            if 0 <= j < N:
                P_dense[k * NX:(k + 1) * NX, j * NX:(j + 1) * NX] = P2[k, s]
    np.testing.assert_allclose(P_dense, P_oracle, atol=1e-9)

    # banded matvec agrees with the dense apply
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, NX))
    y = np.asarray(btd_matvec(schur2.Pinv, jnp.asarray(x)))
    np.testing.assert_allclose(y, (P_oracle @ x.ravel()).reshape(N, NX),
                               atol=1e-9)

    gamma = np.asarray(schur.gamma).ravel()
    lam_dense = np.linalg.solve(S_dense, gamma).reshape(N, NX)
    res2 = pcg_solve(
        schur2.S, schur2.Pinv, schur2.gamma, jnp.zeros((N, NX), jnp.float64),
        max_iter=500, exit_tol=1e-12, exit_criterion="rnorm",
    )
    assert bool(res2.converged)
    np.testing.assert_allclose(np.asarray(res2.lam), lam_dense, atol=1e-6)


def test_precond_poly2(problem):
    """precond_poly=2 applies z = (2 Pinv - Pinv S Pinv) r in-loop and must
    converge to the same solution."""
    *_, schur = problem
    S_dense = np.asarray(btd_to_dense(schur.S))
    lam_dense = np.linalg.solve(
        S_dense, np.asarray(schur.gamma).ravel()).reshape(N, NX)
    res = pcg_solve(
        schur.S, schur.Pinv, schur.gamma, jnp.zeros((N, NX), jnp.float64),
        max_iter=500, exit_tol=1e-12, exit_criterion="rnorm", precond_poly=2,
    )
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.lam), lam_dense, atol=1e-6)
