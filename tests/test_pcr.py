"""Parallel cyclic reduction direct solver vs LDL^T / dense oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpcgpu.config import CostConfig
from mpcgpu.models import iiwa14
from mpcgpu.ops.btd import btd_matvec
from mpcgpu.ops.pcr import pcr_solve, pcr_solve_refined
from mpcgpu.ops.schur import form_schur_system
from mpcgpu.solver.kkt import build_kkt
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj


def _schur(N, dtype):
    model = iiwa14(dtype=dtype)
    cost = CostConfig.for_knots(N)
    reps = (N + 665) // 666
    xu = jnp.asarray(np.concatenate([load_xu_traj("0_0")] * reps)[:N], dtype)
    ee = jnp.asarray(np.concatenate([load_eepos_traj("0_0")] * reps)[:N], dtype)
    xu = xu + 0.01 * jax.random.normal(jax.random.PRNGKey(0), xu.shape, dtype)
    kkt = build_kkt(model, cost, xu, xu[0, :14], ee, 1 / 64.0)
    return form_schur_system(kkt, 1e-3)


def _true_residual(S, x, b):
    return float(jnp.max(jnp.abs(btd_matvec(S, x) - b)))


@pytest.mark.parametrize("N", [4, 16, 64, 100])
def test_pcr_exact_f64(N):
    """PCR == exact solve in f64, including non-power-of-two N."""
    schur = _schur(N, jnp.float64)
    x = pcr_solve(schur.S, schur.gamma)
    res = _true_residual(schur.S, x, schur.gamma)
    assert res < 1e-6 * max(1.0, float(jnp.max(jnp.abs(schur.gamma))))


def test_pcr_refined_beats_capped_pcg_f32():
    """PCR + 1 refinement achieves a smaller true residual in f32 than the
    tuned-cap stair PCG (the reference's operating point)."""
    from mpcgpu.ops.pcg import pcg_solve

    schur = _schur(64, jnp.float32)
    lam0 = jnp.zeros_like(schur.gamma)
    pcg = pcg_solve(schur.S, schur.Pinv, schur.gamma, lam0,
                    max_iter=167, exit_tol=1e-5)
    x = pcr_solve_refined(schur.S, schur.gamma, refine=1)
    assert _true_residual(schur.S, x, schur.gamma) < _true_residual(
        schur.S, pcg.lam, schur.gamma
    )


def test_pcr_random_spd_btd():
    """Random well-conditioned SPD BTD vs dense numpy solve."""
    rng = np.random.default_rng(0)
    N, n = 12, 5
    diag = []
    off = []
    for k in range(N):
        Mk = rng.normal(size=(n, n))
        diag.append(Mk @ Mk.T + 5.0 * n * np.eye(n))
        off.append(rng.normal(size=(n, n)) * 0.5)
    dense = np.zeros((N * n, N * n))
    for k in range(N):
        dense[k * n:(k + 1) * n, k * n:(k + 1) * n] = diag[k]
        if k > 0:
            dense[k * n:(k + 1) * n, (k - 1) * n:k * n] = off[k]
            dense[(k - 1) * n:k * n, k * n:(k + 1) * n] = off[k].T
    b = rng.normal(size=(N * n,))
    S = np.zeros((N, 3, n, n))
    for k in range(N):
        S[k, 1] = diag[k]
        if k > 0:
            S[k, 0] = off[k]
            S[k - 1, 2] = off[k].T
    x = pcr_solve(jnp.asarray(S, jnp.float64), jnp.asarray(b.reshape(N, n), jnp.float64))
    ref = np.linalg.solve(dense, b).reshape(N, n)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-8, atol=1e-9)


def test_pcr_sqp_path():
    """linsys='pcr' runs the whole SQP solve."""
    from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
    from mpcgpu.solver.sqp import sqp_solve

    N = 16
    model = iiwa14()
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float32)
    res = sqp_solve(model, CostConfig.for_knots(N), SQPConfig(max_iter=3),
                    PCGConfig(), xu, jnp.zeros((N, 14), jnp.float32),
                    xu[0, :14], ee, 1e-3, 1 / 64.0, linsys="pcr")
    assert np.isfinite(np.asarray(res.xu)).all()
    assert int(res.sqp_iters) == 3
