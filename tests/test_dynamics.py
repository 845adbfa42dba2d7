"""Dynamics unit tests vs finite differences and the recorded reference traces.

Test strategy per SURVEY.md section 4: (1) FK vs the reference's precomputed
ee-pos trajectory, (2) integrator defect ~ 0 along the recorded optimized
trajectory, (3) analytic gradients vs central finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpcgpu.models import dynamics, iiwa14
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def model():
    return iiwa14(dtype=jnp.float64)


@pytest.fixture(scope="module")
def traj():
    xu = load_xu_traj("0_0")
    ee = load_eepos_traj("0_0")
    return xu, ee


def test_fk_matches_reference_eepos_trace(model, traj):
    xu, ee = traj
    rows = slice(0, 32)
    fk = jax.jit(jax.vmap(lambda q: dynamics.fk_ee(model, q)))
    got = np.asarray(fk(xu[rows, :7]))
    np.testing.assert_allclose(got, ee[rows], atol=2e-5)


def test_trajectory_defects_near_zero(model, traj):
    """The recorded xu trace is (near-)dynamically feasible under Euler
    integration with our forward dynamics — the strongest end-to-end oracle
    available (track_iiwa_pcg.cu's traces were generated with the reference
    dynamics)."""
    xu, _ = traj
    rows = slice(1, 64)  # row 0 has inconsistent control in the recording
    x, u = xu[rows, :14], xu[rows, 14:]
    dt = 1.0 / 64.0
    fd = jax.jit(jax.vmap(lambda q, qd, uu: dynamics.forward_dynamics(model, q, qd, uu)))
    qdd = np.asarray(fd(x[:-1, :7], x[:-1, 7:], u[:-1]))
    defect_q = x[:-1, :7] + dt * x[:-1, 7:] - x[1:, :7]
    defect_qd = x[:-1, 7:] + dt * qdd - x[1:, 7:]
    assert np.abs(defect_q).max() < 1e-6
    assert np.abs(defect_qd).max() < 1e-3


def test_id_fd_roundtrip(model, traj):
    xu, _ = traj
    x, u = xu[5, :14], xu[5, 14:]
    qdd = dynamics.forward_dynamics(model, x[:7], x[7:], u)
    tau = dynamics.rnea(model, x[:7], x[7:], qdd)
    np.testing.assert_allclose(np.asarray(tau), u, atol=1e-10)


def test_mass_matrix_spd_and_matches_rnea_columns(model, traj):
    xu, _ = traj
    q = xu[10, :7]
    M = np.asarray(dynamics.mass_matrix(model, q))
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    assert np.linalg.eigvalsh(M).min() > 0
    z = np.zeros(7)
    c0 = dynamics.rnea(model, q, z, z)
    cols = np.stack(
        [np.asarray(dynamics.rnea(model, q, z, np.eye(7)[i]) - c0) for i in range(7)],
        axis=1,
    )
    np.testing.assert_allclose(M, cols, atol=1e-10)


def test_fd_gradient_vs_finite_differences(model, traj):
    xu, _ = traj
    q0, qd0, u0 = xu[3, :7], xu[3, 7:14], xu[3, 14:]
    qdd0, dq, dqd, du = dynamics.fd_and_gradient(model, q0, qd0, u0)
    np.testing.assert_allclose(
        np.asarray(qdd0), np.asarray(dynamics.forward_dynamics(model, q0, qd0, u0))
    )
    eps = 1e-6
    E = np.eye(7)

    def fdiff(f, x0):
        return np.stack(
            [(np.asarray(f(x0 + eps * E[i])) - np.asarray(f(x0 - eps * E[i]))) / (2 * eps) for i in range(7)],
            axis=1,
        )

    num_dq = fdiff(lambda qq: dynamics.forward_dynamics(model, qq, qd0, u0), q0)
    num_dqd = fdiff(lambda qq: dynamics.forward_dynamics(model, q0, qq, u0), qd0)
    num_du = fdiff(lambda uu: dynamics.forward_dynamics(model, q0, qd0, uu), u0)
    np.testing.assert_allclose(np.asarray(dq), num_dq, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dqd), num_dqd, atol=1e-6)
    np.testing.assert_allclose(np.asarray(du), num_du, atol=1e-6)


def test_ee_jacobian_vs_finite_differences(model, traj):
    xu, _ = traj
    q0 = xu[7, :7]
    xyz, J = dynamics.fk_ee_xyz_and_jac(model, q0)
    eps = 1e-7
    E = np.eye(7)
    num = np.stack(
        [
            (np.asarray(dynamics.fk_ee_xyz(model, q0 + eps * E[i])) - np.asarray(dynamics.fk_ee_xyz(model, q0 - eps * E[i]))) / (2 * eps)
            for i in range(7)
        ],
        axis=1,
    )
    np.testing.assert_allclose(np.asarray(J), num, atol=1e-6)


def test_aba_matches_mass_matrix_solve(model, traj):
    """ABA (forward_dynamics_aba) == M^{-1}(u - c) on random states."""
    key = jax.random.PRNGKey(3)
    for _ in range(5):
        k1, k2, k3, key = jax.random.split(key, 4)
        q = jax.random.uniform(k1, (7,), jnp.float64, -2.5, 2.5)
        qd = jax.random.uniform(k2, (7,), jnp.float64, -2.0, 2.0)
        u = jax.random.uniform(k3, (7,), jnp.float64, -10.0, 10.0)
        ref = dynamics.forward_dynamics(model, q, qd, u)
        aba = dynamics.forward_dynamics_aba(model, q, qd, u)
        np.testing.assert_allclose(np.asarray(aba), np.asarray(ref), atol=1e-9)
