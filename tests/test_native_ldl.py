"""Native C++ block-tridiagonal LDL^T (the qdldl-equivalent CPU baseline)
against the on-device scan implementation and a dense oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from mpcgpu.ops.btd import btd_to_dense
from mpcgpu.ops.ldl import btd_ldl_solve


def _system(N=24, n=14, seed=1):
    rng = np.random.default_rng(seed)
    S = np.zeros((N, 3, n, n))
    for k in range(N):
        A = rng.standard_normal((n, n)) * 0.3
        S[k, 1] = A @ A.T + 3 * np.eye(n)
        if k > 0:
            S[k, 0] = rng.standard_normal((n, n)) * 0.1
    for k in range(N - 1):
        S[k, 2] = S[k + 1, 0].T
    b = rng.standard_normal((N, n))
    return S, b


def test_native_matches_dense_and_jax():
    from mpcgpu.native import btd_ldl_solve_cpu

    S, b = _system()
    x_native = btd_ldl_solve_cpu(S, b)
    dense = np.linalg.solve(np.asarray(btd_to_dense(jnp.asarray(S))), b.ravel())
    np.testing.assert_allclose(x_native.ravel(), dense, atol=1e-10)
    x_jax = np.asarray(btd_ldl_solve(jnp.asarray(S), jnp.asarray(b)))
    np.testing.assert_allclose(x_jax.ravel(), dense, atol=1e-8)
