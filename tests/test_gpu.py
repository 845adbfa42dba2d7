"""Card-only checks of the compiled PCG kernel (marked ``gpu``; they skip
where JAX's default device is not a GPU).  chip_smoke.py runs the full
comparison at every horizon."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpcgpu.ops.pcg import pcg_solve
from mpcgpu.ops.pcg_pallas import pcg_solve_pallas

pytestmark = pytest.mark.gpu


def _system(N, n=14, seed=0):
    rng = np.random.default_rng(seed)
    S = np.zeros((N, 3, n, n))
    for k in range(N):
        A = 0.3 * rng.standard_normal((n, n))
        S[k, 1] = A @ A.T + 3.2 * np.eye(n)
        if k > 0:
            S[k, 0] = 0.35 * rng.standard_normal((n, n))
    S[:-1, 2] = np.swapaxes(S[1:, 0], -1, -2)
    P = np.zeros_like(S)
    P[:, 1] = np.linalg.inv(S[:, 1])
    g = rng.standard_normal((N, n))
    return [jnp.asarray(a, jnp.float32) for a in (S, P, g, np.zeros_like(g))]


@pytest.mark.parametrize("N", [32, 64, 512])
def test_compiled_kernel_matches_xla_pcg(gpu, N):
    args = _system(N, seed=N)
    ref = pcg_solve(*args, max_iter=200, exit_tol=1e-8)
    got = pcg_solve_pallas(*args, max_iter=200, exit_tol=1e-8)
    assert bool(got.converged) and bool(ref.converged)
    assert abs(int(got.iters) - int(ref.iters)) <= 1
    err = float(jnp.linalg.norm(got.lam - ref.lam) / jnp.linalg.norm(ref.lam))
    assert err < 1e-4, err
