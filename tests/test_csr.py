"""CSR/CSC packing parity with the reference's closed-form layout
(utils/csr.cuh; nnz formula qdldl/sqp.cuh:148)."""

import numpy as np

from mpcgpu.ops.csr import btd_lower_csc_pattern, btd_lower_csc_values, btd_nnz_lower


def test_lower_csc_roundtrip():
    N, n = 6, 4
    rng = np.random.default_rng(0)
    S = np.zeros((N, 3, n, n))
    for k in range(N):
        A = rng.standard_normal((n, n))
        S[k, 1] = A + A.T
        if k > 0:
            S[k, 0] = rng.standard_normal((n, n))
    for k in range(N - 1):
        S[k, 2] = S[k + 1, 0].T

    col_ptr, row_ind = btd_lower_csc_pattern(n, N)
    vals = btd_lower_csc_values(S)
    assert col_ptr[-1] == len(row_ind) == len(vals) == btd_nnz_lower(n, N)

    # reconstruct dense lower triangle and compare
    dim = N * n
    L = np.zeros((dim, dim))
    for col in range(dim):
        for p in range(col_ptr[col], col_ptr[col + 1]):
            L[row_ind[p], col] = vals[p]
    dense = np.zeros((dim, dim))
    for k in range(N):
        dense[k * n : (k + 1) * n, k * n : (k + 1) * n] = S[k, 1]
        if k > 0:
            dense[k * n : (k + 1) * n, (k - 1) * n : k * n] = S[k, 0]
    np.testing.assert_allclose(L, np.tril(dense))


def test_csr_feeds_direct_solver_cross_check():
    """The CSR layer's reason to exist (qdldl/sqp.cuh:148-166): pack a REAL
    Schur system through the lower-triangle pattern, hand it to a sparse LDL-
    style direct factorization (scipy splu, standing in for qdldl), and check
    the solution against btd_ldl_solve and PCG."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from mpcgpu.config import CostConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.ops.ldl import btd_ldl_solve
    from mpcgpu.ops.pcg import pcg_solve
    from mpcgpu.ops.schur import form_schur_system
    from mpcgpu.solver.kkt import build_kkt
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    N, n = 12, 14
    model = iiwa14(dtype=jnp.float32)
    cost = CostConfig.for_knots(N)
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    xu = xu + 0.02 * jax.random.normal(jax.random.PRNGKey(0), xu.shape, jnp.float32)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float32)
    kkt = build_kkt(model, cost, xu, xu[0, :n], ee, 1 / 64.0)
    schur = form_schur_system(kkt, 1e-3)

    # pack the lower triangle via the CSR layer, then let scipy see the full
    # symmetric matrix: A = L + L^T - diag(L)
    col_ptr, row_ind = btd_lower_csc_pattern(n, N)
    vals = btd_lower_csc_values(np.asarray(schur.S, np.float64))
    L = sp.csc_matrix((vals, row_ind, col_ptr), shape=(N * n, N * n))
    A = L + L.T - sp.diags(L.diagonal())

    g = np.asarray(schur.gamma, np.float64).ravel()
    x_scipy = spla.splu(A.tocsc()).solve(g)

    x_ldl = np.asarray(
        btd_ldl_solve(schur.S, schur.gamma), np.float64).ravel()
    pcg = pcg_solve(schur.S, schur.Pinv, schur.gamma,
                    jnp.zeros_like(schur.gamma), max_iter=500, exit_tol=1e-12)
    x_pcg = np.asarray(pcg.lam, np.float64).ravel()

    scale = np.abs(x_scipy).max()
    np.testing.assert_allclose(x_ldl, x_scipy, atol=2e-4 * scale)
    np.testing.assert_allclose(x_pcg, x_scipy, atol=2e-3 * scale)


def test_upper_csc_roundtrip():
    """qdldl input orientation (upper CSC = the reference's lower CSR,
    csr.cuh:40-74): pattern/value packing reconstructs the dense upper
    triangle."""
    from mpcgpu.ops.csr import btd_upper_csc_pattern, btd_upper_csc_values

    N, n = 6, 4
    rng = np.random.default_rng(1)
    S = np.zeros((N, 3, n, n))
    for k in range(N):
        A = rng.standard_normal((n, n))
        S[k, 1] = A + A.T
        if k > 0:
            S[k, 0] = rng.standard_normal((n, n))
    for k in range(N - 1):
        S[k, 2] = S[k + 1, 0].T

    col_ptr, row_ind = btd_upper_csc_pattern(n, N)
    vals = btd_upper_csc_values(S)
    assert col_ptr[-1] == len(row_ind) == len(vals) == btd_nnz_lower(n, N)
    dim = N * n
    U = np.zeros((dim, dim))
    for col in range(dim):
        for p in range(col_ptr[col], col_ptr[col + 1]):
            U[row_ind[p], col] = vals[p]
    dense = np.zeros((dim, dim))
    for k in range(N):
        dense[k * n : (k + 1) * n, k * n : (k + 1) * n] = S[k, 1]
        if k < N - 1:
            dense[k * n : (k + 1) * n, (k + 1) * n : (k + 2) * n] = S[k, 2]
    np.testing.assert_allclose(U, np.triu(dense))


def test_sparse_ldl_random_quasidefinite():
    """The native elimination-tree LDL^T (QDLDL_etree/factor/solve
    equivalent, qdldl/sqp.cuh:22-49) on a random sparse quasi-definite
    matrix, vs dense numpy."""
    from mpcgpu.native import SparseLDL

    rng = np.random.default_rng(2)
    dim = 40
    A = np.diag(rng.uniform(1.0, 2.0, dim))
    # random symmetric sparse off-diagonals
    for _ in range(120):
        i, j = rng.integers(0, dim, 2)
        if i == j:
            continue
        v = rng.standard_normal() * 0.1
        A[i, j] += v
        A[j, i] += v
    # upper CSC of A
    cols, rows, vals = [0], [], []
    for j in range(dim):
        for i in range(j + 1):
            if A[i, j] != 0.0:
                rows.append(i)
                vals.append(A[i, j])
        cols.append(len(rows))
    fac = SparseLDL(np.asarray(cols, np.int64), np.asarray(rows, np.int64))
    npos = fac.factor(np.asarray(vals))
    assert npos == sum(np.linalg.eigvalsh(A) > 0)
    b = rng.standard_normal(dim)
    x = fac.solve(b)
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-9, atol=1e-9)


def test_csr_feeds_real_qdldl_equivalent():
    """C18 made literal: the actual elimination-tree sparse LDL^T consumes
    the CSR layer's packing of a REAL Schur system and cross-checks
    btd_ldl_solve, PCG, and scipy splu."""
    import jax
    import jax.numpy as jnp

    from mpcgpu.config import CostConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.native import qdldl_solve_schur
    from mpcgpu.ops.ldl import btd_ldl_solve
    from mpcgpu.ops.schur import form_schur_system
    from mpcgpu.solver.kkt import build_kkt
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    N, n = 12, 14
    model = iiwa14(dtype=jnp.float32)
    cost = CostConfig.for_knots(N)
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    xu = xu + 0.02 * jax.random.normal(jax.random.PRNGKey(3), xu.shape, jnp.float32)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float32)
    kkt = build_kkt(model, cost, xu, xu[0, :n], ee, 1 / 64.0)
    schur = form_schur_system(kkt, 1e-3)

    S64 = np.asarray(schur.S, np.float64)
    g = np.asarray(schur.gamma, np.float64)
    x_qdldl = qdldl_solve_schur(S64, g)

    # dense oracle built from the SAME packed values the factorization saw
    # (the upper-CSC packing implicitly symmetrizes theta blocks whose f32
    # asymmetry is ~1e-7 relative)
    from mpcgpu.ops.csr import btd_upper_csc_pattern, btd_upper_csc_values

    dim = N * n
    col_ptr, row_ind = btd_upper_csc_pattern(n, N)
    vals = btd_upper_csc_values(S64)
    U = np.zeros((dim, dim))
    for col in range(dim):
        for p in range(col_ptr[col], col_ptr[col + 1]):
            U[row_ind[p], col] = vals[p]
    dense = U + U.T - np.diag(np.diag(U))
    x_dense = np.linalg.solve(dense, g.ravel())
    scale = np.abs(x_dense).max()
    # backward-stability residual check (conditioning-free)
    res = dense @ x_qdldl.ravel() - g.ravel()
    assert np.linalg.norm(res) < 1e-10 * np.linalg.norm(dense) * np.linalg.norm(x_qdldl)
    np.testing.assert_allclose(x_qdldl.ravel(), x_dense, atol=1e-6 * scale)

    x_ldl = np.asarray(btd_ldl_solve(schur.S, schur.gamma), np.float64).ravel()
    np.testing.assert_allclose(x_ldl, x_dense, atol=2e-4 * scale)
