"""Whole-solve Pallas-Triton PCG kernel against the lax.while_loop PCG.

The kernel runs in the Pallas interpreter here (interpret=True); its
lowering to Triton for the GPU is checked by exporting it for CUDA, which
needs no GPU.  The compiled kernel is compared on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpcgpu.ops.btd import btd_matvec, btd_to_dense
from mpcgpu.ops.pcg import pcg_solve
from mpcgpu.ops.pcg_pallas import pad_btd, pcg_solve_pallas


def _make_system(N=64, n=14, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    S = np.zeros((N, 3, n, n), dtype)
    for k in range(N):
        A = rng.standard_normal((n, n)).astype(dtype) * 0.3
        S[k, 1] = A @ A.T + 3 * np.eye(n, dtype=dtype)
        if k > 0:
            S[k, 0] = rng.standard_normal((n, n)).astype(dtype) * 0.1
    for k in range(N - 1):
        S[k, 2] = S[k + 1, 0].T
    D = np.stack([np.linalg.inv(S[k, 1]) for k in range(N)])
    P = np.zeros_like(S)
    for k in range(N):
        P[k, 1] = D[k]
        if k > 0:
            P[k, 0] = -D[k] @ S[k, 0] @ D[k - 1]
        if k < N - 1:
            P[k, 2] = -D[k] @ S[k, 2] @ D[k + 1]
    gamma = rng.standard_normal((N, n)).astype(dtype)
    return map(jnp.asarray, (S, P, gamma, np.zeros((N, n), dtype)))


_SCHUR = {}


def _iiwa_schur(N):
    """IIWA Schur system (f64) at N knots and a warm start: the solution of
    the neighbouring control step's system, shifted one knot."""
    if N not in _SCHUR:
        from mpcgpu.config import CostConfig
        from mpcgpu.models import iiwa14
        from mpcgpu.ops.ldl import btd_ldl_solve
        from mpcgpu.ops.schur import form_schur_system
        from mpcgpu.solver.kkt import build_kkt
        from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

        model = iiwa14(dtype=jnp.float64)
        out = []
        for off in (0, 1):
            xu = jnp.asarray(load_xu_traj("0_0")[off:off + N], jnp.float64)
            ee = jnp.asarray(load_eepos_traj("0_0")[off:off + N], jnp.float64)
            kkt = build_kkt(model, CostConfig.for_knots(N), xu, xu[0, :14],
                            ee, 1 / 64.0)
            s = form_schur_system(kkt, 1e-3)
            out.append((s, btd_ldl_solve(s.S, s.gamma)))
        (_, lam_prev), (s, _) = out
        warm = jnp.concatenate([lam_prev[1:], lam_prev[-1:]], axis=0)
        _SCHUR[N] = (s.S, s.Pinv, s.gamma, warm)
    return _SCHUR[N]


def test_pallas_pcg_matches_while_loop():
    S, P, gamma, lam0 = _make_system()
    ref = pcg_solve(S, P, gamma, lam0, max_iter=200, exit_tol=1e-10)
    got = pcg_solve_pallas(S, P, gamma, lam0, max_iter=200, exit_tol=1e-10, interpret=True)
    assert bool(got.converged)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam), atol=1e-5)


def test_pallas_pcg_solves_system():
    S, P, gamma, lam0 = _make_system(N=32, n=14, seed=3)
    got = pcg_solve_pallas(S, P, gamma, lam0, max_iter=300, exit_tol=1e-12, interpret=True)
    dense = np.linalg.solve(np.asarray(btd_to_dense(S), np.float64),
                            np.asarray(gamma, np.float64).ravel())
    np.testing.assert_allclose(
        np.asarray(got.lam).ravel(), dense, atol=1e-4
    )


def test_rnorm_exit_criterion():
    """'rnorm' exits on ||r||_2 < tol (reference/GBD-PCG semantics, SURVEY C17)
    and agrees between the while_loop and pallas implementations."""
    S, P, gamma, lam0 = _make_system(N=32, n=14, seed=5)
    tol = 1e-4
    ref = pcg_solve(S, P, gamma, lam0, max_iter=300, exit_tol=tol,
                    exit_criterion="rnorm")
    got = pcg_solve_pallas(S, P, gamma, lam0, max_iter=300, exit_tol=tol,
                           exit_criterion="rnorm", interpret=True)
    assert bool(ref.converged) and bool(got.converged)
    assert int(got.iters) == int(ref.iters)
    # the residual at exit really satisfies the 2-norm test
    r = np.asarray(gamma, np.float64).ravel() - (
        np.asarray(btd_to_dense(S), np.float64)
        @ np.asarray(ref.lam, np.float64).ravel())
    assert np.linalg.norm(r) < tol
    # eta-criterion run at the same tol exits at a DIFFERENT iterate in
    # general (different metric) — just check both solve the system
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                               atol=1e-5)


def test_rnorm_exit_criterion_sharded():
    """Knot-sharded PCG honors the rnorm criterion (psum'd r.r)."""
    from jax.sharding import Mesh
    from mpcgpu.parallel.pcg_sharded import pcg_solve_sharded

    S, P, gamma, lam0 = _make_system(N=32, n=14, seed=7)
    devs = np.array(jax.devices()[:4]).reshape(4)
    mesh = Mesh(devs, ("knot",))
    tol = 1e-4
    ref = pcg_solve(S, P, gamma, lam0, max_iter=300, exit_tol=tol,
                    exit_criterion="rnorm")
    got = pcg_solve_sharded(S, P, gamma, lam0, mesh, max_iter=300,
                            exit_tol=tol, exit_criterion="rnorm")
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                               atol=1e-5)


def _assert_same_solve(got, ref, max_rel):
    assert bool(got.converged) == bool(ref.converged)
    assert abs(int(got.iters) - int(ref.iters)) <= 1
    err = float(jnp.linalg.norm(got.lam - ref.lam) / jnp.linalg.norm(ref.lam))
    assert err < max_rel, err


# The IIWA Schur systems (condition ~1e6 and more) amplify reduction-order
# differences over hundreds of CG iterations even in f64: converged solves
# agree to ~3e-5 relative (measured), not to rounding.  Exit flags and
# iteration counts are exact to one iteration.
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("criterion,tol", [("eta", 1e-5), ("eta", 1e-7),
                                           ("rnorm", 1e-3), ("rnorm", 1e-5)])
def test_kernel_exit_semantics_on_iiwa_schur(criterion, tol, start):
    """Both exit criteria, cold and warm starts, on the N=16 system, where
    every combination converges (in 9 to 123 iterations)."""
    S, P, g, warm = _iiwa_schur(16)
    lam0 = warm if start == "warm" else jnp.zeros_like(g)
    kw = dict(max_iter=400, exit_tol=tol, exit_criterion=criterion)
    ref = pcg_solve(S, P, g, lam0, **kw)
    assert bool(ref.converged)
    _assert_same_solve(pcg_solve_pallas(S, P, g, lam0, interpret=True, **kw),
                       ref, 1e-3)


@pytest.mark.parametrize("N", [32, 64, 37])
def test_kernel_matches_pcg_solve_on_iiwa_schur(N):
    """Warm-started solves at the operating tolerance (eta 1e-5), which
    converge in 100-200 iterations; N=37 exercises the knot padding."""
    S, P, g, warm = _iiwa_schur(N)
    kw = dict(max_iter=400, exit_tol=1e-5)
    ref = pcg_solve(S, P, g, warm, **kw)
    assert bool(ref.converged)
    _assert_same_solve(pcg_solve_pallas(S, P, g, warm, interpret=True, **kw),
                       ref, 1e-3)


@pytest.mark.parametrize("N", [32, 64])
def test_kernel_cap_bound_on_iiwa_schur(N):
    """Cold starts at N >= 32 stall far from eta 1e-5: both solvers stop at
    exactly the cap, unconverged, with finite iterates."""
    S, P, g, _ = _iiwa_schur(N)
    lam0 = jnp.zeros_like(g)
    ref = pcg_solve(S, P, g, lam0, max_iter=60, exit_tol=1e-5)
    got = pcg_solve_pallas(S, P, g, lam0, max_iter=60, exit_tol=1e-5,
                           interpret=True)
    assert int(ref.iters) == int(got.iters) == 60
    assert not bool(ref.converged) and not bool(got.converged)
    assert bool(jnp.isfinite(got.lam).all())


@pytest.mark.parametrize("criterion", ["eta", "rnorm"])
def test_kernel_vmap_exact_per_instance_iterations(criterion):
    """Under vmap every instance exits on its own count, exactly the count
    pcg_solve gives that instance alone."""
    S, P, g, lam0 = _make_system(N=32, seed=11)
    gs = jnp.stack([g, 1e-3 * g, 0.3 * g, 1e-5 * g])
    tol = 1e-6 if criterion == "eta" else 1e-5
    one = [pcg_solve(S, P, gg, lam0, max_iter=100, exit_tol=tol,
                     exit_criterion=criterion) for gg in gs]
    got = jax.vmap(lambda gg: pcg_solve_pallas(
        S, P, gg, lam0, max_iter=100, exit_tol=tol, exit_criterion=criterion,
        interpret=True))(gs)
    want = np.array([int(r.iters) for r in one])
    assert len(set(want)) > 1, want          # the instances really differ
    np.testing.assert_array_equal(np.asarray(got.iters), want)
    for i, r in enumerate(one):
        np.testing.assert_allclose(np.asarray(got.lam[i]), np.asarray(r.lam),
                                   rtol=1e-5, atol=1e-7)


def test_kernel_iteration_cap_exact():
    """A solve that cannot reach tol stops at exactly max_iter, unconverged."""
    S, P, g, lam0 = _make_system(N=16, seed=2)
    got = pcg_solve_pallas(S, P, g, lam0, max_iter=3, exit_tol=0.0,
                           interpret=True)
    ref = pcg_solve(S, P, g, lam0, max_iter=3, exit_tol=0.0)
    assert int(got.iters) == int(ref.iters) == 3
    assert not bool(got.converged)
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N", [24, 64, 100, 200])
def test_kernel_chunking_matches(N):
    """The in-kernel chunk loop (_CHUNK knots per step) gives the same solve
    whether one chunk covers the horizon (N <= 64) or several do (2 and 4
    chunks at N = 100 and 200)."""
    S, P, g, lam0 = _make_system(N=N, seed=4)
    ref = pcg_solve(S, P, g, lam0, max_iter=100, exit_tol=1e-10)
    got = pcg_solve_pallas(S, P, g, lam0, max_iter=100, exit_tol=1e-10,
                           interpret=True)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,n,chunk", [(37, 14, 16), (16, 14, 64),
                                       (8, 5, 4), (20, 16, 8)])
def test_pad_btd_keeps_the_system(N, n, chunk):
    """Padding n -> power of two and N -> multiple of the chunk: identity
    diagonal, zero coupling and zero rhs, so the padded matvec restricted to
    the real entries is the original one and padded entries stay zero."""
    S, P, g, _ = _make_system(N=N, n=n, seed=N)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((N, n)),
                    jnp.float32)
    S_p, P_p, g_p, x_p, c = pad_btd(S, P, g, x, chunk)
    Np, nb = g_p.shape
    assert nb & (nb - 1) == 0 and nb >= n
    assert Np % c == 0 and Np >= N and c & (c - 1) == 0
    for M, M_p in ((S, S_p), (P, P_p)):
        y = btd_matvec(M_p, x_p)
        np.testing.assert_allclose(np.asarray(y[:N, :n]),
                                   np.asarray(btd_matvec(M, x)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(y[N:]), 0.0)
        np.testing.assert_array_equal(np.asarray(y[:, n:]), 0.0)
        diag = np.asarray(M_p[:, 1])
        np.testing.assert_array_equal(diag[N:], np.broadcast_to(
            np.eye(nb), (Np - N, nb, nb)))
        np.testing.assert_array_equal(diag[:N, n:, n:], np.broadcast_to(
            np.eye(nb - n), (N, nb - n, nb - n)))
    np.testing.assert_array_equal(np.asarray(g_p[N:]), 0.0)
    np.testing.assert_array_equal(np.asarray(g_p[:, n:]), 0.0)


def test_kernel_rejects_wide_band_operands():
    S5 = jnp.zeros((16, 5, 14, 14), jnp.float32)
    g = jnp.zeros((16, 14), jnp.float32)
    with pytest.raises(ValueError, match="3-band"):
        pcg_solve_pallas(S5, S5, g, g, interpret=True)


@pytest.mark.parametrize("N,B", [(32, None), (64, None), (512, None),
                                 (32, 256)])
def test_kernel_lowers_to_triton(N, B):
    """The kernel lowers to one Triton custom call, with one program per
    instance under vmap.  Lowering for CUDA needs no GPU; what Triton's
    compiler then makes of it is checked on the card (chip_smoke.py)."""
    f = lambda S, P, g, l: pcg_solve_pallas(S, P, g, l, max_iter=167,
                                            exit_tol=1e-5)
    if B:
        f = jax.vmap(f)
    lead = (B,) if B else ()
    shp = lambda *s: jax.ShapeDtypeStruct(lead + s, jnp.float32)
    exp = jax.export.export(
        jax.jit(f), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(shp(N, 3, 14, 14), shp(N, 3, 14, 14), shp(N, 14), shp(N, 14))
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert f"grid_x = {B or 1} : i32" in text
    assert 'name = "pcg_solve_pallas"' in text
