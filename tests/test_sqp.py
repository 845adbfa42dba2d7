"""SQP solver tests: merit decrease, PCG-vs-direct parity (the reference's own
cross-validation strategy, SURVEY.md section 4), and rho schedule behavior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu.models import iiwa14
from mpcgpu.solver.merit import merit_function
from mpcgpu.solver.sqp import sqp_solve
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

N = 16
NX = 14
DT = 1.0 / 64.0


@pytest.fixture(scope="module")
def problem():
    model = iiwa14(dtype=jnp.float32)
    cost = CostConfig()
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    ee_goal = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float32)
    # perturb the warm start so the solver has work to do
    key = jax.random.PRNGKey(0)
    xu = xu + 0.02 * jax.random.normal(key, xu.shape, jnp.float32)
    xs = xu[0, :NX]
    lam = jnp.zeros((N, NX), jnp.float32)
    return model, cost, xu, lam, xs, ee_goal


def _merit(model, cost, xu, xs, ee_goal):
    return float(
        merit_function(model, cost, xu, xs, ee_goal, 10.0, DT, include_x0=False)
    )


def test_sqp_decreases_merit_pcg(problem):
    model, cost, xu, lam, xs, ee_goal = problem
    m0 = _merit(model, cost, xu, xs, ee_goal)
    res = sqp_solve(
        model, cost, SQPConfig(max_iter=8), PCGConfig(max_iter=200, exit_tol=1e-8),
        xu, lam, xs, ee_goal, rho=1e-3, dt=DT, linsys="pcg",
    )
    m1 = _merit(model, cost, res.xu, xs, ee_goal)
    assert m1 < m0 * 0.5, (m0, m1)
    assert int(res.sqp_iters) >= 1
    assert np.all(np.asarray(res.pcg_iters[: int(res.sqp_iters)]) >= 0)


def test_pcg_and_ldl_paths_agree(problem):
    """PCG and direct LDL^T share every stage except the linear solve — the
    reference's numerical oracle (mpcsim.cuh:21-25). With a tight PCG tol the
    resulting trajectories must match closely."""
    model, cost, xu, lam, xs, ee_goal = problem
    kw = dict(xs=xs, ee_goal=ee_goal, rho=1e-3, dt=DT)
    res_pcg = sqp_solve(
        model, cost, SQPConfig(max_iter=4), PCGConfig(max_iter=1000, exit_tol=1e-12),
        xu, lam, linsys="pcg", **kw,
    )
    res_ldl = sqp_solve(
        model, cost, SQPConfig(max_iter=4), PCGConfig(),
        xu, lam, linsys="ldl", **kw,
    )
    # float32 PCG converges to ~1e-6 on lambda; over 4 SQP iterations with a
    # discrete line search the iterates stay within a few 1e-3
    np.testing.assert_allclose(
        np.asarray(res_pcg.xu), np.asarray(res_ldl.xu), rtol=0, atol=5e-3
    )
    assert int(res_pcg.sqp_iters) == int(res_ldl.sqp_iters)


def test_sqp_near_feasible_start_accepts_small_steps(problem):
    """Starting ON the recorded (near-feasible, near-optimal) trajectory the
    solver should not blow the iterate up."""
    model, cost, *_ = problem
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    ee_goal = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float32)
    xs = xu[0, :NX]
    lam = jnp.zeros((N, NX), jnp.float32)
    m0 = _merit(model, cost, xu, xs, ee_goal)
    res = sqp_solve(
        model, cost, SQPConfig(max_iter=5), PCGConfig(max_iter=200, exit_tol=1e-8),
        xu, lam, xs, ee_goal, rho=1e-3, dt=DT, linsys="pcg",
    )
    m1 = _merit(model, cost, res.xu, xs, ee_goal)
    assert m1 <= m0 + 1e-6


def test_double_precision_solve():
    """USE_DOUBLES parity (settings.cuh:41-49): the stack is dtype-generic —
    build the model and iterates in f64 and the whole solve runs in f64
    (and converges tighter than f32 allows)."""
    import jax

    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    N = 16
    model = iiwa14(dtype=jnp.float64)
    cost = CostConfig.for_knots(N)
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float64)
    xu = xu + 0.01 * jax.random.normal(jax.random.PRNGKey(0), xu.shape,
                                       jnp.float64)
    xs = xu[0, :14]
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float64)
    lam = jnp.zeros((N, 14), jnp.float64)
    res = sqp_solve(model, cost, SQPConfig(max_iter=3),
                    PCGConfig(max_iter=200, exit_tol=1e-18),
                    xu, lam, xs, ee, 1e-3, 1 / 64.0, linsys="pcg")
    assert res.xu.dtype == jnp.float64
    assert bool(jnp.isfinite(res.xu).all())
    # f64 reaches an eta far below anything f32 can represent usefully
    res_tight = sqp_solve(model, cost, SQPConfig(max_iter=1),
                          PCGConfig(max_iter=500, exit_tol=1e-16),
                          xu, lam, xs, ee, 1e-3, 1 / 64.0, linsys="pcg")
    assert bool(res_tight.pcg_converged[0])


def test_eisenstat_walker_forcing():
    """PCGConfig.forcing='ew' (per-SQP-iteration forcing tolerance) reaches
    the same solution quality as fixed-tolerance while spending fewer total
    PCG iterations — the rnorm-cost lever of the round-3 accuracy-parity
    work."""
    import jax

    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    N = 16
    model = iiwa14(dtype=jnp.float32)
    cost = CostConfig.for_knots(N)
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    xu = xu + 0.05 * jax.random.normal(jax.random.PRNGKey(7), xu.shape, jnp.float32)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float32)
    xs = xu[0, :14]
    lam = jnp.zeros((N, 14), jnp.float32)
    # NOTE: the measured saving is small (~1-3% of total PCG iterations at
    # N=16): the stair-preconditioned residual drops steeply only near
    # convergence, so a looser early tolerance buys few iterations — see
    # PARITY.md's forcing study.  At >= 10 SQP iterations EW is
    # simultaneously cheaper AND equal-or-better merit.
    scfg = SQPConfig(max_iter=10)

    fixed = sqp_solve(model, cost, scfg,
                      PCGConfig(max_iter=200, exit_tol=1e-6,
                                exit_criterion="rnorm"),
                      xu, lam, xs, ee, 1e-3, DT, linsys="pcg")
    ew = sqp_solve(model, cost, scfg,
                   PCGConfig(max_iter=200, exit_tol=1e-6,
                             exit_criterion="rnorm", forcing="ew"),
                   xu, lam, xs, ee, 1e-3, DT, linsys="pcg")

    it_fixed = int(np.sum(np.asarray(fixed.pcg_iters)[np.asarray(fixed.pcg_iters) >= 0]))
    it_ew = int(np.sum(np.asarray(ew.pcg_iters)[np.asarray(ew.pcg_iters) >= 0]))
    assert it_ew < it_fixed, (it_ew, it_fixed)
    # same solution quality: final merit within 1% of the fixed-tol solve
    m_fixed = float(fixed.merit)
    m_ew = float(ew.merit)
    assert m_ew <= m_fixed * 1.01 + 1e-6, (m_ew, m_fixed)


def test_stair2_with_pcg_pallas_falls_back_to_xla_pcg(problem, on_gpu):
    """preconditioner='stair2' emits a 5-band Pinv that the PCG kernel's
    3-band matvec cannot take: on a GPU the default solver for it is the
    band-general XLA PCG (exactly linsys='pcg'), an explicit kernel request
    raises, and the kernel itself rejects wide-band operands."""
    import dataclasses

    from mpcgpu.ops.pcg_pallas import pcg_solve_pallas

    model, cost, xu, lam, xs, ee = problem
    cfg2 = dataclasses.replace(PCGConfig(max_iter=120, exit_tol=1e-8),
                               preconditioner="stair2")
    scfg = SQPConfig(max_iter=2)
    ref = sqp_solve(model, cost, scfg, cfg2, xu, lam, xs, ee, 1e-3, DT,
                    linsys="pcg")
    got = sqp_solve(model, cost, scfg, cfg2, xu, lam, xs, ee, 1e-3, DT)
    np.testing.assert_array_equal(np.asarray(got.xu), np.asarray(ref.xu))
    with pytest.raises(ValueError, match="3-band"):
        sqp_solve(model, cost, scfg, cfg2, xu, lam, xs, ee, 1e-3, DT,
                  linsys="pcg_pallas")
    S5 = jnp.zeros((N, 5, NX, NX), xu.dtype)
    g = jnp.zeros((N, NX), xu.dtype)
    with pytest.raises(ValueError, match="3-band"):
        pcg_solve_pallas(S5, S5, g, g, interpret=True)


@pytest.mark.parametrize("linsys", ["auto", "pcg_pallas"])
def test_sqp_with_pcg_kernel_matches_xla_pcg(on_gpu, linsys):
    """The SQP loop with the PCG kernel (the GPU default at this horizon;
    interpreted here) takes the same steps as with the XLA PCG.  In f64: in
    f32 these Schur systems amplify reduction-order differences in
    unconverged PCG solves to ~1e-2 on xu after three SQP iterations."""
    model = iiwa14(dtype=jnp.float64)
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float64)
    xu = xu + 0.02 * jax.random.normal(jax.random.PRNGKey(0), xu.shape,
                                       jnp.float64)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float64)
    lam = jnp.zeros((N, NX), jnp.float64)
    cost = CostConfig()
    scfg, pcfg = SQPConfig(max_iter=3), PCGConfig(max_iter=100, exit_tol=1e-6)
    ref = sqp_solve(model, cost, scfg, pcfg, xu, lam, xu[0, :NX], ee, 1e-3,
                    DT, linsys="pcg")
    got = sqp_solve(model, cost, scfg, pcfg, xu, lam, xu[0, :NX], ee, 1e-3,
                    DT, linsys=linsys)
    assert int(got.sqp_iters) == int(ref.sqp_iters)
    np.testing.assert_array_equal(np.asarray(got.ls_alpha_idx),
                                  np.asarray(ref.ls_alpha_idx))
    assert np.max(np.abs(np.asarray(got.pcg_iters)
                         - np.asarray(ref.pcg_iters))) <= 1
    np.testing.assert_allclose(np.asarray(got.xu), np.asarray(ref.xu),
                               atol=1e-5)


def test_qdldl_host_matches_ondevice_ldl_closed_loop(problem):
    """linsys='qdldl_host' — the reference's LITERAL per-iteration host
    round-trip (D2H Schur values -> cached-symbolic QDLDL factor/solve ->
    H2D, qdldl/sqp.cuh:268-273) via jax.pure_callback — tracks the same
    closed-loop trajectory as the on-device block LDL^T."""
    model, cost, xu0, lam0, xs0, ee = problem
    scfg = SQPConfig(max_iter=2)
    pcfg = PCGConfig(max_iter=100, exit_tol=1e-8)

    def track(linsys, steps=5):
        xu, lam, xs, rho = xu0, lam0, xs0, jnp.asarray(1e-3, jnp.float32)
        fn = jax.jit(lambda *a: sqp_solve(model, cost, scfg, pcfg, *a, DT,
                                          linsys=linsys))
        path = []
        for _ in range(steps):
            res = fn(xu, lam, xs, ee, rho)
            xu = jnp.roll(res.xu, -1, axis=0).at[-1].set(res.xu[-1])
            lam = jnp.roll(res.lam, -1, axis=0).at[-1].set(res.lam[-1])
            xs = res.xu[1, :NX]
            rho = res.rho
            path.append(np.asarray(xs))
        return np.stack(path)

    ref = track("ldl")
    got = track("qdldl_host")
    np.testing.assert_allclose(got, ref, atol=5e-3)
