"""The XLA stages in float32 against float64 oracles, at the widths the
production stages run: KKT assembly, Schur + stair preconditioner, dz
recovery, the line-search merits, and the closed-loop plant.  These are the
plain references the GPU run (chip_smoke.py phase d) is held to."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpcgpu.config import CostConfig
from mpcgpu.models import dynamics, iiwa14
from mpcgpu.ops.ldl import btd_ldl_solve
from mpcgpu.ops.schur import compute_dz, form_schur_system
from mpcgpu.solver.kkt import build_kkt, tracking_cost_grad_hess
from mpcgpu.solver.merit import line_search_merits, merit_function
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

DT = 1.0 / 64.0
# f32 against f64, relative error in the norm of the whole stage output:
# f32 keeps ~7 digits and the 14x14 inverses behind Schur, Pinv and dz cost
# up to three of them (measured 2e-5 for dz at N=64)
STAGE_RTOL = 1e-4


def _problem(N, dtype, pert=0.01, seed=0):
    model = iiwa14(dtype=dtype)
    xu = np.asarray(load_xu_traj("0_0")[:N], np.float64)
    xu = xu + pert * np.random.default_rng(seed).standard_normal(xu.shape)
    ee = np.asarray(load_eepos_traj("0_0")[:N], np.float64)
    xu = jnp.asarray(xu, dtype)
    return model, CostConfig.for_knots(N), xu, xu[0, :14], jnp.asarray(ee, dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("N,integrator_type", [(16, 0), (16, 1), (144, 0)])
def test_kkt_f32_matches_f64(N, integrator_type):
    ref = build_kkt(*_problem(N, jnp.float64), DT, integrator_type)
    got = build_kkt(*_problem(N, jnp.float32), DT, integrator_type)
    for f in ("Q", "q", "R", "r", "A", "B", "c"):
        e = _rel(getattr(got, f), getattr(ref, f))
        assert e < STAGE_RTOL, (f, e)


def test_terminal_eval_quirk():
    """terminal_at_last_state=False evaluates knot N-1's cost at x_{N-2}
    (the reference's behaviour, iiwa_eepos_plant.cuh:399)."""
    model, cost, xu, xs, ee = _problem(16, jnp.float64)
    quirk = dataclasses.replace(cost, terminal_at_last_state=False)
    got = build_kkt(model, quirk, xu, xs, ee, DT)
    Q, q, _, _ = tracking_cost_grad_hess(model, quirk, xu[-2, :14],
                                         xu[-1, 14:], ee[-1])
    np.testing.assert_allclose(np.asarray(got.q[-1]), np.asarray(q),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(got.Q[-1]), np.asarray(Q),
                               rtol=1e-12, atol=1e-15)
    plain = build_kkt(model, cost, xu, xs, ee, DT)
    np.testing.assert_array_equal(np.asarray(got.q[:-1]),
                                  np.asarray(plain.q[:-1]))


def _stages(dtype, N, lam=None):
    model, cost, xu, xs, ee = _problem(N, dtype)
    kkt = build_kkt(model, cost, xu, xs, ee, DT)
    s = form_schur_system(kkt, 1e-3)
    lam = btd_ldl_solve(s.S, s.gamma) if lam is None else jnp.asarray(lam, dtype)
    return dict(S=s.S, Pinv=s.Pinv, gamma=s.gamma,
                dz=compute_dz(kkt, s, lam)), lam


@pytest.mark.parametrize("stage", ["S", "Pinv", "gamma", "dz"])
@pytest.mark.parametrize("N", [16, 64])
def test_schur_and_dz_f32_match_f64(stage, N):
    """dz is recovered from the same (f64 direct) multipliers on both sides,
    so each stage is compared on equal inputs."""
    ref, lam = _stages(jnp.float64, N)
    got, _ = _stages(jnp.float32, N, lam)
    e = _rel(got[stage], ref[stage])
    assert e < STAGE_RTOL, e


@pytest.mark.parametrize("integrator_type", [0, 1])
def test_line_search_merits_match_loop_and_f64(integrator_type):
    """The vmapped 9-candidate merit equals the merit evaluated one alpha at
    a time (the reference's loop), and its f32 value matches f64."""
    N = 32
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        model, cost, xu, xs, ee = _problem(N, dtype)
        dz = jnp.asarray(0.1 * np.random.default_rng(1).standard_normal(
            xu.shape), dtype)
        mu = jnp.asarray(10.0, dtype)
        merits, alphas = line_search_merits(
            model, cost, xu, dz, xs, ee, mu, DT,
            integrator_type=integrator_type, include_zero=True)
        loop = [merit_function(model, cost, xu + a * dz, xs, ee, mu, DT,
                               include_x0=True,
                               integrator_type=integrator_type)
                for a in np.asarray(alphas)]
        np.testing.assert_allclose(np.asarray(merits), np.asarray(loop),
                                   rtol=1e-6 if dtype == jnp.float32 else 1e-12)
        np.testing.assert_array_equal(
            np.asarray(alphas), np.concatenate([[0.0], -0.5 ** np.arange(8)]))
        out[dtype] = merits
    assert _rel(out[jnp.float32], out[jnp.float64]) < STAGE_RTOL


def _plant_oracle(model, xs, plan, t_off, sim_t, timestep, sim_step):
    """Explicit float64 loop of simple_simulate (integrator.cuh:295-325):
    Euler substeps of sim_step, the last one partial, each using the plan
    knot whose window contains the elapsed time."""
    nq = model.nq
    plan = np.asarray(plan, np.float64)
    x = np.asarray(xs, np.float64)
    t, left = t_off, sim_t
    while left > 1e-15:
        dt = min(sim_step, left)
        k = min(int(t / timestep), plan.shape[0] - 1)
        u = plan[k, 2 * nq:]
        qdd = np.asarray(dynamics.forward_dynamics_aba(
            model, jnp.asarray(x[:nq]), jnp.asarray(x[nq:]), jnp.asarray(u)))
        x = np.concatenate([x[:nq] + dt * x[nq:], x[nq:] + dt * qdd])
        t += sim_step
        left -= dt
    return x


@pytest.mark.parametrize("t_off,sim_t", [(0.0, 5e-4), (0.002, 2e-3),
                                         (0.013, 1.3e-3)])
def test_plant_matches_f64_substep_oracle(t_off, sim_t):
    """The closed loop's plant (a lax.scan with a clip schedule, in f32)
    against the explicit f64 substep loop, including partial windows."""
    from mpcgpu.sim.mpc import _simulate_plant

    plan = np.asarray(load_xu_traj("0_0")[:32], np.float64)
    xs = plan[0, :14] + 0.01 * np.random.default_rng(0).standard_normal(14)
    with jax.enable_x64(True):
        want = _plant_oracle(iiwa14(dtype=jnp.float64), xs, plan, t_off,
                             sim_t, DT, 2e-4)
    got = _simulate_plant(iiwa14(dtype=jnp.float32),
                          jnp.asarray(xs, jnp.float32),
                          jnp.asarray(plan, jnp.float32), t_off, sim_t, DT,
                          10, 2e-4)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_plant_windows_compose():
    """Integrating one 2 ms window equals two 1 ms windows to rounding (the
    clip schedule integrates exactly the requested time)."""
    from mpcgpu.sim.mpc import _simulate_plant

    model = iiwa14()
    plan = jnp.asarray(load_xu_traj("0_0")[:32], jnp.float32)
    xs = plan[0, :14]
    a1 = _simulate_plant(model, xs, plan, 0.0, 1e-3, DT, 10, 2e-4)
    a2 = _simulate_plant(model, a1, plan, 1e-3, 1e-3, DT, 10, 2e-4)
    a = _simulate_plant(model, xs, plan, 0.0, 2e-3, DT, 10, 2e-4)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a2), rtol=1e-6,
                               atol=1e-7)
