"""ANGLE_WRAP option (integrator.cuh:12-19,42-43,125-128; default-off
template param of kkt.cuh:22 and merit.cuh:99)."""

import jax
import jax.numpy as jnp
import numpy as np

from mpcgpu.config import CostConfig
from mpcgpu.models import iiwa14
from mpcgpu.solver.kkt import (
    _WRAP_PI, angle_wrap, build_kkt, integrator_step)
from mpcgpu.solver.merit import line_search_merits


def test_angle_wrap_formula():
    """Reference angleWrap is a reflection at +-pi (truncated pi literal)."""
    x = np.array([0.0, 1.0, -1.0, 3.2, -3.2, 3.14159, -3.14159, 6.0])
    got = np.asarray(angle_wrap(jnp.asarray(x)))
    ref = x.copy()
    for i, v in enumerate(ref):
        if v > _WRAP_PI:
            v = -(v - _WRAP_PI)
        if v < -_WRAP_PI:
            v = -(v + _WRAP_PI)
        ref[i] = v
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_integrator_step_wraps_positions_only():
    model = iiwa14()
    rng = np.random.default_rng(0)
    # states near the wrap boundary so the option actually fires
    x = jnp.asarray(np.concatenate([3.1 + 0.2 * rng.standard_normal(7),
                                    rng.standard_normal(7)]))
    u = jnp.asarray(rng.standard_normal(7))
    plain = integrator_step(model, x, u, 0.1)
    wrapped = integrator_step(model, x, u, 0.1, wrap=True)
    np.testing.assert_allclose(np.asarray(wrapped[:7]),
                               np.asarray(angle_wrap(plain[:7])), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(wrapped[7:]), np.asarray(plain[7:]),
                               rtol=1e-12)
    assert not np.allclose(np.asarray(wrapped[:7]), np.asarray(plain[:7]))


def _problem(N=16, seed=1, near_pi=True):
    model = iiwa14()
    cost = CostConfig.for_knots(N)
    rng = np.random.default_rng(seed)
    q = (3.05 if near_pi else 0.0) + 0.3 * rng.standard_normal((N, 7))
    xu = np.concatenate([q, 0.5 * rng.standard_normal((N, 14))], axis=1)
    xu = jnp.asarray(xu, jnp.float32)
    xs = xu[0, :14]
    ee = jnp.asarray(rng.standard_normal((N, 6)), jnp.float32)
    return model, cost, xu, xs, ee


def test_build_kkt_wrap_changes_defect_only():
    model, cost, xu, xs, ee = _problem()
    dt = 1.0 / 64
    plain = build_kkt(model, cost, xu, xs, ee, dt)
    wrapped = build_kkt(model, cost, xu, xs, ee, dt, angle_wrap=True)
    # Jacobians and cost blocks identical; defect rows differ where a next-q
    # crossed pi
    np.testing.assert_allclose(np.asarray(plain.A), np.asarray(wrapped.A))
    np.testing.assert_allclose(np.asarray(plain.Q), np.asarray(wrapped.Q))
    assert not np.allclose(np.asarray(plain.c), np.asarray(wrapped.c))
    # wrapped defect = x_{k+1} - wrap(f(x_k)) on the q rows
    x = np.asarray(xu[:, :14])
    f_q = x[1:, :7] - np.asarray(plain.c)[1:, :7]      # unwrapped f(x_k)_q
    want = x[1:, :7] - np.asarray(angle_wrap(jnp.asarray(f_q)))
    np.testing.assert_allclose(np.asarray(wrapped.c)[1:, :7], want,
                               rtol=1e-5, atol=1e-6)


def test_kkt_wrap_f32_matches_f64():
    """The wrapped defect in f32 against the same assembly in f64."""
    dt = 1.0 / 64
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        model, cost, xu, xs, ee = _problem(seed=2)
        model = iiwa14(dtype=dtype)
        out[dtype] = build_kkt(model, cost, xu.astype(dtype), xs.astype(dtype),
                               ee.astype(dtype), dt, angle_wrap=True)
    np.testing.assert_allclose(np.asarray(out[jnp.float32].c),
                               np.asarray(out[jnp.float64].c),
                               rtol=1e-4, atol=1e-5)


def test_merit_wrap_matches_per_alpha_oracle():
    """line_search_merits(angle_wrap=True) equals the merit of each
    candidate with the wrapped integrator, one alpha at a time, and the
    wrap really changes the merits near +-pi."""
    from mpcgpu.solver.merit import merit_function

    model, cost, xu, xs, ee = _problem(seed=3)
    dt = 1.0 / 64
    rng = np.random.default_rng(4)
    dz = jnp.asarray(0.1 * rng.standard_normal(xu.shape), jnp.float32)
    mu = jnp.float32(10.0)
    got, alphas = line_search_merits(model, cost, xu, dz, xs, ee, mu, dt,
                                     include_zero=True, angle_wrap=True)
    want = [merit_function(model, cost, xu + a * dz, xs, ee, mu, dt,
                           include_x0=True, angle_wrap=True)
            for a in np.asarray(alphas)]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    plain, _ = line_search_merits(model, cost, xu, dz, xs, ee, mu, dt,
                                  include_zero=True)
    assert not np.allclose(np.asarray(got), np.asarray(plain))
