"""Closed-loop MPC integration test (SURVEY.md section 4 point 4): track a
short window of the recorded IIWA trace and verify the tracking error stays
small — the reference's own correctness criterion (mpcsim.cuh:300-309)."""

import jax.numpy as jnp
import numpy as np

from mpcgpu.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu.models import iiwa14
from mpcgpu.sim.mpc import simulate_mpc
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj


def test_closed_loop_tracking_short():
    model = iiwa14(dtype=jnp.float32)
    xu_traj = load_xu_traj("0_0")[:80]
    ee_traj = load_eepos_traj("0_0")[:80]
    stats = simulate_mpc(
        model,
        xu_traj,
        ee_traj,
        knot_points=16,
        timestep=1.0 / 64.0,
        sqp_cfg=SQPConfig(max_iter=5),
        pcg_cfg=PCGConfig(max_iter=100, exit_tol=1e-6),
        sim_cfg=SimConfig(max_control_updates=40),
        linsys="pcg",
    )
    s = stats.summary()
    assert s["control_updates"] == 40
    assert len(stats.tracking_errors) >= 3
    # L1 xyz error in meters; the arm should stay close to the goal trace
    assert s["avg_tracking_error"] < 0.12, s
    assert np.isfinite(s["avg_pcg_iters"])


def test_closed_loop_ldl_matches_pcg_roughly():
    model = iiwa14(dtype=jnp.float32)
    xu_traj = load_xu_traj("0_0")[:60]
    ee_traj = load_eepos_traj("0_0")[:60]
    kw = dict(
        knot_points=16,
        timestep=1.0 / 64.0,
        sqp_cfg=SQPConfig(max_iter=3),
        sim_cfg=SimConfig(max_control_updates=25),
    )
    s_pcg = simulate_mpc(
        model, xu_traj, ee_traj, pcg_cfg=PCGConfig(max_iter=200, exit_tol=1e-8),
        linsys="pcg", **kw,
    ).summary()
    s_ldl = simulate_mpc(model, xu_traj, ee_traj, linsys="ldl", **kw).summary()
    # solver cross-validation by construction (mpcsim.cuh:21-25)
    assert abs(s_pcg["avg_tracking_error"] - s_ldl["avg_tracking_error"]) < 0.05


def test_ondevice_sim_matches_host_loop():
    """simulate_mpc_ondevice (one jitted scan) == the host control loop."""
    import jax.numpy as jnp
    from mpcgpu.config import SimConfig, SQPConfig
    from mpcgpu.sim.mpc import simulate_mpc, simulate_mpc_ondevice
    from mpcgpu.models import iiwa14
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    model = iiwa14()
    xu_traj = load_xu_traj("0_0")[:80]
    ee_traj = load_eepos_traj("0_0")[:80]
    sim = SimConfig(max_control_updates=40)
    scfg = SQPConfig(max_iter=2, max_time_us=None)
    host = simulate_mpc(model, xu_traj, ee_traj, 16, 1 / 64.0,
                        sqp_cfg=scfg, sim_cfg=sim)
    dev = simulate_mpc_ondevice(model, xu_traj, ee_traj, 16, 1 / 64.0,
                                sqp_cfg=scfg, sim_cfg=sim)
    h = np.asarray(host.tracking_errors)
    d = np.asarray(dev["tracking_errors"])
    assert len(h) == len(d)
    # the two paths are separately compiled programs of the same math; f32
    # rounding differences amplify chaotically through the closed loop, so
    # the comparison is behavioral, not bitwise
    np.testing.assert_allclose(d, h, rtol=0.1, atol=5e-3)
    np.testing.assert_allclose(
        float(dev["final_tracking_error"]), host.final_tracking_error,
        rtol=0.1, atol=5e-3,
    )


def test_batched_ondevice_sim():
    """Batched scenario sim: B=1/perturb=0 equals the single-instance path;
    perturbed instances stay finite and differ."""
    from mpcgpu.config import SimConfig, SQPConfig
    from mpcgpu.sim.mpc import (simulate_mpc_ondevice,
                                    simulate_mpc_ondevice_batched)
    from mpcgpu.models import iiwa14
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    model = iiwa14()
    xu_traj = load_xu_traj("0_0")[:80]
    ee_traj = load_eepos_traj("0_0")[:80]
    sim = SimConfig(max_control_updates=30)
    scfg = SQPConfig(max_iter=1, max_time_us=None)
    one = simulate_mpc_ondevice(model, xu_traj, ee_traj, 16, 1 / 64.0,
                                sqp_cfg=scfg, sim_cfg=sim)
    bat = simulate_mpc_ondevice_batched(model, xu_traj, ee_traj, 16, 1 / 64.0,
                                        batch=2, perturb_scale=0.0,
                                        sqp_cfg=scfg, sim_cfg=sim)
    e1 = np.asarray(one["tracking_errors"])
    eb = np.asarray(bat["tracking_errors"])[:, np.asarray(bat["shift_mask"])]
    np.testing.assert_allclose(eb[0], e1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eb[1], eb[0])

    bat2 = simulate_mpc_ondevice_batched(model, xu_traj, ee_traj, 16, 1 / 64.0,
                                         batch=3, perturb_scale=0.05,
                                         sqp_cfg=scfg, sim_cfg=sim)
    errs = np.asarray(bat2["final_tracking_error"])
    assert np.isfinite(np.asarray(bat2["tracking_errors"])).all()
    assert len(np.unique(np.round(errs, 6))) > 1


def test_ondevice_adaptive_frequency_sim():
    """Adaptive-frequency (non-const-update-freq) mode of the on-device sim:
    solve time modeled as per_iter_us * sqp_iters (mpcsim.cuh:280-288
    equivalent — see _ondevice_scan_adaptive)."""
    from mpcgpu.sim.mpc import simulate_mpc_ondevice

    model = iiwa14(dtype=jnp.float32)
    xu_traj = load_xu_traj("0_0")[:30]
    ee_traj = load_eepos_traj("0_0")[:30]
    out = simulate_mpc_ondevice(
        model, xu_traj, ee_traj, 16, 1 / 64.0,
        sqp_cfg=SQPConfig(max_iter=2),
        pcg_cfg=PCGConfig(max_iter=60, exit_tol=1e-6),
        sim_cfg=SimConfig(const_update_freq=False, max_control_updates=600),
        linsys="pcg",
        per_iter_us=4000.0,   # modeled: ~4 ms per SQP iteration
    )
    assert out["control_updates"] > 10
    errs = np.asarray(out["tracking_errors"])
    assert errs.size >= 3 and np.isfinite(errs).all()
    assert float(errs.mean()) < 0.2
    # modeled sim times are multiples of per_iter_us scaled by sqp_iters
    st = np.asarray(out["sim_times_us"])
    it = np.asarray(out["sqp_iters"])
    np.testing.assert_allclose(st, 4000.0 * it, rtol=1e-5)


def test_time_budget_ondevice():
    """On-device time budget: max_time_us becomes a traced iteration cap;
    solves stay single-dispatch (sqpTimecheck equivalent)."""
    model = iiwa14(dtype=jnp.float32)
    xu_traj = load_xu_traj("0_0")[:40]
    ee_traj = load_eepos_traj("0_0")[:40]
    stats = simulate_mpc(
        model, xu_traj, ee_traj, knot_points=16, timestep=1 / 64.0,
        sqp_cfg=SQPConfig(max_iter=8, max_time_us=10_000_000.0),
        pcg_cfg=PCGConfig(max_iter=60, exit_tol=1e-6),
        sim_cfg=SimConfig(max_control_updates=10, time_budget_mode=True),
        linsys="pcg",
    )
    s = stats.summary()
    assert s["control_updates"] == 10
    # huge budget -> cap = max_iter; solver actually iterates
    assert max(stats.sqp_iters) >= 1
    assert np.isfinite(s["avg_tracking_error"])


def test_ondevice_sim_knot_sharded_matches_single_device():
    """simulate_mpc_ondevice(knot_mesh=...): the WHOLE closed-loop tracking
    experiment with every solve knot-sharded SPMD (round 4: C4 extended
    across chips) must reproduce the single-device on-device sim."""
    import jax.numpy as jnp

    from mpcgpu.config import PCGConfig, SimConfig, SQPConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.parallel.mesh import make_mesh
    from mpcgpu.sim.mpc import simulate_mpc_ondevice
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    model = iiwa14(dtype=jnp.float64)
    xu_traj = load_xu_traj("0_0")[:80]
    ee_traj = load_eepos_traj("0_0")[:80]
    kw = dict(
        knot_points=16, timestep=1 / 64.0, dtype=jnp.float64,
        sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
        pcg_cfg=PCGConfig(max_iter=60, exit_tol=1e-8),
        sim_cfg=SimConfig(max_control_updates=30),
    )
    ref = simulate_mpc_ondevice(model, xu_traj, ee_traj, **kw)
    mesh = make_mesh(n_instance=1, n_knot=4)
    got = simulate_mpc_ondevice(model, xu_traj, ee_traj, knot_mesh=mesh,
                                pcg_method="pipelined", **kw)
    import numpy as np

    np.testing.assert_allclose(np.asarray(got["tracking_errors"]),
                               np.asarray(ref["tracking_errors"]), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(got["final_tracking_error"]),
        np.asarray(ref["final_tracking_error"]), atol=1e-6)
    # same exit behavior per solve (f64: iterate paths agree to rounding)
    assert np.max(np.abs(np.asarray(got["pcg_iters"], np.int64)
                         - np.asarray(ref["pcg_iters"], np.int64))) <= 1


def test_ondevice_batched_sim_instance_sharded_matches_unsharded():
    """simulate_mpc_ondevice_batched(instance_mesh=...): the scenario fleet
    shard_mapped across devices must reproduce the single-device batched
    run per instance (round 4: config-8 capability x device sharding)."""
    import jax.numpy as jnp
    import numpy as np

    from mpcgpu.config import PCGConfig, SimConfig, SQPConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.parallel.mesh import make_mesh
    from mpcgpu.sim.mpc import simulate_mpc_ondevice_batched
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    model = iiwa14(dtype=jnp.float64)
    xu_traj = load_xu_traj("0_0")[:60]
    ee_traj = load_eepos_traj("0_0")[:60]
    kw = dict(
        knot_points=16, timestep=1 / 64.0, batch=8, dtype=jnp.float64,
        sqp_cfg=SQPConfig(max_iter=1, max_time_us=None),
        pcg_cfg=PCGConfig(max_iter=40, exit_tol=1e-8),
        sim_cfg=SimConfig(max_control_updates=20),
    )
    ref = simulate_mpc_ondevice_batched(model, xu_traj, ee_traj, **kw)
    mesh = make_mesh(n_instance=4, n_knot=1)
    got = simulate_mpc_ondevice_batched(model, xu_traj, ee_traj,
                                        instance_mesh=mesh, **kw)
    np.testing.assert_allclose(np.asarray(got["tracking_errors"]),
                               np.asarray(ref["tracking_errors"]), atol=1e-8)
    np.testing.assert_array_equal(np.asarray(got["shift_mask"]),
                                  np.asarray(ref["shift_mask"]))
    np.testing.assert_allclose(np.asarray(got["final_tracking_error"]),
                               np.asarray(ref["final_tracking_error"]),
                               atol=1e-8)


def test_ondevice_sim_adaptive_knot_sharded_matches_single_device():
    """Adaptive-frequency on-device sim with knot_mesh: the data-dependent
    shift schedule runs SPMD; matches the single-device adaptive sim when
    both use the same explicit per_iter_us model."""
    import jax.numpy as jnp
    import numpy as np

    from mpcgpu.config import PCGConfig, SimConfig, SQPConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.parallel.mesh import make_mesh
    from mpcgpu.sim.mpc import simulate_mpc_ondevice
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    model = iiwa14(dtype=jnp.float64)
    xu_traj = load_xu_traj("0_0")[:60]
    ee_traj = load_eepos_traj("0_0")[:60]
    kw = dict(
        knot_points=16, timestep=1 / 64.0, dtype=jnp.float64,
        sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
        pcg_cfg=PCGConfig(max_iter=40, exit_tol=1e-8),
        sim_cfg=SimConfig(max_control_updates=20, const_update_freq=False),
        per_iter_us=400.0,   # explicit solve-time model for both runs
    )
    ref = simulate_mpc_ondevice(model, xu_traj, ee_traj, **kw)
    mesh = make_mesh(n_instance=1, n_knot=4)
    got = simulate_mpc_ondevice(model, xu_traj, ee_traj, knot_mesh=mesh,
                                pcg_method="pipelined", **kw)
    assert got["control_updates"] == ref["control_updates"]
    np.testing.assert_allclose(np.asarray(got["tracking_errors"]),
                               np.asarray(ref["tracking_errors"]), atol=1e-6)
