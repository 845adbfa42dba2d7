"""Auxiliary-subsystem smoke tests: checkpoint/resume, profiling, stats,
CSR packing round-trip through the experiment utilities (SURVEY.md section 5)."""

import numpy as np
import jax.numpy as jnp

from mpcgpu.utils.checkpoint import load_mpc_state, save_mpc_state
from mpcgpu.utils.profiling import WallTimer, time_jitted


def test_checkpoint_roundtrip(tmp_path):
    xu = np.random.default_rng(0).normal(size=(32, 21)).astype(np.float32)
    lam = np.zeros((32, 14), np.float32)
    save_mpc_state(tmp_path / "ck.npz", xu=xu, lam=lam, rho=1e-3,
                   traj_offset=17)
    st = load_mpc_state(tmp_path / "ck.npz")
    np.testing.assert_array_equal(st["xu"], xu)
    np.testing.assert_array_equal(st["lam"], lam)
    assert float(st["rho"]) == 1e-3
    assert int(st["traj_offset"]) == 17


def test_walltimer_and_time_jitted():
    import jax

    t = WallTimer()
    out = None
    with t.measure(out):
        out = jnp.ones((8,)) * 2.0
    assert len(t.samples_us) == 1 and t.samples_us[0] >= 0.0

    f = jax.jit(lambda x: x * 2.0 + 1.0)
    med_us = time_jitted(f, jnp.ones((64, 64)), reps=3)
    assert med_us > 0.0


def test_resume_continues_mpc(tmp_path):
    """Save mid-run warm-start state, resume, and keep tracking."""
    from mpcgpu.config import PCGConfig, SQPConfig
    from mpcgpu.models import iiwa14
    from mpcgpu.solver.sqp import sqp_solve
    from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj

    model = iiwa14()
    N = 16
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float32)
    lam = jnp.zeros((N, 14), jnp.float32)
    scfg, pcfg = SQPConfig(max_iter=2), PCGConfig(max_iter=40)

    r1 = sqp_solve(model, CostConfig_for(N), scfg, pcfg, xu, lam, xu[0, :14],
                   ee, 1e-3, 1 / 64.0, linsys="pcg")
    save_mpc_state(tmp_path / "mid.npz", xu=r1.xu, lam=r1.lam, rho=r1.rho)
    st = load_mpc_state(tmp_path / "mid.npz")
    r2 = sqp_solve(model, CostConfig_for(N), scfg, pcfg,
                   jnp.asarray(st["xu"]), jnp.asarray(st["lam"]),
                   jnp.asarray(st["xu"])[0, :14], ee,
                   float(st["rho"]), 1 / 64.0, linsys="pcg")
    assert np.isfinite(np.asarray(r2.xu)).all()
    assert float(r2.merit) <= float(r1.merit) + 1e-3


def CostConfig_for(N):
    from mpcgpu.config import CostConfig

    return CostConfig.for_knots(N)


def test_reference_cap_table():
    """The per-horizon PCG caps are the reference's settings.cuh:124-144
    values, with 200 for horizons it does not list."""
    from mpcgpu.config import PCGConfig

    assert [PCGConfig.tuned_max_iter(n) for n in (32, 64, 128, 256, 512)] \
        == [173, 167, 167, 118, 67]
    assert PCGConfig.tuned_max_iter(16) == 200


def test_busy_ns_is_the_union_of_intervals():
    from mpcgpu.utils.profiling import TraceEvent, busy_ns

    ev = [TraceEvent("a", 0, 10), TraceEvent("b", 5, 10),   # overlap -> 15
          TraceEvent("c", 30, 5), TraceEvent("d", 31, 2),   # nested -> 5
          TraceEvent("e", 35, 1)]                           # touching -> 1
    assert busy_ns(ev) == 21
    assert busy_ns([]) == 0


def test_reduce_trace_counts():
    """Idle share, kernels (copies excluded), device-to-host copies by name
    or by destination, and CUDA-graph launches from the host."""
    from mpcgpu.utils.profiling import TraceEvent, reduce_trace

    dev = [TraceEvent("loop_fusion", 0, 40),
           TraceEvent("MemcpyD2H", 50, 10),
           TraceEvent("MemcpyD2D", 70, 10,
                      "kind_src:device kind_dst:device size:4"),
           TraceEvent("pcg_solve_pallas", 80, 20),
           TraceEvent("memcpy", 100, 0,
                      "kind_src:device kind_dst:pinned size:1")]
    host = [TraceEvent("cuGraphLaunch (CudaGraph:7)", 0, 3),
            TraceEvent("command_buffer", 0, 5)]
    r = reduce_trace(dev, host)
    assert r["window_ns"] == 100 and r["busy_ns"] == 80
    assert abs(r["idle_share"] - 0.2) < 1e-12
    assert r["kernels"] == 3
    assert r["d2h_copies"] == 2
    assert r["graph_launches"] == 1
