"""mpcgpu.device: the one place that decides the platform and the solver."""

import jax
import jax.numpy as jnp
import pytest

from mpcgpu import device
from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu.models import iiwa14
from mpcgpu.ops.pcg_pallas import pcg_solve_pallas
from mpcgpu.solver.sqp import sqp_solve
from mpcgpu.utils.trajfiles import load_eepos_traj, load_xu_traj


def test_platform_is_cpu_here():
    assert device.platform() == "cpu"


@pytest.mark.parametrize("precond", ["stair", "jacobi", "none", "stair2"])
@pytest.mark.parametrize("knots", [32, 512])
def test_cpu_default_is_xla_pcg(precond, knots):
    assert device.resolve_linsys("auto", precond, knots) == "pcg"


@pytest.mark.parametrize("precond,knots,want", [
    ("stair", 32, "pcg_pallas"),
    ("stair", 256, "pcg_pallas"),
    ("jacobi", 64, "pcg_pallas"),
    ("stair", 257, "pcg"),
    ("stair", 512, "pcg"),
    ("stair2", 64, "pcg"),
])
def test_gpu_default(monkeypatch, precond, knots, want):
    """The kernel for 3-band preconditioners up to KERNEL_MAX_KNOTS, where it
    beat the XLA loop on the card; the XLA loop otherwise."""
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    assert device.resolve_linsys("auto", precond, knots) == want


@pytest.mark.parametrize("linsys", ["pcg", "ldl", "pcr", "qdldl_host"])
def test_explicit_portable_solvers_pass_through(linsys):
    assert device.resolve_linsys(linsys, "stair", 64) == linsys


def test_kernel_request_without_gpu_raises():
    with pytest.raises(ValueError, match="GPU kernel"):
        device.resolve_linsys("pcg_pallas", "stair", 64)


def test_sqp_kernel_request_on_cpu_raises_instead_of_interpreting():
    """No silent route to the Pallas interpreter or to another solver."""
    N = 16
    model = iiwa14(dtype=jnp.float32)
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    ee = jnp.asarray(load_eepos_traj("0_0")[:N], jnp.float32)
    with pytest.raises(ValueError, match="GPU kernel"):
        sqp_solve(model, CostConfig(), SQPConfig(max_iter=1),
                  PCGConfig(max_iter=10), xu, jnp.zeros((N, 14), jnp.float32),
                  xu[0, :14], ee, 1e-3, 1 / 64.0, linsys="pcg_pallas")


def test_kernel_wrapper_does_not_interpret_by_default():
    """interpret= belongs to the wrapper and is off unless asked for: on the
    CPU the un-interpreted kernel fails to lower rather than running in the
    interpreter."""
    S = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (8, 3, 4, 4))
    g = jnp.ones((8, 4), jnp.float32)
    with pytest.raises(ValueError, match="Only interpret mode"):
        jax.block_until_ready(pcg_solve_pallas(S, S, g, g, max_iter=2))
    got = pcg_solve_pallas(S, S, g, jnp.zeros_like(g), max_iter=2,
                           interpret=True)
    assert bool(jnp.isfinite(got.lam).all())


def test_unknown_platform_raises(monkeypatch):
    class Dev:
        platform = "metal"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    with pytest.raises(RuntimeError, match="unsupported platform"):
        device.platform()
    with pytest.raises(RuntimeError, match="unsupported platform"):
        device.resolve_linsys("auto", "stair", 64)
