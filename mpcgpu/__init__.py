"""mpcgpu — a nonlinear MPC (SQP + PCG) solver framework in JAX, run on GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of A2R-Lab/MPCGPU
(real-time SQP trajectory optimization with block-tridiagonal Schur-complement
KKT systems solved by symmetric-stair-preconditioned conjugate gradient):

  * dims are static jit arguments; data lives in ``[N, ...]`` knot-leading
    block arrays (pytrees), not ragged device buffers;
  * rigid-body dynamics + analytic gradients are batched JAX functions built
    from extracted model data (GRiD-equivalent, see ``models/``);
  * the PCG inner loop is one on-device loop: a ``lax.while_loop``, or on a
    GPU one Pallas-Triton kernel per solve (``ops/pcg_pallas.py``);
  * scaling is ``jax.sharding``/``shard_map`` over an ``(instance, knot)``
    mesh with `ppermute` halo exchange, not host-driven multi-process code.

Reference parity citations (file:line) point into the MPCGPU repository.
"""

from mpcgpu.config import CostConfig, PCGConfig, SQPConfig, SimConfig


def __getattr__(name):
    # lazy top-level conveniences (keep import light; jax loads on demand)
    if name in ("sqp_solve", "make_sqp_solver"):
        from mpcgpu.solver import sqp
        return getattr(sqp, name)
    if name in ("simulate_mpc", "simulate_mpc_ondevice",
                "simulate_mpc_ondevice_batched"):
        from mpcgpu.sim import mpc
        return getattr(mpc, name)
    if name == "iiwa14":
        from mpcgpu.models import iiwa14
        return iiwa14
    raise AttributeError(name)


__all__ = [
    "CostConfig",
    "PCGConfig",
    "SQPConfig",
    "SimConfig",
    "sqp_solve",
    "make_sqp_solver",
    "simulate_mpc",
    "simulate_mpc_ondevice",
    "simulate_mpc_ondevice_batched",
    "iiwa14",
]

__version__ = "0.2.0"
