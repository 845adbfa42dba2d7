"""Batched parallel-scenario MPC: vmap over a leading instance axis.

The reference solves one MPC problem at a time; scenario batching (256
instances per device, BASELINE configs[3]) is a new capability.  One vmap
makes the entire SQP solve a single batched XLA program.

Per-instance PCG semantics under vmap: with linsys="pcg" the vmapped
``lax.while_loop`` runs until every instance has exited, and ``pcg_solve``
freezes the instances that are done, so iteration counts and iterates stay
exact per instance.  With linsys="pcg_pallas" the kernel gets a grid axis
over instances, and each program exits on its own count.
"""

from __future__ import annotations

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mpcgpu.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu.models.robot import RobotModel
from mpcgpu.solver.sqp import sqp_solve


def make_batched_sqp_solver(
    model: RobotModel,
    cost: CostConfig,
    sqp_cfg: SQPConfig,
    pcg_cfg: PCGConfig,
    dt: float,
    linsys: str = "auto",
    donate: bool = True,
    instance_mesh: Mesh | None = None,
):
    """fn(xu (B,N,nx+nu), lam (B,N,nx), xs (B,nx), ee_goal (B,N,6), rho (B,))
    -> batched SQPResult.

    instance_mesh: optional Mesh with an "instance" axis — the batch is
    shard_mapped across its devices, each solving its own slab of instances
    with no collectives.  Without it, inputs placed with a sharding
    (``parallel/mesh.shard_batched_problem``) are partitioned by XLA.
    """

    def _solve_one(xu, lam, xs, ee_goal, rho):
        return sqp_solve(
            model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, rho, dt,
            linsys=linsys,
        )

    fn = jax.vmap(_solve_one)
    if instance_mesh is not None:
        ax = "instance"
        # the PCG kernel's pallas_call carries no varying-axes annotation
        fn = shard_map(fn, mesh=instance_mesh, in_specs=(P(ax),) * 5,
                       out_specs=P(ax), check_vma=False)
    donate_argnums = (0, 1) if donate else ()
    return jax.jit(fn, donate_argnums=donate_argnums)
