"""Scaling: batched instances (vmap/DP) and knot-sharded meshes (SP).

The reference is strictly single-GPU single-problem (SURVEY.md section 2);
these are new first-class components:
  * ``batched``   — leading instance axis, 256 problems/device (BASELINE configs[3]);
  * ``mesh``      — (instance, knot) device meshes + sharding helpers;
  * ``pcg_sharded`` — shard_map PCG with ppermute halo exchange over the knot
    (horizon) axis (BASELINE configs[4]).
"""

from mpcgpu.parallel.batched import make_batched_sqp_solver
from mpcgpu.parallel.mesh import make_mesh, shard_batched_problem
from mpcgpu.parallel.pcg_sharded import pcg_solve_sharded

__all__ = [
    "make_batched_sqp_solver",
    "make_mesh",
    "shard_batched_problem",
    "pcg_solve_sharded",
]
