"""Device mesh construction and sharding helpers.

Axes:
  * ``instance`` — data parallelism over independent MPC problems (scenario
    batching); no cross-device communication in the solver.
  * ``knot``     — sequence parallelism over the MPC horizon: the BTD Schur
    system is row-partitioned by knot blocks; SpMV/preconditioner need only
    nearest-neighbor halo blocks (O(1) per PCG iteration) and the dot
    products need a psum (SURVEY.md section 5).

The mesh is a flat list of devices.  The GPUs of one host are joined all to
all by NVLink, so no device order is closer than another and the mesh shape
follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_instance: int = 1, n_knot: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_instance * n_knot
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_instance, n_knot)
    return Mesh(arr, axis_names=("instance", "knot"))


def shard_batched_problem(mesh: Mesh, xu, lam, xs, ee_goal, rho):
    """Place a batched problem ((B, N, ...) arrays) on the (instance, knot) mesh.

    Batch axis -> instance, knot axis -> knot; per-problem scalars/vectors are
    instance-sharded only.
    """
    s2 = NamedSharding(mesh, P("instance", "knot"))
    s1 = NamedSharding(mesh, P("instance"))
    return (
        jax.device_put(xu, s2),
        jax.device_put(lam, s2),
        jax.device_put(xs, s1),
        jax.device_put(ee_goal, s2),
        jax.device_put(rho, s1),
    )
