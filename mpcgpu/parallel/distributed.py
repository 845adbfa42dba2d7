"""Multi-host initialization and mesh spanning hosts.

The reference has no distributed backend (SURVEY.md section 2); here
multi-host runs use ``jax.distributed`` with the (instance, knot) mesh laid
out so the knot (sequence-parallel) axis stays within one host, whose GPUs
share NVLink, and the instance (data-parallel) axis crosses hosts over the
network — instance parallelism needs no solver communication, so the
network never sits on the PCG critical path.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Thin wrapper over jax.distributed.initialize (no-op if single process
    and no coordinator given)."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_host_aligned_mesh(n_knot_per_host: Optional[int] = None) -> Mesh:
    """(instance, knot) mesh with the knot axis contained in each host.

    knot-axis collectives (ppermute halos, psum dots — every PCG iteration)
    ride NVLink; the instance axis (no solver comms) spans hosts.
    """
    devices = np.asarray(jax.devices())
    n_local = jax.local_device_count()
    n_knot = n_knot_per_host or n_local
    if n_local % n_knot != 0:
        raise ValueError(f"knot axis {n_knot} must divide local device count {n_local}")
    n_instance = len(devices) // n_knot
    return Mesh(devices.reshape(n_instance, n_knot), axis_names=("instance", "knot"))
