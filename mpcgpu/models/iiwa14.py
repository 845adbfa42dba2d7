"""Kuka IIWA-14 model (7 revolute-z joints, serial chain).

Constants extracted from the reference GRiD codegen data by
tools/extract_grid_model.py (see _iiwa14_data.py header for provenance).
"""

from __future__ import annotations

import jax.numpy as jnp

from mpcgpu.models import _iiwa14_data as _d
from mpcgpu.models.robot import RobotModel

NQ = _d.NQ          # 7 joints
NX = 2 * NQ         # state [q, qd]
NU = NQ             # torque controls


def iiwa14(dtype=jnp.float32, gravity: float = 0.0) -> RobotModel:
    """Build the IIWA-14 RobotModel (gravity=0 matches the reference,
    iiwa_eepos_plant.cuh:51)."""
    f = lambda a: jnp.asarray(a, dtype)
    return RobotModel(
        xc=f(_d.XC), xs=f(_d.XS), xcos=f(_d.XCOS),
        inertia=f(_d.IMATS),
        hc=f(_d.HOMC), hs=f(_d.HOMS), hcos=f(_d.HOMCOS),
        gravity=gravity,
    )
