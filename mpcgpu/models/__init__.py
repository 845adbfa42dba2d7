"""Robot models and rigid-body dynamics (GRiD-equivalent).

The reference ships 5.7k lines of unrolled CUDA spatial algebra generated by
GRiD (include/dynamics/iiwa/iiwa_eepos_grid.cuh).  Here the same capability is
a compact, batched Featherstone implementation in JAX, parameterized by a
``RobotModel`` pytree whose constants are extracted from the reference's baked
model data (tools/extract_grid_model.py).
"""

from mpcgpu.models.robot import RobotModel
from mpcgpu.models.iiwa14 import iiwa14
from mpcgpu.models.chain import make_serial_chain, planar_arm, spatial_inertia
from mpcgpu.models.urdf import load_urdf
from mpcgpu.models import dynamics

__all__ = ["RobotModel", "iiwa14", "dynamics", "load_urdf",
           "make_serial_chain", "planar_arm", "spatial_inertia"]
