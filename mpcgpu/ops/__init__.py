"""Block-tridiagonal linear algebra: Schur condensation, PCG, direct LDL^T."""

from mpcgpu.ops.btd import btd_matvec, btd_to_dense
from mpcgpu.ops.schur import SchurSystem, form_schur_system, compute_dz
from mpcgpu.ops.pcg import pcg_solve
from mpcgpu.ops.ldl import btd_ldl_solve

__all__ = [
    "btd_matvec",
    "btd_to_dense",
    "SchurSystem",
    "form_schur_system",
    "compute_dz",
    "pcg_solve",
    "btd_ldl_solve",
]
