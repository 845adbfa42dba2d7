"""SQP trajectory-optimization solver stack (KKT -> Schur -> PCG -> dz -> line search)."""

from mpcgpu.solver.kkt import KKTBlocks, build_kkt
from mpcgpu.solver.merit import merit_function, line_search_merits
from mpcgpu.solver.sqp import SQPResult, sqp_solve, make_sqp_solver

__all__ = [
    "KKTBlocks",
    "build_kkt",
    "merit_function",
    "line_search_merits",
    "SQPResult",
    "sqp_solve",
    "make_sqp_solver",
]
