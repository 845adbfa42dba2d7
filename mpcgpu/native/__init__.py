"""Native (C++) runtime components.

``btd_ldl``: CPU block-tridiagonal LDL^T direct solver — the framework's
qdldl-equivalent host-side baseline (reference include/qdldl/sqp.cuh), exposed
through ctypes and built on demand with g++.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SO = _DIR / "libbtd_ldl.so"
_SRC = _DIR / "btd_ldl.cpp"

_lib = None


def _build() -> None:
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", str(_SO)],
        check=True,
    )


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_SO))
    lib.btd_ldl_solve.restype = ctypes.c_int
    lib.btd_ldl_solve.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return lib


def btd_ldl_solve_cpu(S: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve S x = b on the CPU for a BTD matrix in (N, 3, n, n) layout.

    Mirrors the reference's host-side qdldl role (D2H values -> factor ->
    solve -> H2D, qdldl/sqp.cuh:268-273); used as a numerical cross-check of
    the on-device solvers.
    """
    S = np.asarray(S, np.float64)
    b = np.ascontiguousarray(np.asarray(b, np.float64))
    N, _, n, _ = S.shape
    theta = np.ascontiguousarray(S[:, 1])
    phi = np.ascontiguousarray(S[1:, 0]) if N > 1 else np.zeros((0, n, n))
    x = np.zeros((N, n), np.float64)
    rc = _load().btd_ldl_solve(n, N, theta, phi, b, x)
    if rc != 0:
        raise RuntimeError("btd_ldl_solve: singular diagonal block")
    return x


# ---------------------------------------------------------------------------
# sparse elimination-tree LDL^T (the literal qdldl-equivalent, C18)
# ---------------------------------------------------------------------------

_SLDL_SO = _DIR / "libsparse_ldl.so"
_SLDL_SRC = _DIR / "sparse_ldl.cpp"
_sldl_lib = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _load_sldl():
    global _sldl_lib
    if _sldl_lib is not None:
        return _sldl_lib
    if not _SLDL_SO.exists() or _SLDL_SO.stat().st_mtime < _SLDL_SRC.stat().st_mtime:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             str(_SLDL_SRC), "-o", str(_SLDL_SO)],
            check=True,
        )
    lib = ctypes.CDLL(str(_SLDL_SO))
    lib.sldl_etree.restype = ctypes.c_int64
    lib.sldl_etree.argtypes = [ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _i64p]
    lib.sldl_factor.restype = ctypes.c_int64
    lib.sldl_factor.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p,
        _f64p, _f64p, _i64p, _i64p, _i64p, _i64p, _f64p,
    ]
    lib.sldl_solve.restype = None
    lib.sldl_solve.argtypes = [ctypes.c_int64, _i64p, _i64p, _f64p, _f64p, _f64p]
    _sldl_lib = lib
    return lib


class SparseLDL:
    """Elimination-tree sparse LDL^T with a cached symbolic factorization —
    the reference's QDLDL_etree / QDLDL_factor / QDLDL_solve usage pattern
    (pattern prepped once via prep_csr, qdldl/sqp.cuh:164-166; numeric
    factor+solve per SQP iteration, :193, :271).

    Consumes upper-triangular CSC (ops/csr.py::btd_upper_csc_pattern
    orientation): per column, ascending row indices with the diagonal
    present and last.
    """

    def __init__(self, col_ptr: np.ndarray, row_ind: np.ndarray):
        self.Ap = np.ascontiguousarray(col_ptr, np.int64)
        self.Ai = np.ascontiguousarray(row_ind, np.int64)
        self.n = len(self.Ap) - 1
        n = self.n
        lib = _load_sldl()
        self.Lnz = np.zeros(n, np.int64)
        self.etree = np.zeros(n, np.int64)
        work = np.zeros(n, np.int64)
        nnz_l = lib.sldl_etree(n, self.Ap, self.Ai, work, self.Lnz, self.etree)
        if nnz_l < 0:
            raise ValueError("pattern is not upper-triangular CSC with diagonal")
        self.nnz_l = int(nnz_l)
        self.Lp = np.zeros(n + 1, np.int64)
        self.Li = np.zeros(self.nnz_l, np.int64)
        self.Lx = np.zeros(self.nnz_l, np.float64)
        self.D = np.zeros(n, np.float64)
        self.Dinv = np.zeros(n, np.float64)
        self._iwork = np.zeros(3 * n, np.int64)
        self._bwork = np.zeros(n, np.int64)
        self._fwork = np.zeros(n, np.float64)

    def factor(self, values: np.ndarray) -> int:
        """Numeric factorization; returns the count of positive pivots."""
        vals = np.ascontiguousarray(values, np.float64)
        rc = _load_sldl().sldl_factor(
            self.n, self.Ap, self.Ai, vals, self.Lp, self.Li, self.Lx,
            self.D, self.Dinv, self.Lnz, self.etree, self._iwork,
            self._bwork, self._fwork)
        if rc < 0:
            raise RuntimeError("sparse LDL^T: zero pivot")
        return int(rc)

    def solve(self, b: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(b, np.float64).copy()
        _load_sldl().sldl_solve(self.n, self.Lp, self.Li, self.Lx,
                                self.Dinv, x)
        return x


def qdldl_solve_schur(S: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """One-call direct solve of the BTD Schur system through the sparse
    elimination-tree LDL^T — the qdldl_solve_schur analogue
    (qdldl/sqp.cuh:22-49).  S (N,3,n,n), gamma (N,n); returns lambda (N,n).
    """
    from mpcgpu.ops.csr import btd_upper_csc_pattern, btd_upper_csc_values

    S = np.asarray(S, np.float64)
    N, _, n, _ = S.shape
    col_ptr, row_ind = btd_upper_csc_pattern(n, N)
    fac = SparseLDL(col_ptr, row_ind)
    fac.factor(btd_upper_csc_values(S))
    return fac.solve(np.asarray(gamma, np.float64).reshape(N * n)).reshape(N, n)


_SLDL_CACHE: dict = {}


def qdldl_solve_schur_cached(S: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """qdldl_solve_schur with the SYMBOLIC factorization cached per (n, N) —
    the reference's exact usage: pattern prepped once (prep_csr,
    qdldl/sqp.cuh:164-166), numeric factor + solve per SQP iteration
    (:193, :271).  This is the host end of the ``linsys="qdldl_host"``
    per-iteration D2H -> factor/solve -> H2D round-trip."""
    from mpcgpu.ops.csr import btd_upper_csc_pattern, btd_upper_csc_values

    S = np.asarray(S, np.float64)
    N, _, n, _ = S.shape
    fac = _SLDL_CACHE.get((n, N))
    if fac is None:
        col_ptr, row_ind = btd_upper_csc_pattern(n, N)
        fac = _SLDL_CACHE[(n, N)] = SparseLDL(col_ptr, row_ind)
    fac.factor(btd_upper_csc_values(S))
    return fac.solve(np.asarray(gamma, np.float64).reshape(N * n)).reshape(N, n)
