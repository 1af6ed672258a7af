"""ctypes binding to the native C++ host library (native/multigrid_host.cpp).

The reference's host layer (assembly + COO->CSR + implicit SpMV via MKL
handles) is C++; this module is its native counterpart here: the shared
library is built on demand with g++ and loaded via ctypes (pybind11 is not
available in this environment).  Falls back cleanly (``available() ->
False``) when no compiler is present — the device compute path never
needs it.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "multigrid_host.cpp"
_LIB_DIR = pathlib.Path(
    os.environ.get("TMG_NATIVE_CACHE",
                   pathlib.Path(__file__).resolve().parent.parent / ".build"))
_LIB = _LIB_DIR / "libmultigrid_host.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build() -> bool:
    """Compile the library unless an up-to-date one exists.  Concurrent
    processes (test workers) serialize on a lock file, and the library
    appears atomically, so none loads a half-written file."""
    if not _SRC.exists():
        return False
    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    import fcntl
    with open(_LIB_DIR / "libmultigrid_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
            return True
        tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            return False
        os.replace(tmp, _LIB)
        return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        lib = ctypes.CDLL(str(_LIB))

        lib.tmg_assemble.restype = ctypes.c_int64
        lib.tmg_assemble.argtypes = [ctypes.c_int64, ctypes.c_void_p,
                                     _i64p, _i64p, _f64p]
        lib.tmg_coo_to_csr.restype = ctypes.c_int64
        lib.tmg_coo_to_csr.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       _i64p, _i64p, _f64p,
                                       _i64p, _i64p, _f64p]
        lib.tmg_assemble_rhs.restype = None
        lib.tmg_assemble_rhs.argtypes = [ctypes.c_int64, ctypes.c_void_p,
                                         _f64p]
        lib.tmg_assemble_stencil9.restype = ctypes.c_int64
        lib.tmg_assemble_stencil9.argtypes = [ctypes.c_int64,
                                              ctypes.c_int64, _f64p,
                                              _i64p, _i64p, _f64p]
        lib.tmg_spmv.restype = None
        lib.tmg_spmv.argtypes = [ctypes.c_int64, _i64p, _i64p, _f64p,
                                 _f64p, _f64p]
        lib.tmg_residual.restype = ctypes.c_double
        lib.tmg_residual.argtypes = [ctypes.c_int64, _i64p, _i64p, _f64p,
                                     _f64p, _f64p, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def assemble_csr(n: int, cell_coeff: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble the interior stiffness in CSR: (indptr, indices, data).

    ``cell_coeff=None`` gives the Poisson 5-point stencil (diag 4); an
    (n, n) array gives the variable-coefficient flux stencil.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    m = (n - 1) ** 2
    indptr = np.zeros(m + 1, np.int64)
    indices = np.zeros(5 * m, np.int64)
    data = np.zeros(5 * m, np.float64)
    if cell_coeff is not None:
        cc = np.ascontiguousarray(cell_coeff, np.float64)
        assert cc.shape == (n, n)
        ccp = cc.ctypes.data_as(ctypes.c_void_p)
    else:
        ccp = None
    nnz = lib.tmg_assemble(n, ccp, indptr, indices, data)
    return indptr, indices[:nnz].copy(), data[:nnz].copy()


def assemble_stencil9(coef: np.ndarray, n: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """General 9-point stencil -> interior CSR: (indptr, indices, data).

    ``coef`` is the (3, 3, S, S) coefficient array of any framework
    stencil family (anisotropic/rotated, Helmholtz, upwind convection,
    Galerkin coarse ops); columns at non-unknown nodes are dropped.
    The independent native oracle for the whole VarStencilOp family.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    cc = np.ascontiguousarray(coef, np.float64)
    assert cc.ndim == 4 and cc.shape[:2] == (3, 3) \
        and cc.shape[2] == cc.shape[3], cc.shape
    S = cc.shape[2]
    m = (n - 1) ** 2
    indptr = np.zeros(m + 1, np.int64)
    indices = np.zeros(9 * m, np.int64)
    data = np.zeros(9 * m, np.float64)
    nnz = lib.tmg_assemble_stencil9(n, S, cc.reshape(-1), indptr,
                                    indices, data)
    return indptr, indices[:nnz].copy(), data[:nnz].copy()


def coo_to_csr(rows: int, coo_i, coo_j, coo_v):
    """Duplicate-merging COO->CSR (double-precision accumulation)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    coo_i = np.ascontiguousarray(coo_i, np.int64)
    coo_j = np.ascontiguousarray(coo_j, np.int64)
    coo_v = np.ascontiguousarray(coo_v, np.float64)
    nnz_in = len(coo_v)
    indptr = np.zeros(rows + 1, np.int64)
    indices = np.zeros(nnz_in, np.int64)
    data = np.zeros(nnz_in, np.float64)
    nnz = lib.tmg_coo_to_csr(rows, nnz_in, coo_i, coo_j, coo_v,
                             indptr, indices, data)
    return indptr, indices[:nnz].copy(), data[:nnz].copy()


def assemble_rhs(n: int, f_values: Optional[np.ndarray] = None) -> np.ndarray:
    """Interior load vector b = f * h^2 (row-major (n-1)^2)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    m = (n - 1) ** 2
    out = np.zeros(m, np.float64)
    if f_values is not None:
        fv = np.ascontiguousarray(f_values, np.float64).reshape(m)
        lib.tmg_assemble_rhs(n, fv.ctypes.data_as(ctypes.c_void_p), out)
    else:
        lib.tmg_assemble_rhs(n, None, out)
    return out


def spmv(indptr, indices, data, x) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    rows = len(indptr) - 1
    y = np.zeros(rows, np.float64)
    lib.tmg_spmv(rows, np.ascontiguousarray(indptr, np.int64),
                 np.ascontiguousarray(indices, np.int64),
                 np.ascontiguousarray(data, np.float64),
                 np.ascontiguousarray(x, np.float64), y)
    return y


def residual_norm(indptr, indices, data, x, b) -> float:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    rows = len(indptr) - 1
    return float(lib.tmg_residual(
        rows, np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        np.ascontiguousarray(data, np.float64),
        np.ascontiguousarray(x, np.float64),
        np.ascontiguousarray(b, np.float64), None))
