"""ctypes bindings for the native geometry kernels (native/mgb_native.cpp).

Loaded lazily; every entry point has a pure-Python/numpy fallback, so the
package works without the shared library.  The library is built on demand
with g++ the first time it's requested (and the result cached on disk).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_SRC_DIR, "libmgb_native.so")


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("MGB_NO_NATIVE"):
            return None
        src = os.path.join(_SRC_DIR, "mgb_native.cpp")
        try:
            if not os.path.exists(_SO_PATH) or (
                os.path.exists(src)
                and os.path.getmtime(src) > os.path.getmtime(_SO_PATH)
            ):
                # compile to a pid-unique temp path and rename atomically:
                # concurrent imports (parallel test workers) must
                # never dlopen a partially written .so or race two
                # compilers onto the same output file
                tmp = f"{_SO_PATH}.tmp{os.getpid()}"
                try:
                    subprocess.run(
                        [
                            "g++",
                            "-O3",
                            "-shared",
                            "-fPIC",
                            "-std=c++17",
                            "-o",
                            tmp,
                            src,
                        ],
                        check=True,
                        capture_output=True,
                        timeout=120,
                    )
                    os.rename(tmp, _SO_PATH)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(_SO_PATH)
        except Exception:
            return None

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")

        lib.csr_to_ell.restype = ctypes.c_int
        lib.csr_to_ell.argtypes = [
            ctypes.c_int64, i64p, i32p, f64p, ctypes.c_int64, i32p, f64p
        ]
        lib.element_max_cols.restype = ctypes.c_int64
        lib.element_max_cols.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p]
        lib.csr_to_level_basis.restype = ctypes.c_int
        lib.csr_to_level_basis.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i32p, f64p, ctypes.c_int64, i32p, f64p,
        ]
        lib.tri_edge_tables.restype = ctypes.c_int64
        lib.tri_edge_tables.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i32p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def csr_to_ell(indptr, indices, data, nrows, K, itype=np.int32, dtype=np.float64):
    """Native CSR->ELL padding; returns (cols, vals) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    cols = np.zeros((nrows, K), dtype=np.int32)
    vals = np.zeros((nrows, K), dtype=np.float64)
    rc = lib.csr_to_ell(
        nrows,
        np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int32),
        np.ascontiguousarray(data, dtype=np.float64),
        K,
        cols,
        vals,
    )
    if rc != 0:
        raise ValueError(f"row nnz exceeds width {K}")
    return cols.astype(itype, copy=False), vals.astype(dtype, copy=False)


def csr_to_level_basis(indptr, indices, data, nelem, nq, m, dtype=np.float64):
    """Native element-local extraction; returns (idx, rloc, nl) or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float64)
    nl = int(lib.element_max_cols(nelem, nq, indptr, indices))
    idx = np.full((nelem, nl), m, dtype=np.int32)
    rloc = np.zeros((nelem, nq, nl), dtype=np.float64)
    rc = lib.csr_to_level_basis(
        nelem, nq, m, indptr, indices, data, nl, idx, rloc
    )
    if rc != 0:
        raise RuntimeError("csr_to_level_basis: nl overflow")
    return idx, rloc.astype(dtype, copy=False), nl


def tri_edge_tables(tris):
    """Native triangle edge tables; returns (tri_edges, edge_pairs,
    edge_count) or None."""
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, dtype=np.int64)
    nt = len(tris)
    tri_edges = np.zeros((nt, 3), dtype=np.int64)
    edge_pairs = np.zeros((3 * nt, 2), dtype=np.int64)
    edge_count = np.zeros(3 * nt, dtype=np.int32)
    ne = int(lib.tri_edge_tables(nt, tris, tri_edges, edge_pairs, edge_count))
    return tri_edges, edge_pairs[:ne], edge_count[:ne]
