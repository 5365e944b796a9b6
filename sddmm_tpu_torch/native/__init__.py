"""ctypes loader for the native C++ host accelerators.

Builds ``libsddmm_native.so`` on first use (g++ -O3 -fopenmp) from the
JAX package's source ``sddmm_tpu/native/src/native.cpp``, read as a file
(importing ``sddmm_tpu`` would load jax), into the port's own build
directory ``sddmm_tpu_torch/_build/``.  Every entry point has a pure numpy
fallback elsewhere in the package with the same results; ``available()``
is False when no compiler is present, and callers fall back to it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG.parent / "sddmm_tpu" / "native" / "src" / "native.cpp"
_LIB_PATH = _PKG / "_build" / "libsddmm_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    # build under a per-process name and rename: concurrent test workers
    # never load a half-written library
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           str(_SRC), "-o", str(tmp)]
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _LIB_PATH.exists() or (
                _SRC.exists()
                and _SRC.stat().st_mtime > _LIB_PATH.stat().st_mtime):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _build_failed = True
            return None

        lib.sddmm_mtx_read.restype = ctypes.c_int
        lib.sddmm_mtx_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.sddmm_free.restype = None
        lib.sddmm_free.argtypes = [ctypes.c_void_p]
        lib.sddmm_greedy_cluster.restype = ctypes.c_int64
        lib.sddmm_greedy_cluster.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sddmm_cpu_golden.restype = None
        lib.sddmm_cpu_golden.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def mtx_read(path: str):
    """Fast .mtx read.  Returns (m, n, rows, cols, vals, symmetry) with
    0-based int32 indices, or None if the native lib is unavailable.
    Raises ValueError on parse errors."""
    lib = _load()
    if lib is None:
        return None
    m = ctypes.c_longlong()
    n = ctypes.c_longlong()
    nnz = ctypes.c_longlong()
    rows_p = ctypes.POINTER(ctypes.c_int32)()
    cols_p = ctypes.POINTER(ctypes.c_int32)()
    vals_p = ctypes.POINTER(ctypes.c_double)()
    sym = ctypes.c_int()
    field = ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    rc = lib.sddmm_mtx_read(
        str(path).encode(), ctypes.byref(m), ctypes.byref(n),
        ctypes.byref(nnz), ctypes.byref(rows_p), ctypes.byref(cols_p),
        ctypes.byref(vals_p), ctypes.byref(sym), ctypes.byref(field),
        err, len(err))
    if rc != 0:
        raise ValueError(f"mtx parse error: {err.value.decode()}")
    k = nnz.value
    try:
        rows = np.ctypeslib.as_array(rows_p, shape=(k,)).copy()
        cols = np.ctypeslib.as_array(cols_p, shape=(k,)).copy()
        vals = np.ctypeslib.as_array(vals_p, shape=(k,)).copy()
    finally:
        lib.sddmm_free(rows_p)
        lib.sddmm_free(cols_p)
        lib.sddmm_free(vals_p)
    symmetry = {0: "general", 1: "symmetric", 2: "skew-symmetric"}[sym.value]
    return m.value, n.value, rows, cols, vals, symmetry


def greedy_cluster(block_ptr, block_idx, block_cnt, order, num_rows,
                   num_blocks, alpha):
    """Native exact greedy clustering; returns (cluster_of, num_clusters)
    or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    block_ptr = np.ascontiguousarray(block_ptr, dtype=np.int64)
    block_idx = np.ascontiguousarray(block_idx, dtype=np.int32)
    block_cnt = np.ascontiguousarray(block_cnt, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    cluster_of = np.empty(num_rows, dtype=np.int64)
    nc = lib.sddmm_greedy_cluster(
        _ptr(block_ptr, ctypes.c_int64), _ptr(block_idx, ctypes.c_int32),
        _ptr(block_cnt, ctypes.c_int64), _ptr(order, ctypes.c_int64),
        len(order), num_rows, num_blocks, float(alpha),
        _ptr(cluster_of, ctypes.c_int64))
    return cluster_of, int(nc)


def cpu_golden_sddmm(a, bt, row_ptr, col_idx):
    """Native OpenMP golden SDDMM or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.float32)
    bt = np.ascontiguousarray(bt, dtype=np.float32)
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    out = np.empty(len(col_idx), dtype=np.float32)
    lib.sddmm_cpu_golden(
        _ptr(a, ctypes.c_float), _ptr(bt, ctypes.c_float), a.shape[1],
        _ptr(row_ptr, ctypes.c_int64), _ptr(col_idx, ctypes.c_int32),
        a.shape[0], _ptr(out, ctypes.c_float))
    return out
