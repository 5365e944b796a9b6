"""ctypes loader for the native C++ host accelerators.

Builds the library on first use (g++ -O3 -march=native -fopenmp) from the
port's own source ``sddmm_tpu_torch/native/src/native.cpp`` (a copy of the
JAX package's, which stays its reference) into the port's build directory
``sddmm_tpu_torch/_build/``.  The library's name carries a hash of the
source, the flags and the host's ``-march=native`` target, so a library
built from another source or on another host is never loaded.  Every entry
point has a pure numpy fallback elsewhere in the package with the same
results (the greedy's is ``reorder.rows._greedy_cluster`` in its native
arithmetic); ``available()`` is False when no compiler is present, and
callers fall back to it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
_SRC = Path(__file__).resolve().parent / "src" / "native.cpp"
_BUILD = _PKG / "_build"
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


@functools.lru_cache(maxsize=1)
def _host_target() -> bytes:
    """What ``-march=native`` resolves to on this host (empty without
    g++, whose build then fails anyway)."""
    try:
        res = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                             capture_output=True, timeout=60)
        return res.stdout
    except (OSError, subprocess.TimeoutExpired):
        return b""


def lib_path(src: Path = _SRC) -> Path:
    """The library built from ``src``: named after a hash of its bytes,
    the flags and the host's target."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_host_target())
    h.update(src.read_bytes())
    return _BUILD / f"libsddmm_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    # build under a per-process name and rename: concurrent test workers
    # never load a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, out)
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
        path = lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
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
