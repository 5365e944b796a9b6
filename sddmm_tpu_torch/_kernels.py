"""Build and bind the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, under ``sddmm_tpu_torch/_build/``
(git-ignored).  The library's name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale build is never loaded.  It is
bound with ctypes: pointers and the stream are passed as ``c_void_p``.

Any failure (no nvcc, a compile error, a load error) raises
``RuntimeError`` with the compiler's output; nothing here falls back to
the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: nvcc's output of the build this process made (``-Xptxas -v``: registers,
#: shared memory and spills per kernel); empty if the library was cached
build_log = ""


def _sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA kernels of sddmm_tpu_torch cannot "
        "be built")


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libsddmm_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return res.stdout + res.stderr


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sddmm_tile_dot_bf16x3.restype = i32
    lib.sddmm_tile_dot_bf16x3.argtypes = [p, p, p, i64, i32, i32, i32, p]
    lib.sddmm_gather_dot.restype = i32
    lib.sddmm_gather_dot.argtypes = [p, p, p, p, p, i64, i32, p]


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            build_log = _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        _bind(lib)
        _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a launch error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with "
                           f"cudaError {rc}")
