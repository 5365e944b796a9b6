"""Build and bind the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and links them into one shared
library with a plain C interface, under ``sddmm_tpu_torch/_build/``
(git-ignored).  The library's name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale build is never loaded.  It is
bound with ctypes: pointers and the stream are passed as ``c_void_p``.

Every C entry point launches one kernel instance.  ``launch`` calls it,
raises on a launch error and adds one to ``launches[entry point]``: the
count a run reads to show that a path went through the kernels.

Any failure (no nvcc, a compile error, a load error) raises
``RuntimeError`` with the compiler's output; nothing here falls back to
the plain PyTorch versions.
"""

from __future__ import annotations

import collections
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: nvcc's output of the build this process made (``-Xptxas -v``: registers,
#: shared memory and spills per kernel); empty if the library was cached
build_log = ""
#: launches per kernel instance (C entry point name -> count); added to by
#: ``launch`` only, so a CPU tensor's plain version never counts
launches: collections.Counter = collections.Counter()


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


def _run(cmds: list) -> str:
    """Run the commands at once; raise with their output if any fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def _build(out: Path) -> str:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(_sources(), objs)])
        log += _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return log


#: C entry point of the CSR SpMM kernel (``csrc/spmm.cu``), fp32 only
SPMM_ENTRY = "sddmm_csr_spmm_float32"
#: C entry point of the segment softmax kernel (``csrc/segment_softmax.cu``)
SOFTMAX_ENTRY = "sddmm_segment_softmax_float32"
#: and of its backward, in the same source
SOFTMAX_BWD_ENTRY = "sddmm_segment_softmax_backward_float32"
#: C entry points of the hybrid's backward over the work table
#: (``csrc/tile_grad.cu``): the per-unit products, then their reduction
TILE_GRAD_ENTRY = "sddmm_tile_grad_float32"
TILE_GRAD_REDUCE_ENTRY = "sddmm_tile_grad_reduce_float32"


def gather_dot_entry(adt, bdt) -> str:
    """C entry point of the gather-dot instance for A and B stored in the
    torch dtypes ``adt`` and ``bdt``."""
    return (f"sddmm_gather_dot_{str(adt).removeprefix('torch.')}_"
            f"{str(bdt).removeprefix('torch.')}")


def _entry_points() -> dict:
    """C entry point name -> ctypes argtypes, for every kernel instance:
    the tile dot per compute mode, the gather-dot per (A, B) storage pair
    of the modes, the CSR SpMM, the segment softmax and its backward, and
    the tile-grad kernel and its reduction."""
    from sddmm_tpu_torch.ops.tile_dot import MODES, STORAGE
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tile = [p, i64, i64, p, i64, i64, i64, p, i64, p, p, p, i64, i32, i32,
            i32, i32, i32, p]
    gather = [p, i64, i64, p, i64, i64, i64, p, p, p, p, i64, p, p, i32,
              i32, p, i64, i64, i32, i32, i32, i32, i32, p]
    spmm = [p, i64, p, p, i32, p, p, p, p, i64, p, i64, i64, i64, p, i64,
            i64, i64, i32, i32, i32, i32, p]
    softmax = [p, i64, p, p, i64, p, i64, ctypes.c_float, p, i64, i32, p]
    softmax_bwd = [p, i64, p, i64, p, p, i64, p, i64, ctypes.c_float, p,
                   i64, i32, p]
    tile_grad = [p, i64, i64, p, i64, i64, i64, p, i64, p, p, p, p, i64,
                 i64, p, p, i64, i32, i32, i32, i32, p]
    tile_grad_reduce = [p, i64, i32, p, p, i64, i64, p, i64, p, i64, i64,
                        i32, i32, i32, p]
    eps = {f"sddmm_tile_dot_{m}": tile for m in MODES}
    eps[TILE_GRAD_ENTRY] = tile_grad
    eps[TILE_GRAD_REDUCE_ENTRY] = tile_grad_reduce
    eps.update({gather_dot_entry(*pair): gather for pair in STORAGE.values()})
    eps[SPMM_ENTRY] = spmm
    eps[SOFTMAX_ENTRY] = softmax
    eps[SOFTMAX_BWD_ENTRY] = softmax_bwd
    return eps


def _bind(lib: ctypes.CDLL) -> None:
    for name, argtypes in _entry_points().items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes


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


def launch(name: str, *args) -> None:
    """Call the C entry point ``name`` (one kernel instance) with ``args``
    (ctypes-convertible, stream last); raise if it reports a launch error,
    else count the launch."""
    rc = getattr(load(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with "
                           f"cudaError {rc}")
    launches[name] += 1
