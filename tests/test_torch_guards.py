"""Guards of the port: it never loads jax, never builds or runs a kernel
without the CUDA toolchain, and never carries on silently on the CPU."""

import ctypes
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(ROOT), timeout=300)


def test_import_does_not_load_jax():
    res = _python(
        "import sys\n"
        "import sddmm_tpu_torch, sddmm_tpu_torch.ops, sddmm_tpu_torch.utils\n"
        "import sddmm_tpu_torch.interop, sddmm_tpu_torch.reorder.autotune\n"
        "import sddmm_tpu_torch.reorder.validate, sddmm_tpu_torch.data.io\n"
        "import sddmm_tpu_torch.models.factorization\n"
        "import sddmm_tpu_torch.utils.checkpoint\n"
        "assert 'jax' not in sys.modules, 'jax loaded'\n"
        "assert 'sddmm_tpu' not in sys.modules, 'sddmm_tpu loaded'\n"
        "print('clean')\n")
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_no_jax_import_in_sources():
    for path in (ROOT / "sddmm_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("from sddmm_tpu ")
                        or s.startswith("from sddmm_tpu.")
                        or s.startswith("import sddmm_tpu ")
                        or s.startswith("import sddmm_tpu.")), (path, line)


def test_kernel_load_raises_without_nvcc():
    """Where there is no nvcc, loading the kernels raises RuntimeError: no
    fallback to the plain versions."""
    res = _python(
        "import os\n"
        "os.environ['PATH'] = '/nonexistent'\n"
        "os.environ['CUDA_HOME'] = '/nonexistent'\n"
        "from sddmm_tpu_torch import _kernels\n"
        "try:\n"
        "    _kernels.load()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n")
    assert res.returncode == 0 and "raised: nvcc not found" in res.stdout, (
        res.stdout + res.stderr)


def test_kernel_load_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernels can be built")
    from sddmm_tpu_torch import _kernels
    if _kernels.lib_path().exists():
        pytest.skip("a built kernel library is present")
    with pytest.raises(RuntimeError):
        _kernels.load()


def test_library_name_tracks_sources():
    from sddmm_tpu_torch import _kernels
    p = _kernels.lib_path()
    assert p.parent.name == "_build" and p.name.startswith("libsddmm_kernels_")
    assert p == _kernels.lib_path()
    assert {s.name for s in _kernels._sources()} == {
        "tile_dot.cu", "gather_dot.cu", "spmm.cu", "segment_softmax.cu",
        "tile_grad.cu"}


def test_build_runs_commands_together_and_raises():
    """The build starts one nvcc per source at once and raises with the
    compiler's output if any fails; every kernel instance has a binding."""
    from sddmm_tpu_torch import _kernels
    assert _kernels._run([["echo", "one"], ["echo", "two"]]) == "one\ntwo\n"
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _kernels._run([["echo", "fine"], ["false"]])
    from sddmm_tpu_torch.ops.tile_dot import MODES
    eps = _kernels._entry_points()
    assert {f"sddmm_tile_dot_{m}" for m in MODES} < set(eps)
    # the gather-dot has one instance per storage pair of the modes
    assert {e for e in eps if e.startswith("sddmm_gather_dot_")} == {
        "sddmm_gather_dot_float32_float32", "sddmm_gather_dot_float32_bfloat16",
        "sddmm_gather_dot_float16_float16",
        "sddmm_gather_dot_bfloat16_bfloat16"}
    assert _kernels.SPMM_ENTRY in eps
    # the segment softmax and its backward bind too, so a build or bind
    # failure raises
    assert _kernels.SOFTMAX_ENTRY in eps
    assert eps[_kernels.SOFTMAX_ENTRY][7] is ctypes.c_float
    assert eps[_kernels.SOFTMAX_BWD_ENTRY][9] is ctypes.c_float
    # the SpMM takes a value index and head and chunk strides (23
    # arguments, stream last)
    assert len(eps[_kernels.SPMM_ENTRY]) == 23
    # the hybrid's backward: the tile-grad kernel and its reduction (23 and
    # 16 arguments, stream last)
    assert len(eps[_kernels.TILE_GRAD_ENTRY]) == 23
    assert len(eps[_kernels.TILE_GRAD_REDUCE_ENTRY]) == 16


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from sddmm_tpu_torch import HybridSDDMM
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.reorder.autotune import from_params
    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=1)
    packed = from_params(csr, 128, alpha=0.3, delta=0.05).packed
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridSDDMM(packed, device="cuda")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _entry_points():
    """Every public constructor and function of the port that takes a
    device, by name."""
    # modules from sys.modules: ``sddmm_tpu_torch.ops.csr_sddmm`` is also a
    # function of ``sddmm_tpu_torch.ops``
    from importlib import import_module
    entry, batch, csr_sddmm, dense, hybrid, softmax, spmm = (
        import_module(f"sddmm_tpu_torch.{name}") for name in (
            "entry", "ops.batch", "ops.csr_sddmm", "ops.dense", "ops.hybrid",
            "ops.softmax", "ops.spmm"))
    from sddmm_tpu_torch.models import (BlockSparseAttention,
                                        GraphAttentionLayer,
                                        SparseFactorizationModel)
    return {
        "HybridSDDMM": hybrid.HybridSDDMM.__init__,
        "HybridSDDMM.from_csr": hybrid.HybridSDDMM.from_csr,
        "sddmm_hybrid": hybrid.sddmm_hybrid,
        "DenseSDDMM": dense.DenseSDDMM.__init__,
        "DenseSDDMM.from_csr": dense.DenseSDDMM.from_csr,
        "dense_masked_sddmm": dense.dense_masked_sddmm,
        "csr_sddmm": csr_sddmm.csr_sddmm,
        "csr_spmm": spmm.csr_spmm,
        "csr_softmax": softmax.csr_softmax,
        "batched_csr_sddmm": batch.batched_csr_sddmm,
        "GraphAttentionLayer": GraphAttentionLayer.__init__,
        "BlockSparseAttention": BlockSparseAttention.__init__,
        "entry": entry.entry,
        "SparseFactorizationModel": SparseFactorizationModel.__init__,
        "SparseFactorizationModel.from_csr":
            SparseFactorizationModel.from_csr,
    }


ENTRY_POINTS = ("HybridSDDMM", "HybridSDDMM.from_csr", "sddmm_hybrid",
                "DenseSDDMM", "DenseSDDMM.from_csr", "dense_masked_sddmm",
                "csr_sddmm", "csr_spmm", "csr_softmax", "batched_csr_sddmm",
                "GraphAttentionLayer", "BlockSparseAttention", "entry",
                "SparseFactorizationModel",
                "SparseFactorizationModel.from_csr")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name):
    """The port runs on the card unless the caller asks for the CPU: every
    entry point's ``device`` defaults to "cuda" (read from its
    signature)."""
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ["HybridSDDMM", "DenseSDDMM",
                                  "GraphAttentionLayer", "entry",
                                  "csr_softmax", "SparseFactorizationModel"])
def test_default_device_raises_without_a_card(name):
    """Without a card the default raises; it never falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from sddmm_tpu_torch.data import generate
    from sddmm_tpu_torch.entry import entry
    from sddmm_tpu_torch.models import (GraphAttentionLayer,
                                        SparseFactorizationModel)
    from sddmm_tpu_torch.ops.dense import DenseSDDMM
    from sddmm_tpu_torch.ops.hybrid import HybridSDDMM
    from sddmm_tpu_torch.ops.softmax import csr_softmax
    from sddmm_tpu_torch.reorder.autotune import from_params
    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=1)
    calls = {
        "HybridSDDMM": lambda: HybridSDDMM(
            from_params(csr, 32, alpha=0.3, delta=0.05).packed),
        "DenseSDDMM": lambda: DenseSDDMM(4, 4),
        "GraphAttentionLayer": lambda: GraphAttentionLayer(csr, 8, 8),
        "entry": entry,
        "csr_softmax": lambda: csr_softmax(csr, np.ones(csr.nnz)),
        "SparseFactorizationModel": lambda: SparseFactorizationModel.from_csr(
            csr, 8),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name]()
