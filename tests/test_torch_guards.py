"""Guards of the port: it never loads jax, never builds or runs a kernel
without the CUDA toolchain, never carries on silently on the CPU and never
reads a file of the JAX package; and every parity test holds the port to
the JAX package's native path."""

import ast
import ctypes
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_native_ready
from torch_native_ready import reference_native_loaded  # noqa: F401

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
        "import sddmm_tpu_torch.reorder.device_cluster\n"
        "import sddmm_tpu_torch.parallel, sddmm_tpu_torch.parallel.dryrun\n"
        "assert 'jax' not in sys.modules, 'jax loaded'\n"
        "assert 'sddmm_tpu' not in sys.modules, 'sddmm_tpu loaded'\n"
        "print('clean')\n")
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_entry_point_modules_do_not_load_jax():
    """The bench route, the CLI, the logger, the profiler, the timers and
    the search import neither jax nor the JAX package."""
    res = _python(
        "import sys\n"
        "import sddmm_tpu_torch.bench, sddmm_tpu_torch.cli\n"
        "import sddmm_tpu_torch.utils.logger, sddmm_tpu_torch.utils.util\n"
        "import sddmm_tpu_torch.utils.profiling\n"
        "import sddmm_tpu_torch.utils.timing\n"
        "import sddmm_tpu_torch.reorder.autotune\n"
        "assert 'jax' not in sys.modules, 'jax loaded'\n"
        "assert 'sddmm_tpu' not in sys.modules, 'sddmm_tpu loaded'\n"
        "print('clean')\n")
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


#: the harness scripts of the port, one per JAX script
HARNESS_SCRIPTS = ("torch_make_synth_suite", "torch_convert_mtx_to_npz",
                   "torch_fetch_datasets", "torch_run_bench_suite",
                   "torch_run_baselines", "torch_analyze_results",
                   "torch_plot_results", "torch_make_matched_clones",
                   "torch_matched_clone_report", "torch_scaling_bench",
                   "torch_calibrate", "torch_probe_configs",
                   "torch_update_tuned_configs", "torch_probe_dense_dlmc",
                   "torch_autofold", "torch_probe_hub", "torch_probe_dtype",
                   "torch_probe_variance", "torch_probe_breakdown",
                   "torch_probe_cluster", "torch_probe_csr_order",
                   "torch_probe_gid_order")


def test_no_jax_import_in_sources():
    """The port's package, the smoke run and the port's scripts import
    neither jax nor the JAX package."""
    paths = (list((ROOT / "sddmm_tpu_torch").rglob("*.py"))
             + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("torch_*.py")))
    # the multi-device path, the clustering, the smoke run and the harness
    # scripts are among them
    names = {p.relative_to(ROOT).as_posix() for p in paths}
    assert {"sddmm_tpu_torch/parallel/dist.py",
            "sddmm_tpu_torch/parallel/mesh.py",
            "sddmm_tpu_torch/parallel/launch.py",
            "sddmm_tpu_torch/parallel/dryrun.py",
            "sddmm_tpu_torch/reorder/device_cluster.py",
            "chip_smoke.py"} <= names
    assert {f"scripts/{s}.py" for s in HARNESS_SCRIPTS} <= names
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("from sddmm_tpu ")
                        or s.startswith("from sddmm_tpu.")
                        or s.startswith("import sddmm_tpu ")
                        or s.startswith("import sddmm_tpu.")), (path, line)


def _imports_jax_package(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        if any(n.split(".")[0] == "sddmm_tpu" for n in names):
            return True
    return False


def test_parity_tests_wait_for_the_jax_library():
    """Every test file that imports the JAX package requests the fixture
    that loads its native library first (tests/torch_native_ready.py)."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    checked = []
    for path in files:
        tree = ast.parse(path.read_text())
        if not _imports_jax_package(tree):
            continue
        checked.append(path.name)
        assert any(isinstance(node, ast.ImportFrom)
                   and node.module == "torch_native_ready"
                   and "reference_native_loaded" in
                   [a.name for a in node.names]
                   for node in tree.body), path.name
    assert "test_torch_pack_parity.py" in checked
    assert "test_torch_card.py" not in checked
    assert len(checked) >= 24


def _jax_package_path(node) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and (node.value == "sddmm_tpu"
                 or node.value.startswith("sddmm_tpu/")))


#: calls that take a path
PATH_CALLS = {"Path", "PurePath", "join", "joinpath", "open",
              "spec_from_file_location"}


def test_no_path_into_the_jax_package():
    """No file of the port joins a path into ``sddmm_tpu/`` (its data
    under ``results/`` is not the JAX package)."""
    for path in (list((ROOT / "sddmm_tpu_torch").rglob("*.py"))
                 + [ROOT / "chip_smoke.py"]
                 + sorted((ROOT / "scripts").glob("torch_*.py"))):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                operands = [node.left, node.right]
            elif isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(
                    f, "id", "")
                operands = node.args if name in PATH_CALLS else []
            else:
                continue
            assert not any(map(_jax_package_path, operands)), (
                path.relative_to(ROOT), node.lineno)
    for path in sorted((ROOT / "scripts").glob("torch_*.sh")):
        assert not re.search(r"(?<![\w/])sddmm_tpu/", path.read_text()), path


@pytest.mark.parametrize("library", ["there", "missing"])
def test_reference_native_fails_and_never_skips(library, monkeypatch,
                                                tmp_path):
    """Where the JAX package's library never loads, ``reference_native``
    fails the test with the reason: a parity test never skips for it."""
    from sddmm_tpu import native as jnative
    monkeypatch.setattr(jnative, "_load", lambda: None)
    if library == "missing":
        monkeypatch.setattr(jnative, "_LIB_PATH", tmp_path / "none.so")
    with pytest.raises(pytest.fail.Exception) as err:
        torch_native_ready.reference_native(timeout_s=0.2)
    assert "sddmm_tpu.native" in str(err.value)
    assert ("g++ build failed" in str(err.value)) == (library == "missing")


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
        "tile_grad.cu", "cluster_round.cu"}


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
    # (14 and 16 arguments since they take the plan of rows by class: its
    # rows and three counts, and the heads a group walks; stream last)
    assert len(eps[_kernels.SOFTMAX_ENTRY]) == 14
    assert len(eps[_kernels.SOFTMAX_BWD_ENTRY]) == 16
    assert eps[_kernels.SOFTMAX_ENTRY][8] is ctypes.c_float
    assert eps[_kernels.SOFTMAX_BWD_ENTRY][10] is ctypes.c_float
    # the SpMM takes a value index and head and chunk strides (23
    # arguments, stream last)
    assert len(eps[_kernels.SPMM_ENTRY]) == 23
    # the hybrid's backward: the tile-grad kernel and its reduction (23 and
    # 16 arguments, stream last)
    assert len(eps[_kernels.TILE_GRAD_ENTRY]) == 23
    assert len(eps[_kernels.TILE_GRAD_REDUCE_ENTRY]) == 16
    # the clustering round's two kernels, alpha a float: the leaders take
    # the clusters-a-round array and the host loop's bail_after, bail_yield
    # (a double) and max_rounds (16 arguments), the rows the live lists (13)
    lead = eps[_kernels.CLUSTER_LEADERS_ENTRY]
    assert len(lead) == 16 and lead[11] is ctypes.c_float
    assert lead[13] is ctypes.c_double
    rows = eps[_kernels.CLUSTER_ASSIGN_ENTRY]
    assert len(rows) == 13 and rows[11] is ctypes.c_float


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
    entry, batch, csr_sddmm, dense, hybrid, softmax, spmm, autotune = (
        import_module(f"sddmm_tpu_torch.{name}") for name in (
            "entry", "ops.batch", "ops.csr_sddmm", "ops.dense", "ops.hybrid",
            "ops.softmax", "ops.spmm", "reorder.autotune"))
    from sddmm_tpu_torch.models import (BlockSparseAttention,
                                        DistributedSparseFactorizationModel,
                                        GraphAttentionLayer,
                                        SparseFactorizationModel)
    from sddmm_tpu_torch.parallel import (DistributedDenseSDDMM,
                                          DistributedHybridSDDMM, make_mesh)
    from sddmm_tpu_torch.parallel.dryrun import dryrun_multichip
    from sddmm_tpu_torch.reorder.device_cluster import batched_cluster_device
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
        "autotune": autotune.autotune,
        "autotune_multi": autotune.autotune_multi,
        "batched_cluster_device": batched_cluster_device,
        "make_mesh": make_mesh,
        "DistributedHybridSDDMM": DistributedHybridSDDMM.__init__,
        "DistributedDenseSDDMM": DistributedDenseSDDMM.__init__,
        "DistributedDenseSDDMM.from_csr": DistributedDenseSDDMM.from_csr,
        "DistributedSparseFactorizationModel":
            DistributedSparseFactorizationModel.__init__,
        "DistributedSparseFactorizationModel.from_csr":
            DistributedSparseFactorizationModel.from_csr,
        "dryrun_multichip": dryrun_multichip,
    }


ENTRY_POINTS = ("HybridSDDMM", "HybridSDDMM.from_csr", "sddmm_hybrid",
                "DenseSDDMM", "DenseSDDMM.from_csr", "dense_masked_sddmm",
                "csr_sddmm", "csr_spmm", "csr_softmax", "batched_csr_sddmm",
                "GraphAttentionLayer", "BlockSparseAttention", "entry",
                "SparseFactorizationModel",
                "SparseFactorizationModel.from_csr", "autotune",
                "autotune_multi", "batched_cluster_device", "make_mesh",
                "DistributedHybridSDDMM", "DistributedDenseSDDMM",
                "DistributedDenseSDDMM.from_csr",
                "DistributedSparseFactorizationModel",
                "DistributedSparseFactorizationModel.from_csr",
                "dryrun_multichip")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name):
    """The port runs on the card unless the caller asks for the CPU: every
    entry point's ``device`` defaults to "cuda" (read from its
    signature)."""
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ["HybridSDDMM", "DenseSDDMM",
                                  "GraphAttentionLayer", "entry",
                                  "csr_softmax", "SparseFactorizationModel",
                                  "autotune measured",
                                  "batched_cluster_device",
                                  "HybridSDDMM.from_csr device clustering",
                                  "DistributedHybridSDDMM",
                                  "DistributedDenseSDDMM",
                                  "DistributedSparseFactorizationModel",
                                  "dryrun_multichip"])
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
    from sddmm_tpu_torch.reorder.autotune import autotune, from_params
    from sddmm_tpu_torch.models import DistributedSparseFactorizationModel
    from sddmm_tpu_torch.parallel import (DistributedDenseSDDMM,
                                          DistributedHybridSDDMM)
    from sddmm_tpu_torch.parallel.dryrun import dryrun_multichip
    from sddmm_tpu_torch.reorder.device_cluster import batched_cluster_device
    from sddmm_tpu_torch.reorder.rows import row_encodings
    csr = generate.block_clustered(8, 8, block_prob=0.3, seed=1)
    enc = row_encodings(csr, 16)
    calls = {
        "HybridSDDMM": lambda: HybridSDDMM(
            from_params(csr, 32, alpha=0.3, delta=0.05).packed),
        "DenseSDDMM": lambda: DenseSDDMM(4, 4),
        "GraphAttentionLayer": lambda: GraphAttentionLayer(csr, 8, 8),
        "entry": entry,
        "csr_softmax": lambda: csr_softmax(csr, np.ones(csr.nnz)),
        "SparseFactorizationModel": lambda: SparseFactorizationModel.from_csr(
            csr, 8),
        "autotune measured": lambda: autotune(csr, 32, measure=True),
        "batched_cluster_device": lambda: batched_cluster_device(
            np.arange(csr.m), *enc, 0.3),
        "HybridSDDMM.from_csr device clustering":
            lambda: HybridSDDMM.from_csr(csr, method="device"),
        # the device is checked before the mesh is read
        "DistributedHybridSDDMM": lambda: DistributedHybridSDDMM(
            from_params(csr, 32, alpha=0.3, delta=0.05).packed, None),
        "DistributedDenseSDDMM": lambda: DistributedDenseSDDMM(4, 4, None),
        "DistributedSparseFactorizationModel":
            lambda: DistributedSparseFactorizationModel.from_csr(csr, None,
                                                                 8),
        "dryrun_multichip": lambda: dryrun_multichip(4),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name]()


@pytest.mark.parametrize("name", ["bench", "cli"])
def test_bench_and_cli_raise_without_a_card(name, tmp_path):
    """``python -m sddmm_tpu_torch.bench`` and ``.cli`` run on the card
    unless ``--device cpu`` is given: without one they raise, and nothing
    runs on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from sddmm_tpu_torch import bench, cli
    from sddmm_tpu_torch.data import generate, io
    path = tmp_path / "m.mtx"
    io.save_mtx(path, generate.block_clustered(4, 4, block_prob=0.3, seed=1))
    argv = {"bench": ["--quick"], "cli": ["-f", str(path), "-k", "16"]}
    main = {"bench": bench.main, "cli": cli.main}[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv[name])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv[name] + ["--device", "cuda"])


def test_spawned_rank_does_not_load_jax():
    """A rank started by ``launch.spawn`` (a fresh interpreter) that
    imports the whole port, the multi-device path and the clustering
    among it, has neither jax nor the JAX package in sys.modules."""
    from sddmm_tpu_torch.parallel import launch
    import torch_parallel_worker as worker
    (mods,) = launch.spawn(1, worker.imported_modules, (), backend="gloo",
                           timeout_s=120)
    assert "sddmm_tpu_torch.parallel.dist" in mods
    assert "sddmm_tpu_torch.reorder.device_cluster" in mods
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")
                or m == "sddmm_tpu" or m.startswith("sddmm_tpu.")]


def _jax_all(subpackage: str) -> list:
    """The names in ``sddmm_tpu/<subpackage>/__init__.py``'s ``__all__``,
    read with ``ast`` (nothing of the JAX package imported)."""
    import ast
    tree = ast.parse((ROOT / "sddmm_tpu" / subpackage / "__init__.py")
                     .read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


#: a JAX name whose counterpart in the port has another name
COUNTERPART = {"time_jax_fn": "time_fn", "csr_sddmm_jax": "csr_sddmm_torch"}


@pytest.mark.parametrize("subpackage", ["data", "models", "ops", "parallel",
                                        "reorder", "utils"])
def test_subpackage_exports_match_jax(subpackage):
    """Every name a subpackage of the JAX package exports (``__all__``), or
    its named counterpart, imports from the port's subpackage of the same
    name."""
    from importlib import import_module
    names = _jax_all(subpackage)
    assert names, subpackage
    mod = import_module(f"sddmm_tpu_torch.{subpackage}")
    missing = [n for n in names if not hasattr(mod, COUNTERPART.get(n, n))]
    assert not missing, (subpackage, missing)


def test_utils_exports_timers_and_log():
    res = _python(
        "import sys\n"
        "from sddmm_tpu_torch.utils import Timer, RunLog, time_fn\n"
        "from sddmm_tpu_torch.utils import timing, logger\n"
        "assert Timer is timing.Timer and time_fn is timing.time_fn\n"
        "assert RunLog is logger.RunLog\n"
        "assert 'jax' not in sys.modules, 'jax loaded'\n"
        "print('clean')\n")
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
