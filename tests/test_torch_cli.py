"""The port's CLI against the JAX package's on the same matrix file: every
log field that does not depend on time is equal (matrix shape and nnz,
reordering and packing statistics, grids, densities); run with
``--device cpu``.  Fields compared as text, exactly."""

import argparse
import copy

import pytest
import torch

from sddmm_tpu import cli as jcli
from sddmm_tpu.data import generate as jgen
from sddmm_tpu.data import io as jio
from sddmm_tpu.reorder.bsmr import BSMR as JBSMR
from sddmm_tpu.utils.logger import parse_log as jparse
from sddmm_tpu_torch import cli
from sddmm_tpu_torch.utils.logger import parse_log
from torch_native_ready import reference_native_loaded  # noqa: F401


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side (threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the fields a run's clock sets, and the device
TIMED = {"Device", "bsmr_rowReordering", "bsmr_colReordering",
         "bsmr_reordering", "bsmr_gflops", "bsmr_sddmm"}

MATRICES = {
    "clustered": lambda: jgen.block_clustered(12, 12, block_prob=0.25,
                                              seed=31),
    "dlmc": lambda: jgen.random_sparse(96, 96, 0.3, seed=3),
    "sparse": lambda: jgen.block_clustered(24, 24, block_prob=0.05, seed=4),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mats")
    out = {}
    for name, make in MATRICES.items():
        out[name] = d / f"{name}.mtx"
        jio.save_mtx(out[name], make())
    return out


def _untimed(entries):
    return {k: v for k, v in entries.items() if k not in TIMED}


RUNS = {
    "single": ("clustered", ["-k", "32"]),
    "validate": ("clustered", ["-k", "32", "--validate", "-a", "0.5",
                               "-d", "0.1"]),
    "tune dense": ("dlmc", ["-k", "32", "--tune", "--validate"]),
    "tune hybrid": ("sparse", ["-k", "32", "--tune", "--validate"]),
    "order csr, tf32": ("sparse", ["-k", "16", "--order", "csr",
                                   "--compute-dtype", "tf32"]),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_log_matches_jax(run, files, tmp_path, capsys):
    name, argv = RUNS[run]
    path = str(files[name])
    assert cli.main(["-f", path, *argv, "-l", str(tmp_path / "t"),
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    got = parse_log((tmp_path / "t" / f"BSMR_torch_k_{argv[1]}.log")
                    .read_text())
    assert parse_log(printed) == got
    assert jcli.main(["-f", path, *argv, "-l", str(tmp_path / "j")]) == 0
    want = jparse((tmp_path / "j" / f"BSMR_tpu_k_{argv[1]}.log").read_text())
    assert got["Device"] == "cpu"
    assert float(got["bsmr_gflops"]) > 0
    assert "checkResults" not in got
    assert _untimed(got) == _untimed(want)


def test_positional_fallback(files, capsys):
    """FILE K as positionals (reference include/Options.hpp:120-123); a
    missing file, a mix of -f and positionals and a K that is not an int
    are parser errors."""
    path = str(files["clustered"])
    assert cli.main([path, "16", "--device", "cpu"]) == 0
    got = parse_log(capsys.readouterr().out)
    assert jcli.main([path, "16"]) == 0
    want = jparse(capsys.readouterr().out)
    assert got["K"] == "16" and _untimed(got) == _untimed(want)
    for argv in ([], ["-f", path, path], [path, "x"]):
        with pytest.raises(SystemExit):
            cli.main(argv + ["--device", "cpu"])


def test_sweep_matches_jax(files, tmp_path, monkeypatch):
    """-t 1 with the grids cut: one log file per (K, alpha, delta), each
    equal to JAX's sweep cell on a shared row reordering."""
    monkeypatch.setattr(cli, "SWEEP_ALPHAS", (0.3,))
    monkeypatch.setattr(cli, "SWEEP_DELTAS", (0.0, 0.3))
    monkeypatch.setattr(cli, "SWEEP_KS", (16, 32))
    path = files["clustered"]
    assert cli.main(["-f", str(path), "-t", "1", "-l", str(tmp_path),
                     "--device", "cpu"]) == 0
    logs = {p.name for p in tmp_path.glob("*.log")}
    assert logs == {"BSMR_k_16_a_0.3_d_0.log", "BSMR_k_16_a_0.3_d_0.3.log",
                    "BSMR_k_32_a_0.3_d_0.log", "BSMR_k_32_a_0.3_d_0.3.log"}
    csr = jio.load(path)
    shared = JBSMR(0.3, 0.0, csr, compute=False)
    shared.run_row_reordering(csr)
    args = argparse.Namespace(file=str(path), iterations=10,
                              compute_dtype="float32", order="packed",
                              method="auto")
    for delta, dname in ((0.0, "0"), (0.3, "0.3")):
        for k in (16, 32):
            want = jparse(jcli._run_sweep_cell(
                csr, copy.copy(shared), k, 0.3, delta, args).print_log())
            got = parse_log((tmp_path / f"BSMR_k_{k}_a_0.3_d_{dname}.log")
                            .read_text())
            assert float(got["bsmr_gflops"]) > 0
            assert _untimed(got) == _untimed(want)
