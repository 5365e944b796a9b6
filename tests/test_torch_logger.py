"""The port's run logger against the JAX package's: the same ``[key :
value]`` lines for the same fields (the device line apart), the same parse,
and ``scripts/analyze_results.py`` reading a log directory the port's CLI
wrote.  Text is compared exactly: no tolerance."""

import sys
from pathlib import Path

import pytest
import torch

from sddmm_tpu.utils import logger as jlog
from sddmm_tpu_torch import cli
from sddmm_tpu_torch.data import generate, io
from sddmm_tpu_torch.utils import logger as tlog

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side (threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = {
    "defaults": {},
    "a run": dict(input_file="m/x.mtx", k=128, alpha=0.3, delta=0.1,
                  num_iterations=10, num_row_panels=12, num_clusters=8,
                  num_dense_block=37, average_density=0.245,
                  original_num_dense_block=19,
                  original_average_density=0.3686, row_reordering_ms=0.57,
                  col_reordering_ms=0.64, packing_ms=2.0,
                  dense_grid=(0, 2, 2, 0), sparse_grid=(206, 0, 0),
                  num_dense_data=6034, num_sparse_data=206,
                  sddmm_time_ms=2.11, m=192, n=192, nnz=6240,
                  sparsity=0.8307, tile_k=128),
    "a failed check": dict(k=32, nnz=5000, sddmm_time_ms=0.5,
                           error_rate=0.0123, matrix_a_type="tf32",
                           matrix_b_type="tf32"),
}


@pytest.mark.parametrize("case", list(FIELDS))
def test_print_log_matches_jax(case):
    """The same lines as JAX's RunLog but the device's, which is the
    run's own device here."""
    fields = FIELDS[case]
    got = tlog.RunLog(device=tlog.device_name("cpu"), **fields).print_log()
    want = jlog.RunLog(**fields).print_log()
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert got_lines[2] == "[Device : cpu]"
    assert want_lines[2].startswith("[Device : ")
    del got_lines[2], want_lines[2]
    assert got_lines == want_lines


TEXTS = {
    "one log": jlog.RunLog(k=64, nnz=10, sddmm_time_ms=1.0).print_log(),
    "two passes": ("[K : 32], [NNZ : 10]\n[bsmr_gflops : 12.5]\n"
                   "[csr_gflops : 0.0]\n[K : 32]\n[bsmr_gflops : 0.0]\n"
                   "[csr_gflops : 3.0]\n[bsmr_dataRatio: 1.50]\n"),
    "junk": "no brackets\n[unterminated\n[a : b] [c: d] [e]\n",
}


@pytest.mark.parametrize("prefer", [(), ("_gflops",)],
                         ids=["last-wins", "prefer_nonzero"])
@pytest.mark.parametrize("name", list(TEXTS))
def test_parse_log_matches_jax(name, prefer):
    text = TEXTS[name]
    assert tlog.parse_log(text, prefer_nonzero=prefer) == jlog.parse_log(
        text, prefer_nonzero=prefer)


def test_device_name():
    assert tlog.device_name("cpu") == "cpu"


def test_analyze_results_reads_the_port_logs(tmp_path, monkeypatch):
    """A single run and a (cut) sweep of the port's CLI: analyze_results
    collects both, by the matrix's file stem."""
    import analyze_results
    path = tmp_path / "demo.mtx"
    io.save_mtx(path, generate.block_clustered(8, 8, block_prob=0.3,
                                               seed=31))
    logs = tmp_path / "logs"
    assert cli.main(["-f", str(path), "-k", "16", "-l", str(logs / "one"),
                     "--device", "cpu"]) == 0
    monkeypatch.setattr(cli, "SWEEP_ALPHAS", (0.3,))
    monkeypatch.setattr(cli, "SWEEP_DELTAS", (0.3,))
    monkeypatch.setattr(cli, "SWEEP_KS", (16, 32))
    assert cli.main(["-f", str(path), "-t", "1", "-l", str(logs / "sweep"),
                     "--device", "cpu"]) == 0
    for k in (16, 32):
        table = analyze_results.collect(logs, k)
        assert table["demo"]["bsmr"] > 0
        assert table["demo"]["NNZ"] > 0
