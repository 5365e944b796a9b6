"""The port's bench route against the repo's ``bench.py``: the same config
validation errors, the same configs picked on the ``--quick`` matrices,
the same speed-of-light bytes, and one JSON line with the JAX bench's keys
(and the port's own) from a CPU run.  Counts and errors compared exactly;
``sol_ms_of`` within rel 1e-12 (the same float arithmetic)."""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import bench as jbench  # noqa: E402

from sddmm_tpu.data import generate as jgen  # noqa: E402
from sddmm_tpu.reorder.autotune import autotune as j_autotune  # noqa: E402
from sddmm_tpu.reorder.autotune import from_params as j_from_params  # noqa
from sddmm_tpu_torch import bench  # noqa: E402
from sddmm_tpu_torch.data import generate as tgen  # noqa: E402
from sddmm_tpu_torch.reorder.autotune import from_params  # noqa: E402

# the JAX package's layout model as shipped around each test
from test_torch_pack_parity import _shipped_layout_model  # noqa: F401,E402

@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side (threads a worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_bench_validate.py's cases: (file text or None for no file)
CASES = {
    "missing file": None,
    "good entries": json.dumps({
        "_comment": "x",
        "k128": {"m1": {"alpha": 0.3, "delta": 0.05, "g": 2, "c": 1,
                        "merge": True, "hub": 2048, "pallas": True,
                        "a_layout": "panels"},
                 "m2": {"dense": True}}}),
    "bad a_layout": {"alpha": 0.3, "delta": 0.05, "a_layout": "panles"},
    "unknown key": {"alpha": 0.3, "delta": 0.05, "gg": 2},
    "missing delta": {"alpha": 0.3},
    "not a number": {"alpha": "0.3", "delta": 0.05},
    "not an int": {"alpha": 0.3, "delta": 0.05, "g": 2.5},
    "dense with extra": {"dense": True, "alpha": 0.3},
    "not an object": "not-a-dict",
    "bad dtype and sorts": {"alpha": 0.3, "delta": 0.0, "dtype": "fp8",
                            "sort_runs": "x", "sort_res": "y"},
    "bad JSON": "{nope",
    "bad K key": json.dumps({"q128": {}}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_validate_matches_jax(case, tmp_path, monkeypatch):
    path = tmp_path / "tuned_configs.json"
    text = CASES[case]
    if text is not None:
        if not isinstance(text, str) or text == "not-a-dict":
            text = json.dumps({"k128": {"m": text}})
        path.write_text(text)
    monkeypatch.setattr(jbench, "TUNED_CONFIGS", path)
    want = jbench.validate_tuned_configs()
    assert bench.validate_tuned_configs(path) == want
    assert bool(want) == (case not in ("missing file", "good entries"))


def test_committed_files_are_valid():
    assert bench.validate_tuned_configs() == []
    assert bench.validate_tuned_configs(bench.H100_CONFIGS) == []
    assert bench.TUNED_CONFIGS == jbench.TUNED_CONFIGS


SOL_CASES = {
    "clustered G1": ("block_clustered", (24, 24),
                     {"block_prob": 0.1, "seed": 33},
                     dict(alpha=0.3, delta=0.05)),
    "clustered G2 C2 residual": ("block_clustered", (24, 24),
                                 {"block_prob": 0.1, "noise_density": 0.01,
                                  "seed": 33},
                                 dict(alpha=0.3, delta=0.3, group_size=2,
                                      k_chunks=2)),
    "powerlaw slabs": ("powerlaw_graph", (2500,),
                       {"avg_degree": 16, "seed": 44},
                       dict(alpha=0.1, delta=0.05, hub_cols=256,
                            hot_rows=256, hot_rows_pre=True)),
}


@pytest.mark.parametrize("dtype", ["tf32", "mixed", "bfloat16"])
@pytest.mark.parametrize("case", list(SOL_CASES))
def test_sol_ms_of_counts_jax_bytes(case, dtype):
    fn, args, kw, cfg = SOL_CASES[case]
    t = from_params(getattr(tgen, fn)(*args, **kw), 64,
                    compute_dtype=dtype, **cfg)
    j = j_from_params(getattr(jgen, fn)(*args, **kw), 64,
                      compute_dtype=dtype, **cfg)
    got = bench.sol_ms_of(t.packed, 64, dtype, 856.0)
    assert got == pytest.approx(jbench.sol_ms_of(j.packed, 64, dtype),
                                rel=1e-12)


KEYS = ("metric", "value", "unit", "backend", "device", "stream_gbps",
        "vs_baseline", "per_matrix", "per_matrix_csr_order",
        "geomean_csr_order", "sol_fraction", "roofline_fraction",
        "speedup_vs_csr_same_chip", "geomean_vs_csr", "timing_sessions_ms",
        "tuning_s", "configs", "warnings")


def test_quick_on_cpu_prints_one_json_line(capsys):
    """``--quick --device cpu``: one JSON line with the keys, and for both
    quick matrices the config JAX's ``--quick`` path picks (its estimate-
    only autotune, bench.py:294-296)."""
    out = bench.main(["--quick", "--device", "cpu", "--sessions", "1",
                      "--iterations", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert all(key in out for key in KEYS)
    assert out["metric"] == "torch_hybrid_sddmm_geomean_gflops_k128"
    assert out["backend"] == "torch-cpu" and out["device"] == "cpu"
    assert out["stream_gbps"] is None
    names = ["clustered16", "powerlaw"]
    for key in ("per_matrix", "per_matrix_csr_order",
                "speedup_vs_csr_same_chip", "timing_sessions_ms",
                "tuning_s", "sol_fraction", "roofline_fraction"):
        assert sorted(out[key]) == names, key
    # GFLOPS are rounded to 0.1: a slow CPU run may read 0.0
    assert all(ms[0] > 0 for ms in out["timing_sessions_ms"].values())
    assert all(v is None for v in out["roofline_fraction"].values())
    assert "value_4matrix" not in out
    jsuite = jbench.suite(True)
    for name in names:
        want = j_autotune(jsuite[name](), k=128, compute_dtype="tf32",
                          measure=False)
        assert out["configs"][name] == bench.config_of(want, "tf32")


def test_retune_saves_the_h100_file(tmp_path, monkeypatch, capsys):
    """``--retune --save-tuned`` writes every winner, valid and naming the
    device, into the port's own file (never the reference's), and the
    bench reads it back through ``--tuned-configs``."""
    saved = tmp_path / "tuned_configs_h100.json"
    monkeypatch.setattr(bench, "H100_CONFIGS", saved)
    quick_suite = bench.suite
    monkeypatch.setattr(bench, "suite", lambda quick: quick_suite(True))
    ref = bench.TUNED_CONFIGS.read_text()
    out = bench.main(["--retune", "--save-tuned", "--device", "cpu",
                      "--sessions", "1", "--iterations", "2", "--k", "64"])
    assert bench.TUNED_CONFIGS.read_text() == ref
    data = json.loads(saved.read_text())
    assert "cpu" in data["_comment"]
    assert data["k64"] == out["configs"]
    assert bench.validate_tuned_configs(saved) == []
    again = bench.main(["--tuned-configs", str(saved), "--device", "cpu",
                        "--sessions", "1", "--iterations", "2", "--k", "64"])
    assert again["configs"] == out["configs"]
    capsys.readouterr()


def test_config_of_folds_back():
    """``config_of`` of a folded config is the config (the twins' flags,
    the hub and the mode included)."""
    csr = tgen.powerlaw_graph(2500, avg_degree=16, seed=44)
    cfg = {"alpha": 0.1, "delta": 0.05, "g": 1, "c": 1, "merge": True,
           "hub": 256, "pallas": True, "a_layout": "panels",
           "dtype": "mixed"}
    t = bench.fold_config(csr, 64, cfg, "mixed")
    assert bench.config_of(t, "mixed") == cfg
