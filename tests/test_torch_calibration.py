"""The port's calibration of the layout model against the JAX package's:
``load_calibration`` field for field, the model under one loaded
calibration (``from_params``'s packing, the scores, the ranking), the
import-time autoload, and ``scripts/torch_calibrate.py``'s mechanics on the
CPU (its numbers there are the host's and mean nothing).  Both packages'
constants are the shipped ones at the start of every case and put back
after it.  Tolerances: the constants and packings exactly; the scores
within rel 1e-12 (the same float arithmetic in the same order)."""

import copy
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.reorder import autotune as ja
from sddmm_tpu_torch.data import generate as tgen
from sddmm_tpu_torch.reorder import autotune as ta
from torch_native_ready import reference_native_loaded  # noqa: F401

# the JAX package's layout model as shipped around each test
from test_torch_pack_parity import (_LAYOUT_MODEL, _SHIPPED, _put,  # noqa
                                    _shipped_layout_model, CONFIGS,
                                    _pair_csr, assert_same_packing,
                                    conftest_csrs)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_calibrate  # noqa: E402
import torch_calibration_fit  # noqa: E402

REL = 1e-12
#: a calibration in the card's range of rates (test input only)
CARD = {
    "stream_gbps": 3010.5,
    "row_rate_8mb": {"128": 910.0, "256": 820.0, "512": 615.0,
                     "1024": 352.0, "2048": 181.0},
    "src_factor": {"2": 1.04, "4": 1.02, "16": 0.99, "32": 0.95,
                   "64": 0.61, "128": 0.47, "256": 0.41},
    "dot_g16_ms": {f"{mode},{m}": rate * m / 16.0
                   for mode, rate in (("tf32", 210.0), ("mixed", 260.0),
                                      ("float16", 240.0),
                                      ("bfloat16", 520.0),
                                      ("float32", 120.0))
                   for m in (16, 32, 64, 128)},
}
THREE_MODES = {"stream_gbps": 2950.0,
               "row_rate_8mb": {"512": 600.0, "1024": 333.0},
               "dot_g16_ms": {k: v for k, v in CARD["dot_g16_ms"].items()
                              if k.split(",")[0] in ("tf32", "bfloat16",
                                                     "float32")}}

LOADS = {
    "three_modes_derived": [THREE_MODES],
    "all_five_modes": [CARD],
    "src_with_anchor": [{"src_factor": {"2": 1.1, "8": 1.0, "16": 0.9,
                                        "32": 0.8, "64": 0.5,
                                        "256": 0.3}}],
    "src_without_anchor_past_l2": [{"src_factor": {"4": 1.2, "48": 0.7,
                                                   "128": 0.4,
                                                   "512": 0.35}}],
    "unknown_keys": [dict(CARD, card="NVIDIA H100 80GB HBM3, 700.00 W",
                          device="cuda:0", platform="gpu", extra=[1, 2])],
    "derived_then_measured": [THREE_MODES, CARD],
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _shipped_port_model():
    """The port's layout model as shipped during the test, and as it was
    after it (``_SRC_MB`` and ``_SRC_F`` rebound, the dicts in place)."""
    saved = {name: copy.copy(getattr(ta, name)) for name in _LAYOUT_MODEL}
    for name in _LAYOUT_MODEL:
        _put(ta, name, getattr(_SHIPPED, name))
    yield
    for name, value in saved.items():
        _put(ta, name, value)


def _assert_same_model():
    for name in _LAYOUT_MODEL:
        x, y = getattr(ja, name), getattr(ta, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert type(x) is type(y) and x == y, name


def _load_both(cal):
    ja.load_calibration(copy.deepcopy(cal))
    ta.load_calibration(copy.deepcopy(cal))


@pytest.mark.parametrize("case", list(LOADS))
def test_loader_field_for_field(case):
    """One dict (or two in a row) through both loaders leaves the five
    measured constants equal, exactly."""
    for cal in LOADS[case]:
        _load_both(cal)
    _assert_same_model()
    if case == "three_modes_derived":
        assert ta._DOT_G16_MS[("mixed", 64)] == ta._DOT_G16_MS[("tf32", 64)]
        assert ta._DOT_G16_MS[("float16", 32)] == \
            ta._DOT_G16_MS[("bfloat16", 32)] / 3.0
    if case == "src_without_anchor_past_l2":
        assert list(ta._SRC_MB) == [0.0, 4.0, 8.0, 48.0, 128.0, 512.0, 1e9]
        assert list(ta._SRC_F) == [1.2, 1.2, 1.0, 0.7, 0.4, 0.35, 0.35]
    if case == "derived_then_measured":
        assert ta._DOT_G16_MS[("mixed", 16)] == 260.0e6
    if case == "unknown_keys":
        assert ta.STREAM_GBPS == CARD["stream_gbps"]


def test_loader_reads_a_path(tmp_path):
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(CARD))
    ta.load_calibration(path)
    ja.load_calibration(str(path))
    _assert_same_model()
    assert ta._ROW_RATE_8MB[2048] == 181.0


def test_shipped_constants_untouched_without_a_calibration():
    """No calibration loaded: the port's constants are JAX's as shipped."""
    _assert_same_model()
    assert ta.STREAM_GBPS == 856.0


@pytest.mark.parametrize("cfg_name", ["clustered16", "clustered128",
                                      "banded"])
@pytest.mark.parametrize("name", ["small_random", "clustered",
                                  "clustered16_quick", "powerlaw_quick"])
def test_from_params_identical_under_calibration(name, cfg_name,
                                                 conftest_csrs):
    """Under one loaded calibration both packages' ``from_params`` build
    the identical ``PackedMatrix`` with the same score; the calibration
    moves the score off the shipped one."""
    csr_j, csr_t = _pair_csr(name, conftest_csrs)
    cfg = CONFIGS[cfg_name]
    kw = dict(alpha=cfg["alpha"], delta=cfg["delta"],
              group_size=cfg.get("g", 1), k_chunks=cfg.get("c", 1),
              merge_superpanels=cfg.get("merge", True),
              sort_runs=cfg.get("sort_runs", "cid"),
              b_cost_scale=cfg.get("b_cost_scale", 1.0))
    shipped = ta.from_params(csr_t, 128, **kw).est_ms
    _load_both(CARD)
    tj = ja.from_params(csr_j, 128, **kw)
    tt = ta.from_params(csr_t, 128, **kw)
    assert_same_packing(tj.packed, tt.packed)
    assert tj.est_ms == tt.est_ms != shipped


@pytest.mark.parametrize("dtype", ["tf32", "mixed", "float16", "bfloat16",
                                   "float32"])
@pytest.mark.parametrize("k,c", [(32, 1), (128, 1), (128, 2), (256, 4)])
@pytest.mark.parametrize("case", ["three_modes_derived", "all_five_modes"])
def test_scores_equal_under_calibration(case, k, c, dtype):
    """``estimate_ms``, ``mxu_ms`` and ``estimate_dense_ms`` of both
    packages under one calibration, on a packing with every tile height,
    derived and measured mode rates."""
    csr_t = tgen.block_clustered(40, 40, block_prob=0.06, seed=21)
    csr_j = jgen.block_clustered(40, 40, block_prob=0.06, seed=21)
    for cal in LOADS[case]:
        _load_both(cal)
    tt = ta.from_params(csr_t, k, 0.3, 0.05, compute_dtype=dtype)
    tj = ja.from_params(csr_j, k, 0.3, 0.05, compute_dtype=dtype)
    assert_same_packing(tj.packed, tt.packed)
    for fn in ("estimate_ms", "mxu_ms"):
        args = (tt.packed, k, dtype) + ((c,) if fn == "estimate_ms" else ())
        jargs = (tj.packed, k, dtype) + ((c,) if fn == "estimate_ms"
                                         else ())
        assert getattr(ta, fn)(*args) == pytest.approx(
            getattr(ja, fn)(*jargs), rel=REL), fn
    for shape in ((96, 128, k), (4096, 4096, k), (100, 30000, k)):
        assert ta.estimate_dense_ms(*shape, dtype) == pytest.approx(
            ja.estimate_dense_ms(*shape, dtype), rel=REL)


@pytest.mark.parametrize("k", [32, 128])
def test_hub_candidates_equal_under_calibration(k):
    t = tgen.powerlaw_graph(2500, avg_degree=16, seed=44)
    j = jgen.powerlaw_graph(2500, avg_degree=16, seed=44)
    _load_both(CARD)
    assert ta.hub_candidates(t, k) == ja.hub_candidates(j, k)


def _describe(t):
    return (t.alpha, t.delta, t.merge_superpanels, t.group_size, t.k_chunks,
            t.hub_cols, t.hot_rows, t.dense)


def _ranked(module, csr, monkeypatch, k):
    """Every candidate of ``module.autotune`` in its score order (the list
    the shoot-out would pick from; nothing is timed)."""
    got = []

    def record(csr, k, candidates, *args):
        got[:] = list(candidates)
        return candidates[0]

    monkeypatch.setattr(module, "_shootout", record)
    kw = {"device": "cpu"} if module is ta else {}
    module.autotune(csr, k=k, measure=True, **kw)
    return [(_describe(c), c.est_ms) for c in got]


@pytest.mark.parametrize("name", [
    ("block_clustered", (24, 24), {"block_prob": 0.1, "seed": 33}),
    ("powerlaw_graph", (2500,), {"avg_degree": 16, "seed": 44}),
    ("random_sparse", (96, 128, 0.35), {"seed": 5})],
    ids=["block_clustered", "powerlaw", "dlmc_96x128"])
def test_autotune_ranks_identically_under_calibration(name, monkeypatch):
    """Under one calibration ``autotune(measure=False)`` picks JAX's
    winner, and the search scores every candidate as JAX does, in the same
    order."""
    fn, args, kw = name
    t, j = getattr(tgen, fn)(*args, **kw), getattr(jgen, fn)(*args, **kw)
    _load_both(CARD)
    win_t, win_j = ta.autotune(t, k=64), ja.autotune(j, k=64)
    assert _describe(win_t) == _describe(win_j)
    assert win_t.est_ms == pytest.approx(win_j.est_ms, rel=REL)
    got, want = (_ranked(ta, t, monkeypatch, 64),
                 _ranked(ja, j, monkeypatch, 64))
    assert [d for d, _ in got] == [d for d, _ in want]
    assert len(got) > 3
    for (_, x), (_, y) in zip(got, want):
        assert x == pytest.approx(y, rel=REL)


def _import_constants(env_value):
    code = ("import json, sys\n"
            "sys.modules['jax'] = None\n"
            "from sddmm_tpu_torch.reorder import autotune as a\n"
            "print(json.dumps({'stream': a.STREAM_GBPS,"
            " 'tf32_16': a._DOT_G16_MS[('tf32', 16)],"
            " 'src_mb': list(a._SRC_MB)}))\n")
    env = {k: v for k, v in os.environ.items()
           if k != "SDDMM_TPU_CALIBRATION"}
    env["SDDMM_TPU_CALIBRATION"] = str(env_value)
    return subprocess.run([sys.executable, "-W", "always", "-c", code],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_autoload_from_the_environment(tmp_path):
    """``SDDMM_TPU_CALIBRATION`` loads the file when the port is imported
    (without jax)."""
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(CARD))
    res = _import_constants(path)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["stream"] == CARD["stream_gbps"]
    assert got["tf32_16"] == CARD["dot_g16_ms"]["tf32,16"] * 1e6
    assert got["src_mb"] == [0.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                             256.0, 1e9]


def test_autoload_of_a_missing_file_warns(tmp_path):
    """A bad path warns and keeps the shipped constants."""
    res = _import_constants(tmp_path / "missing.json")
    assert res.returncode == 0, res.stderr
    assert "not loaded" in res.stderr and "shipped constants" in res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["stream"] == 856.0
    assert got["tf32_16"] == 11.5e6
    assert got["src_mb"] == list(_SHIPPED._SRC_MB)


JAX_KEYS = {"stream_gbps", "row_rate_8mb", "src_factor", "dot_g16_ms"}


def test_calibrate_script_on_cpu(tmp_path, capsys):
    """``--quick --device cpu`` writes the JAX schema plus ``card``, every
    rate above 0, and both loaders read the file to equal constants."""
    out = tmp_path / "cal.json"
    assert torch_calibrate.main(["--quick", "--device", "cpu", "-o",
                                 str(out)]) == 0
    cal = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip()) == cal
    assert JAX_KEYS | {"card", "device", "platform"} == set(cal)
    assert cal["card"] == "cpu" and cal["platform"] == "cpu"
    assert cal["stream_gbps"] > 0
    assert set(cal["row_rate_8mb"]) == {"128", "256", "512", "1024", "2048"}
    assert set(cal["src_factor"]) == {"2", "4", "16", "32", "64", "128",
                                      "256"}
    assert set(cal["dot_g16_ms"]) == {f"{mode},{m}" for mode in
                                      ("tf32", "mixed", "float16",
                                       "bfloat16", "float32")
                                      for m in (16, 32, 64, 128)}
    rates = (list(cal["row_rate_8mb"].values())
             + list(cal["src_factor"].values())
             + list(cal["dot_g16_ms"].values()))
    assert all(r > 0 and math.isfinite(r) for r in rates)
    ja.load_calibration(str(out))
    ta.load_calibration(out)
    _assert_same_model()
    assert ta._DOT_G16_MS[("mixed", 16)] == \
        cal["dot_g16_ms"]["mixed,16"] * 1e6


def test_calibrate_script_reads_the_jax_schema(tmp_path):
    """The JAX script's file (no ``card``, three modes) loads into the
    port as into JAX."""
    jax_file = tmp_path / "jax_cal.json"
    jax_file.write_text(json.dumps(dict(THREE_MODES, device="TPU_0",
                                        platform="tpu",
                                        src_factor={"2": 4.0, "4": 1.1,
                                                    "16": 0.45,
                                                    "32": 0.4})))
    ta.load_calibration(jax_file)
    ja.load_calibration(jax_file)
    _assert_same_model()


def test_calibrate_script_raises_without_a_card(tmp_path):
    """The default device is the card; without one the script raises and
    writes nothing."""
    out = tmp_path / "cal.json"
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_calibrate.main(["--quick", "-o", str(out)])
    assert not out.exists()


def test_dot_calls_counts_the_sessions():
    """The launches a dot probe adds on the card: every session's timed
    calls and warm-ups."""
    assert torch_calibrate.dot_calls() == 5 * (200 + 3)
    assert torch_calibrate.dot_calls(quick=True) == 2 * (3 + 3)
    assert torch_calibrate.dot_calls(iterations=50) == 5 * (50 + 3)


def test_fit_helpers():
    """The fit's statistics: Spearman against scipy, the |log| spread, and
    a winner that shares the model's best score with its twin."""
    from scipy.stats import spearmanr
    est = [1.0, 2.0, 2.0, 4.0, 3.5]
    meas = [0.5, 0.8, 0.7, 2.0, 3.0]
    assert torch_calibration_fit.spearman(est, meas) == pytest.approx(
        spearmanr(est, meas).statistic, rel=1e-12)
    assert math.isnan(torch_calibration_fit.spearman([1, 1], [1, 2]))
    fins = [{"config": {"alpha": 0.1}, "est_ms": 1.0, "measured_ms": 0.5},
            {"config": {"alpha": 0.1, "pallas": True}, "est_ms": 1.0,
             "measured_ms": 0.4},
            {"config": {"alpha": 0.3}, "est_ms": 2.0, "measured_ms": 2.0}]
    s = torch_calibration_fit.fit_stats(fins)
    assert s["finalists"] == 3 and s["top_is_winner"]
    assert s["winner"] == {"alpha": 0.1, "pallas": True}
    assert s["median_abs_log"] == pytest.approx(math.log(2.0))
    assert s["worst_abs_log"] == pytest.approx(math.log(2.5))
    fins[1]["est_ms"] = 1.5
    assert not torch_calibration_fit.fit_stats(fins)["top_is_winner"]


def test_fit_snapshot_restores_the_shipped_model():
    saved = torch_calibration_fit.snapshot()
    ta.load_calibration(CARD)
    assert ta.STREAM_GBPS != 856.0
    torch_calibration_fit.restore(saved)
    for name in torch_calibration_fit.CONSTANTS:
        x, y = getattr(_SHIPPED, name), getattr(ta, name)
        assert (np.array_equal(x, y) if isinstance(x, np.ndarray)
                else x == y), name


def test_fit_reads_the_breadth_suite_logs():
    """The committed uncalibrated breadth suite at K=128: bsmr over csr
    0.96x, an ablation ahead of the pick on 22 of 28 matrices."""
    s = torch_calibration_fit.baselines_summary(
        ROOT / "results" / "torch_synth_suite_logs", 128)
    assert s["matrices"] == 28
    assert round(s["bsmr_over_csr"], 2) == 0.96
    assert len(s["ablation_beats_pick"]) == 22


def test_fit_shootout_on_cpu():
    """The fit's measured shoot-out on the CPU: every finalist scored and
    timed, fastest first."""
    csr = tgen.block_clustered(24, 24, block_prob=0.1, seed=33)
    fins = torch_calibration_fit.shootout(csr, 32, 1, "cpu")
    assert len(fins) >= 2
    assert all(f["est_ms"] > 0 and f["measured_ms"] > 0 for f in fins)
    assert [f["measured_ms"] for f in fins] == sorted(
        f["measured_ms"] for f in fins)
    s = torch_calibration_fit.fit_stats(fins)
    assert -1.0 <= s["spearman"] <= 1.0 or math.isnan(s["spearman"])
