"""The port's harness scripts (``scripts/torch_*.py``) against the JAX
package's (``scripts/*.py``) on the CPU: each pair runs on the same small
seeded inputs, the port's with ``--device cpu``, and what they write is
held to each other.

Tolerances: files, logs' untimed fields, checks, tables and clone arrays
are compared exactly (as text or bit for bit); only the sharded runner's
values are held to the single-device runner within ``SCALING_REL``.  The
fields a clock sets (GFLOPS, times, reordering milliseconds) and the
device name differ by nature and are left out (``TIMED``)."""

import csv
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sddmm_tpu.data import generate as jgen
from sddmm_tpu.data import io as jio
from sddmm_tpu.utils.logger import parse_log as jparse
from sddmm_tpu_torch.utils.logger import RunLog as TRunLog
from torch_native_ready import reference_native_loaded  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
sys.path.insert(0, str(SCRIPTS))

import analyze_results as j_analyze  # noqa: E402
import convert_mtx_to_npz as j_convert  # noqa: E402
import fetch_datasets as j_fetch  # noqa: E402
import make_matched_clones as j_clones  # noqa: E402
import make_synth_suite as j_synth  # noqa: E402
import matched_clone_report as j_report  # noqa: E402
import run_baselines as j_baselines  # noqa: E402
import run_bench_suite as j_suite  # noqa: E402
import torch_analyze_results as t_analyze  # noqa: E402
import torch_convert_mtx_to_npz as t_convert  # noqa: E402
import torch_fetch_datasets as t_fetch  # noqa: E402
import torch_make_matched_clones as t_clones  # noqa: E402
import torch_make_synth_suite as t_synth  # noqa: E402
import torch_matched_clone_report as t_report  # noqa: E402
import torch_plot_results as t_plot  # noqa: E402
import torch_run_baselines as t_baselines  # noqa: E402
import torch_run_bench_suite as t_suite  # noqa: E402
import torch_scaling_bench as t_scaling  # noqa: E402

CPU = ["--device", "cpu"]
# the fields a run's clock sets, and the device
TIMED = {"Device", "bsmr_rowReordering", "bsmr_colReordering",
         "bsmr_reordering", "bsmr_sddmm"}
# the sharded runner against the single-device one (max abs err / max
# |value|): the 'feat' sum adds two fp32 partials, one rounding
SCALING_REL = 1e-5
TOOLS = ["csr", "dense", "bsmr", "bsmr_dense_only", "bsmr_residual_only"]


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _untimed(entries):
    return {k: v for k, v in entries.items()
            if k not in TIMED and not k.endswith("_gflops")}


@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    """Two tiny matrices: one the tuner gives the dense class, one a
    hybrid packing."""
    d = tmp_path_factory.mktemp("mats")
    jio.save_mtx(d / "dlmc.mtx", jgen.random_sparse(96, 96, 0.3, seed=3))
    jio.save_mtx(d / "blocks.mtx", jgen.block_clustered(24, 24,
                                                        block_prob=0.05,
                                                        seed=4))
    return d


@pytest.fixture(scope="module")
def baseline_logs(matrices, tmp_path_factory):
    """Both run_baselines scripts with all five tools and --validate over
    the two matrices at K 16 and 32: (JAX's log dir, the port's)."""
    d = tmp_path_factory.mktemp("baselines")
    argv = [str(matrices), None, "--ks", "16", "32", "--validate",
            "--tools", *TOOLS]
    argv[1] = str(d / "jax")
    assert j_baselines.main(argv) == 0
    argv[1] = str(d / "torch")
    assert t_baselines.main(argv + CPU) == 0
    return d / "jax", d / "torch"


@pytest.mark.parametrize("name", ["powerlaw8", "uniform_1e3",
                                  "banded_narrow"])
def test_synth_suite_files_byte_equal(name, tmp_path):
    assert j_synth.main([str(tmp_path / "j"), "--only", name]) == 0
    assert t_synth.main([str(tmp_path / "t"), "--only", name] + CPU) == 0
    want = (tmp_path / "j" / f"{name}.mtx").read_bytes()
    assert (tmp_path / "t" / f"{name}.mtx").read_bytes() == want
    assert [p.name for p in (tmp_path / "t").iterdir()] == [f"{name}.mtx"]


def test_synth_suite_writes_past_the_filter(tmp_path, capsys):
    """An entry outside the reference's dataset filter (tall16x: n = 2048),
    where the JAX script's assertion stops: the port writes it, noted,
    byte-equal to JAX's generator and writer."""
    assert not t_synth.in_filter(t_synth.corpus()["tall16x"]())
    with pytest.raises(AssertionError):
        j_synth.main([str(tmp_path / "j"), "--only", "tall16x"])
    assert t_synth.main([str(tmp_path / "t"), "--only", "tall16x"]
                        + CPU) == 0
    assert "outside the reference's dataset filter" in capsys.readouterr().out
    jio.save_mtx(tmp_path / "want.mtx", j_synth.corpus()["tall16x"]())
    assert ((tmp_path / "t" / "tall16x.mtx").read_bytes()
            == (tmp_path / "want.mtx").read_bytes())
    assert list(j_synth.corpus()) == list(t_synth.corpus())


def test_convert_mtx_to_npz_arrays_equal(matrices, tmp_path):
    files = [str(p) for p in sorted(matrices.glob("*.mtx"))]
    assert j_convert.main(files + ["-o", str(tmp_path / "j")]) == 0
    assert t_convert.main(files + ["-o", str(tmp_path / "t")] + CPU) == 0
    for name in ("dlmc.npz", "blocks.npz"):
        with np.load(tmp_path / "j" / name) as want, \
                np.load(tmp_path / "t" / name) as got:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key], want[key]), key


def test_fetch_filter_keeps_and_moves_the_same(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    jio.save_mtx(src / "big.mtx", jgen.random_sparse(64, 64, 0.1, seed=1))
    jio.save_smtx(src / "sub" / "wide.smtx",
                  jgen.random_sparse(40, 80, 0.2, seed=2))
    jio.save_mtx(src / "sparse.mtx", jgen.random_sparse(64, 64, 0.01,
                                                        seed=3))
    (src / "broken.mtx").write_text("not a matrix\n")
    (src / "notes.md").write_text("skipped\n")
    for pkg, mod in (("j", j_fetch), ("t", t_fetch)):
        shutil.copytree(src, tmp_path / pkg)
        argv = ["filter", str(tmp_path / pkg), "--min-dim", "50",
                "--min-nnz", "100", "--move-to", "excluded"]
        assert mod.main((CPU if pkg == "t" else []) + argv) == 0

    def tree(root):
        return sorted(p.relative_to(root).as_posix()
                      for p in root.rglob("*") if p.is_file())

    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    assert set(tree(tmp_path / "t" / "excluded")) == {
        "wide.smtx", "sparse.mtx", "broken.mtx"}


def test_fetch_synth_writes_the_same(tmp_path, monkeypatch):
    """``synth``: the same four matrices to the same files (the writer
    recorded in place of writing: save_mtx's bytes are held equal above)."""
    from sddmm_tpu.data import io as jio_mod
    from sddmm_tpu_torch.data import io as tio_mod
    seen = {"j": {}, "t": {}}
    for pkg, mod in (("j", jio_mod), ("t", tio_mod)):
        monkeypatch.setattr(mod, "save_mtx", lambda path, csr, pkg=pkg:
                            seen[pkg].__setitem__(Path(path).name, csr))
    assert j_fetch.main(["synth", "--out", str(tmp_path / "j")]) == 0
    assert t_fetch.main(CPU + ["synth", "--out", str(tmp_path / "t")]) == 0
    assert sorted(seen["t"]) == sorted(seen["j"]) == [
        "banded.mtx", "clustered128.mtx", "clustered16.mtx", "powerlaw.mtx"]
    for name, want in seen["j"].items():
        got = seen["t"][name]
        assert (got.m, got.n) == (want.m, want.n)
        for field in ("row_ptr", "col_idx", "values"):
            assert np.array_equal(getattr(got, field), getattr(want, field))


def test_run_bench_suite_logs_match(matrices, tmp_path):
    argv = ["--ks", "16", "32", "--validate"]
    assert j_suite.main([str(matrices), str(tmp_path / "j")] + argv) == 0
    assert t_suite.main([str(matrices), str(tmp_path / "t")] + argv
                        + CPU) == 0
    for stem in ("dlmc", "blocks"):
        for k in (16, 32):
            want = jparse((tmp_path / "j" / stem / f"BSMR_tpu_k_{k}.log")
                          .read_text())
            got = jparse((tmp_path / "t" / stem / f"BSMR_torch_k_{k}.log")
                         .read_text())
            assert got["Device"] == "cpu" and float(got["bsmr_gflops"]) > 0
            assert "checkResults" not in got
            assert _untimed(got) == _untimed(want)


def test_run_baselines_checks_and_fields_match(baseline_logs):
    jdir, tdir = baseline_logs
    names = sorted(p.name for p in jdir.glob("*.log"))
    assert names == sorted(p.name for p in tdir.glob("*.log")) == [
        "blocks_k16.log", "blocks_k32.log", "dlmc_k16.log", "dlmc_k32.log"]
    for name in names:
        want = jparse((jdir / name).read_text())
        got = jparse((tdir / name).read_text())
        for tool in TOOLS:
            assert got[f"{tool}_check"] == want[f"{tool}_check"] == "PASS"
            assert float(got[f"{tool}_gflops"]) > 0
        assert float(got["bsmr_csr_order_gflops"]) > 0
        assert got["Device"] == "cpu"
        assert _untimed(got) == _untimed(want)
    assert jparse((tdir / "dlmc_k32.log").read_text())["bsmr_strategy"] \
        == "dense"
    assert "bsmr_strategy" not in jparse((tdir / "blocks_k32.log")
                                         .read_text())


def test_run_baselines_resume_and_truncate(matrices, tmp_path, capsys):
    """--resume skips a cell whose log has every tool; without it a rerun
    truncates the log it first writes, and a second tool pass of one
    invocation appends."""
    logs = tmp_path / "logs"
    argv = [str(matrices), str(logs), "--ks", "16", "--tools", "csr"] + CPU
    assert t_baselines.main(argv) == 0
    assert t_baselines.main(argv) == 0
    first = (logs / "blocks_k16.log").read_text()
    assert first.count("[File : ") == 1
    capsys.readouterr()
    assert t_baselines.main(argv + ["--resume"]) == 0
    assert "all Ks done, skipping" in capsys.readouterr().out
    assert (logs / "blocks_k16.log").read_text().count("[File : ") == 1
    assert t_baselines.main([str(matrices), str(logs), "--ks", "16",
                             "--tools", "csr", "dense", "--resume"]
                            + CPU) == 0
    text = (logs / "blocks_k16.log").read_text()
    assert text.startswith(first) and text.count("[File : ") == 2
    assert "[dense_gflops : " in text[len(first):]


def test_analyze_results_same_table(baseline_logs, tmp_path):
    """Both analyzers on JAX's logs give the same CSV, byte for byte, and
    the same geomeans; on each package's own logs, the same matrices,
    tools and untimed meta columns."""
    jdir, tdir = baseline_logs
    for k in (16, 32):
        want = j_analyze.collect(jdir, k)
        assert t_analyze.collect(jdir, k) == want
        assert t_analyze.geomean_speedups(want) == \
            j_analyze.geomean_speedups(want)
        assert j_analyze.main([str(jdir), "--k", str(k), "--out",
                               str(tmp_path / "j.csv"), "--hybrid"]) == 0
        assert t_analyze.main([str(jdir), "--k", str(k), "--out",
                               str(tmp_path / "t.csv"), "--hybrid"]
                              + CPU) == 0
        assert (tmp_path / "t.csv").read_bytes() == \
            (tmp_path / "j.csv").read_bytes()
        got = t_analyze.collect(tdir, k)
        assert sorted(got) == sorted(want) == ["blocks", "dlmc"]
        for m in want:
            assert sorted(got[m]) == sorted(want[m])
            for meta in ("bsmr_numClusters", "bsmr_numDenseBlock",
                         "bsmr_averageDensity", "NNZ"):
                assert got[m][meta] == want[m][meta], (m, meta)


def test_plot_results_writes_four_figures(baseline_logs, tmp_path):
    pytest.importorskip("matplotlib")
    _, tdir = baseline_logs
    for fig in ("sddmm", "hybrid", "reordering", "overhead"):
        out = tmp_path / f"torch_{fig}_k32.png"
        assert t_plot.main([fig, str(tdir), "--k", "32", "--out", str(out)]
                           + CPU) == 0
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("name", ["HEP-th", "c-63"])
def test_matched_clone_arrays_equal(name):
    """The clone of a named matrix: the same arrays as JAX's calibrated()
    at the manifest's sizes, and the manifest's clone_nnz."""
    manifest = json.loads((ROOT / "results" / "matched_clones_manifest.json")
                          .read_text())
    rec = t_clones.ref_rows()[name]
    assert rec == {key: manifest[f"clone_{name}"][key]
                   for key in ("m", "n", "nnz", "ref_bsmr_gflops")}
    cls, params = t_clones.RECIPES[name]
    assert j_clones.RECIPES[name] == (cls, params)
    want = j_clones.calibrated(cls, rec["m"], rec["n"], rec["nnz"], params)
    got = t_clones.calibrated(cls, rec["m"], rec["n"], rec["nnz"], params)
    assert got.shape == want.shape
    for field in ("rows", "cols", "values"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.to_csr().nnz == manifest[f"clone_{name}"]["clone_nnz"]


def test_make_matched_clones_main(tmp_path, monkeypatch):
    """main() over a two-clone manifest: the two .smtx files and a
    manifest whose entries equal the committed ones."""
    committed = json.loads((ROOT / "results" /
                            "matched_clones_manifest.json").read_text())
    assert set(t_clones.ref_rows()) == set(t_clones.RECIPES)
    two = {k: committed[k] for k in ("clone_HEP-th", "clone_c-63")}
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps(two))
    monkeypatch.setattr(t_clones, "REF_MANIFEST", ref)
    assert t_clones.main([str(tmp_path / "out")] + CPU) == 0
    got = json.loads((tmp_path / "out" / "manifest.json").read_text())
    assert got == two
    assert sorted(p.name for p in (tmp_path / "out").glob("*.smtx")) == [
        "clone_HEP-th.smtx", "clone_c-63.smtx"]


def test_matched_clone_report_rows(tmp_path):
    """A hand-written two-clone manifest and logs: the port's rows are
    JAX's with the tpu_* columns named for the card, plus the log's
    device."""
    clones, logs = tmp_path / "clones", tmp_path / "logs"
    clones.mkdir()
    logs.mkdir()
    manifest = {
        "clone_A": dict(m=100, n=120, nnz=5000, ref_bsmr_gflops=2000.0,
                        clone_class="banded", clone_nnz=4900,
                        nnz_match=0.98),
        "clone_B": dict(m=300, n=300, nnz=9000, ref_bsmr_gflops=1500.5,
                        clone_class="powerlaw", clone_nnz=9100,
                        nnz_match=1.011),
    }
    (clones / "manifest.json").write_text(json.dumps(manifest))
    for name, (bsmr_ms, csr) in {"clone_A": (0.5, 812.25),
                                 "clone_B": (0.25, 1999.9)}.items():
        log = TRunLog(input_file=f"{name}.smtx", device="cuda:Card X",
                      k=128, sddmm_time_ms=bsmr_ms)
        log.m = log.n = 100
        log.nnz = manifest[name]["clone_nnz"]
        # a second pass's placeholder after the measured values
        (logs / f"{name}_k128.log").write_text(
            log.print_log() + f"[csr_gflops : {csr}]\n"
            + "[bsmr_gflops : 0.0]\n[csr_gflops : 0.0]\n")
    assert j_report.main([str(clones), str(logs), "-o",
                          str(tmp_path / "j.csv")]) == 0
    assert t_report.main([str(clones), str(logs), "-o",
                          str(tmp_path / "t.csv")] + CPU) == 0
    want = list(csv.DictReader((tmp_path / "j.csv").open()))
    got = list(csv.DictReader((tmp_path / "t.csv").open()))
    rename = {"tpu_bsmr_gflops": "card_bsmr_gflops",
              "tpu_csr_gflops": "card_csr_gflops"}
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.pop("device") == "cuda:Card X"
        assert g == {rename.get(k, k): v for k, v in w.items()}
    assert float(got[0]["card_bsmr_gflops"]) > 0


def test_scaling_bench_matches_jax(capsys):
    """1, 2 and 4 ranks over gloo on the CPU against JAX's --virtual 4:
    the same meshes, the sharded values within SCALING_REL of the
    single-device runner, and the packed step's all-reduce and all-gather
    counts equal to JAX's compiled-HLO counts."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(SCRIPTS / "scaling_bench.py"),
                          "--virtual", "4", "--iterations", "2"],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    assert t_scaling.main(["--virtual", "4", "--iterations", "2"]
                          + CPU) == 0
    out = capsys.readouterr().out
    got = json.loads(out.strip().splitlines()[-1])
    assert "ranks share the CPU: not a scaling number" in out
    assert got["virtual"] and want["virtual"] and got["k"] == want["k"]
    assert got["backend"] == "gloo" and got["device"] == "cpu"
    assert [r["devices"] for r in got["results"]] == [1, 2, 4] == [
        r["devices"] for r in want["results"]]
    for g, w in zip(got["results"], want["results"]):
        assert g["mesh"] == w["mesh"]
        assert g["max_rel_err"] < SCALING_REL
        for kind in ("all-reduce", "all-gather"):
            assert g["collectives"][kind] == w["collectives"][kind], kind
        assert g["tile_balance_max_over_mean"] == \
            w["tile_balance_max_over_mean"]
        assert g["nnz_per_s"] > 0


PORTED = {  # script -> the arguments of a run that would need a device
    "torch_make_synth_suite": ["OUT", "--only", "powerlaw8"],
    "torch_convert_mtx_to_npz": ["M.mtx", "-o", "OUT"],
    "torch_fetch_datasets": ["synth", "--out", "OUT"],
    "torch_run_bench_suite": ["MATS", "OUT"],
    "torch_run_baselines": ["MATS", "OUT"],
    "torch_analyze_results": ["LOGS"],
    "torch_plot_results": ["sddmm", "LOGS"],
    "torch_make_matched_clones": ["OUT"],
    "torch_matched_clone_report": ["CLONES", "LOGS"],
    "torch_scaling_bench": ["--devices", "1"],
    "torch_calibrate": ["--quick", "-o", "OUT/cal.json"],
    "torch_calibration_fit": ["OUT"],
    "torch_probe_configs": ["--configs", "a=0.3,d=0.05"],
    "torch_update_tuned_configs": ["LOG", "--matrix", "banded", "--k",
                                   "128"],
    "torch_probe_dense_dlmc": [],
    "torch_autofold": ["LOGS", "--validate", "--configs", "OUT/h100.json"],
    "torch_probe_hub": [],
    "torch_probe_dtype": [],
    "torch_probe_variance": [],
    "torch_probe_breakdown": [],
    "torch_probe_cluster": [],
    "torch_probe_csr_order": [],
    "torch_probe_gid_order": [],
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_script_raises_without_a_card(name, tmp_path, monkeypatch):
    """Each script runs on the card unless --device cpu is given: without
    a card the default raises before any work, and nothing writes."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    module = __import__(name)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(extra + PORTED[name])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", sorted(PORTED))
def test_script_help_without_jax(name):
    """--help of each script exits 0 in a process where importing jax or
    the JAX package fails."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['sddmm_tpu'] = None\n"
            f"sys.argv = [{str(SCRIPTS / (name + '.py'))!r}, '--help']\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "usage:" in res.stdout
