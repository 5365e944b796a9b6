"""Cells, configurations, traffic mixes and metrics are found by name, and a
new one is new files and entries alone."""

import json
import shutil

import pytest

from perfbench import cells, trace

BENCH = cells.load_benchmark()


def test_every_cell_resolves():
    for w in BENCH["workloads"]:
        cell = cells.cell(w["name"])
        assert cell.chips == 1
        assert cells.system(cell.config["system"]).build
        assert cells.loop(cell.traffic["loop"]).Loop
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) == 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names


def test_every_metric_has_a_reader_that_finds_nothing_elsewhere():
    empty = trace.Records(kind="none")
    for m in BENCH["per_layer"]:
        assert cells.reader(m["name"])(empty) is None


def test_configs_and_files_agree():
    for c in BENCH["configs"]:
        data = json.loads((cells.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        for key in c["reduced"]:
            assert key in data


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        cells.cell("no.such.cell")
    with pytest.raises(KeyError):
        cells.loop("no_such_loop")


def test_a_new_mix_is_data_alone(tmp_path):
    """A mix added as a file and a workload entry runs through the lookup
    of an unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "sddmm.powerlaw512k.k64", "config": "bsmr-sddmm-tf32",
        "traffic": "powerlaw512k.k64", "chips": 1, "why": "a throwaway mix"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sddmm.powerlaw512k.k128" in m.get("workloads", []):
            m["workloads"].append("sddmm.powerlaw512k.k64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "perfbench/traffic/powerlaw512k.k128.json")
                     .read_text())
    mix["k"] = 64
    (root / "perfbench/traffic/powerlaw512k.k64.json").write_text(json.dumps(mix))
    harness = (root / "perfbench").glob("*.py")
    before = {p.name: p.read_bytes() for p in harness}
    cell = cells.cell("sddmm.powerlaw512k.k64", root=root)
    assert cell.traffic["k"] == 64
    assert cell.config["system"] == "hybrid_sddmm"
    assert {m["name"] for m in cell.per_layer} >= {"host_ms.sddmm",
                                                   "mfu.sddmm"}
    assert cells.loop(cell.traffic["loop"], root=root).Loop
    harness = (root / "perfbench").glob("*.py")
    after = {p.name: p.read_bytes() for p in harness}
    assert before == after


def test_a_new_metric_is_a_file_and_an_entry(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({
        "name": "calls_traced.sddmm", "unit": "calls", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "sddmm_gflops", "workloads": ["sddmm.powerlaw512k.k128"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "perfbench/metrics/calls_traced.sddmm.py").write_text(
        "def read(records):\n    return records.calls or None\n")
    cell = cells.cell("sddmm.powerlaw512k.k128", root=root)
    assert "calls_traced.sddmm" in {m["name"] for m in cell.per_layer}
    read = cells.reader("calls_traced.sddmm", root=root)
    assert read(trace.Records(kind="sddmm", calls=7)) == 7


def test_merge_nests():
    assert cells.merge({"a": {"b": 1, "c": 2}, "d": 3},
                       {"a": {"b": 5}}) == {"a": {"b": 5, "c": 2}, "d": 3}
