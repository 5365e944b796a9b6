"""The readers of the program's own span table and launch counter
(``sddmm_tpu_torch.utils.profiling``): found by name, None off the card
and on an empty table, and the expected number from a hand-built table."""

import json

import pytest

from conftest import TINY
from perfbench import cells, trace

RUN = cells._module(cells.HERE / "run.py", "perfbench.run_main")

#: metric -> (loop kind, the hand-built table's expected reading)
PROGRAM_METRICS = {
    "prepare_ms.sddmm": ("sddmm", 0.65),
    "to_csr_ms.sddmm": ("sddmm", 0.27),
    "launch_us.train": ("train", 12.5),
}

#: a summary() as the card would give it
TABLE = {
    "spans": {
        "hybrid.prepare": {"count": 100, "host_ms": 9.0, "self_ms": 9.0,
                           "device_ms": 0.65, "queue_ms": 30.0,
                           "parents": {}},
        "hybrid.to_csr": {"count": 100, "host_ms": 4.0, "self_ms": 4.0,
                          "device_ms": 0.27, "queue_ms": 31.0,
                          "parents": {}},
        "attention.forward": {"count": 1152, "host_ms": 900.0,
                              "self_ms": 100.0, "device_ms": 3.1,
                              "queue_ms": 42.0, "parents": {}},
    },
    "launch": {"count": 8, "host_ms": 0.1},
    "dropped": 0,
}

EMPTY = {"spans": {}, "launch": {"count": 0, "host_ms": 0.0}, "dropped": 0}


def _on_card(kind):
    """Records as a traced run on the card leaves them: device intervals."""
    return trace.Records(kind=kind, calls=1,
                         kernels=[("tile_table_kernel", 0.0, 1e-3)])


@pytest.fixture
def table(monkeypatch):
    from sddmm_tpu_torch.utils import profiling

    def put(summary):
        monkeypatch.setattr(profiling, "summary", lambda: summary)
    return put


def test_the_metrics_resolve_by_name():
    bench = cells.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, (kind, _) in PROGRAM_METRICS.items():
        assert callable(cells.reader(name))
        entry = entries[name]
        assert entry["source"] in ("program_span", "program_counter")
        (workload,) = entry["workloads"]
        cell = cells.cell(workload)
        assert name in {m["name"] for m in cell.per_layer}
        assert cells.loop(cell.traffic["loop"]).Loop.kind == kind


@pytest.mark.parametrize("name", sorted(PROGRAM_METRICS))
def test_reader_from_a_hand_built_table(name, table):
    kind, want = PROGRAM_METRICS[name]
    table(TABLE)
    assert cells.reader(name)(_on_card(kind)) == pytest.approx(want)
    # another loop's records, or a run with no device interval: nothing
    other = "train" if kind == "sddmm" else "sddmm"
    assert cells.reader(name)(_on_card(other)) is None
    assert cells.reader(name)(trace.Records(kind=kind)) is None


@pytest.mark.parametrize("name", sorted(PROGRAM_METRICS))
def test_reader_on_an_empty_table(name, table):
    table(EMPTY)
    assert cells.reader(name)(_on_card(PROGRAM_METRICS[name][0])) is None


def test_reader_without_the_table_in_the_program(monkeypatch):
    """A program with no span table (an older checkout) reads nothing."""
    from sddmm_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "summary")
    for name, (kind, _) in PROGRAM_METRICS.items():
        assert cells.reader(name)(_on_card(kind)) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_readers_none_on_the_cpu_rehearsal(cell, capsys):
    """The rehearsal's captures fill the table with host spans, without a
    device time or a launch: the line holds none of the new metrics, and
    each reader finds nothing in the table as the run left it."""
    from sddmm_tpu_torch.utils import profiling
    profiling.clear()
    rc = RUN.main(["--workload", cell, "--seed", str(2 ** 31 + 7),
                   "--seconds", "0.3", "--trace", "1",
                   "--rehearse-cpu", json.dumps(TINY[cell])])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not set(line["metrics"]) & set(PROGRAM_METRICS)
    spans = profiling.summary()["spans"]
    assert spans["hybrid.sddmm"]["count"] > 0
    assert spans["hybrid.sddmm"]["device_ms"] is None
    assert profiling.summary()["launch"]["count"] == 0
    kind = cells.loop(cells.cell(cell).traffic["loop"]).Loop.kind
    for name, (k, _) in PROGRAM_METRICS.items():
        if k == kind:
            assert cells.reader(name)(_on_card(kind)) is None
    profiling.clear()
