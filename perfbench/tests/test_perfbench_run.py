"""The command end to end on the CPU: the rehearsal through the kernels'
plain versions at tiny sizes, the result line's shape, and the refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, TINY

CMD = [sys.executable, "perfbench/run.py"]
ENV = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")


def _run(args, cwd=ROOT):
    return subprocess.run(CMD + args, cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_rehearsal_line(cell, trace):
    p = _run(["--workload", cell, "--seed", str(2 ** 31 + 12345),
              "--seconds", "0.5", "--trace", str(trace),
              "--rehearse-cpu", json.dumps(TINY[cell])])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "cpu"
    assert line["attempted"] > 0
    for name, m in line["checks"].items():
        assert set(m) == {"value", "limit"}
        assert f"check {name} = " in p.stderr
    assert p.stderr.strip().splitlines()[-1].startswith("perfbench: check")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m["unit"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    if trace == 0:
        assert {k: v["unit"] for k, v in line["metrics"].items()} == e2e
    else:
        # off the card only the host's metric has something to read
        kind = "train" if cell.startswith("longformer") else "sddmm"
        assert set(line["metrics"]) == {f"host_ms.{kind}"}
        assert "busy_s" not in line["device"]


def test_no_card_no_result():
    p = _run(["--workload", "sddmm.powerlaw512k.k128", "--seed", "1",
              "--seconds", "1", "--trace", "0"])
    assert p.returncode == 2
    assert p.stdout == ""
    assert "torch.cuda.is_available() is false" in p.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "sddmm.powerlaw512k.k128", "--seed", "1",
              "--seconds", "1", "--trace", "0",
              "--rehearse-cpu", json.dumps(TINY["sddmm.powerlaw512k.k128"])],
             cwd=tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()
