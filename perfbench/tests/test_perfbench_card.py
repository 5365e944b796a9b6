"""Every cell on the card for one second: a result line that is correct.
Skips where there is no CUDA card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, TINY


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_on_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
