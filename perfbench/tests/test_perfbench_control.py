"""The controls come out not correct under every cell's limits: the
reference put in the program's place, computed in the precisions below
the configuration's (TF32, then bfloat16), fails at least one number of
the cell, while the program passes them all.  At the tiny sizes of
``conftest.TINY`` on the CPU; on the card at the cells' own sizes it is
``perfbench/limits.py``."""

import json

import pytest
import torch

from conftest import TINY
from perfbench import cells


def _loop(cell_name, seed):
    cell = cells.cell(cell_name)
    cell.config = cells.merge(cell.config, TINY[cell_name].get("config", {}))
    cell.traffic = cells.merge(cell.traffic,
                               TINY[cell_name].get("traffic", {}))
    system_mod = cells.system(cell.config["system"])
    pattern = system_mod.pattern(cell.config, cell.traffic)
    system = system_mod.build(cell.config, cell.traffic, pattern, "cpu")
    loop = cells.loop(cell.traffic["loop"]).Loop(
        system, pattern, cell.config, cell.traffic, torch.device("cpu"),
        seed)
    loop.window(0.2)
    return loop, cell.traffic["limits"]


def _fails(numbers, limits):
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("precision", ["tf32", "bfloat16"])
@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5, 40])
def test_control_fails_program_passes(cell, precision, seed):
    loop, limits = _loop(cell, seed)
    assert not _fails(loop.judge(loop.readings()), limits)
    control = loop.judge(loop.control_readings(precision))
    assert _fails(control, limits), json.dumps(control)
