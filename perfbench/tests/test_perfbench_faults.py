"""A run with its timed path broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct.

Each case drives the whole run (``run.main``) on the CPU at the tiny sizes
of ``conftest.TINY``, skipping only the look for a card."""

import json

import pytest
import torch

from conftest import TINY
from perfbench import cells

RUN = cells._module(cells.HERE / "run.py", "perfbench.run_main")
SEED = 2 ** 31 + 77


def run_cell(cell, capsys):
    capsys.readouterr()
    rc = RUN.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "0.3", "--trace", "0",
                   "--rehearse-cpu", json.dumps(TINY[cell])])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _alter_one(out):
    out.view(-1)[out.numel() // 3] += 1.0
    return out


def _drop_half(out):
    # half of the batch left out: its rows or entries never computed
    out[out.shape[0] // 2:] = 0.0
    return out


SDDMM_FAULTS = {"answer_altered": _alter_one, "half_left_out": _drop_half}


@pytest.mark.parametrize("fault", [None, *SDDMM_FAULTS])
def test_sddmm_faults(fault, monkeypatch, capsys):
    system = cells.system("hybrid_sddmm")
    if fault:
        call = system.System.call
        monkeypatch.setattr(system.System, "call",
                            lambda self, ops: SDDMM_FAULTS[fault](
                                call(self, ops)))
    line = run_cell("sddmm.powerlaw512k.k128", capsys)
    assert line["correct"] is (fault is None), line["checks"]


def test_train_unbroken_is_correct(capsys):
    assert run_cell("longformer.train", capsys)["correct"]


def test_train_state_unchanged(monkeypatch, capsys):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    line = run_cell("longformer.train", capsys)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_left_out(monkeypatch, capsys):
    # the mean taken over the first half of the batch's sequences
    loop = cells.loop("train")
    loss_of = loop.loss_of
    monkeypatch.setattr(loop, "loss_of",
                        lambda outs, ys: loss_of(outs[:len(outs) // 2],
                                                 ys[:len(ys) // 2]))
    line = run_cell("longformer.train", capsys)
    assert not line["correct"]
