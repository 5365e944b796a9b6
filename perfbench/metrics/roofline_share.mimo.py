"""roofline_share.mimo: least time for the work of one training step of the
MiMo-V2-Flash stack (``perfbench/counts_mimo.py``) as a % of its
device-busy time. Moves train_step_ms."""

from perfbench import readers


def read(records):
    return readers.roofline_share(records, "train_stack")
