"""roofline_share.train: least time for the work of one training step as a
% of its device-busy time. Moves train_step_ms."""

from perfbench import readers


def read(records):
    return readers.roofline_share(records, "train")
