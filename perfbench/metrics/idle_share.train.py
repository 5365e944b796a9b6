"""idle_share.train: % of the profiled sub-window of training steps in
which no device op ran. Moves train_step_ms."""

from perfbench import readers


def read(records):
    return readers.idle_share(records, "train")
