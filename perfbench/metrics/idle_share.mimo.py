"""idle_share.mimo: % of the profiled sub-window of the MiMo-V2-Flash stack's
training steps in which no device op ran. Moves train_step_ms."""

from perfbench import readers


def read(records):
    return readers.idle_share(records, "train_stack")
