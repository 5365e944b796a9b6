"""mfu.mimo: useful operations of one training step of the MiMo-V2-Flash
stack over its wall time times the mode's peak, in %. Moves
train_step_ms."""

from perfbench import readers


def read(records):
    return readers.mfu(records, "train_stack")
