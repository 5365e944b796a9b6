"""host_ms.mimo: mean host time (ms) to enqueue one training step of the
MiMo-V2-Flash stack, each after a synchronize. Moves train_step_ms."""

from perfbench import readers


def read(records):
    return readers.host_ms(records, "train_stack")
