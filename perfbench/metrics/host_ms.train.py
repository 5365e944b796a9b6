"""host_ms.train: mean host time (ms) to enqueue one training step, each
after a synchronize. Moves train_step_ms."""

from perfbench import readers


def read(records):
    return readers.host_ms(records, "train")
